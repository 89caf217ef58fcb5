"""Time the split-K GEMVs and the split-N wgmma kernel at the main path's
shapes under several split counts, on one GPU.

    python -m ktransformers_tpu_torch.ops.cuda.split_sweep

quant_gemv_kernel (int8 weights, bf16 x, M = 1 and the gathered entry),
w4a8_gemv_kernel (W4A8 weights, bf16 x, M = 1: splits of whole scale
groups) and quant_wgmma_t_kernel (W4A8 weights, bf16 dy, the SFT step's
512 rows) are launched through their wrappers' launchers with the planner
replaced by a fixed count; the planner's own choice is marked. Each time is the median of
20 launches with the L2 cache flushed before each (as chip_smoke.py times
its kernels), beside the one-call library yardstick (torch.matmul on the
bf16-dequantized weight) where there is one. Prints one line per shape,
then all of them as one JSON line.
"""

from __future__ import annotations

import json
import subprocess
import sys

import torch

from ktransformers_tpu_torch.ops.cuda.breakdown import time_ms


def sweep(label, plan_mod, plan_name, choose, counts, launcher, library):
    """{count: ms} for the forced counts, the planner's count marked."""
    real = getattr(plan_mod, plan_name)
    row = {"planned": None, "library_ms": None, "ms": {}}
    try:
        for c in counts:
            setattr(plan_mod, plan_name, choose(c))
            row["ms"][c] = time_ms(launcher()[0])
    finally:
        setattr(plan_mod, plan_name, real)
    row["planned"] = time_ms(launcher()[0])
    if library is not None:
        row["library_ms"] = time_ms(library)
    print(f"{label}: " + ", ".join(f"{c} {ms:.4f}" for c, ms in
                                   row["ms"].items())
          + f"; planned {row['planned']:.4f}; library {row['library_ms']}",
          flush=True)
    return row


def main() -> int:
    if not torch.cuda.is_available():
        print("split_sweep: no CUDA device", file=sys.stderr)
        return 1
    from ktransformers_tpu_torch.models.init import _Draw
    from ktransformers_tpu_torch.ops.cuda import quant_matmul as QM
    from ktransformers_tpu_torch.ops.cuda import quant_matmul_t as QT
    from ktransformers_tpu_torch.ops.cuda import w4a8_matmul as MM
    from ktransformers_tpu_torch.quant.formats import dequantize
    from ktransformers_tpu_torch.quant.w4a8 import repack_offset_lo

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)
    rd = _Draw(2, torch.device("cuda"), torch.bfloat16)
    bf = torch.bfloat16

    def rn(*shape):
        return torch.randn(*shape, device="cuda", generator=rd.gen).to(bf)

    result = dict(card=card, gemv={}, w4a8_gemv={}, wgmma_t={})
    for k, n, label in ((2048, 3648, "qkv_a"), (2048, 2048, "o_proj"),
                        (10944, 2048, "layer-0 down"),
                        (2048, 102400, "lm_head"),
                        (4096, 6144, "Mixtral qkv")):
        x, w = rn(1, k), rd.q((k, n), "int8", 128)
        wdq = dequantize(w, bf)
        most = k // QM.GEMV_UNIT // QM.GEMV_LANES
        counts = sorted({c for c in (1, 8, 16, 32, 64, 128) if c <= most})
        result["gemv"][label] = sweep(
            f"gemv int8 {label} M=1", QM, "gemv_plan",
            lambda c: (lambda *a: (c, 1)), counts,
            lambda x=x, w=w: QM.dense_launcher(x, w, "gemv"),
            lambda x=x, wdq=wdq: torch.matmul(x, wdq))
        del wdq
    we = rd.q((64, 2048, 2816), "int8", 128)
    ids = torch.randperm(64, generator=torch.Generator().manual_seed(3))[
        :6].to(torch.int32).cuda()
    xe = rn(6, 2048)
    result["gemv"]["gathered gate_up 6 rows"] = sweep(
        "gemv int8 gathered gate_up 6 rows", QM, "gemv_plan",
        lambda c: (lambda *a: (c, 1)), (1, 2, 4, 8, 16, 32),
        lambda: QM.gathered_launcher(xe, we, ids, "gemv"), None)
    del we

    for k, n, label in ((2048, 3648, "qkv_a"), (2048, 2048, "o_proj"),
                        (10944, 2048, "layer-0 down (gs 96)"),
                        (2048, 102400, "lm_head")):
        w = repack_offset_lo(rd.q((k, n), "int4_g", 128))
        x = rn(1, k)
        wdq = dequantize(w, bf)
        gs2 = w.group_size // 2
        groups = k // w.group_size
        counts = sorted({c for c in (1, 2, 4, 8, 16, 32, 64, groups)
                         if c <= groups})
        result["w4a8_gemv"][label] = sweep(
            f"gemv w4a8 {label} M=1", MM, "w4a8_gemv_plan",
            lambda c, gs2=gs2: (lambda *a: (c, gs2 // MM.GEMV_UNIT)), counts,
            lambda x=x, w=w: MM.dense_w4a8_launcher(x, w, "gemv"),
            lambda x=x, wdq=wdq: torch.matmul(x, wdq))
        del wdq

    for k, n, label in ((2048, 3648, "qkv_a"), (2048, 2048, "o_proj"),
                        (2048, 102400, "lm_head"),
                        (2048, 21888, "layer-0 gate_up"),
                        (10944, 2048, "layer-0 down (gs 96)")):
        gs = 96 if k == 10944 else 128
        w = repack_offset_lo(rd.q((k, n), "int4_g", gs))
        dy = rn(512, n)
        wdq = dequantize(w, bf)
        most = max(1, -(-n // QT.WGMMA_NC) // QT.WGMMA_MIN_STAGES)
        counts = sorted({c for c in (1, 2, 3, 4, 6, 8, 12, 16) if c <= most})
        result["wgmma_t"][label] = sweep(
            f"wgmma_t w4a8 dx M=512 {label}", QT, "t_plan",
            lambda c: (lambda *a: c), counts,
            lambda dy=dy, w=w: QT.dense_t_launcher(dy, w, "wgmma"),
            lambda dy=dy, wdq=wdq: torch.matmul(dy, wdq.T))
        del wdq
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
