"""Time the split-K GEMVs, the split-N wgmma kernel and the five bf16
attention kernels at the main path's shapes under several split counts
or block shapes, on one GPU.

    python -m ktransformers_tpu_torch.ops.cuda.split_sweep [section ...]

Sections (default: all): gemv, w4a8_gemv, ffn_gemv, wgmma_t, mla_decode,
mla_prefill, mla_paged_decode, gqa_prefill, gqa_decode.
quant_gemv_kernel (int8 weights, bf16 x, M = 1 and the gathered entry),
w4a8_gemv_kernel (W4A8 weights, bf16 x, M = 1: splits of whole scale
groups), w4a8_ffn_gemv_kernel (the W4A8 FFN's one-row gate_up launch
alone: 6 and 48 routed rows, the shared experts at M = 1),
quant_wgmma_t_kernel (W4A8 weights, bf16 dy, the SFT step's 512 rows),
mla_decode_split_kernel (16 heads, rows a split), mla_prefill_mma_kernel
(16 heads, heads a block), mla_paged_decode_split_kernel (16 heads, the
serving batch, positions a split), gqa_prefill_mma_kernel (Mixtral's
32 / 8 heads, query rows a block) and gqa_decode_split_kernel (Mixtral's
32 / 8 heads, the serving batch, splits a (sequence, KV head)) are
launched through their wrappers' launchers with the planner replaced by a
fixed count; the planner's own choice is marked, and the FFN and
attention rows also time the first version ("first"). Each time is the median of 20 launches with the L2
cache flushed before each (as chip_smoke.py times its kernels), beside the
one-call library yardstick (torch.matmul on the bf16-dequantized weight)
where there is one; the attention kernels' yardstick is chip_smoke.py's.
Prints one line per shape, then all of them as one JSON line.
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

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)
    rd = _Draw(2, torch.device("cuda"), torch.bfloat16)

    def rn(*shape):
        return torch.randn(*shape, device="cuda", generator=rd.gen).to(
            torch.bfloat16)

    sections = sys.argv[1:] or list(SECTIONS)
    result = dict(card=card)
    for name in sections:
        result[name] = {}
        SECTIONS[name](result[name], rd, rn)
    print(json.dumps(result))
    return 0


def gemv_section(result, rd, rn):
    from ktransformers_tpu_torch.ops.cuda import quant_matmul as QM
    from ktransformers_tpu_torch.quant.formats import dequantize

    bf = torch.bfloat16
    for k, n, label in ((2048, 3648, "qkv_a"), (2048, 2048, "o_proj"),
                        (10944, 2048, "layer-0 down"),
                        (2048, 102400, "lm_head"),
                        (4096, 6144, "Mixtral qkv")):
        x, w = rn(1, k), rd.q((k, n), "int8", 128)
        wdq = dequantize(w, bf)
        most = k // QM.GEMV_UNIT // QM.GEMV_LANES
        counts = sorted({c for c in (1, 8, 16, 32, 64, 128) if c <= most})
        result[label] = sweep(
            f"gemv int8 {label} M=1", QM, "gemv_plan",
            lambda c: (lambda *a: (c, 1)), counts,
            lambda x=x, w=w: QM.dense_launcher(x, w, "gemv"),
            lambda x=x, wdq=wdq: torch.matmul(x, wdq))
        del wdq
    we = rd.q((64, 2048, 2816), "int8", 128)
    ids = torch.randperm(64, generator=torch.Generator().manual_seed(3))[
        :6].to(torch.int32).cuda()
    xe = rn(6, 2048)
    result["gathered gate_up 6 rows"] = sweep(
        "gemv int8 gathered gate_up 6 rows", QM, "gemv_plan",
        lambda c: (lambda *a: (c, 1)), (1, 2, 4, 8, 16, 32),
        lambda: QM.gathered_launcher(xe, we, ids, "gemv"), None)
    del we


def w4a8_gemv_section(result, rd, rn):
    from ktransformers_tpu_torch.ops.cuda import w4a8_matmul as MM
    from ktransformers_tpu_torch.quant.formats import dequantize
    from ktransformers_tpu_torch.quant.w4a8 import repack_offset_lo

    bf = torch.bfloat16
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
        result[label] = sweep(
            f"gemv w4a8 {label} M=1", MM, "w4a8_gemv_plan",
            lambda c, gs2=gs2: (lambda *a: (c, gs2 // MM.GEMV_UNIT)), counts,
            lambda x=x, w=w: MM.dense_w4a8_launcher(x, w, "gemv"),
            lambda x=x, wdq=wdq: torch.matmul(x, wdq))
        del wdq


def wgmma_t_section(result, rd, rn):
    from ktransformers_tpu_torch.ops.cuda import quant_matmul_t as QT
    from ktransformers_tpu_torch.quant.formats import dequantize
    from ktransformers_tpu_torch.quant.w4a8 import repack_offset_lo

    bf = torch.bfloat16
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
        result[label] = sweep(
            f"wgmma_t w4a8 dx M=512 {label}", QT, "t_plan",
            lambda c: (lambda *a: c), counts,
            lambda dy=dy, w=w: QT.dense_t_launcher(dy, w, "wgmma"),
            lambda dy=dy, wdq=wdq: torch.matmul(dy, wdq.T))
        del wdq


def mla_decode_section(result, rd, rn):
    """mla_decode_split_kernel at 16 heads under forced rows a split
    (splits = ceil(S / span)), the first version beside it."""
    from ktransformers_tpu_torch.ops.cuda import mla_decode as MD
    from ktransformers_tpu_torch.ops.rope import rope_rotation_matrix

    h, r, dr = 16, 512, 64
    scale = (128 + 64) ** -0.5
    for b, smax, lens in ((1, 1024, [512]), (1, 4096, [2048]),
                          (1, 4096, [4095]),
                          (8, 1024, [1, 64, 65, 300, 512, 513, 800, 1000])):
        rot = rope_rotation_matrix(rn(b, dr // 2).float(),
                                   rn(b, dr // 2).float(), True)
        args = (rn(b, h, r), rn(b, h, dr), rn(b, 1, r + dr),
                torch.ones(r, device="cuda"), rot, rn(b, smax, r),
                rn(b, smax, dr),
                torch.tensor(lens, dtype=torch.int32, device="cuda"), scale,
                1e-6)
        spans = [sp for sp in (16, 32, 64, 128, 256, 512, 1024)
                 if -(-smax // sp) <= MD.DECODE_MAX_SPLITS]
        label = f"B={b} S={smax} cached {lens[0]}..{lens[-1]}"
        row = sweep(f"mla_decode_split {label}, rows a split", MD,
                    "decode_split_plan",
                    lambda sp, smax=smax: (lambda *a: (-(-smax // sp), sp)),
                    spans, lambda args=args: MD.mla_launcher(*args, "split"),
                    None)
        row["first_ms"] = time_ms(MD.mla_launcher(*args, "fused")[0])
        print(f"  first {row['first_ms']:.4f}", flush=True)
        result[label] = row


def mla_prefill_section(result, rd, rn):
    """mla_prefill_mma_kernel at 16 heads, 4 or 2 heads a block, the first
    version beside it, at the four shapes chip_smoke.py times."""
    from ktransformers_tpu_torch.ops.cuda import paged_attention as PA

    h, r, dr, page, pmax = 16, 512, 64, 64, 32
    scale = (128 + 64) ** -0.5
    for olds, s, valids in (([256], 256, [256]), ([0, 256], 256, [256, 200]),
                            ([0], 512, [512]), ([0, 256], 512, [512, 456])):
        c = len(olds)
        perm = torch.randperm(c * pmax, generator=torch.Generator()
                              .manual_seed(s + c)) + 1
        tables = perm.reshape(c, pmax).to(torch.int32).cuda()
        ckv, kpe = rn(c * pmax + 1, page, r), rn(c * pmax + 1, page, dr)
        lengths = torch.tensor(olds, dtype=torch.int32, device="cuda")
        valid = torch.tensor(valids, dtype=torch.int32, device="cuda")
        qn, qp = rn(c, h, s, r), rn(c, h, s, dr)
        args = (qn, qp, ckv, kpe, tables, lengths, valid, scale)
        label = f"C={c} S={s} old={olds} valid={valids}"
        row = sweep(f"mla_prefill_mma {label}, heads a block", PA,
                    "prefill_plan", lambda hb: (lambda *a: hb), (4, 2),
                    lambda args=args: PA.prefill_launcher(*args, "mma"),
                    None)
        row["first_ms"] = time_ms(PA.prefill_launcher(*args, "first")[0])
        print(f"  first {row['first_ms']:.4f}", flush=True)
        result[label] = row


def mla_paged_decode_section(result, rd, rn):
    """mla_paged_decode_split_kernel at the serving batch (8 sequences of
    lengths 1..2048, 16 heads, 32 pages a sequence) under forced positions
    a split, at page 16, 64 and 128, the first version beside it."""
    from ktransformers_tpu_torch.ops.cuda import mla_decode as MD
    from ktransformers_tpu_torch.ops.cuda import paged_attention as PA

    h, r, dr = 16, 512, 64
    scale = (128 + 64) ** -0.5
    lens = [1, 64, 65, 512, 513, 1000, 2047, 2048]
    for page in (16, 64, 128):
        pmax = 2048 // page
        perm = torch.randperm(8 * pmax, generator=torch.Generator()
                              .manual_seed(page)) + 1
        tables = perm.reshape(8, pmax).to(torch.int32).cuda()
        args = (rn(8, h, r), rn(8, h, dr), rn(8 * pmax + 1, page, r),
                rn(8 * pmax + 1, page, dr), tables,
                torch.tensor(lens, dtype=torch.int32, device="cuda"), scale)
        spans = [sp for sp in (64, 128, 256, 512, 1024, 2048)
                 if -(-2048 // sp) <= MD.DECODE_MAX_SPLITS]
        label = f"B=8 page={page} lengths 1..2048"
        row = sweep(f"mla_paged_decode_split {label}, positions a split", MD,
                    "decode_split_plan",
                    lambda sp: (lambda *a: (-(-2048 // sp), sp)), spans,
                    lambda args=args: PA.decode_launcher(*args,
                                                         kernel="split"),
                    None)
        row["first_ms"] = time_ms(PA.decode_launcher(*args,
                                                     kernel="first")[0])
        print(f"  first {row['first_ms']:.4f}", flush=True)
        result[label] = row


def gqa_prefill_section(result, rd, rn):
    """gqa_prefill_mma_kernel at Mixtral's widths (32 query heads over 8 KV
    heads of 128, page 64), 64 or 128 query rows a block, the first version
    beside it, at the chunks chip_smoke.py times and at S = 512."""
    from ktransformers_tpu_torch.ops.cuda import paged_attention as PA

    h, hkv, d, page, pmax = 32, 8, 128, 64, 32
    for olds, s, valids in (([256], 256, [256]), ([0, 256], 256, [256, 200]),
                            ([0], 512, [512]), ([0, 256], 512, [512, 456])):
        c = len(olds)
        perm = torch.randperm(c * pmax, generator=torch.Generator()
                              .manual_seed(s + c)) + 1
        tables = perm.reshape(c, pmax).to(torch.int32).cuda()
        args = (rn(c, h, s, d), rn(c * pmax + 1, page, hkv, d),
                rn(c * pmax + 1, page, hkv, d), tables,
                torch.tensor(olds, dtype=torch.int32, device="cuda"),
                torch.tensor(valids, dtype=torch.int32, device="cuda"),
                d ** -0.5)
        label = f"C={c} S={s} old={olds} valid={valids}"
        row = sweep(f"gqa_prefill_mma {label}, rows a block", PA,
                    "gqa_prefill_plan", lambda rows: (lambda *a: rows),
                    PA.GQA_PREFILL_ROWS,
                    lambda args=args: PA.gqa_prefill_launcher(*args,
                                                              kernel="mma"),
                    None)
        row["first_ms"] = time_ms(PA.gqa_prefill_launcher(
            *args, kernel="first")[0])
        print(f"  first {row['first_ms']:.4f}", flush=True)
        result[label] = row


def ffn_gemv_section(result, rd, rn):
    """w4a8_ffn_gemv_kernel (the gate_up launch of a one-row FFN call) at
    DeepSeek-V2-Lite's decode shapes under forced splits of whole scale
    groups, the first version's gate_up (ffn_up_kernel<1>) beside it."""
    from ktransformers_tpu_torch.ops.cuda import w4a8_ffn as F
    from ktransformers_tpu_torch.quant.w4a8 import repack_offset_lo

    def w(shape):
        return repack_offset_lo(rd.q(shape, "int4_g", 128))

    gu, dn = w((64, 2048, 2816)), w((64, 1408, 2048))
    g = torch.Generator().manual_seed(3)
    calls = []
    for rows in (6, 48):
        ids = torch.stack([torch.randperm(64, generator=g)[:6]
                           for _ in range(rows // 6)]).reshape(-1)
        x = rn(rows, 2048)
        calls.append((f"gathered {rows} rows", lambda k, x=x,
                      ids=ids.to(torch.int32).cuda(): F.gathered_launcher(
                          x, gu, dn, ids, "silu", k)))
    sgu, sdn, xs = w((2048, 5632)), w((2816, 2048)), rn(1, 2048)
    calls.append(("shared M=1", lambda k: F.dense_launcher(xs, sgu, sdn,
                                                           "silu", k)))
    for label, launcher in calls:
        row = sweep(f"ffn_gemv {label}, splits", F, "ffn_gemv_plan",
                    lambda c: (lambda *a: (c, 8)), (1, 2, 4, 8, 12, 16),
                    lambda launcher=launcher: (launcher("gemv")[0].up, None),
                    None)
        row["first_ms"] = time_ms(launcher("rows")[0].up)
        print(f"  first {row['first_ms']:.4f}", flush=True)
        result[label] = row


def gqa_decode_section(result, rd, rn):
    """gqa_decode_split_kernel at Mixtral's widths (32 query heads over 8
    KV heads of 128, page 64) and the serving batch (8 sequences of
    lengths 1..2048), window 0 and 512, under forced splits, the first
    version beside it."""
    from ktransformers_tpu_torch.ops.cuda import paged_attention as PA

    lens = [1, 64, 65, 512, 513, 1000, 2047, 2048]
    perm = torch.randperm(8 * 32, generator=torch.Generator()
                          .manual_seed(8)) + 1
    tables = perm.reshape(8, 32).to(torch.int32).cuda()
    args = (rn(8, 32, 128), rn(8 * 32 + 1, 64, 8, 128),
            rn(8 * 32 + 1, 64, 8, 128), tables,
            torch.tensor(lens, dtype=torch.int32, device="cuda"),
            128 ** -0.5)
    for window in (0, 512):
        label = f"B=8 page=64 lengths 1..2048 window={window}"
        row = sweep(f"gqa_decode_split {label}, splits", PA,
                    "gqa_decode_split_plan", lambda c: (lambda *a: c),
                    (1, 2, 3, 4, 5, 6, 8, 12, 16, 32),
                    lambda window=window: PA.gqa_decode_launcher(
                        *args, window=window, kernel="split"), None)
        row["first_ms"] = time_ms(PA.gqa_decode_launcher(
            *args, window=window, kernel="first")[0])
        print(f"  first {row['first_ms']:.4f}", flush=True)
        result[label] = row


SECTIONS = {"gemv": gemv_section, "w4a8_gemv": w4a8_gemv_section,
            "ffn_gemv": ffn_gemv_section,
            "wgmma_t": wgmma_t_section, "mla_decode": mla_decode_section,
            "mla_prefill": mla_prefill_section,
            "mla_paged_decode": mla_paged_decode_section,
            "gqa_prefill": gqa_prefill_section,
            "gqa_decode": gqa_decode_section}


if __name__ == "__main__":
    sys.exit(main())
