"""Time the W4A8 kernels folded (quantizing x themselves) beside one prep
launch + the unfolded kernel on the same operands, on one GPU.

    python -m ktransformers_tpu_torch.ops.cuda.fold_sweep

The GEMVs at one row a tile: w4a8_gemv_kernel at DeepSeek-V2-Lite's M = 1
projections and Mixtral-8x7B's gathered experts (2 and 16 rows), and the
W4A8 FFN's one-row calls (w4a8_ffn_gemv_kernel + the down GEMV); the
tensor-core kernels over row counts that straddle their crossovers:
w4a8_mma_kernel at DeepSeek-V2-Lite's dense projections and Mixtral's
grouped gate_up, w4a8_ffn_mma_kernel (the whole FFN call, its down on the
requantized codes as before) at the shared experts (I = 2816) and the
routed experts over sorted rows. Every one of them gives the same bits
folded and unfolded (checked here too). Each time is the median of 20
launches with the L2 cache flushed before each (breakdown.time_ms, as
chip_smoke.py times its kernels). The crossovers of w4a8_matmul.folds
(MMA_FOLD_MAX_ROWS) and w4a8_ffn.ffn_folds (FFN_MMA_FOLD_MAX_ROWS) are the
row counts from which prep + unfolded wins. Prints a line a shape, then
all of them as one JSON line.
"""

from __future__ import annotations

import json
import subprocess
import sys

import torch

from ktransformers_tpu_torch.ops.cuda.breakdown import time_ms

ROWS = (2, 3, 4, 5, 6, 7, 8, 9, 12, 16, 24, 32, 48, 64, 128, 256)
DIFFER: list = []


def pair(label, rows, launcher, prep) -> dict:
    """{rows: (folded ms, prep + unfolded ms)} of ``launcher(m, fold)``
    ((launch, out)) and ``prep(m)`` (one prep launch); a row count whose
    two outputs are not the same bits is named and fails the sweep at its
    end."""
    out = {}
    for m in rows:
        f_launch, f_out = launcher(m, True)
        u_launch, u_out = launcher(m, False)
        f_launch()
        u_launch()
        if not torch.equal(f_out, u_out):
            DIFFER.append(f"{label} M={m}")
            print(f"{label} M={m}: folded and unfolded differ", flush=True)
        out[m] = (time_ms(f_launch),
                  time_ms(lambda: (prep(m), u_launch())))
    print(f"{label}: " + ", ".join(f"M={m} {f:.4f} / {u:.4f}"
                                   for m, (f, u) in out.items()), flush=True)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("fold_sweep: no CUDA device", file=sys.stderr)
        return 1
    from ktransformers_tpu_torch.models.init import _Draw
    from ktransformers_tpu_torch.ops.cuda import w4a8_ffn as F
    from ktransformers_tpu_torch.ops.cuda import w4a8_matmul as MM
    from ktransformers_tpu_torch.quant.w4a8 import repack_offset_lo

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}; folded ms / prep + unfolded ms", flush=True)
    rd = _Draw(3, torch.device("cuda"), torch.bfloat16)

    def rn(*shape):
        return torch.randn(*shape, device="cuda", generator=rd.gen).to(
            torch.bfloat16)

    def w(shape, gs=128):
        return repack_offset_lo(rd.q(shape, "int4_g", gs))

    def sizes(m, e):
        ids = torch.randint(0, e, (m,), generator=rd.gen, device="cuda")
        return torch.bincount(ids, minlength=e).to(torch.int32)

    result = dict(card=card)
    xs: dict = {}

    def x(m, k):
        """The rows of one shape, the same tensor for both launches."""
        if (m, k) not in xs:
            xs[m, k] = rn(m, k)
        return xs[m, k]

    ids = {r: torch.randint(0, 8, (r,), generator=rd.gen, device="cuda",
                            dtype=torch.int32) for r in (2, 16)}
    ids.update({r: torch.randint(0, 64, (r,), generator=rd.gen,
                                 device="cuda", dtype=torch.int32)
                for r in (6, 48)})
    one = {}
    for k, n, gs, what in ((2048, 3648, 128, "qkv_a"),
                           (2048, 2048, 128, "o_proj"),
                           (2048, 102400, 128, "lm_head"),
                           (2048, 21888, 128, "layer-0 gate_up"),
                           (10944, 2048, 96, "layer-0 down (gs 96)")):
        wt = w((k, n), gs)
        one[what] = pair(
            f"w4a8_gemv dense {what}", (1,),
            lambda m, f: MM.dense_w4a8_launcher(x(m, k), wt, "gemv", f),
            lambda m: MM.prep_activations(x(m, k), k, gs))[1]
        rows = [m for m in (ROWS if n < 20000 else (2, 4, 8, 16))
                if MM.mma_fold_fits(m, k, gs, MM.MMA_STAGES, 64)]
        result[f"dense {what}"] = pair(
            f"w4a8_mma dense {what}", rows,
            lambda m, f: MM.dense_w4a8_launcher(x(m, k), wt, "mma", f),
            lambda m: MM.prep_activations(x(m, k), k, gs))
        del wt
    for k, n in ((4096, 28672), (14336, 4096)):
        wt = w((8, k, n))
        for r in (2, 16):
            one[f"mixtral gathered {r} rows [8, {k}, {n}]"] = pair(
                f"w4a8_gemv mixtral gathered [8, {k}, {n}]", (r,),
                lambda m, f: MM.gathered_launcher(x(m, k), wt, ids[m],
                                                  "gemv", f),
                lambda m: MM.prep_activations(x(m, k), k, 128))[r]
        del wt
    gu, dn = w((64, 2048, 2816)), w((64, 1408, 2048))
    for r in (6, 48):
        one[f"ffn gathered {r} rows"] = pair(
            "w4a8_ffn_gemv gathered routed", (r,),
            lambda m, f: F.gathered_launcher(x(m, 2048), gu, dn, ids[m],
                                             "silu", "gemv", f),
            lambda m: MM.prep_activations(x(m, 2048), 2048, 128))[r]
    sgu, sdn = w((2048, 5632)), w((2816, 2048))
    one["ffn dense shared M=1"] = pair(
        "w4a8_ffn_gemv dense shared", (1,),
        lambda m, f: F.dense_launcher(x(m, 2048), sgu, sdn, "silu", "gemv",
                                      f),
        lambda m: MM.prep_activations(x(m, 2048), 2048, 128))[1]
    result["gemv"] = one
    wt = w((8, 4096, 28672))
    grp = {m: sizes(m, 8) for m in ROWS}
    result["mixtral grouped gate_up"] = pair(
        "w4a8_mma mixtral grouped gate_up",
        [m for m in ROWS if MM.mma_fold_fits(m, 4096, 128, MM.MMA_STAGES,
                                             64)],
        lambda m, f: MM.grouped_launcher(x(m, 4096), wt, grp[m], "mma", f),
        lambda m: MM.prep_activations(x(m, 4096), 4096, 128))
    del wt
    ffn_rows = [m for m in ROWS
                if MM.mma_fold_fits(m, 2048, 128, F.FFN_MMA_STAGES, 256)]
    result["ffn dense shared"] = pair(
        "w4a8_ffn_mma dense shared I=2816", ffn_rows,
        lambda m, f: F.dense_launcher(x(m, 2048), sgu, sdn, "silu", "mma",
                                      f),
        lambda m: MM.prep_activations(x(m, 2048), 2048, 128))
    grp = {m: sizes(m, 64) for m in ROWS}
    result["ffn grouped routed"] = pair(
        "w4a8_ffn_mma grouped routed (64 experts)", ffn_rows,
        lambda m, f: F.grouped_launcher(x(m, 2048), gu, dn, grp[m], "silu",
                                        "mma", f),
        lambda m: MM.prep_activations(x(m, 2048), 2048, 128))
    print(json.dumps(result))
    if DIFFER:
        print(f"fold_sweep: folded and unfolded differ at {DIFFER}",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
