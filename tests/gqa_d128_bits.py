"""Rows 13 and 15 (GQA paged decode and prefill) at head dim 128 against an
older build of their source: the same operands through this tree's
kernels (templates on the head dim) and through a
``gqa_paged_attention.cu`` whose C entries take D = 128 only (the source
before head dim 256 was added), built apart; every output must have the
same bits.

    python tests/gqa_d128_bits.py OLD_CSRC_DIR

OLD_CSRC_DIR holds that older ``gqa_paged_attention.cu`` and its headers,
e.g. ``git archive <commit> ktransformers_tpu_torch/csrc | tar -x -C DIR``
then ``DIR/ktransformers_tpu_torch/csrc``. The old library is built into
``OLD_CSRC_DIR/build``. Needs a CUDA card. Cases: every route (bf16:
``gqa_decode_split_kernel`` and ``gqa_prefill_mma_kernel`` at 64- and
128-row blocks, and both first versions; float32: the first versions), G
= 4 / 7 / 12 (32 / 28 / 96 query heads over 8 / 4 / 8 KV heads), window
0 and 512, a decode batch of 8 at lengths 1..2048 and two prefill chunks.
Prints a line a case, then ``ALL SAME`` (exit 0) or ``SOME DIFFER`` (exit
1). It holds nothing in the test suite.
"""

import ctypes
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from ktransformers_tpu_torch.ops.cuda import _build  # noqa: E402
from ktransformers_tpu_torch.ops.cuda import paged_attention as PA  # noqa: E402

SCALE = 0.088
PAGE, PMAX, B = 64, 32, 8
LENGTHS = [1, 64, 65, 512, 513, 1000, 2047, 2048]
HEADS = ((32, 8), (28, 4), (96, 8))
CHUNKS = (([256], [256]), ([0, 256], [256, 200]))


def old_library(csrc: str):
    """The older source built as it was built then; its C entries typed."""
    out = os.path.join(csrc, "build")
    os.makedirs(out, exist_ok=True)
    so = os.path.join(out, "libgqa_d128.so")
    subprocess.run([_build.nvcc_path(), *_build.ARCH_FLAGS, "-std=c++17",
                    "-O3", "-shared", "-Xcompiler", "-fPIC", "-I", csrc,
                    "-o", so, os.path.join(csrc, "gqa_paged_attention.cu")],
                   check=True)
    lib = ctypes.CDLL(so)
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.kt_gqa_paged_decode.argtypes = [p] * 5 + [i] * 6 + [f, i] + [p] * 3
    lib.kt_gqa_paged_prefill.argtypes = [p] * 6 + [i] * 7 + [f, i] + [p] * 2
    lib.kt_gqa_prefill_mma.argtypes = [p] * 6 + [i] * 7 + [f, i] + [p] * 2
    lib.kt_gqa_decode_split.argtypes = [p] * 5 + [i] * 7 + [f] + [p] * 4
    lib.kt_gqa_decode_pieces.argtypes = [i, i]
    return lib


def stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def decode_cases(old, q, k, v, tables, lens, window) -> list:
    """(route, same bits) of each decode route q's dtype takes."""
    b, h = q.shape[:2]
    hkv = k.shape[2]
    bf16 = q.dtype == torch.bfloat16
    out = []
    for kern in ("split", "first") if bf16 else ("first",):
        launch, new = PA.gqa_decode_launcher(q, k, v, tables, lens, SCALE,
                                             window, kern)
        launch()
        o = torch.empty_like(q)
        if kern == "split":
            splits = PA.gqa_decode_split_plan(b, hkv, PMAX * PAGE,
                                              PA.sm_count(q.device))
            part = torch.empty(b * hkv * splits * PA.gqa_decode_rec(128),
                               device=q.device)
            cnt = torch.zeros(b * hkv, dtype=torch.int32, device=q.device)
            err = old.kt_gqa_decode_split(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), tables.data_ptr(),
                lens.data_ptr(), b, h, hkv, PAGE, PMAX, window, splits,
                SCALE, part.data_ptr(), cnt.data_ptr(), o.data_ptr(),
                stream())
        else:
            pieces = old.kt_gqa_decode_pieces(PAGE, PMAX)
            part = torch.empty(b * pieces * h * 130, device=q.device)
            err = old.kt_gqa_paged_decode(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), tables.data_ptr(),
                lens.data_ptr(), b, h, hkv, PAGE, PMAX, window, SCALE,
                int(bf16), o.data_ptr(), part.data_ptr(), stream())
        torch.cuda.synchronize()
        out.append((kern, err == 0 and torch.equal(o, new)))
    return out


def prefill_cases(old, q, k, v, tables, olds, valids, window) -> list:
    """(route, same bits) of each prefill route q's dtype takes, the mma
    kernel at both of its block heights."""
    c, h, s = q.shape[:3]
    hkv = k.shape[2]
    bf16 = q.dtype == torch.bfloat16
    lengths = torch.tensor(olds, dtype=torch.int32, device=q.device)
    valid = torch.tensor(valids, dtype=torch.int32, device=q.device)
    plan, out = PA.gqa_prefill_plan, []
    routes = (("mma", 64), ("mma", 128), ("first", None)) if bf16 else (
        ("first", None),)
    for kern, rows in routes:
        if rows is not None:
            PA.gqa_prefill_plan = lambda *a, r=rows: r
        try:
            launch, new = PA.gqa_prefill_launcher(q, k, v, tables, lengths,
                                                  valid, SCALE, window, kern)
            launch()
        finally:
            PA.gqa_prefill_plan = plan
        o = torch.empty_like(q)
        fn = old.kt_gqa_prefill_mma if kern == "mma" else \
            old.kt_gqa_paged_prefill
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), tables.data_ptr(),
                 lengths.data_ptr(), valid.data_ptr(), c, h, hkv, s, PAGE,
                 PMAX, window, SCALE, rows if kern == "mma" else int(bf16),
                 o.data_ptr(), stream())
        torch.cuda.synchronize()
        out.append((f"{kern}{rows or ''}", err == 0 and torch.equal(o, new)))
    return out


def main() -> int:
    if len(sys.argv) != 2 or not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 2
    old = old_library(sys.argv[1])
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)

    def rn(*shape, dtype):
        return torch.randn(shape, generator=g, device=dev).to(dtype)

    n = B * PMAX + 1
    ok, cases = True, 0
    for dtype in (torch.bfloat16, torch.float32):
        for h, hkv in HEADS:
            for window in (0, 512):
                k = rn(n, PAGE, hkv, 128, dtype=dtype)
                v = rn(n, PAGE, hkv, 128, dtype=dtype)
                tables = (torch.randperm(n - 1, device=dev)[: B * PMAX]
                          + 1).reshape(B, PMAX).to(torch.int32)
                lens = torch.tensor(LENGTHS, dtype=torch.int32, device=dev)
                q = rn(B, h, 128, dtype=dtype)
                for kern, same in decode_cases(old, q, k, v, tables, lens,
                                               window):
                    print("decode", dtype, h, hkv, window, kern,
                          "same bits" if same else "DIFFER")
                    ok, cases = ok and same, cases + 1
                for olds, valids in CHUNKS:
                    qq = rn(len(olds), h, 256, 128, dtype=dtype)
                    for kern, same in prefill_cases(
                            old, qq, k, v, tables[: len(olds)].contiguous(),
                            olds, valids, window):
                        print("prefill", dtype, h, hkv, window, olds, kern,
                              "same bits" if same else "DIFFER")
                        ok, cases = ok and same, cases + 1
    print(f"{cases} cases: " + ("ALL SAME" if ok else "SOME DIFFER"))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
