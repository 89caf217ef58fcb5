"""Where the time of the redesigned kernels goes, on one GPU.

    python -m ktransformers_tpu_torch.ops.cuda.breakdown [kernel ...]

Each kernel is rebuilt from a copy of csrc/ with parts of its loop
compiled out, and timed through its wrapper's launcher at the main path's
shapes (L2 flushed before each launch, median of 20):
- quant_mma_kernel (int8 weights, bf16 x): without the decode pass (the
  mma reads whatever the decoded tile holds), without the mma, without
  both;
- w4a8_mma_kernel: without the group epilogue, without the s8 mma,
  without both;
- quant_gemv_kernel (int8 weights, M = 1 and the gathered entry): without
  the decode and FMAs (one add a loaded word), without the cross-split
  reduction (every split stores its own sums), without both;
- quant_wgmma_t_kernel (W4A8 weights, bf16 dy, the SFT step's shapes):
  without the decode of the weight tile, without the wgmma, without the
  cross-split reduction, without decode and wgmma;
- w4a8_gemv_kernel (M = 1 and the gathered entry): without the transposes
  and int8 dots (one xor a loaded word), without the cross-split
  reduction, without both;
- w4a8_ffn_mma_kernel (the FFN's gate_up at 64-row tiles): without the
  s8 mma, without the group epilogue, without the GLU and requant (the
  staging through shared memory included), without mma and epilogue. The
  FFN call's down launch (w4a8_mma_kernel, unchanged) is in every time;
- mla_decode_split_kernel (bf16 mla_decode_fused, 16 heads): without the
  two products (mma.sync), without the in-launch merge of the splits,
  without both and the exponentials;
- mla_prefill_mma_kernel (bf16 mla_paged_prefill, 16 heads, the plan's
  block shape): without the products, without the exponentials, without
  both;
- mla_paged_decode_split_kernel (bf16 mla_paged_decode, 16 heads, the
  serving batch over page 64): without the products, without the merge,
  without both and the exponentials;
- gqa_prefill_mma_kernel (bf16 gqa_paged_prefill, Mixtral's 32 / 8 heads,
  the plan's block shape): without the products, without the
  exponentials, without both;
- w4a8_ffn_gemv_kernel (the W4A8 FFN's one-row gate_up, its launch alone:
  6 and 48 routed rows, the shared experts at M = 1): without the
  transposes and int8 dots (w4gv::lane_walk's switch), without the
  cross-split sum, without the GLU and requant, without all three;
- gqa_decode_split_kernel (bf16 gqa_paged_decode, Mixtral's 32 / 8 heads,
  the serving batch, window 0 and 512): without the products, without the
  merge of the splits, without both and the exponentials.
What is left with the main parts out is the skeleton: copies, barriers,
loads. The outputs of the cut variants are garbage; only their times are
read. Beside them, the floor of this way of timing (floor_ms): an empty
launch, and a device-to-device copy (the library's) of 6, 18.4 and 25.6 MB,
the bytes of the new decode kernels' calls. The copies and libraries go to csrc/build/breakdown/ (git-ignored);
each W4A8 copy gets its own namespaces, so that the libraries share no
template symbol. Names on the command line pick kernels (default: all).
Prints one line per shape, then all of them as one JSON line.
"""

from __future__ import annotations

import ctypes
import json
import os
import shutil
import statistics
import subprocess
import sys

import torch

from ktransformers_tpu_torch.ops.cuda import _build

# (file, text, replacement): a variant's switch wraps the marked code
CUTS = {
    "quant_matmul.cu": [
        ("    mma_decode_stage<KIND, BN>(a, slot, Bs);",
         "#if !CUT_DECODE\n    mma_decode_stage<KIND, BN>(a, slot, Bs);\n"
         "#endif"),
        ("          kt_mma::mma_bf16_16816(acc[i][2 * p], af[i], bf[0], "
         "bf[1]);\n          kt_mma::mma_bf16_16816(acc[i][2 * p + 1], "
         "af[i], bf[2], bf[3]);",
         "#if CUT_MMA\n          acc[i][2 * p][0] += __uint_as_float(af[i][0]"
         " ^ bf[0]);\n          acc[i][2 * p + 1][1] += "
         "__uint_as_float(af[i][1] ^ bf[3]);\n#else\n"
         "          kt_mma::mma_bf16_16816(acc[i][2 * p], af[i], bf[0], "
         "bf[1]);\n          kt_mma::mma_bf16_16816(acc[i][2 * p + 1], "
         "af[i], bf[2], bf[3]);\n#endif"),
    ],
    "w4a8_mma.cuh": [
        ("              acc[i][p][h][c] += val * sc[c];",
         "#if CUT_EPILOGUE\n              acc[i][p][h][c] += (float)(pa[i]"
         "[nt][fc] ^ pb[i][nt][fc]);\n#else\n              acc[i][p][h][c]"
         " += val * sc[c];\n#endif"),
        ("            kt_mma::mma_s8_16832(pa[i][2 * p], fa[i], e0 & LO, "
         "e1 & LO);",
         "#if CUT_MMA\n            pa[i][2 * p][0] ^= fa[i][0] ^ e0;\n"
         "            pb[i][2 * p][1] ^= fb[i][1] ^ o1;\n#else\n"
         "            kt_mma::mma_s8_16832(pa[i][2 * p], fa[i], e0 & LO, "
         "e1 & LO);"),
        ("            kt_mma::mma_s8_16832(pb[i][2 * p + 1], fb[i], o0, o1);",
         "            kt_mma::mma_s8_16832(pb[i][2 * p + 1], fb[i], o0, o1);"
         "\n#endif"),
    ],
}
# kernel: (library, {variant: compiler flags}); the GEMV's and the wgmma
# kernel's switches are preprocessor conditions in their sources
VARIANTS = {
    "quant_mma_kernel": ("quant_matmul", {
        "full": [], "no_decode": ["-DCUT_DECODE=1"],
        "no_mma": ["-DCUT_MMA=1"],
        "skeleton": ["-DCUT_DECODE=1", "-DCUT_MMA=1"]}),
    "w4a8_mma_kernel": ("w4a8_matmul", {
        "full": [], "no_epilogue": ["-DCUT_EPILOGUE=1"],
        "no_mma": ["-DCUT_MMA=1"],
        "skeleton": ["-DCUT_EPILOGUE=1", "-DCUT_MMA=1"]}),
    "quant_gemv_kernel": ("quant_matmul", {
        "full": [], "no_decode": ["-DKT_GEMV_CUT_DECODE=1"],
        "no_reduce": ["-DKT_GEMV_CUT_REDUCE=1"],
        "skeleton": ["-DKT_GEMV_CUT_DECODE=1", "-DKT_GEMV_CUT_REDUCE=1"]}),
    "quant_wgmma_t_kernel": ("quant_matmul_t", {
        "full": [], "no_decode": ["-DKT_T_CUT_DECODE=1"],
        "no_wgmma": ["-DKT_T_CUT_WGMMA=1"],
        "no_reduce": ["-DKT_T_CUT_REDUCE=1"],
        "skeleton": ["-DKT_T_CUT_DECODE=1", "-DKT_T_CUT_WGMMA=1"]}),
    "w4a8_gemv_kernel": ("w4a8_matmul", {
        "full": [], "no_decode": ["-DKT_W4GEMV_CUT_DECODE=1"],
        "no_reduce": ["-DKT_W4GEMV_CUT_REDUCE=1"],
        "skeleton": ["-DKT_W4GEMV_CUT_DECODE=1",
                     "-DKT_W4GEMV_CUT_REDUCE=1"]}),
    "w4a8_ffn_mma_kernel": ("w4a8_ffn", {
        "full": [], "no_mma": ["-DKT_FFNMMA_CUT_MMA=1"],
        "no_epilogue": ["-DKT_FFNMMA_CUT_EPILOGUE=1"],
        "no_requant": ["-DKT_FFNMMA_CUT_REQUANT=1"],
        "skeleton": ["-DKT_FFNMMA_CUT_MMA=1",
                     "-DKT_FFNMMA_CUT_EPILOGUE=1"]}),
    "mla_decode_split_kernel": ("mla_decode", {
        "full": [], "no_mma": ["-DKT_MLA_CUT_MMA=1"],
        "no_merge": ["-DKT_MLA_CUT_MERGE=1"],
        "skeleton": ["-DKT_MLA_CUT_MMA=1", "-DKT_MLA_CUT_SOFTMAX=1",
                     "-DKT_MLA_CUT_MERGE=1"]}),
    "mla_prefill_mma_kernel": ("paged_attention", {
        "full": [], "no_mma": ["-DKT_MLA_CUT_MMA=1"],
        "no_softmax": ["-DKT_MLA_CUT_SOFTMAX=1"],
        "skeleton": ["-DKT_MLA_CUT_MMA=1", "-DKT_MLA_CUT_SOFTMAX=1"]}),
    "mla_paged_decode_split_kernel": ("paged_attention", {
        "full": [], "no_mma": ["-DKT_MLA_CUT_MMA=1"],
        "no_merge": ["-DKT_MLA_CUT_MERGE=1"],
        "skeleton": ["-DKT_MLA_CUT_MMA=1", "-DKT_MLA_CUT_SOFTMAX=1",
                     "-DKT_MLA_CUT_MERGE=1"]}),
    "gqa_prefill_mma_kernel": ("gqa_paged_attention", {
        "full": [], "no_mma": ["-DKT_GQA_CUT_MMA=1"],
        "no_softmax": ["-DKT_GQA_CUT_SOFTMAX=1"],
        "skeleton": ["-DKT_GQA_CUT_MMA=1", "-DKT_GQA_CUT_SOFTMAX=1"]}),
    "w4a8_ffn_gemv_kernel": ("w4a8_ffn", {
        "full": [], "no_decode": ["-DKT_W4GEMV_CUT_DECODE=1"],
        "no_reduce": ["-DKT_FFNGV_CUT_REDUCE=1"],
        "no_requant": ["-DKT_FFNGV_CUT_REQUANT=1"],
        "skeleton": ["-DKT_W4GEMV_CUT_DECODE=1", "-DKT_FFNGV_CUT_REDUCE=1",
                     "-DKT_FFNGV_CUT_REQUANT=1"]}),
    "gqa_decode_split_kernel": ("gqa_paged_attention", {
        "full": [], "no_mma": ["-DKT_GQA_CUT_MMA=1"],
        "no_merge": ["-DKT_GQA_CUT_MERGE=1"],
        "skeleton": ["-DKT_GQA_CUT_MMA=1", "-DKT_GQA_CUT_SOFTMAX=1",
                     "-DKT_GQA_CUT_MERGE=1"]}),
}
OUT = os.path.join(_build.BUILD, "breakdown")


def cut_sources() -> str:
    """A copy of csrc/ with the switches of CUTS in place."""
    src = os.path.join(OUT, "csrc")
    shutil.rmtree(src, ignore_errors=True)
    shutil.copytree(_build.CSRC, src,
                    ignore=shutil.ignore_patterns("build"))
    for name, cuts in CUTS.items():
        path = os.path.join(src, name)
        text = open(path).read()
        for old, new in cuts:
            if old not in text:
                raise RuntimeError(f"breakdown: {name} no longer has "
                                   f"{old.strip()[:60]!r}")
            text = text.replace(old, new)
        with open(path, "w") as fh:
            fh.write(text)
    return src


def build_variants(src: str, kernels) -> dict:
    """{(kernel, variant): ctypes library}, all nvcc runs at once."""
    procs = {}
    for kernel in kernels:
        lib, variants = VARIANTS[kernel]
        for v, flags in variants.items():
            tag = f"{kernel}_{v}"
            out = os.path.join(OUT, f"lib{tag}.so")
            cmd = [_build.nvcc_path(), *_build.ARCH_FLAGS, "-std=c++17",
                   "-O3", "-shared", "-Xcompiler", "-fPIC", "-I", src,
                   f"-Dkt=kt_{tag}", f"-Dkt_mma=kt_mma_{tag}",
                   f"-Dkt_mla_mma=kt_mla_mma_{tag}",
                   f"-Dkt_gqa_mma=kt_gqa_mma_{tag}", *flags,
                   "-o", out, os.path.join(src, f"{lib}.cu")]
            procs[(kernel, v)] = (subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True), out, lib)
    libs = {}
    for (kernel, v), (proc, out, lib) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"breakdown: nvcc failed for {kernel} {v}:\n"
                               f"{log}")
        cdll = ctypes.CDLL(out)
        for fn, argtypes in _build.SIGNATURES[lib].items():
            f = getattr(cdll, fn)
            f.argtypes = argtypes
            f.restype = ctypes.c_int
        libs[(kernel, v)] = cdll
    return libs


def time_ms(fn, iters: int = 20) -> float:
    """Median time of one call between CUDA events, the L2 cache flushed
    before each (as chip_smoke.py times its kernels)."""
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    for _ in range(3):
        fn()
    times = []
    for _ in range(iters):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def floor_ms() -> dict:
    """{what: ms} of calls that do no kernel's work, timed as the kernels
    are: an empty launch, and a copy of n MB (read n, write n)."""
    out = {"empty launch": time_ms(lambda: torch.cuda._sleep(0))}
    for mb in (6, 18.4, 25.6):
        src = torch.empty(int(mb * 1e6) // 16 * 4, dtype=torch.int32,
                          device="cuda")
        dst = torch.empty_like(src)
        out[f"copy {mb} MB"] = time_ms(lambda: dst.copy_(src))
    return out


def shapes_of(kernel: str, rn, w, rd) -> list:
    """(label, launcher) pairs of a kernel at the main path's shapes."""
    from ktransformers_tpu_torch.ops.cuda import mla_decode as MD
    from ktransformers_tpu_torch.ops.cuda import paged_attention as PA
    from ktransformers_tpu_torch.ops.cuda import quant_matmul as QM
    from ktransformers_tpu_torch.ops.cuda import quant_matmul_t as QT
    from ktransformers_tpu_torch.ops.cuda import w4a8_ffn as F
    from ktransformers_tpu_torch.ops.cuda import w4a8_matmul as MM
    from ktransformers_tpu_torch.ops.rope import rope_rotation_matrix

    out = []
    if kernel == "quant_mma_kernel":
        for m in (256, 1024):
            x, wq = rn(m, 2048), rd.q((2048, 3648), "int8", 128)
            out.append((f"int8 qkv_a M={m}", lambda x=x, wq=wq:
                        QM.dense_launcher(x, wq, "mma")))
    elif kernel == "w4a8_mma_kernel":
        for m in (256, 1024):
            x, ww = rn(m, 2048), w((2048, 3648))
            out.append((f"w4a8 qkv_a M={m}", lambda x=x, ww=ww:
                        MM.dense_w4a8_launcher(x, ww, "mma")))
        wg = w((8, 4096, 28672))
        top = torch.topk(torch.randn(256, 8, generator=torch.Generator()
                                     .manual_seed(7)), 2, dim=-1).indices
        sizes = torch.bincount(top.reshape(-1), minlength=8).to(
            torch.int32).cuda()
        xg = rn(512, 4096)
        out.append(("w4a8 Mixtral gate_up, 512 sorted rows",
                    lambda: MM.grouped_launcher(xg, wg, sizes, "mma")))
    elif kernel == "quant_gemv_kernel":
        for k, n, label in ((2048, 3648, "qkv_a"), (2048, 2048, "o_proj"),
                            (10944, 2048, "layer-0 down"),
                            (2048, 102400, "lm_head")):
            x, wq = rn(1, k), rd.q((k, n), "int8", 128)
            out.append((f"int8 {label} M=1", lambda x=x, wq=wq:
                        QM.dense_launcher(x, wq, "gemv")))
        we = rd.q((64, 2048, 2816), "int8", 128)
        ids = torch.randperm(64, generator=torch.Generator().manual_seed(3))[
            :6].to(torch.int32).cuda()
        xe = rn(6, 2048)
        out.append(("int8 gathered gate_up, 6 rows",
                    lambda: QM.gathered_launcher(xe, we, ids, "gemv")))
    elif kernel == "quant_wgmma_t_kernel":
        for k, n, label in ((2048, 3648, "qkv_a"), (2048, 102400, "lm_head"),
                            (2048, 21888, "layer-0 gate_up")):
            dy, ww = rn(512, n), w((k, n))
            out.append((f"w4a8 dx M=512 {label}", lambda dy=dy, ww=ww:
                        QT.dense_t_launcher(dy, ww, "wgmma")))
        we = w((64, 2048, 2816))
        topk = torch.stack([torch.randperm(64, generator=torch.Generator()
                                           .manual_seed(5 + i))[:6]
                            for i in range(512)])
        sizes = torch.bincount(topk.reshape(-1), minlength=64).to(
            torch.int32).cuda()
        dye = rn(3072, 2816)
        out.append(("w4a8 gate_up^T, 3072 sorted rows",
                    lambda: QT.grouped_t_launcher(dye, we, sizes, "wgmma")))
    elif kernel == "w4a8_gemv_kernel":
        for k, n, label in ((2048, 3648, "qkv_a"), (2048, 2048, "o_proj"),
                            (10944, 2048, "layer-0 down (gs 96)"),
                            (2048, 102400, "lm_head")):
            x, ww = rn(1, k), w((k, n))
            out.append((f"w4a8 {label} M=1", lambda x=x, ww=ww:
                        MM.dense_w4a8_launcher(x, ww, "gemv")))
        wg = w((8, 4096, 28672))
        ids = torch.topk(torch.randn(8, 8, generator=torch.Generator()
                                     .manual_seed(7)), 2, dim=-1).indices
        ids = ids.reshape(-1).to(torch.int32).cuda()
        xg = rn(16, 4096)
        out.append(("w4a8 Mixtral gate_up, 16 gathered rows",
                    lambda: MM.gathered_launcher(xg, wg, ids, "gemv")))
    elif kernel == "w4a8_ffn_mma_kernel":
        gu, dn = w((64, 2048, 2816)), w((64, 1408, 2048))
        topk = torch.stack([torch.randperm(64, generator=torch.Generator()
                                           .manual_seed(1 + i))[:6]
                            for i in range(256)])
        sizes = torch.bincount(topk.reshape(-1), minlength=64).to(
            torch.int32).cuda()
        xs = rn(1536, 2048)
        out.append(("w4a8 FFN, 1536 sorted rows",
                    lambda: F.grouped_launcher(xs, gu, dn, sizes)))
        sgu, sdn = w((2048, 5632)), w((2816, 2048))
        for m in (256, 520):
            x = rn(m, 2048)
            out.append((f"w4a8 shared FFN M={m}", lambda x=x:
                        F.dense_launcher(x, sgu, sdn)))
    elif kernel == "mla_decode_split_kernel":
        for b, smax, lens in ((1, 1024, [512]), (1, 4096, [2048]),
                              (8, 1024, [1, 64, 65, 300, 512, 513, 800,
                                         1000])):
            rot = rope_rotation_matrix(rn(b, 32).float(), rn(b, 32).float(),
                                       True)
            args = (rn(b, 16, 512), rn(b, 16, 64), rn(b, 1, 576),
                    torch.ones(512, device="cuda"), rot, rn(b, smax, 512),
                    rn(b, smax, 64),
                    torch.tensor(lens, dtype=torch.int32, device="cuda"),
                    0.07, 1e-6)
            out.append((f"B={b} S={smax} cached {lens[0]}..{lens[-1]}",
                        lambda args=args: MD.mla_launcher(*args, "split")))
    elif kernel == "mla_prefill_mma_kernel":
        for olds, s, valids in (([256], 256, [256]), ([0, 256], 256,
                                                      [256, 200]),
                                ([0], 512, [512]),
                                ([0, 256], 512, [512, 456])):
            c = len(olds)
            tables = (torch.randperm(c * 32, generator=torch.Generator()
                                     .manual_seed(s + c)) + 1).reshape(
                c, 32).to(torch.int32).cuda()
            args = (rn(c, 16, s, 512), rn(c, 16, s, 64),
                    rn(c * 32 + 1, 64, 512), rn(c * 32 + 1, 64, 64), tables,
                    torch.tensor(olds, dtype=torch.int32, device="cuda"),
                    torch.tensor(valids, dtype=torch.int32, device="cuda"),
                    0.07)
            out.append((f"C={c} S={s} old={olds} valid={valids}",
                        lambda args=args: PA.prefill_launcher(*args, "mma")))
    elif kernel == "mla_paged_decode_split_kernel":
        lens = [1, 64, 65, 512, 513, 1000, 2047, 2048]
        tables = (torch.randperm(8 * 32, generator=torch.Generator()
                                 .manual_seed(8)) + 1).reshape(8, 32).to(
            torch.int32).cuda()
        args = (rn(8, 16, 512), rn(8, 16, 64), rn(8 * 32 + 1, 64, 512),
                rn(8 * 32 + 1, 64, 64), tables,
                torch.tensor(lens, dtype=torch.int32, device="cuda"), 0.07)
        out.append(("B=8 H=16 page=64 lengths 1..2048",
                    lambda: PA.decode_launcher(*args, kernel="split")))
    elif kernel == "gqa_prefill_mma_kernel":
        for olds, valids in (([256], [256]), ([0, 256], [256, 200])):
            c = len(olds)
            tables = (torch.randperm(c * 32, generator=torch.Generator()
                                     .manual_seed(c)) + 1).reshape(
                c, 32).to(torch.int32).cuda()
            args = (rn(c, 32, 256, 128), rn(c * 32 + 1, 64, 8, 128),
                    rn(c * 32 + 1, 64, 8, 128), tables,
                    torch.tensor(olds, dtype=torch.int32, device="cuda"),
                    torch.tensor(valids, dtype=torch.int32, device="cuda"),
                    128 ** -0.5)
            out.append((f"C={c} S=256 H=32 Hkv=8 old={olds} valid={valids}",
                        lambda args=args: PA.gqa_prefill_launcher(
                            *args, kernel="mma")))
    elif kernel == "w4a8_ffn_gemv_kernel":
        gu, dn = w((64, 2048, 2816)), w((64, 1408, 2048))
        g = torch.Generator().manual_seed(3)
        for rows in (6, 48):
            ids = torch.stack([torch.randperm(64, generator=g)[:6]
                               for _ in range(rows // 6)]).reshape(-1)
            ids = ids.to(torch.int32).cuda()
            x = rn(rows, 2048)
            out.append((f"gathered gate_up, {rows} rows",
                        lambda x=x, ids=ids: (F.gathered_launcher(
                            x, gu, dn, ids)[0].up, None)))
        sgu, sdn, xs = w((2048, 5632)), w((2816, 2048)), rn(1, 2048)
        out.append(("shared gate_up M=1", lambda: (
            F.dense_launcher(xs, sgu, sdn)[0].up, None)))
    elif kernel == "gqa_decode_split_kernel":
        lens = [1, 64, 65, 512, 513, 1000, 2047, 2048]
        tables = (torch.randperm(8 * 32, generator=torch.Generator()
                                 .manual_seed(8)) + 1).reshape(8, 32).to(
            torch.int32).cuda()
        args = (rn(8, 32, 128), rn(8 * 32 + 1, 64, 8, 128),
                rn(8 * 32 + 1, 64, 8, 128), tables,
                torch.tensor(lens, dtype=torch.int32, device="cuda"),
                128 ** -0.5)
        for window in (0, 512):
            out.append((f"B=8 H=32 Hkv=8 page=64 lengths 1..2048 "
                        f"window={window}",
                        lambda window=window: PA.gqa_decode_launcher(
                            *args, window=window, kernel="split")))
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("breakdown: no CUDA device", file=sys.stderr)
        return 1
    from ktransformers_tpu_torch.models.init import _Draw
    from ktransformers_tpu_torch.quant.w4a8 import repack_offset_lo

    kernels = sys.argv[1:] or list(VARIANTS)
    unknown = [k for k in kernels if k not in VARIANTS]
    if unknown:
        print(f"breakdown: unknown kernels {unknown}; pick from "
              f"{list(VARIANTS)}", file=sys.stderr)
        return 2
    os.makedirs(OUT, exist_ok=True)
    libs = build_variants(cut_sources(), kernels)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)
    rd = _Draw(1, torch.device("cuda"), torch.bfloat16)

    def rn(*shape):
        return torch.randn(*shape, device="cuda", generator=rd.gen).to(
            torch.bfloat16)

    def w(shape):
        return repack_offset_lo(rd.q(shape, "int4_g", 128))

    lib_of = _build.lib
    result = dict(card=card, floor=floor_ms(), shapes={})
    print("floor: " + ", ".join(f"{k} {ms:.4f} ms"
                                for k, ms in result["floor"].items()),
          flush=True)
    try:
        for kernel in kernels:
            lib, variants = VARIANTS[kernel]
            for label, launcher in shapes_of(kernel, rn, w, rd):
                row = {}
                for v in variants:
                    _build.lib = (lambda name, lib=lib, key=(kernel, v):
                                  libs[key] if name == lib else lib_of(name))
                    row[v] = time_ms(launcher()[0])
                _build.lib = lib_of
                result["shapes"][f"{kernel}: {label}"] = row
                print(f"{kernel}: {label}: " + ", ".join(
                    f"{v} {ms:.4f} ms" for v, ms in row.items()), flush=True)
    finally:
        _build.lib = lib_of
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
