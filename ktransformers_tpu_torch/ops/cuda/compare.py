"""Time the W4A8 GEMV, tensor-core and FFN kernels of this tree against those
of another csrc tree (the same C interface), in turns, on one GPU.

    python -m ktransformers_tpu_torch.ops.cuda.compare OTHER_CSRC_DIR

Builds csrc/w4a8_matmul.cu and csrc/w4a8_ffn.cu of both trees (each with
its own namespaces, into csrc/build/compare/), then at the main path's
shapes (DeepSeek-V2-Lite's projections at M = 1 on the GEMV and at M = 8,
256 and 1024 on the tensor-core kernel, its experts' grouped gate_up at
1536 rows, Mixtral's gathered experts at 2 and 16 rows, the W4A8 FFN
gathered / grouped / dense) times
the launch of this tree (A) and of the other (B) in the order A B B A,
each the median of 20 with the L2 cache flushed before each launch, and
prints the better of each pair, their ratio, how far the two outputs lie
apart, and for the FFN on tensor cores the gate_up launch of A alone.
Compare versions only inside one call: the card and its host change
between calls.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys

import torch

from ktransformers_tpu_torch.ops.cuda import _build
from ktransformers_tpu_torch.ops.cuda import w4a8_ffn as F
from ktransformers_tpu_torch.ops.cuda import w4a8_matmul as MM
from ktransformers_tpu_torch.ops.cuda.breakdown import time_ms

OUT = os.path.join(_build.BUILD, "compare")
LIBS = ("w4a8_matmul", "w4a8_ffn")


def build(tag: str, src: str) -> dict:
    """{library: ctypes library} of csrc tree ``src``, both nvcc at once."""
    os.makedirs(OUT, exist_ok=True)
    procs = {}
    for lib in LIBS:
        out = os.path.join(OUT, f"lib{lib}_{tag}.so")
        cmd = [_build.nvcc_path(), *_build.ARCH_FLAGS, "-std=c++17", "-O3",
               "-shared", "-Xcompiler", "-fPIC", "-I", src, f"-Dkt=kt_{tag}",
               f"-Dkt_mma=kt_mma_{tag}", "-o", out,
               os.path.join(src, f"{lib}.cu")]
        procs[lib] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True),
                      out)
    libs = {}
    for lib, (proc, out) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"compare: nvcc failed for {src} {lib}:\n{log}")
        cdll = ctypes.CDLL(out)
        for fn, argtypes in _build.SIGNATURES[lib].items():
            f = getattr(cdll, fn)
            f.argtypes = argtypes
            f.restype = ctypes.c_int
        libs[lib] = cdll
    return libs


def shapes(rn, w) -> list:
    """(label, launcher) pairs at the main path's shapes."""
    out = []
    for k, n, label in ((2048, 3648, "qkv_a"), (2048, 2048, "o_proj"),
                        (2048, 102400, "lm_head"),
                        (2048, 21888, "layer-0 gate_up"),
                        (10944, 2048, "layer-0 down")):
        x, wt = rn(1, k), w((k, n))
        out.append((f"gemv {label} M=1", lambda x=x, wt=wt:
                    MM.dense_w4a8_launcher(x, wt, "gemv")))
    for k, n, label in ((2048, 3648, "qkv_a"), (2048, 2048, "o_proj")):
        wt = w((k, n))
        for m in (8, 256, 1024):
            x = rn(m, k)
            out.append((f"mma {label} M={m}", lambda x=x, wt=wt:
                        MM.dense_w4a8_launcher(x, wt, "mma")))
    g = torch.Generator().manual_seed(7)
    for k, n, label in ((4096, 28672, "gate_up"), (14336, 4096, "down")):
        wt = w((8, k, n))
        for tokens in (1, 8):
            ids = torch.topk(torch.randn(tokens, 8, generator=g), 2,
                             dim=-1).indices.reshape(-1).to(torch.int32)
            x = rn(2 * tokens, k)
            out.append((f"gemv Mixtral {label} R={2 * tokens} rows an expert "
                        f"{torch.bincount(ids, minlength=8).tolist()}",
                        lambda x=x, wt=wt, ids=ids.cuda():
                        MM.gathered_launcher(x, wt, ids, "gemv")))
    gu, dn = w((64, 2048, 2816)), w((64, 1408, 2048))
    for tokens in (256,):
        topk = torch.stack([torch.randperm(64, generator=g)[:6]
                            for _ in range(tokens)])
        sizes = torch.bincount(topk.reshape(-1), minlength=64).to(torch.int32)
        xs = rn(6 * tokens, 2048)
        out.append((f"mma grouped gate_up {6 * tokens} rows", lambda xs=xs,
                    sizes=sizes.cuda():
                    MM.grouped_launcher(xs, gu, sizes, "mma")))
    for tokens in (1, 8):
        ids = torch.stack([torch.randperm(64, generator=g)[:6]
                           for _ in range(tokens)]).reshape(-1)
        x = rn(6 * tokens, 2048)
        out.append((f"ffn gathered {6 * tokens} rows", lambda x=x,
                    ids=ids.to(torch.int32).cuda():
                    F.gathered_launcher(x, gu, dn, ids)))
    for tokens in (256, 520):
        topk = torch.stack([torch.randperm(64, generator=g)[:6]
                            for _ in range(tokens)])
        sizes = torch.bincount(topk.reshape(-1), minlength=64).to(torch.int32)
        xs = rn(6 * tokens, 2048)
        out.append((f"ffn grouped {6 * tokens} rows", lambda xs=xs,
                    sizes=sizes.cuda():
                    F.grouped_launcher(xs, gu, dn, sizes)))
    sgu, sdn = w((2048, 5632)), w((2816, 2048))
    for m in (1, 8, 256, 520):
        x = rn(m, 2048)
        out.append((f"ffn dense M={m}", lambda x=x:
                    F.dense_launcher(x, sgu, sdn)))
    return out


def main() -> int:
    if len(sys.argv) != 2 or not torch.cuda.is_available():
        print("compare: needs a CUDA device and OTHER_CSRC_DIR",
              file=sys.stderr)
        return 1
    from ktransformers_tpu_torch.models.init import _Draw
    from ktransformers_tpu_torch.quant.w4a8 import repack_offset_lo

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)
    trees = {"A": build("A", _build.CSRC), "B": build("B", sys.argv[1])}
    real = _build.lib
    rd = _Draw(1, torch.device("cuda"), torch.bfloat16)

    def rn(*shape):
        return torch.randn(*shape, device="cuda", generator=rd.gen).to(
            torch.bfloat16)

    def w(shape):
        return repack_offset_lo(rd.q(shape, "int4_g", 128))

    def use(tag):
        libs = trees[tag]
        _build.lib = lambda name: libs[name] if name in libs else real(name)

    try:
        for label, launcher in shapes(rn, w):
            times = {"A": [], "B": []}
            outs = {}
            for tag in ("A", "B", "B", "A"):
                use(tag)
                launch, out = launcher()
                launch()
                outs[tag] = out.float()
                times[tag].append(time_ms(launch))
            a, b = min(times["A"]), min(times["B"])
            diff = float((outs["A"] - outs["B"]).abs().max()
                         / outs["B"].abs().max())
            extra = ""
            if label.startswith("ffn") and not label.endswith("M=1") \
                    and "gathered" not in label:
                use("A")
                down, F.launch_mma = F.launch_mma, lambda *args: None
                try:
                    extra = f"; A gate_up alone {time_ms(launcher()[0]):.4f}"
                finally:
                    F.launch_mma = down
            print(f"{label}: A {a:.4f} ms, B {b:.4f} ms (A/B {a / b:.3f}), "
                  f"outputs apart {diff:.1e}{extra}", flush=True)
    finally:
        _build.lib = real
    return 0


if __name__ == "__main__":
    sys.exit(main())
