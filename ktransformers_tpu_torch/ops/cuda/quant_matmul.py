"""Matmuls with the weight decoded inside the kernel: wrappers
(csrc/quant_matmul.cu) and their plain PyTorch versions.

One kernel family, three entries, one per Pallas function it replaces in
ktransformers_tpu/ops/pallas/quant_matmul.py:
- quant_matmul: x [..., K] @ W [K, N] (dense projections, dense / shared MLP),
- gathered_quant_matmul: row r uses expert ids[r] (decode MoE),
- grouped_quant_matmul: rows sorted by expert with group sizes; rows past
  sum(group_sizes) come back zero (prefill MoE).
Kinds: int8, fp8, int4 / int4_g / int4_gz (also in the offset-lo encoding),
mxfp4, mxfp8. The arithmetic of every kind is stated in the CUDA source;
the plain versions round the decoded weight to x.dtype at the same place.
Bound on the card at decode: the weight bytes of the experts the rows use.

Three kernels serve the entries; ``route`` picks one by a fixed rule:
quant_gemv_kernel (split-K GEMV) for dense calls of one row and every
gathered call (one row a tile) whose shapes it takes; quant_mma_kernel
(tensor cores, tiles of MMA_BM rows) for bf16 dense and grouped calls of
at least MMA_MIN_ROWS rows whose shapes it takes; and the first version,
quant_rows_kernel, for everything else (float32 activations of several
rows, whose roundings bf16 tensor cores would change, and shapes the
other two refuse).
"""

from __future__ import annotations

import dataclasses

import torch

from ktransformers_tpu_torch.ops.cuda import LAUNCHES, ROUTED_LAUNCHES
from ktransformers_tpu_torch.ops.cuda import _build
from ktransformers_tpu_torch.ops.cuda.w4a8_matmul import (
    _check_x,
    check_cuda_operands,
    dense_tiles,
    device_kind,
    grouped_tiles,
    lift,
    row_tiles,
    scratch,
    sm_count,
    sorted_row_experts,
)
from ktransformers_tpu_torch.quant.formats import (
    INT4_KINDS,
    QTensor,
    dequantize,
    true_group_count,
)

# the kinds of ktransformers_tpu/ops/pallas/__init__.py:PALLAS_KINDS
KINDS = ("int8", "int4", "int4_g", "int4_gz", "fp8", "mxfp4", "mxfp8")
_KIND_CODE = {"int8": 0, "fp8": 1, "int4": 2, "int4_g": 2, "int4_gz": 2,
              "mxfp4": 3, "mxfp8": 4}
_DATA_DTYPES = {
    "int8": (torch.int8,), "fp8": (torch.float8_e4m3fn,),
    "mxfp8": (torch.float8_e4m3fn,), "mxfp4": (torch.uint8,),
    "int4": (torch.uint8, torch.int8), "int4_g": (torch.uint8, torch.int8),
    "int4_gz": (torch.uint8, torch.int8),
}
# tile heights of quant_rows_kernel (the first version)
DENSE_MR = 8    # rows per tile of a dense call with more than one row
GROUPED_MR = 8  # rows per tile of a grouped call
# quant_mma_kernel: tiles of MMA_BM rows, from MMA_MIN_ROWS rows on: on the
# H100 it beats the first version at every M measured from 2 up
# (chip_smoke.py's kernel phase times both on the same operands); M = 1,
# single-user decode, keeps the first version
MMA_BM = 64
MMA_MIN_ROWS = 2
# quant_gemv_kernel: blocks of GEMV_BN columns and GEMV_LANES row lanes,
# storage rows in units of GEMV_UNIT (one 16-byte load a thread each); the
# split count aims at gemv_blocks_per_sm(kind) blocks an SM
GEMV_BN = 256
GEMV_LANES = 8
GEMV_UNIT = 8

def mma_block_n(n: int, ntiles: int, device) -> int:
    """Output columns a block of quant_mma_kernel takes: 128, or 64 where a
    grid of 128-column blocks would have fewer blocks than the card has
    SMs (twice the blocks then, two of them an SM). ntiles is the tile
    map's static length (a grouped map's dead tiles included)."""
    return 64 if (n + 127) // 128 * ntiles < sm_count(device) else 128


def gemv_blocks_per_sm(kind: str) -> int:
    """Blocks an SM the GEMV's split aims at: two for int8 (on the H100 its
    qkv_a / o_proj / layer-0 down / lm_head at M = 1 run fastest with 16-32
    / 16-32 / 32-64 / 1 splits, ops/cuda/split_sweep.py), four for the
    kinds whose decode takes more instructions a byte, which want more
    warps at lm_head width."""
    return 2 if kind == "int8" else 4


def gemv_plan(n: int, ntiles: int, kr: int, rpg: int, sms: int,
              kind: str = "int8") -> tuple[int, int]:
    """(splits, gran) of a quant_gemv_kernel launch: the storage rows are
    cut into ``splits`` runs so that (column blocks x tiles x splits)
    reaches gemv_blocks_per_sm(kind) blocks an SM, as far as every row lane
    of a block keeps a unit (GEMV_UNIT rows) of each split. A run holds whole
    granules of ``gran`` units: a whole scale group where the groups are
    at least as many as the splits and a group has a unit for every lane
    (int4_g, group 128), else one unit, which lies inside one group (rpg is
    a multiple of GEMV_UNIT)."""
    units = kr // GEMV_UNIT
    blocks = -(-n // GEMV_BN) * ntiles
    want = -(-gemv_blocks_per_sm(kind) * sms // blocks)
    splits = max(1, min(want, units // GEMV_LANES))
    per_group = rpg // GEMV_UNIT
    gran = per_group if 1 < splits <= kr // rpg \
        and per_group >= GEMV_LANES else 1
    return splits, gran


def gemv_split_rows(kr: int, splits: int, gran: int) -> list:
    """The storage rows [start, end) of each split, as the kernel cuts
    them."""
    g = kr // GEMV_UNIT // gran
    step = GEMV_UNIT * gran
    return [(step * (g * s // splits), step * (g * (s + 1) // splits))
            for s in range(splits)]


def rows_per_group(w: QTensor) -> int:
    """Storage rows that share one scale row (int8 / fp8: all of them)."""
    kr = w.data.shape[-2]
    if w.kind in ("int8", "fp8"):
        return kr
    gs = w.group_size or w.in_features
    return gs // 2 if w.kind in INT4_KINDS else gs


def route(dtype: torch.dtype, m: int, entry: str, kind: str, k: int,
          n: int, rpg: int) -> str:
    """The kernel of a CUDA call: "gemv" (quant_gemv_kernel), "mma"
    (quant_mma_kernel) or "rows" (quant_rows_kernel). ``entry`` is
    "dense", "gathered" or "grouped"; m the rows of x; rpg the storage rows
    of a scale group. The GEMV takes one-row dense calls and every gathered
    call, either dtype (its roundings are the first version's), N a
    multiple of 16 (16-byte loads), K and rpg of 8. The tensor-core kernel
    takes bf16 x only (float32 activations keep their roundings), N a
    multiple of 16, K of 8, and a scale group whose storage rows fill
    whole stages (16 for the nibble kinds, 32 for the others)."""
    if entry == "gathered" or (entry == "dense" and m == 1):
        return "gemv" if n % 16 == 0 and k % 8 == 0 and rpg % 8 == 0 \
            else "rows"
    if dtype != torch.bfloat16 or m < MMA_MIN_ROWS:
        return "rows"
    stage_rows = 16 if kind in INT4_KINDS else 32
    if n % 16 or k % 8 or rpg % stage_rows:
        return "rows"
    return "mma"


def check_weight(w: QTensor, ndim: int, what: str) -> None:
    """Raise unless w is a weight of one of KINDS with consistent parts."""
    if not isinstance(w, QTensor):
        raise TypeError(f"{what}: weight must be a QTensor")
    if w.kind not in KINDS:
        raise ValueError(f"{what}: unsupported kind {w.kind!r}")
    if w.data.dim() != ndim or w.data.dtype not in _DATA_DTYPES[w.kind]:
        raise ValueError(f"{what}: {w.kind} data must be rank {ndim} of "
                         f"{_DATA_DTYPES[w.kind]}, got {w.data.dtype} "
                         f"{tuple(w.data.shape)}")
    if w.kind in INT4_KINDS and w.kind != "mxfp4":
        if w.act_quant != (w.data.dtype == torch.int8):
            raise ValueError(f"{what}: act_quant={w.act_quant} with "
                             f"{w.data.dtype} data")
    elif w.act_quant:
        raise ValueError(f"{what}: act_quant is an int4 encoding")
    k, n = w.in_features, w.out_features
    gs = w.group_size or k
    if k % gs or (w.kind in INT4_KINDS and gs % 2):
        raise ValueError(f"{what}: K={k} and group {gs} do not fit")
    mx = w.kind in ("mxfp4", "mxfp8")
    s = w.scales
    if s is None or s.dim() != ndim or s.shape[-1] != n \
            or s.shape[:-2] != w.data.shape[:-2] \
            or s.shape[-2] < true_group_count(w):
        raise ValueError(f"{what}: scales must be [..., >= {k // gs}, {n}]")
    if s.dtype != (torch.uint8 if mx else torch.float32):
        raise ValueError(f"{what}: {w.kind} scales have dtype {s.dtype}")
    if w.zeros is not None and (w.kind != "int4_gz"
                                or w.zeros.shape != s.shape
                                or w.zeros.dtype != torch.float32):
        raise ValueError(f"{what}: zero points must be float32 like the "
                         "scales, on int4_gz only")
    if w.kind == "int4_gz" and w.zeros is None:
        raise ValueError(f"{what}: int4_gz needs zero points")


def expert_slice(w: QTensor, e: int) -> QTensor:
    """Expert e of a 3-D weight as a 2-D one (views)."""
    return dataclasses.replace(
        w, data=w.data[e], scales=w.scales[e],
        zeros=None if w.zeros is None else w.zeros[e])


def matblock_ref(x2: torch.Tensor, w: QTensor) -> torch.Tensor:
    """x2 [M, K] @ one 2-D weight: float32 [M, N], the kernels' arithmetic.

    int8 / fp8: the codes are exact in x.dtype and the per-channel scale
    multiplies the f32 sum. Every other kind: the decoded weight
    (code - zero) * scale is rounded to x.dtype (dequantize does exactly
    that) before the product."""
    xf = x2.to(torch.float32)
    if w.kind in ("int8", "fp8"):
        return torch.matmul(xf, w.data.to(torch.float32)) * w.scales
    return torch.matmul(xf, dequantize(w, x2.dtype).to(torch.float32))


def rows_ref(x_rows: torch.Tensor, w: QTensor,
             row_expert: torch.Tensor) -> torch.Tensor:
    """Plain version of all three entries: row r uses expert row_expert[r]
    (-1 = none, the output row is zero). [R, N] in x_rows.dtype."""
    out = torch.zeros(x_rows.shape[0], w.out_features, dtype=torch.float32,
                      device=x_rows.device)
    for e in torch.unique(row_expert).tolist():
        if e < 0:
            continue
        idx = torch.nonzero(row_expert == e).flatten()
        out[idx] = matblock_ref(x_rows[idx], expert_slice(w, e))
    return out.to(x_rows.dtype)


def quant_matmul_ref(x: torch.Tensor, w: QTensor) -> torch.Tensor:
    *lead, kdim = x.shape
    y = matblock_ref(x.reshape(-1, kdim), w).to(x.dtype)
    return y.reshape(*lead, w.out_features)


def gathered_quant_matmul_ref(x_rows, w: QTensor, ids) -> torch.Tensor:
    return rows_ref(x_rows, w, ids.to(torch.int64))


def grouped_quant_matmul_ref(x_sorted, w: QTensor, group_sizes) -> torch.Tensor:
    return rows_ref(x_sorted, w, sorted_row_experts(
        group_sizes.to(x_sorted.device), x_sorted.shape[0]))


def rows_launcher(x_rows: torch.Tensor, w: QTensor, tiles, mr: int,
                  out: torch.Tensor, what: str):
    """Checks a CUDA call on a 3-D weight; returns launch(), which runs only
    quant_rows_kernel and writes ``out`` [R, N]."""
    check_cuda_operands(what, x_rows.device, x_rows, w.data, w.scales,
                        *(() if w.zeros is None else (w.zeros,)))
    kdim, n = w.in_features, w.out_features
    kr = w.data.shape[-2]
    rpg = rows_per_group(w)
    unit = next((u for u in (16, 8, 4) if rpg % u == 0), 0)
    if not unit or n % 4 or kdim % 4:
        raise ValueError(f"{what}: the kernel takes N and K multiples of 4 "
                         f"and {rpg} rows a group a multiple of 4 "
                         f"(N={n}, K={kdim})")
    te, tr0, trs = tiles
    fn = _build.lib("quant_matmul").kt_quant_rows
    flip = 0 if w.act_quant else 8
    dev = x_rows.device

    def launch():
        err = fn(
            x_rows.data_ptr(), w.data.data_ptr(), w.scales.data_ptr(),
            None if w.zeros is None else w.zeros.data_ptr(),
            te.data_ptr(), tr0.data_ptr(), trs.data_ptr(), te.shape[0], mr,
            _KIND_CODE[w.kind], kdim, kr, n, w.scales.shape[-2], rpg, unit,
            flip, int(x_rows.dtype == torch.bfloat16), out.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
        _build.check(err, what)

    return launch


def mma_launcher(x_rows: torch.Tensor, w: QTensor, tiles,
                 out: torch.Tensor, what: str):
    """Checks a CUDA call on a 3-D weight; returns launch(), which runs only
    quant_mma_kernel (tiles of up to MMA_BM rows, mma_block_n columns a
    block) and writes ``out``."""
    check_cuda_operands(what, x_rows.device, x_rows, w.data, w.scales,
                        *(() if w.zeros is None else (w.zeros,)))
    te, tr0, trs = tiles
    bn = mma_block_n(w.out_features, te.shape[0], x_rows.device)
    fn = _build.lib("quant_matmul").kt_quant_mma
    flip = 0 if w.act_quant else 8
    dev = x_rows.device

    def launch():
        err = fn(
            x_rows.data_ptr(), w.data.data_ptr(), w.scales.data_ptr(),
            None if w.zeros is None else w.zeros.data_ptr(),
            te.data_ptr(), tr0.data_ptr(), trs.data_ptr(), te.shape[0], bn,
            _KIND_CODE[w.kind], w.in_features, w.data.shape[-2],
            w.out_features, w.scales.shape[-2], rows_per_group(w), flip,
            out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream,
        )
        _build.check(err, what)

    return launch


def gemv_launcher(x_rows: torch.Tensor, w: QTensor, tiles,
                  out: torch.Tensor, what: str):
    """Checks a CUDA call on a 3-D weight with one row a tile; returns
    launch(), which runs only quant_gemv_kernel (split by gemv_plan) and
    writes ``out`` [R, N]."""
    check_cuda_operands(what, x_rows.device, x_rows, w.data, w.scales,
                        *(() if w.zeros is None else (w.zeros,)))
    parts = (x_rows, w.data, w.scales) + (() if w.zeros is None
                                          else (w.zeros,))
    if any(t.data_ptr() % 16 for t in parts):
        raise ValueError(f"{what}: the GEMV takes 16-byte aligned operands")
    te, tr0, trs = tiles
    kr, n, rpg = w.data.shape[-2], w.out_features, rows_per_group(w)
    dev = x_rows.device
    splits, gran = gemv_plan(n, te.shape[0], kr, rpg, sm_count(dev), w.kind)
    part = cnt = None
    if splits > 1:
        part, cnt = scratch(dev, splits * te.shape[0] * n,
                            -(-n // GEMV_BN) * te.shape[0], "gemv")
    fn = _build.lib("quant_matmul").kt_quant_gemv
    flip = 0 if w.act_quant else 8

    def launch():
        err = fn(
            x_rows.data_ptr(), w.data.data_ptr(), w.scales.data_ptr(),
            None if w.zeros is None else w.zeros.data_ptr(),
            te.data_ptr(), tr0.data_ptr(), trs.data_ptr(), te.shape[0],
            splits, gran, _KIND_CODE[w.kind], w.in_features, kr, n,
            w.scales.shape[-2], rpg, flip,
            int(x_rows.dtype == torch.bfloat16),
            None if part is None else part.data_ptr(),
            None if cnt is None else cnt.data_ptr(), out.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
        _build.check(err, what)

    return launch


def _route(x_rows: torch.Tensor, w: QTensor, entry: str) -> str:
    return route(x_rows.dtype, x_rows.shape[0], entry, w.kind, w.in_features,
                 w.out_features, rows_per_group(w))


def dense_launcher(x2: torch.Tensor, w: QTensor, kernel: str | None = None):
    """(launch, out) of a CUDA quant_matmul call on x2 [M, K]; ``kernel``
    ("rows", "gemv" or "mma") overrides ``route``, for a measurement."""
    m = x2.shape[0]
    out = torch.empty(m, w.out_features, dtype=x2.dtype, device=x2.device)
    kernel = kernel or _route(x2, w, "dense")
    if kernel == "mma":
        return mma_launcher(x2, lift(w), dense_tiles(m, MMA_BM, x2.device),
                            out, "quant_matmul"), out
    if kernel == "gemv":
        return gemv_launcher(x2, lift(w), dense_tiles(m, 1, x2.device), out,
                             "quant_matmul"), out
    mr = 1 if m == 1 else DENSE_MR
    return rows_launcher(x2, lift(w), dense_tiles(m, mr, x2.device), mr, out,
                         "quant_matmul"), out


def gathered_launcher(x_rows: torch.Tensor, w: QTensor, ids: torch.Tensor,
                      kernel: str | None = None):
    out = torch.empty(x_rows.shape[0], w.out_features, dtype=x_rows.dtype,
                      device=x_rows.device)
    if (kernel or _route(x_rows, w, "gathered")) == "gemv":
        return gemv_launcher(x_rows, w, row_tiles(ids), out,
                             "gathered_quant_matmul"), out
    return rows_launcher(x_rows, w, row_tiles(ids), 1, out,
                         "gathered_quant_matmul"), out


def grouped_launcher(x_sorted: torch.Tensor, w: QTensor,
                     group_sizes: torch.Tensor, kernel: str | None = None):
    out = torch.zeros(x_sorted.shape[0], w.out_features,
                      dtype=x_sorted.dtype, device=x_sorted.device)
    m = x_sorted.shape[0]
    if (kernel or _route(x_sorted, w, "grouped")) == "mma":
        return mma_launcher(x_sorted, w, grouped_tiles(group_sizes, m, MMA_BM),
                            out, "grouped_quant_matmul"), out
    tiles = grouped_tiles(group_sizes, m, GROUPED_MR)
    return rows_launcher(x_sorted, w, tiles, GROUPED_MR, out,
                         "grouped_quant_matmul"), out


KERNEL_NAMES = {"gemv": "quant_gemv_kernel", "mma": "quant_mma_kernel"}


def _counted(what: str, kernel: str, launch, out: torch.Tensor
             ) -> torch.Tensor:
    launch()
    LAUNCHES[what] += 1
    if kernel in KERNEL_NAMES:
        ROUTED_LAUNCHES[KERNEL_NAMES[kernel]] += 1
    return out


def quant_matmul(x: torch.Tensor, w: QTensor) -> torch.Tensor:
    """x [..., K] @ w (2-D QTensor [K, N]) -> [..., N] in x.dtype.

    CUDA tensors launch csrc/quant_matmul.cu; CPU tensors take
    quant_matmul_ref."""
    what = "quant_matmul"
    check_weight(w, 2, what)
    *lead, kdim = x.shape
    x2 = x.reshape(-1, kdim)
    _check_x(x2, w.in_features, what)
    if device_kind(x, what) == "cpu":
        return quant_matmul_ref(x, w)
    x2 = x2.contiguous()
    kernel = _route(x2, w, "dense")
    y = _counted(what, kernel, *dense_launcher(x2, w, kernel))
    return y.reshape(*lead, w.out_features)


def gathered_quant_matmul(x_rows: torch.Tensor, w: QTensor,
                          ids: torch.Tensor) -> torch.Tensor:
    """Decode MoE matmul: row r of x_rows [R, K] through expert ids[r] of
    w [E, K, N]; only the routed experts' bytes are read. [R, N]."""
    what = "gathered_quant_matmul"
    check_weight(w, 3, what)
    _check_x(x_rows, w.in_features, what)
    if ids.shape != (x_rows.shape[0],):
        raise ValueError(f"{what}: ids must be [R]")
    if device_kind(x_rows, what) == "cpu":
        return gathered_quant_matmul_ref(x_rows, w, ids)
    x_rows = x_rows.contiguous()
    kernel = _route(x_rows, w, "gathered")
    return _counted(what, kernel,
                    *gathered_launcher(x_rows, w, ids, kernel))


def grouped_quant_matmul(x_sorted: torch.Tensor, w: QTensor,
                         group_sizes: torch.Tensor) -> torch.Tensor:
    """Prefill MoE matmul over rows sorted by expert (group_sizes [E]);
    rows past sum(group_sizes) come back zero. [M, N] in x dtype."""
    what = "grouped_quant_matmul"
    check_weight(w, 3, what)
    _check_x(x_sorted, w.in_features, what)
    if group_sizes.shape != (w.data.shape[0],):
        raise ValueError(f"{what}: group_sizes must be [E]")
    if device_kind(x_sorted, what) == "cpu":
        return grouped_quant_matmul_ref(x_sorted, w, group_sizes)
    x_sorted = x_sorted.contiguous()
    kernel = _route(x_sorted, w, "grouped")
    return _counted(what, kernel,
                    *grouped_launcher(x_sorted, w, group_sizes, kernel))
