"""Transposed matmuls with the weight decoded inside the kernel, the input
gradients of the quant_matmul family: wrappers (csrc/quant_matmul_t.cu) and
their plain PyTorch versions.

dx = dy @ W^T for a packed W [K, N] (the quantized base of LoRA SFT is
frozen, so this is all its matmuls need in the backward). One kernel, two
TPU kernels replaced (ktransformers_tpu/ops/pallas/quant_matmul_t.py):
- quant_matmul_t: dy [..., N] -> dx [..., K] (dense projections),
- grouped_quant_matmul_t: rows sorted by expert with group sizes (the
  backward of the grouped expert matmuls); rows past sum(group_sizes) come
  back zero. Its per-row entry, gathered_quant_matmul_t (row r through
  expert ids[r], the backward of the gathered matmuls), counts as the same
  kernel.
dx is float32. Kinds: those of ops/cuda/quant_matmul.KINDS, W4A8 weights
(offset-lo int4_g) included. The plain versions round as the Pallas kernels
do: int8 / fp8 dy * scale to bf16 against the codes; every other kind dy to
bf16 against the decoded weight rounded to bf16; both accumulate in float32.

Two kernels; ``route`` picks one by a fixed rule: quant_wgmma_t_kernel
(warpgroup MMA, tiles of ``tile_rows`` dy rows and ``block_cols`` dx
columns, the contraction split by ``t_plan``) for every call whose shapes
it takes, and the first version, quant_rows_t_kernel (mma.sync, 64-row
tiles), for the rest (N not a multiple of 16, scale groups of fewer than
16 / 32 storage rows).
"""

from __future__ import annotations

import torch

from ktransformers_tpu_torch.ops.cuda import LAUNCHES, ROUTED_LAUNCHES
from ktransformers_tpu_torch.ops.cuda import _build
from ktransformers_tpu_torch.ops.cuda.quant_matmul import (
    _KIND_CODE,
    check_weight,
    expert_slice,
    lift,
    scratch,
    sm_count,
)
from ktransformers_tpu_torch.ops.cuda.w4a8_matmul import (
    check_cuda_operands,
    dense_tiles,
    device_kind,
    grouped_tiles,
    row_tiles,
    sorted_row_experts,
)
from ktransformers_tpu_torch.quant.formats import (
    INT4_KINDS,
    QTensor,
    dequantize,
)

TILE_ROWS = 64  # dy rows per tile of the first version (its BM)
# quant_wgmma_t_kernel: a block owns tile_rows dy rows (128 or 64) and
# block_cols(rows) dx columns (256 or 128: storage rows, or half as many of
# a nibble kind with both halves), walks the contraction in stages of NC
# columns, and holds up to GMAX scale rows a stage; blocks of 128 rows
# fill an SM alone, blocks of 64 rows two at a time
WGMMA_NC = 64
WGMMA_GMAX = 9
WGMMA_RESIDENT = {128: 1, 64: 2}
# the contraction is split (never below WGMMA_MIN_STAGES stages a split)
# where that shortens the launch: waves of resident blocks x (stages a
# block + WGMMA_BLOCK_OVERHEAD, a block's fill, epilogue and partials in
# stage times)
WGMMA_MIN_STAGES = 8
WGMMA_BLOCK_OVERHEAD = 4


def block_cols(bm: int) -> int:
    return 256 if bm == 128 else 128


def storage_rows_per_block(kind: str, bm: int) -> int:
    return block_cols(bm) // 2 if kind in INT4_KINDS else block_cols(bm)


def t_rows_per_group(w: QTensor) -> int:
    """Storage rows of one scale group as the transposed kernels read them
    (int8 / fp8: one scale row, applied to dy)."""
    kr = w.data.shape[-2]
    if w.kind in ("int8", "fp8"):
        return kr
    gs = w.group_size or w.in_features
    return gs // 2 if w.kind in INT4_KINDS else gs


def route(kind: str, n: int, rpg: int) -> str:
    """The kernel of a CUDA call: "wgmma" (quant_wgmma_t_kernel) or "rows"
    (quant_rows_t_kernel, the first version). The wgmma kernel takes N a
    multiple of 16 (16-byte copies of weight and dy rows) and scale groups
    large enough that the storage rows of its widest block (256 dx columns)
    span at most GMAX of them (nibble kinds: 16 storage rows a group, the
    others 32); both dtypes of dy and every entry."""
    sr = storage_rows_per_block(kind, 128)
    if n % 16 or rpg <= 0 or sr // rpg + 1 > WGMMA_GMAX:
        return "rows"
    return "wgmma"


def tile_rows(entry: str, m: int) -> int:
    """dy rows a tile of quant_wgmma_t_kernel: 128 for dense calls of more
    than 64 rows (each weight tile decoded once per 128 rows, dy read once
    per 256 dx columns), 64 otherwise (grouped experts hold ~48 rows each;
    the gathered entry one a tile)."""
    return 128 if entry == "dense" and m > 64 else 64


def t_plan(kind: str, kr: int, n: int, ntiles: int, bm: int,
           sms: int) -> int:
    """Splits of the contraction of a quant_wgmma_t_kernel launch: the count
    (each split at least WGMMA_MIN_STAGES stages of WGMMA_NC columns) that
    minimizes waves x (stages a block + WGMMA_BLOCK_OVERHEAD), where a wave
    is sms x WGMMA_RESIDENT[bm] blocks; a tie goes to fewer splits (less
    partial traffic). ntiles is the tile map's static length."""
    blocks = -(-kr // storage_rows_per_block(kind, bm)) * ntiles
    stages = -(-n // WGMMA_NC)
    slots = sms * WGMMA_RESIDENT[bm]
    best, best_cost = 1, None
    for s in range(1, max(1, stages // WGMMA_MIN_STAGES) + 1):
        cost = -(-blocks * s // slots) * (-(-stages // s)
                                          + WGMMA_BLOCK_OVERHEAD)
        if best_cost is None or cost < best_cost:
            best, best_cost = s, cost
    return best


def t_split_stages(n: int, splits: int) -> list:
    """The contraction columns [start, end) of each split, as the kernel
    cuts them (whole stages; the last ends at N)."""
    stages = -(-n // WGMMA_NC)
    return [(WGMMA_NC * (stages * s // splits),
             min(n, WGMMA_NC * (stages * (s + 1) // splits)))
            for s in range(splits)]


def matblock_t_ref(dy2: torch.Tensor, w: QTensor) -> torch.Tensor:
    """dy2 [M, N] @ one 2-D weight's transpose: float32 [M, K]."""
    if w.kind in ("int8", "fp8"):
        dys = (dy2.to(torch.float32) * w.scales).to(torch.bfloat16)
        return torch.matmul(dys.to(torch.float32),
                            w.data.to(torch.float32).T)
    wd = dequantize(w, torch.bfloat16).to(torch.float32)
    return torch.matmul(dy2.to(torch.bfloat16).to(torch.float32), wd.T)


def rows_t_ref(dy_rows: torch.Tensor, w: QTensor,
               row_expert: torch.Tensor) -> torch.Tensor:
    """Plain version of the per-row entries: row r through expert
    row_expert[r] of w [E, K, N] (-1 = none, the row of dx is zero).
    float32 [R, K]."""
    out = torch.zeros(dy_rows.shape[0], w.in_features, dtype=torch.float32,
                      device=dy_rows.device)
    for e in torch.unique(row_expert).tolist():
        if e < 0:
            continue
        idx = torch.nonzero(row_expert == e).flatten()
        out[idx] = matblock_t_ref(dy_rows[idx], expert_slice(w, e))
    return out


def quant_matmul_t_ref(dy: torch.Tensor, w: QTensor) -> torch.Tensor:
    *lead, n = dy.shape
    return matblock_t_ref(dy.reshape(-1, n), w).reshape(*lead, w.in_features)


def gathered_quant_matmul_t_ref(dy_rows, w: QTensor, ids) -> torch.Tensor:
    return rows_t_ref(dy_rows, w, ids.to(torch.int64))


def grouped_quant_matmul_t_ref(dy_sorted, w: QTensor,
                               group_sizes) -> torch.Tensor:
    return rows_t_ref(dy_sorted, w, sorted_row_experts(
        group_sizes.to(dy_sorted.device), dy_sorted.shape[0]))


def _check_dy(dy2: torch.Tensor, n: int, what: str) -> None:
    if dy2.dim() != 2 or dy2.shape[1] != n:
        raise ValueError(f"{what}: dy must be [M, {n}], got "
                         f"{tuple(dy2.shape)}")
    if dy2.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{what}: dy must be float32 or bfloat16")


def rows_t_launcher(dy_rows: torch.Tensor, w: QTensor, tiles, mr: int,
                    out: torch.Tensor, what: str):
    """Checks a CUDA call on a 3-D weight; returns launch(), which runs only
    the first version and writes ``out`` float32 [R, K]."""
    check_cuda_operands(what, dy_rows.device, dy_rows, w.data, w.scales,
                        *(() if w.zeros is None else (w.zeros,)))
    kdim, n = w.in_features, w.out_features
    kr = w.data.shape[-2]
    gs = w.group_size or kdim
    rpg = t_rows_per_group(w)
    if n % 4 or kr % rpg:
        raise ValueError(f"{what}: the kernel takes N a multiple of 4 and "
                         f"whole scale groups (N={n}, K={kdim}, group {gs})")
    te, tr0, trs = tiles
    fn = _build.lib("quant_matmul_t").kt_quant_rows_t
    flip = 0 if w.act_quant else 8
    dev = dy_rows.device

    def launch():
        err = fn(
            dy_rows.data_ptr(), w.data.data_ptr(), w.scales.data_ptr(),
            None if w.zeros is None else w.zeros.data_ptr(),
            te.data_ptr(), tr0.data_ptr(), trs.data_ptr(), te.shape[0], mr,
            _KIND_CODE[w.kind], kdim, kr, n, w.scales.shape[-2], rpg, flip,
            int(dy_rows.dtype == torch.bfloat16), out.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
        _build.check(err, what)

    return launch


def wgmma_t_launcher(dy_rows: torch.Tensor, w: QTensor, tiles, bm: int,
                     out: torch.Tensor, what: str):
    """Checks a CUDA call on a 3-D weight; returns launch(), which runs only
    quant_wgmma_t_kernel (tiles of up to bm rows, split by t_plan) and
    writes ``out`` float32 [R, K]."""
    parts = (dy_rows, w.data, w.scales) + (() if w.zeros is None
                                           else (w.zeros,))
    check_cuda_operands(what, dy_rows.device, *parts)
    if any(t.data_ptr() % 16 for t in parts):
        raise ValueError(f"{what}: the wgmma kernel takes 16-byte aligned "
                         "operands")
    te, tr0, trs = tiles
    kr, n = w.data.shape[-2], w.out_features
    dev = dy_rows.device
    splits = t_plan(w.kind, kr, n, te.shape[0], bm, sm_count(dev))
    part = cnt = None
    if splits > 1:
        pairs = -(-kr // storage_rows_per_block(w.kind, bm)) * te.shape[0]
        part, cnt = scratch(dev, pairs * splits * bm * block_cols(bm), pairs,
                            "wgmma_t")
    fn = _build.lib("quant_matmul_t").kt_quant_wgmma_t
    flip = 0 if w.act_quant else 8

    def launch():
        err = fn(
            dy_rows.data_ptr(), w.data.data_ptr(), w.scales.data_ptr(),
            None if w.zeros is None else w.zeros.data_ptr(),
            te.data_ptr(), tr0.data_ptr(), trs.data_ptr(), te.shape[0], bm,
            splits, _KIND_CODE[w.kind], w.in_features, kr, n,
            w.scales.shape[-2], t_rows_per_group(w), flip,
            int(dy_rows.dtype == torch.bfloat16),
            None if part is None else part.data_ptr(),
            None if cnt is None else cnt.data_ptr(), out.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
        _build.check(err, what)

    return launch


def _route(w: QTensor) -> str:
    return route(w.kind, w.out_features, t_rows_per_group(w))


def dense_t_launcher(dy2: torch.Tensor, w: QTensor,
                     kernel: str | None = None):
    """(launch, out) of a CUDA quant_matmul_t call on dy2 [M, N]; ``kernel``
    ("rows" or "wgmma") overrides ``route``, for a measurement."""
    m = dy2.shape[0]
    out = torch.empty(m, w.in_features, dtype=torch.float32,
                      device=dy2.device)
    if (kernel or _route(w)) == "wgmma":
        bm = tile_rows("dense", m)
        return wgmma_t_launcher(dy2, lift(w), dense_tiles(m, bm, dy2.device),
                                bm, out, "quant_matmul_t"), out
    return rows_t_launcher(dy2, lift(w), dense_tiles(m, TILE_ROWS, dy2.device),
                           TILE_ROWS, out, "quant_matmul_t"), out


def gathered_t_launcher(dy_rows: torch.Tensor, w: QTensor,
                        ids: torch.Tensor, kernel: str | None = None):
    out = torch.empty(dy_rows.shape[0], w.in_features, dtype=torch.float32,
                      device=dy_rows.device)
    if (kernel or _route(w)) == "wgmma":
        return wgmma_t_launcher(dy_rows, w, row_tiles(ids),
                                tile_rows("gathered", 1), out,
                                "gathered_quant_matmul_t"), out
    return rows_t_launcher(dy_rows, w, row_tiles(ids), 1, out,
                           "gathered_quant_matmul_t"), out


def grouped_t_launcher(dy_sorted: torch.Tensor, w: QTensor,
                       group_sizes: torch.Tensor, kernel: str | None = None):
    m = dy_sorted.shape[0]
    out = torch.zeros(m, w.in_features, dtype=torch.float32,
                      device=dy_sorted.device)
    if (kernel or _route(w)) == "wgmma":
        bm = tile_rows("grouped", m)
        return wgmma_t_launcher(dy_sorted, w,
                                grouped_tiles(group_sizes, m, bm), bm, out,
                                "grouped_quant_matmul_t"), out
    tiles = grouped_tiles(group_sizes, m, TILE_ROWS)
    return rows_t_launcher(dy_sorted, w, tiles, TILE_ROWS, out,
                           "grouped_quant_matmul_t"), out


def _counted(name: str, w: QTensor, launch, out: torch.Tensor
             ) -> torch.Tensor:
    launch()
    LAUNCHES[name] += 1
    if _route(w) == "wgmma":
        ROUTED_LAUNCHES["quant_wgmma_t_kernel"] += 1
    return out


def quant_matmul_t(dy: torch.Tensor, w: QTensor) -> torch.Tensor:
    """dx = dy [..., N] @ w^T for a 2-D QTensor [K, N]: float32 [..., K].

    CUDA tensors launch csrc/quant_matmul_t.cu; CPU tensors take
    quant_matmul_t_ref."""
    what = "quant_matmul_t"
    check_weight(w, 2, what)
    *lead, n = dy.shape
    dy2 = dy.reshape(-1, n)
    _check_dy(dy2, w.out_features, what)
    if device_kind(dy, what) == "cpu":
        return quant_matmul_t_ref(dy, w)
    dx = _counted(what, w, *dense_t_launcher(dy2.contiguous(), w))
    return dx.reshape(*lead, w.in_features)


def gathered_quant_matmul_t(dy_rows: torch.Tensor, w: QTensor,
                            ids: torch.Tensor) -> torch.Tensor:
    """Row r of dy_rows [R, N] through expert ids[r] of w [E, K, N]:
    float32 [R, K]. Counted as grouped_quant_matmul_t (one kernel, a
    per-row tile map)."""
    what = "gathered_quant_matmul_t"
    check_weight(w, 3, what)
    _check_dy(dy_rows, w.out_features, what)
    if ids.shape != (dy_rows.shape[0],):
        raise ValueError(f"{what}: ids must be [R]")
    if device_kind(dy_rows, what) == "cpu":
        return gathered_quant_matmul_t_ref(dy_rows, w, ids)
    return _counted("grouped_quant_matmul_t", w,
                    *gathered_t_launcher(dy_rows.contiguous(), w, ids))


def grouped_quant_matmul_t(dy_sorted: torch.Tensor, w: QTensor,
                           group_sizes: torch.Tensor) -> torch.Tensor:
    """Rows dy_sorted [M, N] sorted by expert (group_sizes [E]) through
    their expert's transpose: float32 [M, K]; rows past sum(group_sizes)
    come back zero."""
    what = "grouped_quant_matmul_t"
    check_weight(w, 3, what)
    _check_dy(dy_sorted, w.out_features, what)
    if group_sizes.shape != (w.data.shape[0],):
        raise ValueError(f"{what}: group_sizes must be [E]")
    if device_kind(dy_sorted, what) == "cpu":
        return grouped_quant_matmul_t_ref(dy_sorted, w, group_sizes)
    return _counted(what, w, *grouped_t_launcher(dy_sorted.contiguous(), w,
                                                 group_sizes))
