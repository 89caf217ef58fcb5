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
"""

from __future__ import annotations

import torch

from ktransformers_tpu_torch.ops.cuda import LAUNCHES
from ktransformers_tpu_torch.ops.cuda import _build
from ktransformers_tpu_torch.ops.cuda.quant_matmul import (
    _KIND_CODE,
    check_weight,
    expert_slice,
    lift,
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

TILE_ROWS = 64  # dy rows per tile of a dense or grouped call (kernel's BM)


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
    the kernel and writes ``out`` float32 [R, K]."""
    check_cuda_operands(what, dy_rows.device, dy_rows, w.data, w.scales,
                        *(() if w.zeros is None else (w.zeros,)))
    kdim, n = w.in_features, w.out_features
    kr = w.data.shape[-2]
    gs = w.group_size or kdim
    rpg = gs // 2 if w.kind in INT4_KINDS else gs
    if w.kind in ("int8", "fp8"):
        rpg = kr  # one scale row, applied to dy
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


def dense_t_launcher(dy2: torch.Tensor, w: QTensor):
    """(launch, out) of a CUDA quant_matmul_t call on dy2 [M, N]."""
    m = dy2.shape[0]
    out = torch.empty(m, w.in_features, dtype=torch.float32,
                      device=dy2.device)
    return rows_t_launcher(dy2, lift(w), dense_tiles(m, TILE_ROWS, dy2.device),
                           TILE_ROWS, out, "quant_matmul_t"), out


def gathered_t_launcher(dy_rows: torch.Tensor, w: QTensor,
                        ids: torch.Tensor):
    out = torch.empty(dy_rows.shape[0], w.in_features, dtype=torch.float32,
                      device=dy_rows.device)
    return rows_t_launcher(dy_rows, w, row_tiles(ids), 1, out,
                           "gathered_quant_matmul_t"), out


def grouped_t_launcher(dy_sorted: torch.Tensor, w: QTensor,
                       group_sizes: torch.Tensor):
    out = torch.zeros(dy_sorted.shape[0], w.in_features, dtype=torch.float32,
                      device=dy_sorted.device)
    tiles = grouped_tiles(group_sizes, dy_sorted.shape[0], TILE_ROWS)
    return rows_t_launcher(dy_sorted, w, tiles, TILE_ROWS, out,
                           "grouped_quant_matmul_t"), out


def _counted(name: str, launch, out: torch.Tensor) -> torch.Tensor:
    launch()
    LAUNCHES[name] += 1
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
    dx = _counted(what, *dense_t_launcher(dy2.contiguous(), w))
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
    return _counted("grouped_quant_matmul_t",
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
    return _counted(what, *grouped_t_launcher(dy_sorted.contiguous(), w,
                                              group_sizes))
