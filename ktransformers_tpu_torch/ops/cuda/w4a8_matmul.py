"""Dense W4A8 matmul: kernel wrapper (csrc/w4a8_matmul.cu) and its plain
PyTorch version.

Replaces ktransformers_tpu/ops/pallas/w4a8_matmul.py:dense_w4a8_matmul.
Bound on the card: weight bytes at decode (K/2 * N int8 + ng * N f32
scales per call); see the source note in csrc/w4a8_matmul.cu.

Also holds what the FFN wrappers share: the row-tile maps (a tile is up to
``mr`` rows that use one expert) and the plain W4A8 group dot.
"""

from __future__ import annotations

import torch

from ktransformers_tpu_torch.ops.cuda import LAUNCHES
from ktransformers_tpu_torch.ops.cuda import _build
from ktransformers_tpu_torch.quant.formats import QTensor
from ktransformers_tpu_torch.quant.w4a8 import w4a8_prep

_DENSE_TILES: dict = {}


def dense_tiles(m: int, mr: int, device):
    """Tiles of ``mr`` consecutive rows of one (expert 0) weight:
    (expert, row0, rows) int32 [T] each, cached per shape."""
    key = (m, mr, str(device))
    if key not in _DENSE_TILES:
        t = (m + mr - 1) // mr
        row0 = torch.arange(t, dtype=torch.int32) * mr
        rows = torch.clamp(m - row0, max=mr)
        expert = torch.zeros(t, dtype=torch.int32)
        _DENSE_TILES[key] = tuple(v.to(device) for v in (expert, row0, rows))
    return _DENSE_TILES[key]


def row_tiles(ids: torch.Tensor):
    """One tile per row r, expert ids[r] (the gathered decode layout)."""
    r = ids.shape[0]
    row0 = torch.arange(r, dtype=torch.int32, device=ids.device)
    return ids.to(torch.int32).contiguous(), row0, torch.ones_like(row0)


def grouped_tiles(group_sizes: torch.Tensor, m: int, mr: int):
    """Tiles over rows sorted by expert (group_sizes [E]): every tile holds
    up to ``mr`` rows of one expert. Built on the device without a host
    sync: the static count ceil(m / mr) + E covers any split of m rows;
    tiles past the live ones get rows = 0 and are skipped by the kernel."""
    e = group_sizes.shape[0]
    gs = group_sizes.to(torch.int64)
    per = (gs + mr - 1) // mr
    tile_end = torch.cumsum(per, 0)
    tile_start = tile_end - per
    row_off = torch.cumsum(gs, 0) - gs
    t = torch.arange((m + mr - 1) // mr + e, device=gs.device)
    ex = torch.clamp(torch.searchsorted(tile_end, t, right=True), max=e - 1)
    local = t - tile_start[ex]
    row0 = row_off[ex] + local * mr
    rows = torch.clamp(gs[ex] - local * mr, min=0, max=mr)
    rows = torch.minimum(rows, torch.clamp(m - row0, min=0))
    return ex.to(torch.int32), row0.to(torch.int32), rows.to(torch.int32)


def check_w4a8_weight(w: QTensor, ndim: int, what: str) -> int:
    """Raise unless w is a W4A8-ready int4_g weight; returns gs/2."""
    if not isinstance(w, QTensor):
        raise TypeError(f"{what}: weight must be a QTensor")
    if w.kind != "int4_g" or not w.act_quant or w.zeros is not None:
        raise ValueError(
            f"{what}: needs offset-lo int4_g weights without zeros "
            f"(kind={w.kind}, act_quant={w.act_quant})"
        )
    if w.data.dtype != torch.int8 or w.data.dim() != ndim:
        raise ValueError(f"{what}: want int8 data of rank {ndim}, got "
                         f"{w.data.dtype} {tuple(w.data.shape)}")
    gs = w.group_size
    if gs <= 0 or gs % 8:
        raise ValueError(f"{what}: group size {gs} must be a multiple of 8")
    k = w.in_features
    if k % gs:
        raise ValueError(f"{what}: K={k} is not a multiple of group {gs}")
    ng = k // gs
    want = (*w.data.shape[:-2], ng, w.out_features)
    if w.scales is None or tuple(w.scales.shape) != want:
        raise ValueError(f"{what}: scales must be {want}")
    if w.scales.dtype != torch.float32:
        raise ValueError(f"{what}: scales must be float32")
    if w.out_features % 4:
        raise ValueError(f"{what}: N={w.out_features} must be a multiple of 4")
    return gs // 2


def check_cuda_operands(what: str, device, *tensors) -> None:
    for t in tensors:
        if t.device != device:
            raise ValueError(f"{what}: operands on {t.device} and {device}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: operands must be contiguous")


def w4a8_group_dot(qa, qb, sa, sb, t, wdata, scales, gs2: int):
    """Plain W4A8 product for one weight [K/2, N]: float32 [M, N].

    The int8 dots run as float32 matmuls, exact because every partial sum
    is an integer below 2^24 (gs/2 * 127 * 128 < 2^24); groups are added
    in order like _w4a8_group_acc."""
    m, k2 = qa.shape
    n = wdata.shape[-1]
    ng = k2 // gs2
    braw = wdata.to(torch.float32).reshape(ng, gs2, n)
    u = (wdata & 15).to(torch.float32).reshape(ng, gs2, n)
    pa = torch.einsum("mgj,gjn->mgn", qa.to(torch.float32).reshape(m, ng, gs2), u)
    pb = torch.einsum("mgj,gjn->mgn", qb.to(torch.float32).reshape(m, ng, gs2), braw)
    val = pa * sa[:, :, None] + pb * sb[:, :, None] - t[:, :, None]
    acc = torch.zeros(m, n, dtype=torch.float32, device=qa.device)
    for g in range(ng):
        acc = acc + val[:, g] * scales[g]
    return acc


def w4a8_matmul_ref(x2: torch.Tensor, w: QTensor) -> torch.Tensor:
    """Plain version of dense_w4a8_matmul: x2 [M, K] -> [M, N] x2.dtype."""
    kdim = x2.shape[1]
    qa, qb, sa, sb, t, _ = w4a8_prep(x2, kdim, w.group_size)
    y = w4a8_group_dot(qa, qb, sa, sb, t, w.data, w.scales, w.group_size // 2)
    return y.to(x2.dtype)


def _check_x(x: torch.Tensor, kdim: int, what: str) -> None:
    if x.dim() != 2 or x.shape[1] != kdim:
        raise ValueError(f"{what}: x must be [M, {kdim}], got {tuple(x.shape)}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{what}: x must be float32 or bfloat16")


def launch_rows(fn, what, prep, w: QTensor, tiles, mr: int, out):
    """Launch a rows kernel (kt_w4a8_rows / kt_w4a8_ffn_down)."""
    qa, qb, sa, sb, t = prep
    te, tr0, trs = tiles
    k2, n = w.data.shape[-2], w.data.shape[-1]
    gs2 = w.group_size // 2
    err = fn(
        qa.data_ptr(), qb.data_ptr(), sa.data_ptr(), sb.data_ptr(),
        t.data_ptr(), w.data.data_ptr(), w.scales.data_ptr(),
        te.data_ptr(), tr0.data_ptr(), trs.data_ptr(),
        te.shape[0], mr, k2, n, k2 // gs2, gs2,
        int(out.dtype == torch.bfloat16), out.data_ptr(),
        torch.cuda.current_stream(out.device).cuda_stream,
    )
    _build.check(err, what)


def prep_activations(x2: torch.Tensor, kdim: int, group_size: int):
    """(qa, qb, sa, sb, t) of w4a8_prep for x2 [M, K]: the plain version on
    the CPU, one launch of kt_w4a8_prep (csrc/w4a8_matmul.cu) on the card.

    The prep is plain XLA in the JAX package (quant/w4a8.py:w4a8_prep);
    as eager PyTorch it is ~15 small launches per projection."""
    what = "w4a8_prep"
    if x2.device.type == "cpu":
        return w4a8_prep(x2, kdim, group_size)[:5]
    if x2.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{what}: x must be float32 or bfloat16")
    check_cuda_operands(what, x2.device, x2)
    m = x2.shape[0]
    ng = kdim // group_size
    dev = x2.device
    qa = torch.empty(m, kdim // 2, dtype=torch.int8, device=dev)
    qb = torch.empty_like(qa)
    sa = torch.empty(m, ng, dtype=torch.float32, device=dev)
    sb = torch.empty_like(sa)
    t = torch.empty_like(sa)
    err = _build.lib("w4a8_matmul").kt_w4a8_prep(
        x2.data_ptr(), m, kdim, group_size, int(x2.dtype == torch.bfloat16),
        qa.data_ptr(), qb.data_ptr(), sa.data_ptr(), sb.data_ptr(),
        t.data_ptr(), torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(err, what)
    LAUNCHES[what] += 1
    return qa, qb, sa, sb, t


def dense_w4a8_launcher(x2: torch.Tensor, w: QTensor):
    """Checks and prepares a CUDA call; returns (launch, out), where
    launch() runs only the kernel on the prepared operands (so a caller
    can time the kernel apart from the activation prep)."""
    what = "dense_w4a8_matmul"
    check_cuda_operands(what, x2.device, x2, w.data, w.scales)
    m = x2.shape[0]
    qa, qb, sa, sb, t = prep_activations(x2, w.in_features, w.group_size)
    mr = 1 if m == 1 else (4 if m <= 4 else 8)
    out = torch.empty(m, w.out_features, dtype=x2.dtype, device=x2.device)
    fn = _build.lib("w4a8_matmul").kt_w4a8_rows
    tiles = dense_tiles(m, mr, x2.device)

    def launch():
        launch_rows(fn, what, (qa, qb, sa, sb, t), w, tiles, mr, out)

    return launch, out


def dense_w4a8_matmul(x2: torch.Tensor, w: QTensor) -> torch.Tensor:
    """y = x2 @ W for offset-lo int4_g W [K/2, N]: [M, N] in x2.dtype.

    CUDA tensors launch csrc/w4a8_matmul.cu; CPU tensors take
    w4a8_matmul_ref."""
    what = "dense_w4a8_matmul"
    check_w4a8_weight(w, 2, what)
    _check_x(x2, w.in_features, what)
    if x2.device.type == "cpu":
        return w4a8_matmul_ref(x2, w)
    if x2.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {x2.device}")
    launch, out = dense_w4a8_launcher(x2, w)
    launch()
    LAUNCHES[what] += 1
    return out
