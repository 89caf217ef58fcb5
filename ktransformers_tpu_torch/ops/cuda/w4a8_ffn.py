"""W4A8 expert FFN (gate_up -> GLU -> per-group int8 requant -> down):
kernel wrappers (csrc/w4a8_ffn.cu) and their plain PyTorch versions.

One kernel family, three entries, one per Pallas kernel it replaces in
ktransformers_tpu/ops/pallas/w4a8_matmul.py:
- gathered_w4a8_ffn: one expert per routed row (decode MoE),
- dense_w4a8_ffn: one 2-D expert (shared experts, dense MLP),
- grouped_w4a8_ffn: rows sorted by expert with group sizes (prefill MoE).
They compute the same function; each builds its own row-tile map. Bound on
the card at decode: the weight bytes of the experts the rows use.
"""

from __future__ import annotations

import math

import torch

from ktransformers_tpu_torch.ops.cuda import LAUNCHES
from ktransformers_tpu_torch.ops.cuda import _build
from ktransformers_tpu_torch.ops.cuda.w4a8_matmul import (
    _check_x,
    check_cuda_operands,
    check_w4a8_weight,
    dense_tiles,
    grouped_tiles,
    launch_rows,
    prep_activations,
    row_tiles,
    w4a8_group_dot,
)
from ktransformers_tpu_torch.quant.formats import QTensor
from ktransformers_tpu_torch.quant.w4a8 import _quant_rows, w4a8_prep

ACTS = {"silu": 0, "relu": 1, "gelu": 2}
MAX_DOWN_GROUP = 128  # one down group per block of the up kernel


def glu(g: torch.Tensor, u: torch.Tensor, act: str) -> torch.Tensor:
    """The kernels' GLU on float32 (ops/pallas/w4a8_matmul.py:_glu)."""
    if act == "silu":
        return g * (1.0 / (1.0 + torch.exp(-g))) * u
    if act == "relu":
        return torch.clamp(g, min=0.0) * u
    if act == "gelu":
        return 0.5 * g * (1.0 + torch.erf(g / 2.0**0.5)) * u
    raise ValueError(act)


def requant_groups(a: torch.Tensor, gs: int):
    """Per (row, down group) W4A8 requant of a [M, I] float32: (ca, cb int8
    [M, I/2], sa, sb, t f32 [M, I/gs]) with t = 8*sum(lo)."""
    m, inter = a.shape
    seg = a.reshape(m, inter // gs, gs)
    lo, hi = seg[..., : gs // 2], seg[..., gs // 2 :]
    ca, sa = _quant_rows(lo - hi / 16.0)
    cb, sb = _quant_rows(hi / 16.0)
    t = 8.0 * lo.sum(dim=-1)
    return ca.reshape(m, inter // 2), cb.reshape(m, inter // 2), sa, sb, t


def check_ffn(gate_up: QTensor, down: QTensor, ndim: int, kdim: int,
              act: str, what: str):
    """Raise on shapes the kernels do not take; returns (inter, gs_dn).

    The K % gate_up.group_size check is the guard ktransformers_tpu's
    grouped_ffn_fits lacks: there ng1 = K // gs1 truncates the contraction
    without an error."""
    if act not in ACTS:
        raise ValueError(f"{what}: unsupported activation {act!r}")
    check_w4a8_weight(gate_up, ndim, what + " gate_up")
    check_w4a8_weight(down, ndim, what + " down")
    n2x = gate_up.out_features
    inter = n2x // 2
    if gate_up.in_features != kdim or down.out_features != kdim:
        raise ValueError(f"{what}: gate_up/down do not match K={kdim}")
    if n2x != 2 * inter or down.in_features != inter:
        raise ValueError(f"{what}: gate_up [K, 2I] and down [I, K] disagree")
    if gate_up.data.shape[:-2] != down.data.shape[:-2]:
        raise ValueError(f"{what}: gate_up and down expert counts differ")
    gs_dn = down.group_size
    if gs_dn > MAX_DOWN_GROUP or inter % gs_dn:
        raise ValueError(f"{what}: down group {gs_dn} must divide I={inter} "
                         f"and be <= {MAX_DOWN_GROUP}")
    return inter, gs_dn


# The reference's route choice for a dense GLU MLP
# (ktransformers_tpu/ops/pallas/w4a8_matmul.py:dense_ffn_plan, ffn_fits and
# the hooks in ops/pallas/__init__.py). The fused FFN keeps the GLU output
# in float32 before its int8 requant; the unfused route (two dense W4A8
# matmuls) rounds the gate_up output and the GLU to the compute dtype. The
# two are different functions in bf16, so the port takes the fused kernels
# exactly where the reference does. The byte budgets are the reference's.
DENSE_FFN_MAX_M = 4096
GATHERED_FFN_MAX_ROWS = 128
_DENSE_FFN_BUDGET = 10 * 1024 * 1024
_GATHERED_FFN_BUDGET = 15 * 1024 * 1024


def _fusable(gate_up, down, act: str, swiglu_limit) -> bool:
    return (isinstance(gate_up, QTensor) and isinstance(down, QTensor)
            and gate_up.kind == "int4_g" and down.kind == "int4_g"
            and gate_up.act_quant and down.act_quant
            and act in ACTS and swiglu_limit is None)


def dense_ffn_plan(gate_up, down, act: str, swiglu_limit) -> int | None:
    """Inter-dim chunk width the reference's dense_w4a8_ffn would use for
    2-D gate_up [K/2, 2I] / down [I/2, K], or None where it refuses: no
    divisor of I that is a multiple of lcm(128, down group) fits its
    budget (DeepSeek-V2-Lite's dense layer, I = 10944 with down group 96,
    has none)."""
    if not _fusable(gate_up, down, act, swiglu_limit):
        return None
    if gate_up.data.dim() != 2 or down.data.dim() != 2:
        return None
    k2, n2x = gate_up.data.shape
    i2, kdim = down.data.shape
    inter = n2x // 2
    if n2x != 2 * inter or 2 * i2 != inter:
        return None
    step = math.lcm(128, down.group_size or inter)
    bc = (inter // step) * step
    while bc >= step:
        if inter % bc == 0 and 2 * (2 * k2 * bc + (bc // 2) * kdim) \
                <= _DENSE_FFN_BUDGET:
            return bc
        bc -= step
    return None


def ffn_fits(gate_up, down, act: str, swiglu_limit, rows: int) -> bool:
    """Whether the reference's gathered_w4a8_ffn takes 3-D weights
    [E, K/2, 2I] / [E, I/2, K] for ``rows`` rows (its whole-expert
    blocks and per-row temporaries within its budget)."""
    if not _fusable(gate_up, down, act, swiglu_limit):
        return False
    _, k2, n2x = gate_up.data.shape
    _, i2, kdim = down.data.shape
    inter = n2x // 2
    r8 = max(8, ((rows + 7) // 8) * 8)
    need = 2 * (k2 * n2x + i2 * kdim) + r8 * (
        2 * k2 + n2x * 4 + inter * 4 + 2 * kdim * 4 + 2 * n2x * 4
        + 2 * kdim * 4)
    if need > _GATHERED_FFN_BUDGET:
        return False
    return (2 * i2) % (down.group_size or 2 * i2) == 0


def dense_mlp_fused(gate_up, down, act: str, swiglu_limit,
                    rows: int) -> bool:
    """Whether the reference runs a dense GLU MLP over ``rows`` rows through
    a fused FFN kernel: its dense_w4a8_ffn where a chunk plan exists, else
    its gathered_w4a8_ffn over the weights as one expert where they fit.
    Both compute what the port's dense_w4a8_ffn computes. Otherwise it
    runs two dense W4A8 matmuls."""
    if rows <= DENSE_FFN_MAX_M and dense_ffn_plan(
            gate_up, down, act, swiglu_limit) is not None:
        return True
    return (rows <= GATHERED_FFN_MAX_ROWS
            and _fusable(gate_up, down, act, swiglu_limit)
            and gate_up.data.dim() == 2 and down.data.dim() == 2
            and ffn_fits(lift(gate_up), lift(down), act, swiglu_limit, rows))


def w4a8_ffn_ref(x_rows: torch.Tensor, gate_up: QTensor, down: QTensor,
                 row_expert: torch.Tensor, act: str = "silu") -> torch.Tensor:
    """Plain version of all three FFN entries: row r uses expert
    row_expert[r] (-1 = no expert, output row zero). Weights are
    [E, K/2, 2I] / [E, I/2, K]. Returns [R, K] in x_rows.dtype."""
    r, kdim = x_rows.shape
    inter = gate_up.out_features // 2
    qa, qb, sa, sb, t, _ = w4a8_prep(x_rows, kdim, gate_up.group_size)
    out = torch.zeros(r, kdim, dtype=torch.float32, device=x_rows.device)
    for e in torch.unique(row_expert).tolist():
        if e < 0:
            continue
        idx = torch.nonzero(row_expert == e).flatten()
        h = w4a8_group_dot(qa[idx], qb[idx], sa[idx], sb[idx], t[idx],
                           gate_up.data[e], gate_up.scales[e],
                           gate_up.group_size // 2)
        a = glu(h[:, :inter], h[:, inter:], act)
        ca, cb, sa2, sb2, t2 = requant_groups(a, down.group_size)
        out[idx] = w4a8_group_dot(ca, cb, sa2, sb2, t2, down.data[e],
                                  down.scales[e], down.group_size // 2)
    return out.to(x_rows.dtype)


def lift(qt: QTensor) -> QTensor:
    """A 2-D weight as a 1-expert 3-D one (views, no copy)."""
    return QTensor(qt.data[None], qt.scales[None], None, kind=qt.kind,
                   group_size=qt.group_size, act_quant=qt.act_quant)


def gathered_w4a8_ffn_ref(x_rows, gate_up, down, ids, act="silu"):
    return w4a8_ffn_ref(x_rows, gate_up, down, ids.to(torch.int64), act)


def dense_w4a8_ffn_ref(x2, gate_up, down, act="silu"):
    row_expert = torch.zeros(x2.shape[0], dtype=torch.int64, device=x2.device)
    return w4a8_ffn_ref(x2, lift(gate_up), lift(down), row_expert, act)


def grouped_w4a8_ffn_ref(x_sorted, gate_up, down, group_sizes, act="silu"):
    m = x_sorted.shape[0]
    e = gate_up.data.shape[0]
    row_expert = torch.repeat_interleave(
        torch.arange(e, device=x_sorted.device), group_sizes.to(torch.int64)
    )[:m]
    pad = torch.full((m - row_expert.shape[0],), -1, dtype=torch.int64,
                     device=x_sorted.device)
    return w4a8_ffn_ref(x_sorted, gate_up, down,
                        torch.cat([row_expert, pad]), act)


def ffn_launcher(x_rows, gate_up: QTensor, down: QTensor, tiles, mr: int,
                 act: str, out: torch.Tensor, what: str):
    """Checks and prepares a CUDA call; returns launch(), which runs only
    the two kernels on the prepared operands and writes ``out``."""
    r, kdim = x_rows.shape
    inter = gate_up.out_features // 2
    gs1, gs_dn = gate_up.group_size, down.group_size
    check_cuda_operands(what, x_rows.device, x_rows, gate_up.data,
                        gate_up.scales, down.data, down.scales)
    qa, qb, sa, sb, t = prep_activations(x_rows, kdim, gs1)
    dev = x_rows.device
    ng2 = inter // gs_dn
    ca = torch.empty(r, inter // 2, dtype=torch.int8, device=dev)
    cb = torch.empty_like(ca)
    sa2 = torch.empty(r, ng2, dtype=torch.float32, device=dev)
    sb2 = torch.empty_like(sa2)
    t2 = torch.empty_like(sa2)
    te, tr0, trs = tiles
    lib = _build.lib("w4a8_ffn")

    def launch():
        err = lib.kt_w4a8_ffn_up(
            qa.data_ptr(), qb.data_ptr(), sa.data_ptr(), sb.data_ptr(),
            t.data_ptr(), gate_up.data.data_ptr(), gate_up.scales.data_ptr(),
            te.data_ptr(), tr0.data_ptr(), trs.data_ptr(), te.shape[0], mr,
            kdim // 2, inter, kdim // gs1, gs1 // 2, gs_dn, ACTS[act],
            ca.data_ptr(), cb.data_ptr(), sa2.data_ptr(), sb2.data_ptr(),
            t2.data_ptr(), torch.cuda.current_stream(dev).cuda_stream,
        )
        _build.check(err, what + " (gate_up)")
        launch_rows(lib.kt_w4a8_ffn_down, what + " (down)",
                    (ca, cb, sa2, sb2, t2), down, tiles, mr, out)

    return launch


def _counted(what: str, launch, out: torch.Tensor) -> torch.Tensor:
    launch()
    LAUNCHES[what] += 1
    return out


def gathered_launcher(x_rows, gate_up, down, ids, act="silu"):
    out = torch.empty_like(x_rows)
    return ffn_launcher(x_rows, gate_up, down, row_tiles(ids), 1, act, out,
                        "gathered_w4a8_ffn"), out


def dense_launcher(x2, gate_up, down, act="silu"):
    mr = 1 if x2.shape[0] == 1 else 4
    out = torch.empty_like(x2)
    return ffn_launcher(x2, lift(gate_up), lift(down),
                        dense_tiles(x2.shape[0], mr, x2.device), mr, act,
                        out, "dense_w4a8_ffn"), out


def grouped_launcher(x_sorted, gate_up, down, group_sizes, act="silu"):
    mr = 4
    out = torch.zeros_like(x_sorted)
    tiles = grouped_tiles(group_sizes, x_sorted.shape[0], mr)
    return ffn_launcher(x_sorted, gate_up, down, tiles, mr, act, out,
                        "grouped_w4a8_ffn"), out


def _device_kind(x: torch.Tensor, what: str) -> str:
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {x.device}")
    return x.device.type


def gathered_w4a8_ffn(x_rows: torch.Tensor, gate_up: QTensor, down: QTensor,
                      ids: torch.Tensor, act: str = "silu") -> torch.Tensor:
    """Decode MoE FFN: row r through expert ids[r]. [R, K] in x dtype."""
    what = "gathered_w4a8_ffn"
    kdim = x_rows.shape[-1]
    check_ffn(gate_up, down, 3, kdim, act, what)
    _check_x(x_rows, kdim, what)
    if ids.shape != (x_rows.shape[0],):
        raise ValueError(f"{what}: ids must be [R]")
    if _device_kind(x_rows, what) == "cpu":
        return gathered_w4a8_ffn_ref(x_rows, gate_up, down, ids, act)
    return _counted(what, *gathered_launcher(x_rows, gate_up, down, ids, act))


def dense_w4a8_ffn(x2: torch.Tensor, gate_up: QTensor, down: QTensor,
                   act: str = "silu") -> torch.Tensor:
    """FFN of one 2-D expert (gate_up [K/2, 2I], down [I/2, K])."""
    what = "dense_w4a8_ffn"
    kdim = x2.shape[-1]
    check_ffn(gate_up, down, 2, kdim, act, what)
    _check_x(x2, kdim, what)
    if _device_kind(x2, what) == "cpu":
        return dense_w4a8_ffn_ref(x2, gate_up, down, act)
    return _counted(what, *dense_launcher(x2, gate_up, down, act))


def grouped_w4a8_ffn(x_sorted: torch.Tensor, gate_up: QTensor, down: QTensor,
                     group_sizes: torch.Tensor,
                     act: str = "silu") -> torch.Tensor:
    """Prefill MoE FFN over rows sorted by expert; rows past
    sum(group_sizes) come back zero. [M, K] in x dtype."""
    what = "grouped_w4a8_ffn"
    kdim = x_sorted.shape[-1]
    check_ffn(gate_up, down, 3, kdim, act, what)
    _check_x(x_sorted, kdim, what)
    if group_sizes.shape != (gate_up.data.shape[0],):
        raise ValueError(f"{what}: group_sizes must be [E]")
    if _device_kind(x_sorted, what) == "cpu":
        return grouped_w4a8_ffn_ref(x_sorted, gate_up, down, group_sizes, act)
    return _counted(what, *grouped_launcher(x_sorted, gate_up, down,
                                            group_sizes, act))
