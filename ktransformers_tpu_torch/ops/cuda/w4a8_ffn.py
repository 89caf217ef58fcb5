"""W4A8 expert FFN (gate_up -> GLU -> per-group int8 requant -> down):
kernel wrappers (csrc/w4a8_ffn.cu) and their plain PyTorch versions.

One kernel family, three entries, one per Pallas kernel it replaces in
ktransformers_tpu/ops/pallas/w4a8_matmul.py:
- gathered_w4a8_ffn: one expert per routed row (decode MoE),
- dense_w4a8_ffn: one 2-D expert (shared experts, dense MLP),
- grouped_w4a8_ffn: rows sorted by expert with group sizes (prefill MoE).
They compute the same function; each builds its own row-tile map, and
``ffn_route`` picks the two kernels of a call (gate_up, then down) by a
fixed rule: tensor cores for tiles of more than one row, split-K GEMVs for
one-row tiles (w4a8_ffn_gemv_kernel for gate_up + GLU + requant, planned
by ``ffn_gemv_plan``; w4a8_gemv_kernel for the down), the first version
for the shapes those refuse. Whether the gate_up kernel quantizes x
itself (no w4a8_prep launch): the GEMV by w4a8_matmul.gemv_folds, the
tensor-core kernel at up to FFN_MMA_FOLD_MAX_ROWS rows (``ffn_folds``);
the down reads the codes the gate_up's requant wrote. Bound on the card:
the weight bytes of the experts the rows use.

Weights are offset-lo int4, int4_g or int4_gz (the zero term of each scale
group, and of each down group of the requantized activation: its group
sums xs2). A down group wider than MAX_DOWN_GROUP (per-channel int4: all of
I) is held by no block of the fused gate_up kernels: such a call takes the
"split" route, the gate_up as a W4A8 matmul (the GEMV or the tensor-core
kernel, as ops/cuda/w4a8_matmul.route picks) into a float32 plane, one
kt_w4a8_glu_prep launch (the GLU and the requant, one block a row and down
group) and the down matmul.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch

from ktransformers_tpu_torch.ops.cuda import LAUNCHES, ROUTED_LAUNCHES
from ktransformers_tpu_torch.ops.cuda import _build
from ktransformers_tpu_torch.ops.cuda.w4a8_matmul import (
    MMA_BM,
    MMA_MIN_ROWS,
    FOLD_MAX_GROUP,
    ZP,
    GEMV_MAX_ROWS,
    GEMV_UNIT,
    _check_x,
    act_args,
    activations,
    check_cuda_operands,
    check_w4a8_weight,
    dense_tiles,
    device_kind,
    fold_rows,
    gemv_folds,
    gemv_launcher,
    gemv_rows_per_chunk,
    gemv_takes,
    gemv_tile_count,
    group_of,
    grouped_tiles,
    launch_mma,
    launch_rows,
    lift,
    mma_fold_fits,
    mma_takes,
    one_id,
    row_tiles,
    scratch,
    sm_count,
    sorted_row_experts,
    split_k_plan,
    w4a8_group_dot,
    weight_tensors,
    zero_args,
)
from ktransformers_tpu_torch.quant.formats import QTensor
from ktransformers_tpu_torch.quant.w4a8 import (
    W4A8_KINDS,
    _quant_rows,
    w4a8_prep,
)

ACTS = {"silu": 0, "relu": 1, "gelu": 2}
MAX_DOWN_GROUP = 128  # whole down groups a block of the up kernels
# w4a8_ffn_mma_kernel: tiles of MMA_BM rows, this many gate (and up)
# columns a block, holding whole down groups of FFN_MMA_DOWN_GROUPS
FFN_MMA_DOWN_GROUP = 128
FFN_MMA_DOWN_GROUPS = (16, 32, 128)
# ... and it quantizes x itself at up to this many rows, where its A tile
# fits beside its ring of FFN_MMA_STAGES groups (each of the I / 128 blocks
# of a tile quantizes its rows again: the crossover on the H100, which
# ops/cuda/fold_sweep.py and chip_smoke.py time, folded beside prep +
# unfolded kernel)
FFN_MMA_FOLD_MAX_ROWS = 8
FFN_MMA_STAGES = 6
FIRST_MR = 4  # rows a tile of the first version at more than one row


def ffn_route(m: int, entry: str, gs_up: int, gs_dn: int, inter: int,
              kdim: int) -> str:
    """The kernels of a CUDA FFN call (``entry`` "dense", "gathered" or
    "grouped", m rows; gs_up / gs_dn the gate_up and down scale groups,
    group_of: all of K or I for per-channel int4), a pure function of the
    shapes:
    - "split": a down group wider than MAX_DOWN_GROUP, which no block of
      the fused gate_up kernels holds: the gate_up as a W4A8 matmul into a
      float32 plane (w4a8_matmul.route: the GEMV, the tensor-core kernel
      or the first version), kt_w4a8_glu_prep, the down matmul;
    - "gemv": one-row tiles (every gathered call, a dense call of one row):
      w4a8_ffn_gemv_kernel for gate_up + GLU + requant, w4a8_gemv_kernel
      for the down, where both take the shapes (gemv_takes for the down:
      at most 128 rows, K a multiple of 16, a down group of whole 8-row
      units; a gate_up group of whole 8-row units for the gate_up);
    - "mma": dense and grouped calls of at least MMA_MIN_ROWS rows:
      w4a8_ffn_mma_kernel for gate_up + GLU + requant, w4a8_mma_kernel for
      the down, both on 64-row tiles; gate_up groups 128, 96, 32 and 16
      (K a multiple of 64 at the last two), down groups of
      FFN_MMA_DOWN_GROUPS (I a multiple of 128), K a multiple of 32;
    - "rows": the first version (ffn_up_kernel, w4a8_rows_kernel) for the
      shapes those refuse."""
    if gs_dn > MAX_DOWN_GROUP:
        return "split"
    if entry == "gathered" or (entry == "dense" and m == 1):
        takes = gemv_takes(m, gs_dn, kdim) and (gs_up // 2) % GEMV_UNIT == 0
        return "gemv" if takes else "rows"
    if (m >= MMA_MIN_ROWS and gs_up != kdim and mma_takes(gs_up, kdim)
            and gs_dn in FFN_MMA_DOWN_GROUPS
            and inter % FFN_MMA_DOWN_GROUP == 0 and kdim % 32 == 0):
        return "mma"
    return "rows"


def ffn_folds(kernel: str, m: int, kdim: int, gs_up: int,
              zeros: bool = False) -> bool:
    """Whether the gate_up kernel of a CUDA FFN call [m, kdim] routed to the
    tensor cores (kernel "mma") folds the activation prep in (no w4a8_prep
    launch): at up to FFN_MMA_FOLD_MAX_ROWS rows, at gate_up groups of up
    to FOLD_MAX_GROUP, where its A tile fits beside its ring (``zeros``:
    with the gate_up's group sums). The first version never folds; the
    one-row gate_up's rule is gemv_folds (ffn_gemv_call_folds). A pure
    function of the shape."""
    return (kernel == "mma" and m <= FFN_MMA_FOLD_MAX_ROWS
            and gs_up <= FOLD_MAX_GROUP
            and mma_fold_fits(m, kdim, gs_up, FFN_MMA_STAGES,
                              2 * FFN_MMA_DOWN_GROUP, zeros=zeros))


def ffn_gemv_call_folds(rows: int, experts: int, inter: int, gs_dn: int,
                        kdim: int, gs_up: int, sms: int) -> bool:
    """gemv_folds of the one-row gate_up of a W4A8 FFN call of ``rows``
    rows over ``experts`` experts (a dense call: 1 and 1), planned by
    ffn_gemv_plan."""
    rb = gemv_rows_per_chunk(rows, experts)
    splits, gran = ffn_gemv_plan(inter, gs_dn,
                                 gemv_tile_count(rows, experts, rb),
                                 kdim // 2, gs_up // 2, sms)
    return (gran * GEMV_UNIT == gs_up // 2
            and gemv_folds(rb, kdim // gs_up, splits, gs_up))


def ffn_gemv_bc(inter: int, gs_dn: int) -> int:
    """The gate (and up) columns a block of w4a8_ffn_gemv_kernel takes: the
    most whole down groups of gs_dn within MAX_DOWN_GROUP columns that
    divide I in a multiple of 16 columns (a down group of 128 or 96: one;
    of 32 at I = 1408: four)."""
    for k in range(MAX_DOWN_GROUP // gs_dn, 0, -1):
        bc = k * gs_dn
        if inter % bc == 0 and bc % 16 == 0:
            return bc
    raise ValueError(f"no block of down groups of {gs_dn} divides I={inter}")


def ffn_gemv_plan(inter: int, gs_dn: int, ntiles: int, k2: int, gs2: int,
                  sms: int) -> tuple[int, int]:
    """(splits, gran) of a w4a8_ffn_gemv_kernel launch: split_k_plan over
    (I / bc) x tiles blocks a split, one block a (ffn_gemv_bc columns,
    tile). At DeepSeek-V2-Lite's decode shapes (K = 2048, group 128: 16
    groups): 6 routed rows (66 blocks) take 4 splits, the shared experts at
    M = 1 (I = 2816: 22 blocks) 12, 48 routed rows (528 blocks) one."""
    return split_k_plan(inter // ffn_gemv_bc(inter, gs_dn) * ntiles, k2, gs2,
                        sms)


def glu(g: torch.Tensor, u: torch.Tensor, act: str) -> torch.Tensor:
    """The kernels' GLU on float32 (ops/pallas/w4a8_matmul.py:_glu)."""
    if act == "silu":
        return g * (1.0 / (1.0 + torch.exp(-g))) * u
    if act == "relu":
        return torch.clamp(g, min=0.0) * u
    if act == "gelu":
        return 0.5 * g * (1.0 + torch.erf(g / 2.0**0.5)) * u
    raise ValueError(act)


def requant_groups(a: torch.Tensor, gs: int, xsum: bool = False):
    """Per (row, down group) W4A8 requant of a [M, I] float32: (ca, cb int8
    [M, I/2], sa, sb, t f32 [M, I/gs]) with t = 8*sum(lo), and where
    ``xsum`` the group sums sum(lo + hi) (a down with zero points)."""
    m, inter = a.shape
    seg = a.reshape(m, inter // gs, gs)
    lo, hi = seg[..., : gs // 2], seg[..., gs // 2 :]
    ca, sa = _quant_rows(lo - hi / 16.0)
    cb, sb = _quant_rows(hi / 16.0)
    t = 8.0 * lo.sum(dim=-1)
    out = (ca.reshape(m, inter // 2), cb.reshape(m, inter // 2), sa, sb, t)
    return out + ((lo + hi).sum(dim=-1),) if xsum else out


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
    gs_dn = group_of(down)
    if inter % gs_dn:
        raise ValueError(f"{what}: down group {gs_dn} must divide I={inter}")
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
            and gate_up.kind in W4A8_KINDS and down.kind in W4A8_KINDS
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


GROUP_BM = 64  # the reference's rows per grouped tile, in its byte test


def grouped_ffn_fits(gate_up, down, act: str, swiglu_limit) -> bool:
    """Whether the reference's grouped_w4a8_ffn takes 3-D weights (one
    expert's blocks and the tile's temporaries within its budget)."""
    if not _fusable(gate_up, down, act, swiglu_limit):
        return False
    if gate_up.data.dim() != 3 or down.data.dim() != 3:
        return False
    _, k2, n2x = gate_up.data.shape
    _, i2, kdim = down.data.shape
    inter = n2x // 2
    if 2 * i2 != inter or kdim != 2 * k2:
        return False
    if inter % (down.group_size or inter):
        return False
    bm = GROUP_BM
    need = (2 * (k2 * n2x + i2 * kdim) + 2 * (bm * k2) * 2 + bm * n2x * 4
            + bm * inter * 4 + 2 * bm * kdim * 4 + 2 * bm * n2x * 4)
    return need <= _GATHERED_FFN_BUDGET


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


def gate_up_ref(x_rows: torch.Tensor, gate_up: QTensor, gs_dn: int,
                row_expert: torch.Tensor, act: str = "silu",
                xsum: bool = False):
    """Plain version of an FFN call's first half: row r through expert
    row_expert[r] of gate_up [E, K/2, 2I] (-1: none), the GLU and the
    requant per down group of gs_dn (0: all of I). {expert: (rows, (ca, cb,
    sa2, sb2, t2[, xs2]))}, what the down reads (requant_groups; xs2 where
    ``xsum``)."""
    kdim = x_rows.shape[1]
    inter = gate_up.out_features // 2
    qa, qb, sa, sb, t, xs = w4a8_prep(x_rows, kdim, gate_up.group_size)
    mids = {}
    for e in torch.unique(row_expert).tolist():
        if e < 0:
            continue
        idx = torch.nonzero(row_expert == e).flatten()
        h = w4a8_group_dot(
            qa[idx], qb[idx], sa[idx], sb[idx], t[idx], gate_up.data[e],
            gate_up.scales[e], group_of(gate_up) // 2, xs[idx],
            None if gate_up.zeros is None else gate_up.zeros[e])
        mids[e] = idx, requant_groups(glu(h[:, :inter], h[:, inter:], act),
                                      gs_dn or inter, xsum)
    return mids


def w4a8_ffn_ref(x_rows: torch.Tensor, gate_up: QTensor, down: QTensor,
                 row_expert: torch.Tensor, act: str = "silu") -> torch.Tensor:
    """Plain version of all three FFN entries: row r uses expert
    row_expert[r] (-1 = no expert, output row zero). Weights are
    [E, K/2, 2I] / [E, I/2, K]. Returns [R, K] in x_rows.dtype."""
    r, kdim = x_rows.shape
    out = torch.zeros(r, kdim, dtype=torch.float32, device=x_rows.device)
    hasz = down.zeros is not None
    for e, (idx, mid) in gate_up_ref(x_rows, gate_up, group_of(down),
                                     row_expert, act, hasz).items():
        out[idx] = w4a8_group_dot(
            *mid[:5], down.data[e], down.scales[e], group_of(down) // 2,
            mid[5] if hasz else None, down.zeros[e] if hasz else None)
    return out.to(x_rows.dtype)


def gathered_w4a8_ffn_ref(x_rows, gate_up, down, ids, act="silu"):
    return w4a8_ffn_ref(x_rows, gate_up, down, ids.to(torch.int64), act)


def dense_w4a8_ffn_ref(x2, gate_up, down, act="silu"):
    row_expert = torch.zeros(x2.shape[0], dtype=torch.int64, device=x2.device)
    return w4a8_ffn_ref(x2, lift(gate_up), lift(down), row_expert, act)


def grouped_w4a8_ffn_ref(x_sorted, gate_up, down, group_sizes, act="silu"):
    return w4a8_ffn_ref(x_sorted, gate_up, down, sorted_row_experts(
        group_sizes.to(x_sorted.device), x_sorted.shape[0]), act)


@dataclasses.dataclass
class FfnLaunch:
    """The two launches of a CUDA FFN call on prepared operands: up()
    (gate_up + GLU + requant into the scratch plane), then down(), which
    reads that plane and writes the output. Calling it runs both.
    ``kernels``: the ROUTED_LAUNCHES keys of the redesigned kernels the
    call takes (route_kernels for the fused routes)."""
    up: Callable[[], None]
    down: Callable[[], None]
    kernels: tuple | None = None

    def __call__(self) -> None:
        self.up()
        self.down()


def gemv_up_launcher(what, x, gate_up: QTensor, gs_dn: int,
                     ids: torch.Tensor, act: str, mid,
                     fold: bool | None = None):
    """Checks a one-row-tile gate_up on a 3-D weight [E, K/2, 2I] with row
    r of x through expert ids[r]; returns launch(), which runs only
    w4a8_ffn_gemv_kernel (kt_w4a8_ffn_gemv, split by ffn_gemv_plan, blocks
    of ffn_gemv_bc columns) and writes the requantized activation ``mid``
    (ca, cb, sa2, sb2, t2[, xs2]). The kernel quantizes x itself where
    ``fold`` (default gemv_folds), else one prep launch here makes its
    codes."""
    e, k2, n2x = gate_up.data.shape
    inter = n2x // 2
    gs_up = group_of(gate_up)
    gs2 = gs_up // 2
    r = ids.shape[0]
    if r > GEMV_MAX_ROWS or gs2 % GEMV_UNIT or gs_dn % 16:
        raise ValueError(f"{what}: the GEMV takes at most {GEMV_MAX_ROWS} "
                         "rows, a gate_up group of 16s and a down group of "
                         f"16s (rows={r}, groups {2 * gs2} / {gs_dn})")
    if any(p.data_ptr() % 16 for p in weight_tensors(gate_up)):
        raise ValueError(f"{what}: the GEMV takes 16-byte aligned weights")
    dev = mid[0].device
    ids = ids.to(torch.int32).contiguous()
    rb = gemv_rows_per_chunk(r, e)
    tiles = gemv_tile_count(r, e, rb)
    bc = ffn_gemv_bc(inter, gs_dn)
    splits, gran = ffn_gemv_plan(inter, gs_dn, tiles, k2, gs2,
                                 sm_count(dev))
    part = cnt = None
    if splits > 1:
        part, cnt = scratch(dev, r * splits * n2x, inter // bc * tiles,
                            "w4a8_ffn_gemv")
    if fold is None:
        fold = (gran * GEMV_UNIT == gs2
                and gemv_folds(rb, k2 // gs2, splits, gs_up))
    acts = activations(x, 2 * k2, gs_up, fold, gate_up.zeros is not None)
    fn = _build.lib("w4a8_ffn").kt_w4a8_ffn_gemv
    def launch():  # holds acts and mid (and their memory) while it lives
        err = fn(
            *act_args(acts), gate_up.data.data_ptr(),
            gate_up.scales.data_ptr(),
            ids.data_ptr(), r, tiles, splits, gran, rb, k2, inter, k2 // gs2,
            gs2, bc, ACTS[act],
            None if part is None else part.data_ptr(),
            None if cnt is None else cnt.data_ptr(),
            *(v.data_ptr() for v in mid[:5]), *zero_args(acts, gate_up),
            mid_xs(mid), gs_dn,
            torch.cuda.current_stream(dev).cuda_stream,
        )
        _build.check(err, what)

    return launch


def mid_xs(mid):
    """The requant's group-sum plane of ``mid`` (a down with zero points),
    or None."""
    return mid[5].data_ptr() if len(mid) > 5 else None


def split_launcher(x_rows, gate_up: QTensor, down: QTensor, entry: str,
                   tiles, mr: int, act: str, mid, out: torch.Tensor,
                   what: str, ids=None) -> "FfnLaunch":
    """The "split" route of ffn_route (a down group no block holds): up()
    runs the gate_up as a W4A8 matmul into a float32 plane h [R, 2I] (the
    kernel w4a8_matmul.route picks, reading a prep launch's codes) and one
    kt_w4a8_glu_prep launch (the GLU and the requant of each (row, down
    group) into ``mid``), down() the down matmul. ``tiles`` is the row-tile
    map of mr rows a tile for a dense or grouped call (a one-row-tile call
    takes ``ids``)."""
    from ktransformers_tpu_torch.ops.cuda import w4a8_matmul as MM

    r, kdim = x_rows.shape
    inter = gate_up.out_features // 2
    gs_dn = group_of(down)
    dev = x_rows.device
    h = torch.zeros(r, 2 * inter, dtype=torch.float32, device=dev)
    kernels = []

    def matmul(name, acts_or_x, w, out_t):
        """launch() of one W4A8 matmul of the route into out_t."""
        kernel = MM.route(r, entry, group_of(w), w.out_features,
                          w.in_features)
        if kernel == "gemv":
            kernels.append(MM.kernel_name("gemv", w))
            return MM.gemv_launcher(name, acts_or_x, w, ids, out_t, False)
        acts = acts_or_x
        if isinstance(acts, torch.Tensor):
            acts = activations(acts, w.in_features, w.group_size, False,
                               w.zeros is not None)
        if kernel == "mma":
            kernels.append(MM.kernel_name("mma", w))
            return lambda: launch_mma(name, acts, w, tiles, out_t)
        if mr not in (1, FIRST_MR):
            raise ValueError(f"{name}: no W4A8 kernel takes a group of "
                             f"{group_of(w)} at K={w.in_features}")
        fn = _build.lib("w4a8_matmul").kt_w4a8_rows
        return lambda: launch_rows(fn, name, acts, w, tiles, mr, out_t)

    up_mm = matmul(what + " (gate_up)", x_rows, gate_up, h)
    kernels.append("w4a8_prep_block_kernel")  # kt_w4a8_glu_prep's
    glu_fn = _build.lib("w4a8_ffn").kt_w4a8_glu_prep

    def up():
        up_mm()
        err = glu_fn(h.data_ptr(), r, inter, gs_dn, ACTS[act],
                     *(v.data_ptr() for v in mid[:5]), mid_xs(mid),
                     torch.cuda.current_stream(dev).cuda_stream)
        _build.check(err, what + " (glu_prep)")
        LAUNCHES["w4a8_prep"] += 1

    return FfnLaunch(up, matmul(what + " (down)", mid, down, out),
                     tuple(kernels))


def ffn_launcher(x_rows, gate_up: QTensor, down: QTensor, kernel: str,
                 tiles, mr: int, act: str, out: torch.Tensor, what: str,
                 ids=None, fold: bool | None = None,
                 entry: str = "dense") -> FfnLaunch:
    """Checks and prepares a CUDA call on 3-D weights; returns the
    FfnLaunch of the two kernels ``kernel`` (ffn_route) names on the
    prepared operands, which writes ``out``. ``tiles`` is the row-tile map
    of both launches with up to ``mr`` rows a tile (MMA_BM for "mma"); a
    "gemv" call takes ``ids``, the rows' experts (ids = [0] for a dense
    call of one row), and keys its tiles by expert on the card. ``fold``
    (default ffn_folds, gemv_folds for "gemv") says whether the gate_up
    kernel quantizes x itself or reads the codes of one prep launch made
    here."""
    r, kdim = x_rows.shape
    if kernel == "gemv" and (ids is None or ids.shape != (r,)):
        raise ValueError(f"{what}: the GEMVs take an expert a row")
    gs1, gs_dn = group_of(gate_up), group_of(down)
    hasz1 = gate_up.zeros is not None
    if fold is None and kernel not in ("gemv", "split"):
        fold = ffn_folds(kernel, r, kdim, gs1, hasz1)
    if fold and kernel in ("rows", "split"):
        raise ValueError(f"{what}: the {kernel} route takes no x")
    inter = gate_up.out_features // 2
    check_cuda_operands(what, x_rows.device, x_rows,
                        *weight_tensors(gate_up), *weight_tensors(down))
    dev = x_rows.device
    ng2 = inter // gs_dn
    ca = torch.empty(r, inter // 2, dtype=torch.int8, device=dev)
    cb = torch.empty_like(ca)
    planes = [torch.empty(r, ng2, dtype=torch.float32, device=dev)
              for _ in range(4 if down.zeros is not None else 3)]
    mid = (ca, cb, *planes)
    if kernel == "split":
        return split_launcher(x_rows, gate_up, down, entry, tiles, mr, act,
                              mid, out, what, ids)
    if kernel == "gemv":
        return FfnLaunch(
            gemv_up_launcher(what + " (gate_up)", x_rows, gate_up, gs_dn,
                             ids, act, mid, fold),
            gemv_launcher(what + " (down)", mid, down, ids, out),
            route_kernels(kernel, gate_up, down))
    acts = activations(x_rows, kdim, gs1, fold, hasz1)
    te, tr0, trs = tiles
    lib = _build.lib("w4a8_ffn")
    weights = (gate_up.data.data_ptr(), gate_up.scales.data_ptr(),
               te.data_ptr(), tr0.data_ptr(), trs.data_ptr(), te.shape[0])
    tail = tuple(v.data_ptr() for v in mid[:5])
    zeros = (*zero_args(acts, gate_up), mid_xs(mid))
    if kernel == "mma":
        arows = fold_rows(r) if fold else 0

        def up():
            return lib.kt_w4a8_ffn_mma(
                *act_args(acts), *weights, arows, kdim // 2, inter,
                kdim // gs1, gs1 // 2, ACTS[act], *tail, *zeros, gs_dn,
                torch.cuda.current_stream(dev).cuda_stream)

        def down_launch():
            launch_mma(what + " (down)", mid, down, tiles, out)
    else:
        def up():
            return lib.kt_w4a8_ffn_up(
                *(v.data_ptr() for v in acts[:5]), *weights, mr, kdim // 2,
                inter, kdim // gs1, gs1 // 2, gs_dn, ACTS[act], *tail,
                *zeros, torch.cuda.current_stream(dev).cuda_stream)

        def down_launch():
            launch_rows(lib.kt_w4a8_ffn_down, what + " (down)", mid, down,
                        tiles, mr, out)

    return FfnLaunch(lambda: _build.check(up(), what + " (gate_up)"),
                     down_launch, route_kernels(kernel, gate_up, down))


# the redesigned kernels of each route: gate_up, then down
ROUTE_KERNELS = {"gemv": ("w4a8_ffn_gemv_kernel", "w4a8_gemv_kernel"),
                 "mma": ("w4a8_ffn_mma_kernel", "w4a8_mma_kernel")}


def route_kernels(kernel: str, gate_up: QTensor, down: QTensor) -> tuple:
    """The ROUTED_LAUNCHES keys of a fused route's two kernels, as the C
    launchers pick them: each the instantiation with the zero term where
    its weight has zero points."""
    return tuple(name + (ZP if w.zeros is not None else "")
                 for name, w in zip(ROUTE_KERNELS.get(kernel, ()),
                                    (gate_up, down)))


def _counted(what: str, kernel: str, launch, out: torch.Tensor
             ) -> torch.Tensor:
    launch()
    LAUNCHES[what] += 1
    for name in launch.kernels or ():
        ROUTED_LAUNCHES[name] += 1
    return out


def _route(x, gate_up: QTensor, down: QTensor, entry: str) -> str:
    return ffn_route(x.shape[0], entry, group_of(gate_up), group_of(down),
                     gate_up.out_features // 2, x.shape[1])


def gathered_launcher(x_rows, gate_up, down, ids, act="silu",
                      kernel: str | None = None, fold: bool | None = None):
    """(launch, out) of a CUDA gathered_w4a8_ffn call; ``kernel`` ("rows")
    overrides ffn_route and ``fold`` ffn_folds, for a measurement."""
    out = torch.empty_like(x_rows)
    kernel = kernel or _route(x_rows, gate_up, down, "gathered")
    tiles = None if kernel == "gemv" else row_tiles(ids)
    return ffn_launcher(x_rows, gate_up, down, kernel, tiles, 1, act, out,
                        "gathered_w4a8_ffn", ids, fold, "gathered"), out


def dense_launcher(x2, gate_up, down, act="silu", kernel: str | None = None,
                   fold: bool | None = None):
    """(launch, out) of a CUDA dense_w4a8_ffn call; ``kernel`` ("rows")
    overrides ffn_route and ``fold`` ffn_folds, for a measurement."""
    m = x2.shape[0]
    out = torch.empty_like(x2)
    kernel = kernel or _route(x2, gate_up, down, "dense")
    mr = 1 if m == 1 else MMA_BM if kernel in ("mma", "split") else FIRST_MR
    return ffn_launcher(x2, lift(gate_up), lift(down), kernel,
                        dense_tiles(m, mr, x2.device), mr, act, out,
                        "dense_w4a8_ffn", one_id(x2.device), fold,
                        "dense"), out


def grouped_launcher(x_sorted, gate_up, down, group_sizes, act="silu",
                     kernel: str | None = None, fold: bool | None = None):
    """(launch, out) of a CUDA grouped_w4a8_ffn call; ``kernel`` ("rows")
    overrides ffn_route and ``fold`` ffn_folds, for a measurement."""
    m = x_sorted.shape[0]
    out = torch.zeros_like(x_sorted)
    kernel = kernel or _route(x_sorted, gate_up, down, "grouped")
    mr = MMA_BM if kernel == "mma" or (kernel == "split" and m >= MMA_MIN_ROWS) \
        else FIRST_MR
    return ffn_launcher(x_sorted, gate_up, down, kernel,
                        grouped_tiles(group_sizes, m, mr), mr, act, out,
                        "grouped_w4a8_ffn", fold=fold, entry="grouped"), out


def gathered_w4a8_ffn(x_rows: torch.Tensor, gate_up: QTensor, down: QTensor,
                      ids: torch.Tensor, act: str = "silu") -> torch.Tensor:
    """Decode MoE FFN: row r through expert ids[r]. [R, K] in x dtype."""
    what = "gathered_w4a8_ffn"
    kdim = x_rows.shape[-1]
    check_ffn(gate_up, down, 3, kdim, act, what)
    _check_x(x_rows, kdim, what)
    if ids.shape != (x_rows.shape[0],):
        raise ValueError(f"{what}: ids must be [R]")
    if device_kind(x_rows, what) == "cpu":
        return gathered_w4a8_ffn_ref(x_rows, gate_up, down, ids, act)
    kernel = _route(x_rows, gate_up, down, "gathered")
    return _counted(what, kernel, *gathered_launcher(
        x_rows, gate_up, down, ids, act, kernel))


def dense_w4a8_ffn(x2: torch.Tensor, gate_up: QTensor, down: QTensor,
                   act: str = "silu") -> torch.Tensor:
    """FFN of one 2-D expert (gate_up [K/2, 2I], down [I/2, K])."""
    what = "dense_w4a8_ffn"
    kdim = x2.shape[-1]
    check_ffn(gate_up, down, 2, kdim, act, what)
    _check_x(x2, kdim, what)
    if device_kind(x2, what) == "cpu":
        return dense_w4a8_ffn_ref(x2, gate_up, down, act)
    kernel = _route(x2, gate_up, down, "dense")
    return _counted(what, kernel, *dense_launcher(x2, gate_up, down, act,
                                                  kernel))


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
    if device_kind(x_sorted, what) == "cpu":
        return grouped_w4a8_ffn_ref(x_sorted, gate_up, down, group_sizes, act)
    kernel = _route(x_sorted, gate_up, down, "grouped")
    return _counted(what, kernel, *grouped_launcher(
        x_sorted, gate_up, down, group_sizes, act, kernel))
