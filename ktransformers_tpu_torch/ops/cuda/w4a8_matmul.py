"""W4A8 matmuls: kernel wrappers (csrc/w4a8_matmul.cu) and their plain
PyTorch versions.

Three kernels, three entries, one per Pallas function they replace in
ktransformers_tpu/ops/pallas/w4a8_matmul.py:
- dense_w4a8_matmul: x [M, K] @ W [K/2, N] (dense projections),
- gathered_w4a8_matmul: row r through expert ids[r] of W [E, K/2, N]
  (decode MoE experts the fused FFN kernels refuse),
- grouped_w4a8_matmul: rows sorted by expert with group sizes; rows past
  sum(group_sizes) come back zero (prefill MoE, likewise).
Weights are offset-lo int4 (one group of all K), int4_g or int4_gz (the
zero term - xsum * z of each scale group, csrc/w4a8_core.cuh); every
kernel below takes all three.
``route`` picks the kernel of a call by a fixed rule: w4a8_gemv_kernel
(split-K GEMV, tiles keyed by expert) for one-row dense calls and every
gathered call of up to GEMV_MAX_ROWS rows; w4a8_mma_kernel (s8 tensor
cores, tiles of MMA_BM rows) for dense and grouped calls of at least
MMA_MIN_ROWS rows at groups of 128, 96, 32 and 16 and at one group of all
K (``mma_takes``); w4a8_rows_kernel (the first version, __dp4a) for the
shapes those refuse. ``gemv_folds`` and ``folds`` say
whether the kernel quantizes x itself (the activation prep of
quant/w4a8.py:w4a8_prep folded in: no prep launch, no code tensors) or
reads the codes of one kt_w4a8_prep launch: the GEMV where a block
quantizes at most FOLD_MAX_UNITS (row, group) units, the tensor-core
kernel at up to MMA_FOLD_MAX_ROWS rows; the first version never. Bound on
the card at decode: the weight bytes of
the experts the rows use (K/2 * N int8 + ng * N f32 scales each); see the
source notes in csrc/w4a8_gemv.cuh and csrc/w4a8_mma.cuh.

Also holds what the other wrappers share: the row-tile maps (a tile is up
to ``mr`` rows that use one expert), the plain W4A8 group dot, the SM count
and the split kernels' scratch.
"""

from __future__ import annotations

import dataclasses

import torch

from ktransformers_tpu_torch.ops.cuda import LAUNCHES, ROUTED_LAUNCHES
from ktransformers_tpu_torch.ops.cuda import _build
from ktransformers_tpu_torch.quant.formats import QTensor
from ktransformers_tpu_torch.quant.w4a8 import W4A8_KINDS, w4a8_prep

_DENSE_TILES: dict = {}

# w4a8_mma_kernel: tiles of MMA_BM rows, from MMA_MIN_ROWS rows on (on the
# H100 it beats the first version at every M measured from 2 up, as
# chip_smoke.py's kernel phase shows), for the group sizes it is built for
MMA_BM = 64
MMA_MIN_ROWS = 2
MMA_GROUPS = (16, 32, 96, 128)
# w4a8_mma_kernel quantizes x itself at up to this many rows, where its A
# tile (the rows rounded up to 16, every scale group) fits beside its ring
# of MMA_STAGES groups: each of its blocks quantizes the tile again, which
# the ring's first copies hide at a few rows and which costs more than the
# prep launch it saves from 5 rows on (the crossover on the H100:
# ops/cuda/fold_sweep.py and chip_smoke.py time both on the same operands)
MMA_FOLD_MAX_ROWS = 4
MMA_STAGES = 4
# the shared memory a block may take on the H100 (227 KB)
SMEM_MAX = 232448
# the largest scale group a kernel quantizes itself (two values a lane of
# each half group: csrc/w4a8_core.cuh:prep_units)
FOLD_MAX_GROUP = 128
# a folded GEMV block quantizes at most this many (row, scale group) units
# of its split: one round of its four warps, four units each
# (csrc/w4a8_gemv.cuh:split_acts); more outlast the prep launch they save
FOLD_MAX_UNITS = 16
# w4a8_gemv_kernel: blocks of GEMV_BN columns and GEMV_LANES row lanes,
# storage rows in units of GEMV_UNIT (one 16-byte load a thread each), at
# most GEMV_MAX_ROWS rows a call (one id a thread of the tile scan); the
# split count aims at GEMV_BLOCKS_PER_SM blocks an SM
GEMV_BN = 256
GEMV_LANES = 8
GEMV_UNIT = 8
GEMV_MAX_ROWS = 128
GEMV_BLOCKS_PER_SM = 2


def group_of(w: QTensor) -> int:
    """The scale group of a W4A8 weight: group_size, or all of K for a
    per-channel int4 weight (group_size 0)."""
    return w.group_size or w.in_features


def mma_takes(group_size: int, kdim: int | None = None) -> bool:
    """Whether w4a8_mma_kernel takes a scale group (csrc/w4a8_mma.cuh:
    launch_mma): 128 and 96 (a stage a group), 32 and 16 (stages of 32
    bytes of K: K a multiple of 64), or one group of all K (per-channel,
    its int sums over every stage; ``kdim`` given)."""
    if group_size in (96, 128):
        return True
    if group_size in (16, 32):
        return kdim is None or kdim % 64 == 0
    return kdim is not None and group_size == kdim and kdim % 32 == 0


def mma_wide(group_size: int, kdim: int) -> bool:
    """A group the tensor-core kernel takes as one group of all K (its WIDE
    stages): such a call reads a prep launch's codes, never folds."""
    return group_size == kdim and group_size not in MMA_GROUPS


def gemv_takes(rows: int, group_size: int, n: int) -> bool:
    """Whether w4a8_gemv_kernel takes a call of ``rows`` rows: N a multiple
    of 16 (16-byte loads) and a scale group of whole 8-row units."""
    return (rows <= GEMV_MAX_ROWS and n % 16 == 0
            and (group_size // 2) % GEMV_UNIT == 0)


def route(m: int, entry: str, group_size: int, n: int,
          kdim: int | None = None) -> str:
    """The kernel of a CUDA call: "gemv" (w4a8_gemv_kernel), "mma"
    (w4a8_mma_kernel) or "rows" (w4a8_rows_kernel). ``entry`` is "dense",
    "gathered" or "grouped"; m the rows of x; group_size the weight's scale
    group (group_of: K for per-channel int4), ``kdim`` its K. The activation
    codes are integers, so float32 and bf16 x take the same kernel."""
    if entry == "gathered" or (entry == "dense" and m == 1):
        return "gemv" if gemv_takes(m, group_size, n) else "rows"
    if m < MMA_MIN_ROWS or not mma_takes(group_size, kdim) or n % 16:
        return "rows"
    return "mma"


def fold_rows(m: int) -> int:
    """Rows of the A tile a folded tensor-core launch of m rows quantizes
    into: a tile's rows (at most MMA_BM) rounded up to 16."""
    return min(MMA_BM, -(-m // 16) * 16)


def fold_bytes(arows: int, kdim: int, group_size: int,
               zeros: bool = False) -> int:
    """Shared memory of a folded A tile (csrc/w4a8_mma.cuh:fold_bytes): qa
    and qb rows of K/2 bytes (an odd number of 16-byte chunks) and sa, sb,
    t (and xs, with zero points) per row and scale group."""
    k2 = kdim // 2
    ld = k2 if (k2 // 16) % 2 else k2 + 16
    return 2 * arows * ld + (16 if zeros else 12) * arows * (kdim // group_size)


def stage_bytes(group_size: int, bn: int, zeros: bool = False) -> int:
    """Shared memory of a folded ring stage (csrc/w4a8_mma.cuh:Shape, and
    w4a8_ffn.cu's): KC bytes of K of bn weight columns (a group at 128 and
    96, 32 bytes at 32 and 16) and each of its groups' s (and z) columns."""
    gs2 = group_size // 2
    kc = 32 if gs2 < 32 else gs2
    return kc * bn + (kc // gs2) * (8 if zeros else 4) * bn


def mma_fold_fits(m: int, kdim: int, group_size: int, stages: int,
                  bn: int, limit: int = SMEM_MAX,
                  zeros: bool = False) -> bool:
    """Whether a folded A tile of m rows fits beside a tensor-core ring of
    ``stages`` stages of bn columns (stage_bytes) within ``limit`` bytes of
    shared memory."""
    ring = stages * stage_bytes(group_size, bn, zeros)
    return ring + fold_bytes(fold_rows(m), kdim, group_size,
                             zeros) <= limit


def folds(kernel: str, m: int, kdim: int, group_size: int,
          zeros: bool = False) -> bool:
    """Whether a CUDA call [m, kdim] routed to the tensor-core kernel
    (kernel "mma") folds the activation prep in, quantizing x inside the
    kernel (no w4a8_prep launch): at up to MMA_FOLD_MAX_ROWS rows, at
    scale groups of up to FOLD_MAX_GROUP that it takes as groups (not one
    group of all K), where its A tile leaves room for two blocks an SM (at
    K = 2048; not at K = 10944). The first version never folds; the GEMV's
    rule is gemv_folds. A pure function of the shape, as the route is."""
    return (kernel == "mma" and m <= MMA_FOLD_MAX_ROWS
            and group_size <= FOLD_MAX_GROUP
            and not mma_wide(group_size, kdim)
            and mma_fold_fits(m, kdim, group_size, MMA_STAGES, 64,
                              SMEM_MAX // 2 - 1024, zeros))


def gemv_folds(rb: int, ng: int, splits: int, group_size: int) -> bool:
    """Whether a split-K GEMV launch (w4a8_gemv_kernel, w4a8_ffn_gemv_kernel)
    of tiles of rb rows and ``splits`` splits of ng scale groups folds the
    prep in: at groups of up to FOLD_MAX_GROUP, where a block quantizes at
    most FOLD_MAX_UNITS (row, group) units, rb * ceil(ng / splits). A pure
    function of the shape and the SM count, as its plan is."""
    return (group_size <= FOLD_MAX_GROUP
            and rb * -(-ng // splits) <= FOLD_MAX_UNITS)


def gemv_call_folds(n: int, rows: int, experts: int, kdim: int,
                    group_size: int, sms: int) -> bool:
    """gemv_folds of a w4a8_gemv_kernel call of ``rows`` rows over
    ``experts`` experts of [K/2, N] (a dense call: rows = experts = 1)."""
    rb = gemv_rows_per_chunk(rows, experts)
    splits, gran = w4a8_gemv_plan(n, gemv_tile_count(rows, experts, rb),
                                  kdim // 2, group_size // 2, sms)
    return (gran * GEMV_UNIT == group_size // 2
            and gemv_folds(rb, kdim // group_size, splits, group_size))


_SMS: dict = {}


def sm_count(device) -> int:
    key = str(device)
    if key not in _SMS:
        _SMS[key] = torch.cuda.get_device_properties(
            device).multi_processor_count
    return _SMS[key]


_SCRATCH: dict = {}


def scratch(device, floats: int, counters: int, what: str):
    """(f32 partials, int32 counters) of at least the sizes asked, kept per
    device and kernel. The counters are zero between launches: the kernel
    that uses them sets them back; a grown set is allocated with zeros and
    replaces the smaller one here. A captured CUDA graph replays into the
    sets it saw, so it holds them (scratch_sets, engine/cuda_graph.py)."""
    key = (str(device), what)
    buf = _SCRATCH.get(key)
    if buf is None or buf[0].numel() < floats or buf[1].numel() < counters:
        old = (0, 0) if buf is None else (buf[0].numel(), buf[1].numel())
        buf = (torch.empty(max(floats, old[0]), dtype=torch.float32,
                           device=device),
               torch.zeros(max(counters, old[1]), dtype=torch.int32,
                           device=device))
        _SCRATCH[key] = buf
    return buf


def scratch_sets() -> tuple:
    """Every scratch set that scratch() hands out now."""
    return tuple(_SCRATCH.values())


def split_k_plan(blocks: int, k2: int, gs2: int,
                 sms: int) -> tuple[int, int]:
    """(splits, gran) of a split-K W4A8 GEMV launch of ``blocks`` blocks a
    split: the K/2 storage rows are cut into ``splits`` runs of whole scale
    groups (gran = gs2 / GEMV_UNIT units, 64 storage rows at group 128, 48
    at 96) so that blocks x splits reaches GEMV_BLOCKS_PER_SM blocks an SM,
    at least one group a split. One group of all K wider than a fold
    (per-channel int4) is cut inside the group, in whole units (gran 1):
    a run's int dots times the row scales are its share of the group's
    value, and the kernel takes t and the zero term once (the lane that
    holds the group's first unit)."""
    groups = k2 // gs2
    want = -(-GEMV_BLOCKS_PER_SM * sms // blocks)
    if groups == 1 and 2 * gs2 > FOLD_MAX_GROUP:
        return max(1, min(want, k2 // GEMV_UNIT)), 1
    return max(1, min(want, groups)), gs2 // GEMV_UNIT


def w4a8_gemv_plan(n: int, ntiles: int, k2: int, gs2: int,
                   sms: int) -> tuple[int, int]:
    """split_k_plan of a w4a8_gemv_kernel launch: (column blocks of
    GEMV_BN x tiles) blocks a split; ntiles is the static tile count
    (gemv_tile_count)."""
    return split_k_plan(-(-n // GEMV_BN) * ntiles, k2, gs2, sms)


def gemv_split_rows(k2: int, splits: int, gran: int) -> list:
    """The storage rows [start, end) of each split, as the kernel cuts
    them."""
    g = k2 // GEMV_UNIT // gran
    step = GEMV_UNIT * gran
    return [(step * (g * s // splits), step * (g * (s + 1) // splits))
            for s in range(splits)]


def gemv_rows_per_chunk(rows: int, experts: int) -> int:
    """Rows a w4a8_gemv_kernel tile takes (its RB): 1 where the rows are at
    most the experts (at decode most experts get one row), 2 where experts
    must repeat."""
    return 1 if rows <= experts else 2


def gemv_tile_count(rows: int, experts: int, rb: int) -> int:
    """Static tile count of a w4a8_gemv_kernel launch: at least the number
    of (expert, chunk of rb rows) pairs of any routing of ``rows`` rows over
    ``experts`` experts, sum ceil(n_e / rb) <= (rows + d (rb - 1)) / rb for
    d <= min(rows, experts) distinct experts; tiles past the pairs exit."""
    return (rows + min(rows, experts) * (rb - 1)) // rb


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


def sorted_row_experts(group_sizes: torch.Tensor, m: int) -> torch.Tensor:
    """Expert of each of m rows sorted by expert (group_sizes [E]): int64
    [m], -1 for the rows past sum(group_sizes), found on the device with no
    host sync. What the plain versions of the grouped kernels and
    ops/moe.py's plain products walk."""
    ends = torch.cumsum(group_sizes.to(torch.int64), 0)
    rows = torch.arange(m, device=group_sizes.device)
    row_expert = torch.searchsorted(ends, rows, right=True)
    return torch.where(row_expert < group_sizes.shape[0], row_expert,
                       torch.full_like(row_expert, -1))


def lift(w: QTensor) -> QTensor:
    """A 2-D weight as a 1-expert 3-D one (views)."""
    return dataclasses.replace(
        w, data=w.data[None], scales=w.scales[None],
        zeros=None if w.zeros is None else w.zeros[None])


def check_w4a8_weight(w: QTensor, ndim: int, what: str) -> int:
    """Raise unless w is a W4A8-ready int4 / int4_g / int4_gz weight (its
    zero points, where it has them, shaped as its scales); returns gs/2
    (gs = group_of(w))."""
    if not isinstance(w, QTensor):
        raise TypeError(f"{what}: weight must be a QTensor")
    if w.kind not in W4A8_KINDS or not w.act_quant:
        raise ValueError(
            f"{what}: needs offset-lo int4 weights "
            f"(kind={w.kind}, act_quant={w.act_quant})"
        )
    if (w.zeros is not None) != (w.kind == "int4_gz"):
        raise ValueError(f"{what}: {w.kind} weights "
                         f"{'need' if w.kind == 'int4_gz' else 'take no'} "
                         "zero points")
    if w.data.dtype != torch.int8 or w.data.dim() != ndim:
        raise ValueError(f"{what}: want int8 data of rank {ndim}, got "
                         f"{w.data.dtype} {tuple(w.data.shape)}")
    gs = group_of(w)
    if gs <= 0 or gs % 8:
        raise ValueError(f"{what}: group size {gs} must be a multiple of 8")
    k = w.in_features
    if k % gs:
        raise ValueError(f"{what}: K={k} is not a multiple of group {gs}")
    ng = k // gs
    want = (*w.data.shape[:-2], ng, w.out_features)
    for name in ("scales", "zeros"):
        v = getattr(w, name)
        if v is None and name == "zeros":
            continue
        if v is None or tuple(v.shape) != want:
            raise ValueError(f"{what}: {name} must be {want}")
        if v.dtype != torch.float32:
            raise ValueError(f"{what}: {name} must be float32")
    if w.out_features % 4:
        raise ValueError(f"{what}: N={w.out_features} must be a multiple of 4")
    return gs // 2


def device_kind(x: torch.Tensor, what: str) -> str:
    """"cpu" (the wrapper takes its plain version) or "cuda" (it launches);
    raises for any other device."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {x.device}")
    return x.device.type


def weight_tensors(w: QTensor) -> tuple:
    """The device tensors of a W4A8 weight: data, scales and its zero
    points where it has them."""
    return (w.data, w.scales) + (() if w.zeros is None else (w.zeros,))


def check_cuda_operands(what: str, device, *tensors) -> None:
    for t in tensors:
        if t.device != device:
            raise ValueError(f"{what}: operands on {t.device} and {device}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: operands must be contiguous")


def w4a8_group_dot(qa, qb, sa, sb, t, wdata, scales, gs2: int,
                   xsum=None, zeros=None):
    """Plain W4A8 product for one weight [K/2, N]: float32 [M, N].

    The int8 dots run as float32 matmuls, exact because every partial sum
    is an integer below 2^24 (gs/2 * 127 * 128 < 2^24), or as float64 ones
    where a group is wider (per-channel int4: exact below 2^53), each
    rounded once to float32 as the kernels' int32 sums are; groups are
    added in order like _w4a8_group_acc. ``zeros`` [ng, N] (int4_gz) with
    ``xsum`` [M, ng]: each group's value less xsum * z."""
    m, k2 = qa.shape
    n = wdata.shape[-1]
    ng = k2 // gs2
    dot = torch.float32 if gs2 * 127 * 128 < 2**24 else torch.float64
    braw = wdata.to(dot).reshape(ng, gs2, n)
    u = (wdata & 15).to(dot).reshape(ng, gs2, n)
    pa = torch.einsum("mgj,gjn->mgn", qa.to(dot).reshape(m, ng, gs2),
                      u).to(torch.float32)
    pb = torch.einsum("mgj,gjn->mgn", qb.to(dot).reshape(m, ng, gs2),
                      braw).to(torch.float32)
    val = pa * sa[:, :, None] + pb * sb[:, :, None] - t[:, :, None]
    if zeros is not None:
        val = val - xsum[:, :, None] * zeros[None]
    acc = torch.zeros(m, n, dtype=torch.float32, device=qa.device)
    for g in range(ng):
        acc = acc + val[:, g] * scales[g]
    return acc


def w4a8_matmul_ref(x2: torch.Tensor, w: QTensor) -> torch.Tensor:
    """Plain version of dense_w4a8_matmul: x2 [M, K] -> [M, N] x2.dtype."""
    kdim = x2.shape[1]
    qa, qb, sa, sb, t, xs = w4a8_prep(x2, kdim, w.group_size)
    y = w4a8_group_dot(qa, qb, sa, sb, t, w.data, w.scales,
                       group_of(w) // 2, xs, w.zeros)
    return y.to(x2.dtype)


def _check_x(x: torch.Tensor, kdim: int, what: str) -> None:
    if x.dim() != 2 or x.shape[1] != kdim:
        raise ValueError(f"{what}: x must be [M, {kdim}], got {tuple(x.shape)}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{what}: x must be float32 or bfloat16")


X_DTYPES = {torch.float32: 1, torch.bfloat16: 2}  # the entries' x_dtype


def act_args(acts) -> tuple:
    """The activation arguments of a kernel entry (qa, qb, sa, sb, t, x,
    x_dtype): the codes of a prep launch (a tuple of five tensors, or six
    with the group sums xs: zero_args passes those), or the rows x
    themselves (a tensor) for a launch that folds the prep in."""
    if isinstance(acts, torch.Tensor):
        return (None,) * 5 + (acts.data_ptr(), X_DTYPES[acts.dtype])
    return tuple(v.data_ptr() for v in acts[:5]) + (None, 0)


def zero_args(acts, w: QTensor) -> tuple:
    """The zero-term arguments of a kernel entry (xs, z): the group sums of
    a prep launch's codes (the sixth tensor; none where the launch folds
    the prep in) and the weight's zero points, or (None, None) without
    them."""
    if w.zeros is None:
        return None, None
    xs = None if isinstance(acts, torch.Tensor) else acts[5].data_ptr()
    return xs, w.zeros.data_ptr()


def activations(x2: torch.Tensor, kdim: int, group_size: int, fold: bool,
                xsum: bool = False):
    """What a CUDA launch reads: x2 itself where it folds the prep in, else
    the codes of one prep launch (with the group sums where ``xsum``: a
    weight with zero points)."""
    return x2 if fold else prep_activations(x2, kdim, group_size, xsum)


def launch_mma(what, acts, w: QTensor, tiles, out):
    """Launch w4a8_mma_kernel (kt_w4a8_mma) on ``acts`` (act_args: x folds
    the prep in, into an A tile of fold_rows rows)."""
    te, tr0, trs = tiles
    k2, n = w.data.shape[-2], w.data.shape[-1]
    gs2 = group_of(w) // 2
    arows = fold_rows(out.shape[0]) if isinstance(acts, torch.Tensor) else 0
    err = _build.lib("w4a8_matmul").kt_w4a8_mma(
        *act_args(acts), w.data.data_ptr(), w.scales.data_ptr(),
        te.data_ptr(), tr0.data_ptr(), trs.data_ptr(),
        te.shape[0], arows, k2, n, k2 // gs2, gs2,
        int(out.dtype == torch.bfloat16), out.data_ptr(),
        *zero_args(acts, w),
        torch.cuda.current_stream(out.device).cuda_stream,
    )
    _build.check(err, what)


_ONE_ID: dict = {}


def gemv_launcher(what, x, w: QTensor, ids: torch.Tensor, out,
                  fold: bool | None = None):
    """Checks a CUDA call on a 3-D weight w [E, K/2, N] with row r of x
    through expert ids[r] (a dense call: ids = [0] on one expert); returns
    launch(), which runs only w4a8_gemv_kernel (kt_w4a8_gemv, split by
    w4a8_gemv_plan) and writes ``out`` [R, N]. x is the rows (the kernel
    quantizes them itself where ``fold``, default gemv_folds, else one prep
    launch here makes their codes) or the codes themselves (a tuple: the
    FFN's down)."""
    e, k2, n = w.data.shape
    gs = group_of(w)
    gs2 = gs // 2
    r = ids.shape[0]
    if not gemv_takes(r, gs, n):
        raise ValueError(f"{what}: the GEMV takes at most {GEMV_MAX_ROWS} "
                         f"rows, N a multiple of 16 and a group of 16s "
                         f"(rows={r}, N={n}, group={gs})")
    if any(p is not None and p.data_ptr() % 16
           for p in (w.data, w.scales, w.zeros, out)):
        raise ValueError(f"{what}: the GEMV takes 16-byte aligned operands")
    dev = out.device
    ids = ids.to(torch.int32).contiguous()
    rb = gemv_rows_per_chunk(r, e)
    tiles = gemv_tile_count(r, e, rb)
    splits, gran = w4a8_gemv_plan(n, tiles, k2, gs2, sm_count(dev))
    part = cnt = None
    if splits > 1:
        part, cnt = scratch(dev, r * splits * n, -(-n // GEMV_BN) * tiles,
                            "w4a8_gemv")
    if isinstance(x, torch.Tensor):
        if fold is None:
            fold = (gran * GEMV_UNIT == gs2
                    and gemv_folds(rb, k2 // gs2, splits, gs))
        acts = activations(x, w.in_features, gs, fold, w.zeros is not None)
    else:
        acts = x
    fn = _build.lib("w4a8_matmul").kt_w4a8_gemv

    def launch():  # holds acts (and so their memory) while it lives
        err = fn(
            *act_args(acts), w.data.data_ptr(), w.scales.data_ptr(),
            ids.data_ptr(), r, tiles, splits, gran, rb, k2, n, k2 // gs2,
            gs2,
            int(out.dtype == torch.bfloat16),
            None if part is None else part.data_ptr(),
            None if cnt is None else cnt.data_ptr(), out.data_ptr(),
            *zero_args(acts, w),
            torch.cuda.current_stream(dev).cuda_stream,
        )
        _build.check(err, what)

    return launch


def one_id(device) -> torch.Tensor:
    """ids = [0] on ``device``: a dense call's one tile for the GEMV."""
    key = str(device)
    if key not in _ONE_ID:
        _ONE_ID[key] = torch.zeros(1, dtype=torch.int32, device=device)
    return _ONE_ID[key]


def launch_rows(fn, what, prep, w: QTensor, tiles, mr: int, out):
    """Launch a rows kernel (kt_w4a8_rows / kt_w4a8_ffn_down) on the codes
    of a prep launch (with the group sums where w has zero points)."""
    qa, qb, sa, sb, t = prep[:5]
    te, tr0, trs = tiles
    k2, n = w.data.shape[-2], w.data.shape[-1]
    gs2 = group_of(w) // 2
    err = fn(
        qa.data_ptr(), qb.data_ptr(), sa.data_ptr(), sb.data_ptr(),
        t.data_ptr(), w.data.data_ptr(), w.scales.data_ptr(),
        te.data_ptr(), tr0.data_ptr(), trs.data_ptr(),
        te.shape[0], mr, k2, n, k2 // gs2, gs2,
        int(out.dtype == torch.bfloat16), out.data_ptr(),
        *zero_args(prep, w),
        torch.cuda.current_stream(out.device).cuda_stream,
    )
    _build.check(err, what)


# the widest group w4a8_prep_kernel takes (a warp a (row, group)); wider
# ones (per-channel int4) prep on w4a8_prep_block_kernel, a block a (row,
# group) (csrc/w4a8_matmul.cu:launch_prep)
PREP_WARP_MAX_GROUP = 512


def prep_activations(x2: torch.Tensor, kdim: int, group_size: int,
                     xsum: bool = False):
    """(qa, qb, sa, sb, t) of w4a8_prep for x2 [M, K], and xsum where asked
    (the zero term's group sums): the plain version on the CPU, one launch
    of kt_w4a8_prep (csrc/w4a8_matmul.cu) on the card. group_size 0 is one
    group of all K (per-channel int4).

    The prep is plain XLA in the JAX package (quant/w4a8.py:w4a8_prep);
    as eager PyTorch it is ~15 small launches per projection."""
    what = "w4a8_prep"
    if x2.device.type == "cpu":
        return w4a8_prep(x2, kdim, group_size)[:6 if xsum else 5]
    if x2.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{what}: x must be float32 or bfloat16")
    check_cuda_operands(what, x2.device, x2)
    m = x2.shape[0]
    gs = group_size or kdim
    ng = kdim // gs
    dev = x2.device
    qa = torch.empty(m, kdim // 2, dtype=torch.int8, device=dev)
    qb = torch.empty_like(qa)
    planes = [torch.empty(m, ng, dtype=torch.float32, device=dev)
              for _ in range(4 if xsum else 3)]
    err = _build.lib("w4a8_matmul").kt_w4a8_prep(
        x2.data_ptr(), m, kdim, gs, int(x2.dtype == torch.bfloat16),
        qa.data_ptr(), qb.data_ptr(), *(v.data_ptr() for v in planes),
        *([] if xsum else [None]),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(err, what)
    LAUNCHES[what] += 1
    if gs > PREP_WARP_MAX_GROUP:
        ROUTED_LAUNCHES["w4a8_prep_block_kernel"] += 1
    return (qa, qb, *planes)


def dense_w4a8_launcher(x2: torch.Tensor, w: QTensor,
                        kernel: str | None = None, fold: bool | None = None):
    """Checks and prepares a CUDA call; returns (launch, out), where
    launch() runs only the kernel on the prepared operands (so a caller
    can time the kernel apart from a prep launch). ``kernel`` ("rows",
    "gemv" or "mma") overrides ``route`` and ``fold`` overrides ``folds`` /
    ``gemv_folds``, for a measurement (the first version never folds)."""
    what = "dense_w4a8_matmul"
    check_cuda_operands(what, x2.device, x2, *weight_tensors(w))
    m = x2.shape[0]
    gs = group_of(w)
    kernel = kernel or route(m, "dense", gs, w.out_features, w.in_features)
    out = torch.empty(m, w.out_features, dtype=x2.dtype, device=x2.device)
    if kernel == "gemv":
        if m != 1:
            raise ValueError(f"{what}: the GEMV takes one row, got {m}")
        return gemv_launcher(what, x2, lift(w), one_id(x2.device), out,
                             fold), out
    if fold is None:
        fold = folds(kernel, m, w.in_features, gs, w.zeros is not None)
    if fold and kernel == "rows":
        raise ValueError(f"{what}: the first version takes no x")
    acts = activations(x2, w.in_features, gs, fold, w.zeros is not None)
    if kernel == "mma":
        tiles = dense_tiles(m, MMA_BM, x2.device)
        return lambda: launch_mma(what, acts, w, tiles, out), out
    mr = 1 if m == 1 else (4 if m <= 4 else 8)
    fn = _build.lib("w4a8_matmul").kt_w4a8_rows
    tiles = dense_tiles(m, mr, x2.device)
    return lambda: launch_rows(fn, what, acts, w, tiles, mr, out), out


def dense_w4a8_matmul(x2: torch.Tensor, w: QTensor) -> torch.Tensor:
    """y = x2 @ W for offset-lo int4 / int4_g / int4_gz W [K/2, N]: [M, N]
    in x2.dtype.

    CUDA tensors launch csrc/w4a8_matmul.cu; CPU tensors take
    w4a8_matmul_ref."""
    what = "dense_w4a8_matmul"
    check_w4a8_weight(w, 2, what)
    _check_x(x2, w.in_features, what)
    if x2.device.type == "cpu":
        return w4a8_matmul_ref(x2, w)
    if x2.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {x2.device}")
    kernel = route(x2.shape[0], "dense", group_of(w), w.out_features,
                   w.in_features)
    return _counted(what, kernel, *dense_w4a8_launcher(x2, w, kernel), w)


KERNEL_NAMES = {"gemv": "w4a8_gemv_kernel", "mma": "w4a8_mma_kernel"}
# the suffix of a W4A8 kernel's instantiation with the zero term in
# ROUTED_LAUNCHES (the C launchers pick it where z is given)
ZP = "<zp>"


def kernel_name(kernel: str, w: QTensor) -> str:
    """The ROUTED_LAUNCHES key of redesigned kernel ``kernel`` ("gemv" or
    "mma") on weight w."""
    return KERNEL_NAMES[kernel] + (ZP if w.zeros is not None else "")


def _counted(what: str, kernel: str, launch, out: torch.Tensor,
             w: QTensor) -> torch.Tensor:
    launch()
    LAUNCHES[what] += 1
    if kernel in KERNEL_NAMES:
        ROUTED_LAUNCHES[kernel_name(kernel, w)] += 1
    return out


GROUPED_MR = 8  # rows per tile of a grouped call on w4a8_rows_kernel


def w4a8_rows_ref(x_rows: torch.Tensor, w: QTensor,
                  row_expert: torch.Tensor) -> torch.Tensor:
    """Plain version of the gathered and grouped entries: row r of x_rows
    [R, K] through expert row_expert[r] of w [E, K/2, N] (-1: none, the
    output row is zero), the activations quantized per row and scale group
    by w4a8_prep. [R, N] in x_rows.dtype."""
    kdim = x_rows.shape[1]
    qa, qb, sa, sb, t, xs = w4a8_prep(x_rows, kdim, w.group_size)
    out = torch.zeros(x_rows.shape[0], w.out_features, dtype=torch.float32,
                      device=x_rows.device)
    for e in torch.unique(row_expert).tolist():
        if e < 0:
            continue
        idx = torch.nonzero(row_expert == e).flatten()
        out[idx] = w4a8_group_dot(
            qa[idx], qb[idx], sa[idx], sb[idx], t[idx], w.data[e],
            w.scales[e], group_of(w) // 2, xs[idx],
            None if w.zeros is None else w.zeros[e])
    return out.to(x_rows.dtype)


def gathered_w4a8_matmul_ref(x_rows, w: QTensor, ids) -> torch.Tensor:
    return w4a8_rows_ref(x_rows, w, ids.to(torch.int64))


def grouped_w4a8_matmul_ref(x_sorted, w: QTensor, group_sizes) -> torch.Tensor:
    return w4a8_rows_ref(x_sorted, w, sorted_row_experts(
        group_sizes.to(x_sorted.device), x_sorted.shape[0]))


def rows_launcher(x_rows: torch.Tensor, w: QTensor, tiles, mr: int,
                  out: torch.Tensor, what: str):
    """Checks a CUDA call on a 3-D weight and preps its activations (one
    w4a8_prep launch); returns launch(), which runs only the kernel and
    writes ``out`` [R, N]."""
    check_cuda_operands(what, x_rows.device, x_rows, *weight_tensors(w))
    prep = prep_activations(x_rows, w.in_features, w.group_size,
                            w.zeros is not None)
    fn = _build.lib("w4a8_matmul").kt_w4a8_rows
    return lambda: launch_rows(fn, what, prep, w, tiles, mr, out)


def gathered_launcher(x_rows: torch.Tensor, w: QTensor, ids: torch.Tensor,
                      kernel: str | None = None, fold: bool | None = None):
    what = "gathered_w4a8_matmul"
    out = torch.empty(x_rows.shape[0], w.out_features, dtype=x_rows.dtype,
                      device=x_rows.device)
    kernel = kernel or route(x_rows.shape[0], "gathered", group_of(w),
                             w.out_features, w.in_features)
    if kernel == "gemv":
        check_cuda_operands(what, x_rows.device, x_rows, *weight_tensors(w),
                            ids)
        return gemv_launcher(what, x_rows, w, ids, out, fold), out
    if fold:
        raise ValueError(f"{what}: the first version takes no x")
    return rows_launcher(x_rows, w, row_tiles(ids), 1, out, what), out


def grouped_launcher(x_sorted: torch.Tensor, w: QTensor,
                     group_sizes: torch.Tensor, kernel: str | None = None,
                     fold: bool | None = None):
    what = "grouped_w4a8_matmul"
    m = x_sorted.shape[0]
    out = torch.zeros(m, w.out_features, dtype=x_sorted.dtype,
                      device=x_sorted.device)
    gs = group_of(w)
    kernel = kernel or route(m, "grouped", gs, w.out_features, w.in_features)
    if kernel == "mma":
        check_cuda_operands(what, x_sorted.device, x_sorted,
                            *weight_tensors(w))
        if fold is None:
            fold = folds(kernel, m, w.in_features, gs, w.zeros is not None)
        acts = activations(x_sorted, w.in_features, gs, fold,
                           w.zeros is not None)
        tiles = grouped_tiles(group_sizes, m, MMA_BM)
        return lambda: launch_mma(what, acts, w, tiles, out), out
    if fold:
        raise ValueError(f"{what}: the first version takes no x")
    tiles = grouped_tiles(group_sizes, m, GROUPED_MR)
    return rows_launcher(x_sorted, w, tiles, GROUPED_MR, out, what), out


def gathered_w4a8_matmul(x_rows: torch.Tensor, w: QTensor,
                         ids: torch.Tensor) -> torch.Tensor:
    """Decode MoE matmul on int8 dots: row r of x_rows [R, K] through
    expert ids[r] of the offset-lo int4 weight w [E, K/2, N]; only the
    routed experts' bytes are read, once however many rows share an expert
    (the GEMV's tiles are keyed by expert). [R, N] in x_rows.dtype.

    CUDA tensors launch csrc/w4a8_matmul.cu (the GEMV quantizes x
    itself); CPU tensors take gathered_w4a8_matmul_ref."""
    what = "gathered_w4a8_matmul"
    check_w4a8_weight(w, 3, what)
    _check_x(x_rows, w.in_features, what)
    if ids.shape != (x_rows.shape[0],):
        raise ValueError(f"{what}: ids must be [R]")
    if device_kind(x_rows, what) == "cpu":
        return gathered_w4a8_matmul_ref(x_rows, w, ids)
    kernel = route(x_rows.shape[0], "gathered", group_of(w), w.out_features,
                   w.in_features)
    return _counted(what, kernel, *gathered_launcher(x_rows.contiguous(), w,
                                                     ids, kernel), w)


def grouped_w4a8_matmul(x_sorted: torch.Tensor, w: QTensor,
                        group_sizes: torch.Tensor) -> torch.Tensor:
    """Prefill MoE matmul on int8 dots over rows x_sorted [M, K] sorted by
    expert (group_sizes [E]); rows past sum(group_sizes) come back zero.
    [M, N] in x_sorted.dtype. Tiles of MMA_BM rows of one expert (of
    GROUPED_MR on the first version) share each weight read."""
    what = "grouped_w4a8_matmul"
    check_w4a8_weight(w, 3, what)
    _check_x(x_sorted, w.in_features, what)
    if group_sizes.shape != (w.data.shape[0],):
        raise ValueError(f"{what}: group_sizes must be [E]")
    if device_kind(x_sorted, what) == "cpu":
        return grouped_w4a8_matmul_ref(x_sorted, w, group_sizes)
    kernel = route(x_sorted.shape[0], "grouped", group_of(w),
                   w.out_features, w.in_features)
    return _counted(what, kernel, *grouped_launcher(
        x_sorted.contiguous(), w, group_sizes, kernel), w)
