"""The rules and maps of the W4A8 GEMV (w4a8_gemv_kernel) and of the FFN's
tensor-core gate_up (w4a8_ffn_mma_kernel), and plain emulations of both
kernels' walks held against the JAX package's Pallas kernels (interpret
mode).

The CUDA kernels run only on the card (tests/test_torch_cuda.py and
chip_smoke.py hold them to the plain versions there). What these tests
hold on the CPU:
- the route tables of ops/cuda/w4a8_matmul.route and
  ops/cuda/w4a8_ffn.ffn_route (pure functions of the shapes);
- the GEMV's split plan: splits of whole scale groups (64 storage rows at
  group 128, 48 at 96), every storage row in exactly one split and one
  row lane;
- the GEMV's tiles keyed by expert: tile j takes the j-th distinct id (in
  order of first appearance) and every row routed to it, which is what
  the kernel's scan of ids computes (tile_rows in csrc/w4a8_gemv.cuh);
- the kernels' arithmetic in their order: per lane a group's int dots,
  scaled once, t subtracted by the lane holding the group's first unit,
  the lanes and then the splits summed in order (the GEMV); the 64-row
  tile map, one down group of 128 columns a block, groups added in order,
  GLU and requant, then the down on the same tiles (the FFN).

Tolerances, as a share of the reference's largest magnitude:
- 1e-4 for the GEMV against the Pallas kernels, as
  tests/test_torch_kernels.py: both sides run the same integer dots
  exactly and differ in the order of float32 sums (the GEMV's per-lane
  partial scaling is one more such reordering);
- 1e-4 for the FFN walk against the port's plain version, which adds the
  groups in the same order (the two agree to the bit at these shapes);
- 1e-2 for the FFN walk against the Pallas kernels: their float32 sums run
  in another order, which can move an int8 code of the requant by one step
  (1/127 of its group's largest value), as tests/test_torch_cuda.py
  states for the FFN kernels.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ktransformers_tpu.ops.pallas import w4a8_matmul as jwm
from ktransformers_tpu.quant.formats import quantize as j_quantize
from ktransformers_tpu.quant.w4a8 import repack_offset_lo as j_repack
from ktransformers_tpu_torch.convert import qtensor_from_jax
from ktransformers_tpu_torch.ops.cuda import w4a8_ffn as F
from ktransformers_tpu_torch.ops.cuda import w4a8_matmul as MM
from ktransformers_tpu_torch.quant.w4a8 import w4a8_prep
from tests.test_torch_model import one_torch_thread  # noqa: F401

TOL = 1e-4
FFN_TOL = 1e-2


def _rel(out, ref):
    out, ref = np.asarray(out, np.float32), np.asarray(ref, np.float32)
    return float(np.abs(out - ref).max() / np.abs(ref).max())


def _w4a8(rng, shape, group_size):
    w = jnp.asarray(rng.standard_normal(shape).astype(np.float32) * 0.1)
    jq = j_repack(j_quantize(w, "int4_g", group_size=group_size))
    return jq, qtensor_from_jax(jax.device_get(jq), "cpu")


# ------------------------------------------------------------ route tables


@pytest.mark.parametrize("m, entry, group, n, want", [
    (1, "dense", 128, 3648, "gemv"), (1, "dense", 96, 2048, "gemv"),
    (1, "dense", 128, 3640, "rows"),            # N % 16 != 0
    (1, "dense", 8, 2048, "rows"),              # a group of 4 storage rows
    (2, "dense", 128, 3648, "mma"), (64, "dense", 96, 2048, "mma"),
    (520, "dense", 128, 3648, "mma"), (520, "dense", 128, 3640, "rows"),
    (1, "gathered", 128, 28672, "gemv"), (2, "gathered", 128, 4096, "gemv"),
    (64, "gathered", 96, 2048, "gemv"), (520, "gathered", 128, 4096, "rows"),
    (128, "gathered", 128, 4096, "gemv"), (129, "gathered", 128, 4096, "rows"),
    (1, "grouped", 128, 2816, "rows"), (520, "grouped", 96, 2816, "mma"),
])
def test_w4a8_route_table(m, entry, group, n, want):
    """One-row dense calls and gathered calls of up to GEMV_MAX_ROWS rows
    take the GEMV where N is a multiple of 16 and a scale group holds whole
    8-row units; dense and grouped calls of two rows on take the tensor
    cores at group 96 or 128; the rest keep the first version."""
    assert MM.GEMV_MAX_ROWS == 128 and MM.GEMV_UNIT == 8
    assert MM.route(m, entry, group, n) == want


@pytest.mark.parametrize("m, entry, gs_up, gs_dn, inter, kdim, want", [
    (1, "dense", 128, 128, 2816, 2048, "gemv"),    # decode shared experts
    (6, "gathered", 128, 128, 1408, 2048, "gemv"),  # decode routed experts
    (48, "gathered", 128, 128, 1408, 2048, "gemv"),
    (1, "dense", 128, 128, 2816, 2040, "rows"),     # K % 16 != 0
    (2, "dense", 128, 128, 2816, 2048, "mma"),
    (8, "dense", 96, 128, 2816, 2048, "mma"),
    (520, "dense", 128, 128, 2816, 2048, "mma"),
    (1536, "grouped", 128, 128, 1408, 2048, "mma"),
    (3120, "grouped", 96, 128, 1408, 2048, "mma"),
    (64, "dense", 64, 128, 2816, 2048, "rows"),     # gate_up group 64
    (64, "dense", 128, 64, 2816, 2048, "rows"),     # down group 64
    (64, "grouped", 128, 128, 1344, 2048, "rows"),  # I % 128 != 0
    (64, "dense", 128, 128, 2816, 2064, "rows"),    # K % 32 != 0
    (1, "grouped", 128, 128, 1408, 2048, "rows"),
])
def test_ffn_route_table(m, entry, gs_up, gs_dn, inter, kdim, want):
    """The FFN's two kernels by a fixed rule: "gemv" (w4a8_ffn_gemv_kernel,
    then the GEMV down) for one-row tiles, "mma" (w4a8_ffn_mma_kernel, then
    w4a8_mma_kernel) from two rows on where both take the groups, the first
    version otherwise."""
    assert F.ffn_route(m, entry, gs_up, gs_dn, inter, kdim) == want


@pytest.mark.parametrize("rows, experts, want", [
    (1, 1, 1), (2, 8, 1), (6, 64, 1), (48, 64, 1), (16, 8, 2), (128, 8, 2)])
def test_gemv_rows_per_chunk(rows, experts, want):
    assert MM.gemv_rows_per_chunk(rows, experts) == want


# ------------------------------------------------------------- split plan

# (N, static tiles, K/2 storage rows, storage rows a group): DeepSeek-V2-Lite
# qkv_a / o_proj / lm_head / layer-0 gate_up / layer-0 down (group 96) at
# M = 1, the FFN's down (K = 1408), Mixtral's gate_up / down at 2 and 16
# rows (8 experts), and small shapes
PLAN_SHAPES = [
    (3648, 1, 1024, 64), (2048, 1, 1024, 64), (102400, 1, 1024, 64),
    (21888, 1, 1024, 64), (2048, 1, 5472, 48), (2048, 6, 704, 64),
    (2048, 48, 704, 64), (28672, 2, 2048, 64), (4096, 2, 7168, 64),
    (28672, 8, 2048, 64), (4096, 8, 7168, 64), (48, 1, 96, 48),
    (96, 5, 128, 16),
]


def _lane_runs(lo: int, hi: int):
    """The units [l0, l1) of each row lane of a split [lo, hi) of storage
    rows, as the kernel cuts them."""
    u0, u1 = lo // MM.GEMV_UNIT, hi // MM.GEMV_UNIT
    return [(u0 + (u1 - u0) * ly // MM.GEMV_LANES,
             u0 + (u1 - u0) * (ly + 1) // MM.GEMV_LANES)
            for ly in range(MM.GEMV_LANES)]


@pytest.mark.parametrize("n, tiles, k2, gs2", PLAN_SHAPES)
def test_w4a8_gemv_plan(n, tiles, k2, gs2):
    """Splits of whole scale groups; every storage row in exactly one split
    and one lane's run; at most one split a group; the grid reaches
    GEMV_BLOCKS_PER_SM blocks an SM where the groups allow, and not much
    more."""
    sms = 132
    splits, gran = MM.w4a8_gemv_plan(n, tiles, k2, gs2, sms)
    groups = k2 // gs2
    assert gran * MM.GEMV_UNIT == gs2 and 1 <= splits <= groups
    spans = MM.gemv_split_rows(k2, splits, gran)
    assert len(spans) == splits and spans[0][0] == 0 and spans[-1][1] == k2
    seen = np.zeros(k2, np.int32)
    for lo, hi in spans:
        assert lo % gs2 == 0 and hi % gs2 == 0 and hi > lo
        for l0, l1 in _lane_runs(lo, hi):
            seen[l0 * MM.GEMV_UNIT:l1 * MM.GEMV_UNIT] += 1
    assert (seen == 1).all()
    blocks = -(-n // MM.GEMV_BN) * tiles
    assert blocks * splits >= MM.GEMV_BLOCKS_PER_SM * sms or splits == groups
    assert splits == 1 or blocks * (splits - 1) < MM.GEMV_BLOCKS_PER_SM * sms


def test_w4a8_gemv_plan_fills_the_card_at_decode():
    """DeepSeek-V2-Lite's qkv_a and o_proj at M = 1 (29 and 16 blocks of the
    first version on 132 SMs) split into every one of their 16 groups;
    layer 0's down (114 groups of 96) into 33 runs; lm_head (400 column
    blocks) into none."""
    assert MM.w4a8_gemv_plan(3648, 1, 1024, 64, 132) == (16, 8)
    assert MM.w4a8_gemv_plan(2048, 1, 1024, 64, 132) == (16, 8)
    assert MM.w4a8_gemv_plan(2048, 1, 5472, 48, 132) == (33, 6)
    assert MM.w4a8_gemv_plan(102400, 1, 1024, 64, 132) == (1, 8)


# ------------------------------------------------- tiles keyed by expert


def kernel_tiles(ids, experts: int):
    """What the kernel's scan of ids gives each of its static tiles:
    (expert, rows) of the j-th (expert, chunk of RB rows) pair, experts in
    order of first appearance and each one's rows in order; (-1, []) past
    the last pair (the tile exits at once)."""
    ids = [int(i) for i in ids]
    rb = MM.gemv_rows_per_chunk(len(ids), experts)
    pairs = []
    for e in dict.fromkeys(ids):
        rows = [r for r, i in enumerate(ids) if i == e]
        pairs += [(e, rows[c:c + rb]) for c in range(0, len(rows), rb)]
    tiles = MM.gemv_tile_count(len(ids), experts, rb)
    assert len(pairs) <= tiles
    return pairs + [(-1, [])] * (tiles - len(pairs))


@pytest.mark.parametrize("ids, experts", [
    ([3, 0, 5, 3, 7, 1, 3], 8),        # repeats
    ([2] * 9, 4),                       # all equal
    ([4], 8),                           # one row
    ([0], 1),                           # a dense call: ids = [0]
    (list(np.random.default_rng(0).integers(0, 8, 128)), 8),
    (list(np.random.default_rng(1).permutation(64)[:6]), 64),
    (list(np.random.default_rng(2).integers(0, 64, 48)), 64),
    (list(np.random.default_rng(3).integers(0, 8, 16)), 8),  # Mixtral, B=8
    ([5] * 128, 8),                     # the most tiles of two rows
])
def test_gemv_tiles_keyed_by_expert(ids, experts):
    """Every row in exactly one tile; a tile's rows share its expert and
    number at most RB; one expert's tiles are neighbours (their blocks run
    together and share the expert's bytes); the live tiles come first and
    fit the static count gemv_tile_count."""
    rb = MM.gemv_rows_per_chunk(len(ids), experts)
    tiles = kernel_tiles(ids, experts)
    assert len(tiles) == MM.gemv_tile_count(len(ids), experts, rb)
    cover = np.zeros(len(ids), np.int32)
    live = [e for e, rows in tiles if e >= 0]
    assert all(e < 0 for e, _ in tiles[len(live):])
    assert [e for e in dict.fromkeys(live)] == list(
        dict.fromkeys(int(i) for i in ids))
    assert all(a == b or b not in live[:k]
               for k, (a, b) in enumerate(zip(live, live[1:]), 1))
    for e, rows in tiles:
        assert (e < 0) == (not rows) and len(rows) <= rb
        for r in rows:
            assert int(ids[r]) == e
            cover[r] += 1
    assert (cover == 1).all()


@pytest.mark.parametrize("rows, experts", [
    (r, e) for r in (1, 2, 6, 16, 48, 128) for e in (1, 8, 64) if r <= 128])
def test_gemv_tile_count_bounds_every_routing(rows, experts):
    """The static tile count is at least the (expert, chunk) pairs of the
    worst routing: as many distinct experts as can be, the rest on one."""
    rb = MM.gemv_rows_per_chunk(rows, experts)
    d = min(rows, experts)
    worst = d - 1 + -(-(rows - d + 1) // rb)  # d - 1 singletons + one heap
    spread = sum(-(-n // rb) for n in np.bincount(
        np.arange(rows) % d, minlength=d))
    assert MM.gemv_tile_count(rows, experts, rb) >= max(worst, spread)


# ----------------------------------------- the GEMV's arithmetic in order


def emulate_gemv(x: np.ndarray, w, ids, splits: int) -> np.ndarray:
    """w4a8_gemv_kernel's walk on the CPU in float32: for each tile (the
    kernel's scan), split and row lane, the lane's int dots of each group
    it touches, scaled once (t only by the lane holding the group's first
    unit); the lanes summed in order, then the splits in order."""
    xt = torch.from_numpy(x)
    qa, qb, sa, sb, t, _ = w4a8_prep(xt, x.shape[1], w.group_size)
    e_n, k2, n = w.data.shape
    gs2 = w.group_size // 2
    gran = gs2 // MM.GEMV_UNIT
    u = (w.data & 15).to(torch.int64)
    braw = w.data.to(torch.int64)
    out = torch.zeros(x.shape[0], n, dtype=torch.float32)
    for e, rows in kernel_tiles(ids, e_n):
        if e < 0:
            continue
        total = torch.zeros(len(rows), n, dtype=torch.float32)
        for lo, hi in MM.gemv_split_rows(k2, splits, gran):
            v = torch.zeros(len(rows), n, dtype=torch.float32)
            for l0, l1 in _lane_runs(lo, hi):
                acc = torch.zeros(len(rows), n, dtype=torch.float32)
                r0, r1 = l0 * MM.GEMV_UNIT, l1 * MM.GEMV_UNIT
                for g in range(r0 // gs2, -(-r1 // gs2)):
                    a, b = max(r0, g * gs2), min(r1, (g + 1) * gs2)
                    pa = qa[rows, a:b].to(torch.int64) @ u[e, a:b]
                    pb = qb[rows, a:b].to(torch.int64) @ braw[e, a:b]
                    val = (pa.float() * sa[rows, g, None]
                           + pb.float() * sb[rows, g, None])
                    if a == g * gs2:
                        val = val - t[rows, g, None]
                    acc = acc + val * w.scales[e, g]
                v = v + acc
            total = total + v
        out[rows] = total
    return out.numpy()


@pytest.mark.parametrize("group_size, splits, ids", [
    (128, 1, [3, 0, 4, 3, 1, 0, 3]),
    (128, 4, [3, 0, 4, 3, 1, 0, 3]),
    (96, 3, [2, 2, 2, 2, 2]),
    (32, 8, [1]),
])
def test_gemv_walk_matches_gathered_pallas(group_size, splits, ids):
    """The GEMV's walk against gathered_w4a8_matmul of the JAX package:
    repeated experts, all rows on one expert, one row; one split, several
    and one a group (group 32: 16 storage rows = 2 units, so six of the
    eight lanes of a split hold nothing)."""
    rng = np.random.default_rng(group_size + splits)
    k = 4 * group_size if group_size != 32 else 256
    jw, tw = _w4a8(rng, (5, k, 96), group_size)
    ids = np.asarray(ids, np.int32)
    x = rng.standard_normal((len(ids), k)).astype(np.float32)
    assert splits <= k // group_size
    ref = np.asarray(jwm.gathered_w4a8_matmul(
        jnp.asarray(x), jw, jnp.asarray(ids), interpret=True))
    out = emulate_gemv(x, tw, ids, splits)
    assert _rel(out, ref) <= TOL
    plain = MM.gathered_w4a8_matmul(torch.from_numpy(x), tw,
                                    torch.from_numpy(ids)).numpy()
    assert _rel(out, plain) <= TOL


@pytest.mark.parametrize("group_size, k", [(128, 1024), (96, 576)])
def test_gemv_walk_matches_dense_pallas(group_size, k):
    """A dense call of one row is one tile (ids = [0] on one expert), split
    at every group: against dense_w4a8_matmul of the JAX package."""
    rng = np.random.default_rng(k)
    jw, tw = _w4a8(rng, (k, 208), group_size)
    x = rng.standard_normal((1, k)).astype(np.float32)
    ref = np.asarray(jwm.dense_w4a8_matmul(jnp.asarray(x), jw,
                                           interpret=True))
    lifted = MM.lift(tw)
    splits, _ = MM.w4a8_gemv_plan(208, 1, k // 2, group_size // 2, 132)
    assert splits == k // group_size
    out = emulate_gemv(x, lifted, [0], splits)
    assert _rel(out, ref) <= TOL


# ------------------------------- the FFN's 64-row tile walk on tensor cores


def emulate_ffn_mma(x: np.ndarray, gu, dn, tiles, act: str) -> np.ndarray:
    """The two launches of an "mma" FFN call on the CPU in float32: for each
    64-row tile and down group of 128 (one w4a8_ffn_mma_kernel block), the
    block's gate and up columns summed group by group in order, the GLU,
    the requant of the group; then w4a8_mma_kernel over the same tiles.
    Rows no tile covers stay zero."""
    xt = torch.from_numpy(x)
    r, kdim = x.shape
    inter = gu.out_features // 2
    bc = F.FFN_MMA_DOWN_GROUP
    qa, qb, sa, sb, t, _ = w4a8_prep(xt, kdim, gu.group_size)
    ca = torch.zeros(r, inter // 2, dtype=torch.int8)
    cb = torch.zeros_like(ca)
    sa2 = torch.zeros(r, inter // bc)
    sb2, t2 = torch.zeros_like(sa2), torch.zeros_like(sa2)
    out = torch.zeros(r, kdim)
    for e, row0, n in zip(*(v.tolist() for v in tiles)):
        if n <= 0:
            continue
        rows = slice(row0, row0 + n)
        for grp in range(inter // bc):
            cols = torch.cat([torch.arange(grp * bc, (grp + 1) * bc),
                              inter + torch.arange(grp * bc, (grp + 1) * bc)])
            h = MM.w4a8_group_dot(qa[rows], qb[rows], sa[rows], sb[rows],
                                  t[rows], gu.data[e][:, cols],
                                  gu.scales[e][:, cols], gu.group_size // 2)
            a = F.glu(h[:, :bc], h[:, bc:], act)
            c1, c2, s1, s2, tt = F.requant_groups(a, bc)
            half = slice(grp * bc // 2, (grp + 1) * bc // 2)
            ca[rows, half], cb[rows, half] = c1, c2
            sa2[rows, grp], sb2[rows, grp], t2[rows, grp] = \
                s1[:, 0], s2[:, 0], tt[:, 0]
        out[rows] = MM.w4a8_group_dot(ca[rows], cb[rows], sa2[rows],
                                      sb2[rows], t2[rows], dn.data[e],
                                      dn.scales[e], dn.group_size // 2)
    return out.numpy()


@pytest.mark.parametrize("gs_up, act", [(128, "silu"), (96, "gelu")])
def test_ffn_mma_walk_matches_grouped_pallas(gs_up, act):
    """Sorted rows over 4 experts: one longer than a 64-row tile, one
    empty, and 6 rows past the total (zero on both sides), I = 256 (two
    down groups): against grouped_w4a8_ffn of the JAX package."""
    rng = np.random.default_rng(gs_up)
    e, k, inter = 4, 288 if gs_up == 96 else 256, 256
    jgu, tgu = _w4a8(rng, (e, k, 2 * inter), gs_up)
    jdn, tdn = _w4a8(rng, (e, inter, k), 128)
    sizes = np.asarray([70, 0, 9, 21], np.int32)
    m = int(sizes.sum()) + 6
    assert F.ffn_route(m, "grouped", gs_up, 128, inter, k) == "mma"
    xs = rng.standard_normal((m, k)).astype(np.float32)
    ref = np.asarray(jwm.grouped_w4a8_ffn(
        jnp.asarray(xs), jgu, jdn, jnp.asarray(sizes), act=act,
        interpret=True))
    tiles = MM.grouped_tiles(torch.from_numpy(sizes), m, MM.MMA_BM)
    out = emulate_ffn_mma(xs, tgu, tdn, tiles, act)
    assert _rel(out, ref) <= FFN_TOL
    plain = F.grouped_w4a8_ffn(torch.from_numpy(xs), tgu, tdn,
                               torch.from_numpy(sizes), act).numpy()
    assert _rel(out, plain) <= TOL
    assert not out[-6:].any() and not ref[-6:].any()


@pytest.mark.parametrize("m", [2, 72])
def test_ffn_mma_walk_matches_dense_pallas(m):
    """Dense tiles of 64 rows (72: a partial second tile), I = 256: against
    dense_w4a8_ffn of the JAX package."""
    rng = np.random.default_rng(200 + m)
    k, inter = 256, 256
    jgu, tgu = _w4a8(rng, (k, 2 * inter), 128)
    jdn, tdn = _w4a8(rng, (inter, k), 128)
    assert F.ffn_route(m, "dense", 128, 128, inter, k) == "mma"
    x = rng.standard_normal((m, k)).astype(np.float32)
    bc = jwm.dense_ffn_plan(jgu, jdn, "silu", None)
    ref = np.asarray(jwm.dense_w4a8_ffn(jnp.asarray(x), jgu, jdn, act="silu",
                                        bc=bc, interpret=True))
    out = emulate_ffn_mma(x, MM.lift(tgu), MM.lift(tdn),
                          MM.dense_tiles(m, MM.MMA_BM, "cpu"), "silu")
    assert _rel(out, ref) <= FFN_TOL
    plain = F.dense_w4a8_ffn(torch.from_numpy(x), tgu, tdn, "silu").numpy()
    assert _rel(out, plain) <= TOL
