"""The rules and the walk of the W4A8 FFN's one-row gate_up on the split-K
GEMV, w4a8_ffn_gemv_kernel (csrc/w4a8_ffn.cu; gathered_w4a8_ffn, and
dense_w4a8_ffn at one row), held against the JAX package's Pallas kernels
(interpret mode) on the same numpy inputs.

The CUDA kernel runs only on the card (tests/test_torch_cuda.py
-k ffn_gemv and chip_smoke.py hold it to the plain version there). What
these tests hold on the CPU:
- the route table of ops/cuda/w4a8_ffn.ffn_route for one-row tiles: both
  halves on the GEMVs where the gate_up and down groups hold whole 8-row
  units, the first version otherwise;
- the gate_up's split plan (ffn_gemv_plan, a pure function of the
  shapes): splits of whole scale groups, every storage row in one split
  and one row lane, and a grid that fills the card at DeepSeek-V2-Lite's
  decode shapes (6 and 48 routed rows, the shared experts at M = 1);
- the kernel's arithmetic in its order: per tile (the (expert, chunk)
  pairs the kernel's scan of ids gives) and split, each row lane's int
  dots of a scale group scaled once (t subtracted by the lane holding the
  group's first unit), the lanes summed in order, the splits summed in
  order by the last block; the GLU of each (gate, up) column pair; the
  requant per (row, down group); then the down GEMV's own walk on that
  requantized activation.

Tolerance, as a share of the reference's largest magnitude: 1e-2 against
the Pallas kernels and against the port's plain version. The integer dots
are exact on every side, but the float32 sums of the gate_up run in
another order (lanes and splits against the groups in order), which can
move an int8 code of the requant by one step (1/127 of its group's largest
value), as tests/test_torch_w4a8_gemv.py states for the FFN walks.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ktransformers_tpu.ops.pallas import w4a8_matmul as jwm
from ktransformers_tpu_torch.ops.cuda import w4a8_ffn as F
from ktransformers_tpu_torch.ops.cuda import w4a8_matmul as MM
from ktransformers_tpu_torch.quant.w4a8 import w4a8_prep
from tests.test_torch_model import one_torch_thread  # noqa: F401
from tests.test_torch_w4a8_gemv import _lane_runs, _rel, _w4a8, kernel_tiles

FFN_TOL = 1e-2
SMS = 132


# ------------------------------------------------------------ route table


@pytest.mark.parametrize("m, entry, gs_up, gs_dn, inter, kdim, want", [
    (1, "dense", 128, 128, 2816, 2048, "gemv"),     # decode shared experts
    (6, "gathered", 128, 128, 1408, 2048, "gemv"),  # decode routed experts
    (48, "gathered", 128, 128, 1408, 2048, "gemv"),
    (128, "gathered", 128, 128, 1408, 2048, "gemv"),
    (129, "gathered", 128, 128, 1408, 2048, "rows"),  # past 128 rows
    (1, "dense", 96, 96, 576, 576, "gemv"),         # groups of 96
    (1, "dense", 64, 32, 256, 512, "gemv"),
    (1, "dense", 8, 128, 256, 256, "rows"),         # gate_up group of 8
    (1, "dense", 128, 8, 256, 256, "rows"),         # down group of 8
    (1, "dense", 128, 128, 2816, 2040, "rows"),     # K % 16 != 0
])
def test_ffn_route_one_row(m, entry, gs_up, gs_dn, inter, kdim, want):
    """One-row tiles (every gathered call, a dense call of one row) take
    w4a8_ffn_gemv_kernel and the down GEMV where both groups hold whole
    8-row units (the down group is at most 128: check_ffn), at most 128
    rows and K a multiple of 16; the first version otherwise."""
    assert F.ffn_route(m, entry, gs_up, gs_dn, inter, kdim) == want
    assert F.ROUTE_KERNELS["gemv"] == ("w4a8_ffn_gemv_kernel",
                                       "w4a8_gemv_kernel")


# ------------------------------------------------------------- split plan

# (I, down group, static tiles, K/2, gate_up storage rows a group):
# DeepSeek-V2-Lite's 6 and 48 routed rows (64 experts: one row a tile),
# its shared experts at M = 1, and small shapes
PLAN_SHAPES = [
    (1408, 128, 6, 1024, 64), (1408, 128, 48, 1024, 64),
    (2816, 128, 1, 1024, 64), (576, 96, 1, 288, 48), (256, 32, 3, 256, 32),
]


@pytest.mark.parametrize("inter, gs_dn, tiles, k2, gs2", PLAN_SHAPES)
def test_ffn_gemv_plan(inter, gs_dn, tiles, k2, gs2):
    """Splits of whole scale groups; every storage row in exactly one
    split and one lane's run; the grid (down groups x tiles x splits)
    reaches two blocks an SM where the groups allow, and not much more."""
    splits, gran = F.ffn_gemv_plan(inter, gs_dn, tiles, k2, gs2, SMS)
    groups = k2 // gs2
    assert gran * MM.GEMV_UNIT == gs2 and 1 <= splits <= groups
    spans = MM.gemv_split_rows(k2, splits, gran)
    seen = np.zeros(k2, np.int32)
    for lo, hi in spans:
        assert lo % gs2 == 0 and hi % gs2 == 0 and hi > lo
        for l0, l1 in _lane_runs(lo, hi):
            seen[l0 * MM.GEMV_UNIT:l1 * MM.GEMV_UNIT] += 1
    assert (seen == 1).all()
    blocks = inter // gs_dn * tiles
    assert blocks * splits >= MM.GEMV_BLOCKS_PER_SM * SMS or splits == groups
    assert splits == 1 or blocks * (splits - 1) < MM.GEMV_BLOCKS_PER_SM * SMS


def test_ffn_gemv_plan_fills_the_card_at_decode():
    """The first version ran one block a (down group, row): 66 blocks for
    6 routed rows, 22 for the shared experts, on 132 SMs. The plan cuts 6
    rows into 4 splits (264 blocks), the shared experts into 12 (264), and
    leaves 48 rows (528 blocks) whole."""
    assert F.ffn_gemv_plan(1408, 128, 6, 1024, 64, SMS) == (4, 8)
    assert F.ffn_gemv_plan(2816, 128, 1, 1024, 64, SMS) == (12, 8)
    assert F.ffn_gemv_plan(1408, 128, 48, 1024, 64, SMS) == (1, 8)
    rb = MM.gemv_rows_per_chunk(48, 64)
    assert rb == 1 and MM.gemv_tile_count(48, 64, rb) == 48


# ---------------------------------------------- the kernel's walk in order


def walk(prep, w, ids, splits: int) -> torch.Tensor:
    """The split-K walk of one launch in float32 over the activation codes
    prep = (qa, qb, sa, sb, t): for each tile and split, each lane's int
    dots of a group scaled once (t only by the lane holding the group's
    first unit), the lanes summed in order, then the splits in order.
    w4a8_ffn_gemv_kernel runs it over its block's gate and up columns,
    the down GEMV (w4a8_gemv_kernel) over the output's."""
    qa, qb, sa, sb, t = prep
    _, k2, n = w.data.shape
    gs2 = w.group_size // 2
    gran = gs2 // MM.GEMV_UNIT
    u = (w.data & 15).to(torch.int64)
    braw = w.data.to(torch.int64)
    out = torch.zeros(qa.shape[0], n, dtype=torch.float32)
    for e, rows in kernel_tiles(ids, w.data.shape[0]):
        if e < 0:
            continue
        total = torch.zeros(len(rows), n)
        for lo, hi in MM.gemv_split_rows(k2, splits, gran):
            v = torch.zeros(len(rows), n)
            for l0, l1 in _lane_runs(lo, hi):
                acc = torch.zeros(len(rows), n)
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
    return out


def emulate_ffn_gemv(x: np.ndarray, gu, dn, ids, act: str, up_splits=None,
                     down_splits=None) -> np.ndarray:
    """The two launches of a "gemv" FFN call on the CPU: the gate_up walk
    at the kernel's plan (or a forced split count), the GLU of each (gate
    column j, up column j) pair and the requant per (row, down group), as
    the last block of each (down group, tile) set does, then the down
    GEMV's walk at its own plan."""
    r, kdim = x.shape
    inter = gu.out_features // 2
    e = gu.data.shape[0]
    rb = MM.gemv_rows_per_chunk(r, e)
    tiles = MM.gemv_tile_count(r, e, rb)
    if up_splits is None:
        up_splits, _ = F.ffn_gemv_plan(inter, dn.group_size, tiles, kdim // 2,
                                       gu.group_size // 2, SMS)
    if down_splits is None:
        down_splits, _ = MM.w4a8_gemv_plan(kdim, tiles, inter // 2,
                                           dn.group_size // 2, SMS)
    prep = w4a8_prep(torch.from_numpy(x), kdim, gu.group_size)[:5]
    h = walk(prep, gu, ids, up_splits)
    mid = F.requant_groups(F.glu(h[:, :inter], h[:, inter:], act),
                           dn.group_size)
    return walk(mid, dn, ids, down_splits).numpy()


@pytest.mark.parametrize("gs_up, act, ids, up_splits", [
    (128, "silu", [3, 0, 4, 3, 1, 0, 3], None),  # repeats, the plan
    (128, "gelu", [3, 0, 4, 3, 1, 0, 3], 4),     # one split a group
    (128, "relu", [6, 2, 7, 5, 1, 0], 1),        # distinct, one split
    (96, "silu", [2, 2, 2, 2, 2], 4),            # one expert, group 96
    (96, "gelu", [5], None),                     # one row
])
def test_ffn_gemv_walk_matches_gathered_pallas(gs_up, act, ids, up_splits):
    """The walk against gathered_w4a8_ffn of the JAX package: repeated
    experts (their tiles are neighbours in the grid), all rows on one
    expert, one row; every activation; a gate_up group of 96 (K = 384:
    four groups); I = 256 (two down groups of 128); under the plan, one
    split and one split a group. And against the port's plain version."""
    rng = np.random.default_rng(gs_up + len(ids))
    e, inter = 8, 256
    k = 4 * gs_up
    jgu, tgu = _w4a8(rng, (e, k, 2 * inter), gs_up)
    jdn, tdn = _w4a8(rng, (e, inter, k), 128)
    ids = np.asarray(ids, np.int32)
    x = rng.standard_normal((len(ids), k)).astype(np.float32)
    assert F.ffn_route(len(ids), "gathered", gs_up, 128, inter, k) == "gemv"
    ref = np.asarray(jwm.gathered_w4a8_ffn(
        jnp.asarray(x), jgu, jdn, jnp.asarray(ids), act=act, interpret=True))
    out = emulate_ffn_gemv(x, tgu, tdn, ids, act, up_splits)
    assert _rel(out, ref) <= FFN_TOL
    plain = F.gathered_w4a8_ffn(torch.from_numpy(x), tgu, tdn,
                                torch.from_numpy(ids), act).numpy()
    assert _rel(out, plain) <= FFN_TOL


def test_ffn_gemv_walk_two_rows_a_tile():
    """16 rows on 4 of 4 experts: rows outnumber the experts, so tiles
    take two rows of one expert (RB = 2) and the static tile count leaves
    dead tiles, which exit before they arrive on a counter; against the
    Pallas kernel."""
    rng = np.random.default_rng(16)
    e, k, inter = 4, 256, 128
    jgu, tgu = _w4a8(rng, (e, k, 2 * inter), 64)
    jdn, tdn = _w4a8(rng, (e, inter, k), 64)
    ids = rng.integers(0, e, 16).astype(np.int32)
    assert MM.gemv_rows_per_chunk(16, e) == 2
    tiles = kernel_tiles(ids, e)
    assert any(ex < 0 for ex, _ in tiles)
    x = rng.standard_normal((16, k)).astype(np.float32)
    ref = np.asarray(jwm.gathered_w4a8_ffn(
        jnp.asarray(x), jgu, jdn, jnp.asarray(ids), act="silu",
        interpret=True))
    out = emulate_ffn_gemv(x, tgu, tdn, ids, "silu")
    assert _rel(out, ref) <= FFN_TOL


@pytest.mark.parametrize("up_splits", [None, 1])
def test_ffn_gemv_walk_matches_dense_pallas(up_splits):
    """A dense call of one row is one tile (ids = [0] on one expert): the
    shared-expert shape cut to I = 512 (four down groups), K = 1024 (eight
    groups), against dense_w4a8_ffn of the JAX package."""
    rng = np.random.default_rng(512)
    k, inter = 1024, 512
    jgu, tgu = _w4a8(rng, (k, 2 * inter), 128)
    jdn, tdn = _w4a8(rng, (inter, k), 128)
    x = rng.standard_normal((1, k)).astype(np.float32)
    assert F.ffn_route(1, "dense", 128, 128, inter, k) == "gemv"
    bc = jwm.dense_ffn_plan(jgu, jdn, "silu", None)
    ref = np.asarray(jwm.dense_w4a8_ffn(jnp.asarray(x), jgu, jdn, act="silu",
                                        bc=bc, interpret=True))
    out = emulate_ffn_gemv(x, MM.lift(tgu), MM.lift(tdn), [0], "silu",
                           up_splits)
    assert _rel(out, ref) <= FFN_TOL
    plain = F.dense_w4a8_ffn(torch.from_numpy(x), tgu, tdn, "silu").numpy()
    assert _rel(out, plain) <= FFN_TOL


def test_ffn_gemv_walk_down_group_96():
    """A down group of 96 (I = 576, six down groups; the kernel's blocks
    leave 32 of their 128 columns a half idle): the walk against the port's
    plain version (the JAX dense FFN needs I a multiple of 128 there)."""
    rng = np.random.default_rng(96)
    k, inter = 256, 576
    _, tgu = _w4a8(rng, (k, 2 * inter), 128)
    _, tdn = _w4a8(rng, (inter, k), 96)
    assert tdn.group_size == 96
    x = rng.standard_normal((1, k)).astype(np.float32)
    assert F.ffn_route(1, "dense", 128, 96, inter, k) == "gemv"
    out = emulate_ffn_gemv(x, MM.lift(tgu), MM.lift(tdn), [0], "gelu")
    plain = F.dense_w4a8_ffn(torch.from_numpy(x), tgu, tdn, "gelu").numpy()
    assert _rel(out, plain) <= FFN_TOL


def test_jax_runs_on_the_cpu():
    assert jax.default_backend() == "cpu"
