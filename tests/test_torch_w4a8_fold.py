"""The W4A8 activation prep folded into its consumers: the two split-K
GEMVs (w4a8_gemv_kernel, w4a8_ffn_gemv_kernel) and the two tensor-core
kernels (w4a8_mma_kernel, w4a8_ffn_mma_kernel) quantize x themselves
instead of reading the codes of a kt_w4a8_prep launch.

On the CPU (no JAX needed but for the emulation against the JAX package's
w4a8_prep, which skips where JAX is missing):
- the fold rule, ``folds`` / ``ffn_folds``, as pure functions of the shape:
  the GEMVs always fold, the tensor-core kernels below their crossover
  (MMA_FOLD_MAX_ROWS, FFN_MMA_FOLD_MAX_ROWS), the first versions never;
  the prep launches a DeepSeek-V2-Lite W4A8 decode step and a served
  batch-8 step still make (none) and a Mixtral-8x7B decode step (none);
- what a launch is handed (``activations``, ``act_args``): x itself, a
  16-byte aligned copy of a misaligned x, or the prep's five code tensors;
- the split-K GEMVs' split of the scale groups a block quantizes: every
  group in exactly one split, each split's storage rows (the walk's) inside
  its groups, and the shared memory a split takes within the kernels'
  limit at the main path's shapes;
- prep_group's arithmetic (csrc/w4a8_core.cuh) in its order, emulated in
  float32: the codes and scales are the bits of quant/w4a8.py:w4a8_prep
  (JAX package and port), the sums t within float32 rounding.

On the card (the ``cuda`` fixture; skipped here): each folded kernel gives
the same bits as prep_activations + the unfolded kernel on the same
operands, at DeepSeek-V2-Lite and Mixtral-8x7B widths, groups 128 and 96
(layer-0 down), bf16 and float32 x, M = 1, 2, 6 (gathered), 8, 48, 64 and
256; it launches no prep; and it is within the plain version's tolerance
(1e-2 for rows 1, 7 and 8, 3e-2 for the FFN rows 2-4, as chip_smoke.py
holds them):

    python -m pytest --noconftest tests/test_torch_w4a8_fold.py -q
"""

import numpy as np
import pytest
import torch

from ktransformers_tpu_torch.ops.cuda import LAUNCHES
from ktransformers_tpu_torch.ops.cuda import w4a8_ffn as F
from ktransformers_tpu_torch.ops.cuda import w4a8_matmul as MM
from ktransformers_tpu_torch.quant.w4a8 import repack_offset_lo, w4a8_prep

SMS = 132
# the kernels' shared-memory limit for a split's codes and scales
# (csrc/w4a8_gemv.cuh: MAX_ACTS_SMEM)
MAX_ACTS_SMEM = 160 * 1024


@pytest.fixture
def cuda():
    """The card, or a skip: CUDA kernels cannot run on the CPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


# ------------------------------------------------------------- fold rule


@pytest.mark.parametrize("kernel, m, k, gs, want", [
    ("mma", 2, 2048, 128, True), ("mma", 4, 4096, 128, True),
    ("mma", MM.MMA_FOLD_MAX_ROWS, 2048, 128, True),
    ("mma", MM.MMA_FOLD_MAX_ROWS + 1, 2048, 128, False),
    ("mma", 8, 2048, 128, False),
    ("mma", 256, 2048, 128, False),
    ("mma", 2, 10944, 96, False),    # a 197 KB A tile: one block an SM
    ("mma", 2, 2048, 256, False),    # past two values a lane
    ("rows", 1, 2048, 128, False), ("rows", 300, 2048, 64, False),
    ("gemv", 1, 2048, 128, False),   # the GEMV's rule is gemv_folds
])
def test_folds(kernel, m, k, gs, want):
    """The tensor-core kernel quantizes x itself at up to MMA_FOLD_MAX_ROWS
    rows where its A tile leaves room for two blocks an SM, at groups of up
    to 128; the first version reads a prep launch's codes."""
    assert MM.folds(kernel, m, k, gs) is want


@pytest.mark.parametrize("rb, ng, splits, gs, want", [
    (1, 16, 16, 128, True),    # qkv_a at M = 1: a group a split
    (1, 16, 1, 128, True),     # lm_head at M = 1: 16 groups, one split
    (1, 114, 33, 96, True),    # layer-0 down at M = 1: 4 groups a split
    (2, 32, 1, 128, False),    # Mixtral gate_up at 16 rows: 64 units
    (2, 112, 2, 128, False),   # Mixtral down at 16 rows: 112 units
    (1, 32, 2, 128, True),     # Mixtral gate_up at 2 rows: 16 units
    (1, 16, 16, 256, False),   # a group past two values a lane
])
def test_gemv_folds(rb, ng, splits, gs, want):
    """A GEMV block folds the prep in where it quantizes at most
    FOLD_MAX_UNITS (row, group) units: rb x ceil(ng / splits)."""
    assert MM.FOLD_MAX_UNITS == 16
    assert MM.gemv_folds(rb, ng, splits, gs) is want


@pytest.mark.parametrize("n, rows, experts, k, gs, want", [
    (3648, 1, 1, 2048, 128, True), (2048, 1, 1, 2048, 128, True),
    (102400, 1, 1, 2048, 128, True), (21888, 1, 1, 2048, 128, True),
    (2048, 1, 1, 10944, 96, True),
    (28672, 2, 8, 4096, 128, True), (4096, 2, 8, 14336, 128, True),
    (28672, 16, 8, 4096, 128, False), (4096, 16, 8, 14336, 128, False),
])
def test_gemv_call_folds(n, rows, experts, k, gs, want):
    """With the plans of 132 SMs: every DeepSeek-V2-Lite projection at
    M = 1 and Mixtral-8x7B's experts at 2 routed rows fold; at its serving
    batch (16 rows, two a tile) they do not."""
    assert MM.gemv_call_folds(n, rows, experts, k, gs, SMS) is want


@pytest.mark.parametrize("rows, experts, inter, want", [
    (6, 64, 1408, True), (48, 64, 1408, True), (1, 1, 2816, True)])
def test_ffn_gemv_call_folds(rows, experts, inter, want):
    """The W4A8 FFN's one-row gate_up at DeepSeek-V2-Lite's decode shapes
    folds: 4 groups a split at 6 rows, 16 at 48 (one split), 1-2 at the
    shared experts' M = 1."""
    assert F.ffn_gemv_call_folds(rows, experts, inter, 128, 2048, 128,
                                 SMS) is want


@pytest.mark.parametrize("m, want", [(1, 16), (8, 16), (17, 32), (64, 64),
                                     (300, 64)])
def test_fold_rows_and_bytes(m, want):
    """The A tile's rows (the tile's rounded up to 16, at most 64) and its
    bytes: qa and qb rows of K/2 bytes padded to an odd number of 16-byte
    chunks (1024 -> 1040; 5472 -> 5488), 12 bytes of scales a (row,
    group)."""
    assert MM.fold_rows(m) == want
    assert MM.fold_bytes(want, 2048, 128) == 2 * want * 1040 + 12 * want * 16
    assert MM.fold_bytes(16, 10944, 96) == 2 * 16 * 5488 + 12 * 16 * 114


def test_fold_tiles_fit():
    """Beside w4a8_mma_kernel's ring (4 groups of 64 x 64 weight bytes and
    64 scales) an A tile of 64 rows fits at K = 2048 and of 16 at K = 10944
    (group 96), not of 32; beside the FFN kernel's (6 groups of 64 x 256
    and 256 scales, 104,448 bytes) one of 48 rows at K = 2048, not of 64."""
    assert MM.mma_fold_fits(64, 2048, 128, MM.MMA_STAGES, 64)
    assert MM.mma_fold_fits(16, 10944, 96, MM.MMA_STAGES, 64)
    assert not MM.mma_fold_fits(17, 10944, 96, MM.MMA_STAGES, 64)
    assert MM.mma_fold_fits(48, 2048, 128, F.FFN_MMA_STAGES, 256)
    assert not MM.mma_fold_fits(49, 2048, 128, F.FFN_MMA_STAGES, 256)


@pytest.mark.parametrize("kernel, m, want", [
    ("mma", 2, True), ("mma", 4, True), ("mma", 8, True),
    ("mma", F.FFN_MMA_FOLD_MAX_ROWS, True),
    ("mma", F.FFN_MMA_FOLD_MAX_ROWS + 1, False), ("mma", 1536, False),
    ("rows", 1, False), ("rows", 4, False), ("gemv", 1, False),
])
def test_ffn_folds(kernel, m, want):
    """At K = 2048, gate_up group 128 (DeepSeek-V2-Lite's experts); a group
    of 256 never folds; the one-row gate_up's rule is gemv_folds."""
    assert F.ffn_folds(kernel, m, 2048, 128) is want
    assert not F.ffn_folds(kernel, m, 2048, 256)


def test_crossovers():
    """On the H100, folded beside prep + unfolded kernel on the same
    operands (ops/cuda/fold_sweep.py), w4a8_mma_kernel won at 2-4 rows and
    lost from 5, the FFN kernel won up to 8 rows (the serving batch) and
    lost or tied from 12; a 256-token chunk and the SFT step's 512 rows lie
    far past both."""
    assert MM.MMA_FOLD_MAX_ROWS == 4 and F.FFN_MMA_FOLD_MAX_ROWS == 8


def _dense_prep(m, k, n, gs):
    kernel = MM.route(m, "dense", gs, n)
    if kernel == "gemv":
        return 0 if MM.gemv_call_folds(n, 1, 1, k, gs, SMS) else 1
    return 0 if MM.folds(kernel, m, k, gs) else 1


def _ffn_prep(m, entry, inter, kdim=2048):
    kernel = F.ffn_route(m, entry, 128, 128, inter, kdim)
    if kernel == "gemv":
        experts = 64 if entry == "gathered" else 1
        return 0 if F.ffn_gemv_call_folds(m, experts, inter, 128, kdim, 128,
                                          SMS) else 1
    return 0 if F.ffn_folds(kernel, m, kdim, 128) else 1


@pytest.mark.parametrize("m, want", [(1, 0), (4, 1), (8, 57), (256, 109)])
def test_deepseek_step_prep_launches(m, want):
    """Prep launches of a DeepSeek-V2-Lite W4A8 step of m rows (decode at
    1; a batch of 4: only the layer-0 down, whose A tile of K = 10944 would
    leave one block an SM; the served batch of 8: the 57 dense projections,
    past w4a8_mma_kernel's crossover, while the shared-expert FFN calls and
    the 48 routed rows fold; 256 rows: 109, as before; a real prefill chunk
    computes lm_head on its last row only, which folds): qkv_a and o_proj
    of 27
    layers, lm_head, the layer-0 MLP's gate_up (2048 -> 21888) and down
    (10944 -> 2048, group 96), the routed experts (6 rows a token, gathered
    at decode, grouped at prefill) and the shared experts of 26 layers."""
    dense = 27 * (_dense_prep(m, 2048, 3648, 128)
                  + _dense_prep(m, 2048, 2048, 128))
    dense += _dense_prep(m, 2048, 102400, 128)
    dense += _dense_prep(m, 2048, 21888, 128) + _dense_prep(m, 10944, 2048,
                                                             96)
    entry = "gathered" if m <= 8 else "grouped"
    moe = 26 * (_ffn_prep(6 * m, entry, 1408) + _ffn_prep(m, "dense", 2816))
    assert dense + moe == want


@pytest.mark.parametrize("tokens, want", [(1, 0), (8, 64), (256, 64)])
def test_mixtral_step_prep_launches(tokens, want):
    """Prep launches of a Mixtral-8x7B step: its attention is int8 (no
    prep); its experts are too wide for the fused FFN, so 32 layers x two
    W4A8 matmuls over 2 rows a token, gathered at decode (folded at one
    token, not at the serving batch's 16 rows), grouped at prefill."""
    rows = 2 * tokens
    preps = 0
    for k, n in ((4096, 28672), (14336, 4096)):
        if tokens <= 8:
            preps += not MM.gemv_call_folds(n, rows, 8, k, 128, SMS)
        else:
            preps += not MM.folds(MM.route(rows, "grouped", 128, n), rows,
                                  k, 128)
    assert preps * 32 == want


# -------------------------------------------------- what a launch is handed


def test_activations_fold_hands_over_x():
    x = torch.randn(4, 256)
    assert MM.activations(x, 256, 128, True) is x


def test_activations_unfolded_are_the_prep_codes():
    x = torch.randn(3, 256)
    got = MM.activations(x, 256, 128, False)
    want = w4a8_prep(x, 256, 128)[:5]
    assert len(got) == 5
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("dtype, code", [(torch.float32, 1),
                                         (torch.bfloat16, 2)])
def test_act_args(dtype, code):
    """A folded launch gets null codes, x and its dtype; an unfolded one
    the five code tensors and x_dtype 0."""
    x = torch.randn(2, 256).to(dtype)
    assert MM.act_args(x) == (None,) * 5 + (x.data_ptr(), code)
    codes = w4a8_prep(x, 256, 128)[:5]
    assert MM.act_args(codes) == (tuple(v.data_ptr() for v in codes)
                                  + (None, 0))


# ------------------------------------------- the groups a GEMV split takes

# (N, static tiles, K/2, gs/2): DeepSeek-V2-Lite's decode projections and
# experts, the layer-0 down (group 96), Mixtral-8x7B's experts at 2 and 16
# routed rows
GEMV_SHAPES = [
    (3648, 1, 1024, 64), (2048, 1, 1024, 64), (102400, 1, 1024, 64),
    (21888, 1, 1024, 64), (2048, 1, 5472, 48),
    (2048, 6, 704, 64), (2048, 48, 704, 64),
    (28672, 2, 2048, 64), (4096, 2, 7168, 64),
    (28672, 12, 2048, 64), (4096, 12, 7168, 64),
]


@pytest.mark.parametrize("n, tiles, k2, gs2", GEMV_SHAPES)
def test_gemv_split_groups(n, tiles, k2, gs2):
    """Split s of a folded GEMV quantizes scale groups [ng s / S, ng (s+1)
    / S) (csrc/w4a8_gemv.cuh: split_groups): those are exactly the groups
    of its storage rows (gemv_split_rows, the walk's), so every group is
    quantized by one split of each column block and each lane finds its
    codes; the split's codes and scales fit the kernels' shared memory
    (acts_bytes, two rows a tile at most)."""
    splits, gran = MM.w4a8_gemv_plan(n, tiles, k2, gs2, SMS)
    assert gran * MM.GEMV_UNIT == gs2
    ng = k2 // gs2
    seen = np.zeros(ng, np.int32)
    for s, (r0, r1) in enumerate(MM.gemv_split_rows(k2, splits, gran)):
        g0, g1 = ng * s // splits, ng * (s + 1) // splits
        assert (r0, r1) == (g0 * gs2, g1 * gs2)
        seen[g0:g1] += 1
    assert (seen == 1).all()
    per_split = -(-ng // splits)
    assert 2 * per_split * (2 * gs2 + 12) <= MAX_ACTS_SMEM


@pytest.mark.parametrize("inter, tiles", [(1408, 6), (1408, 48), (2816, 1)])
def test_ffn_gemv_split_groups(inter, tiles):
    """The FFN's one-row gate_up (ffn_gemv_plan) cuts K = 2048 the same
    way: 4 splits of 4 groups at 6 routed rows, 12 at the shared experts'
    M = 1 (1-2 groups each), one split of all 16 at 48 rows."""
    splits, gran = F.ffn_gemv_plan(inter, 128, tiles, 1024, 64, SMS)
    assert gran * MM.GEMV_UNIT == 64
    assert splits == {(1408, 6): 4, (1408, 48): 1, (2816, 1): 12}[
        (inter, tiles)]
    rows = MM.gemv_split_rows(1024, splits, gran)
    assert [(r0 // 64, r1 // 64) for r0, r1 in rows] == [
        (16 * s // splits, 16 * (s + 1) // splits) for s in range(splits)]


# ------------------------------------------ prep_group's arithmetic, emulated


def prep_group_emulation(x: np.ndarray, gs: int):
    """csrc/w4a8_core.cuh:prep_group over every (row, group) of x [M, K]
    float32, in its order: each of 32 lanes sums lo[j] for j = lane, lane +
    32, ... from 0; a butterfly (xor 16, 8, 4, 2, 1) adds the lanes; the
    scales are absmax / 127 and the codes rint(v / s) clamped to +-127."""
    f32 = np.float32
    m, k = x.shape
    ng, gs2 = k // gs, gs // 2
    seg = x.reshape(m, ng, gs).astype(f32)
    lo, hi = seg[..., :gs2], seg[..., gs2:]
    a = lo - hi / f32(16)
    b = hi / f32(16)
    lanes = np.zeros((m, ng, 32), f32)
    for j in range(gs2):
        lanes[..., j % 32] = (lanes[..., j % 32] + lo[..., j]).astype(f32)
    for o in (16, 8, 4, 2, 1):
        lanes = (lanes + lanes[..., np.arange(32) ^ o]).astype(f32)
    assert (lanes == lanes[..., :1]).all()  # every lane holds the same sum

    def q(v):
        s = (np.maximum(np.abs(v).max(-1), f32(1e-8)) / f32(127)).astype(f32)
        codes = np.clip(np.rint((v / s[..., None]).astype(f32)), -127, 127)
        return codes.astype(np.int8).reshape(m, k // 2), s

    qa, sa = q(a)
    qb, sb = q(b)
    return qa, qb, sa, sb, (f32(8) * lanes[..., 0]).astype(f32)


@pytest.mark.parametrize("m, k, gs", [(1, 2048, 128), (8, 2048, 128),
                                      (3, 10944, 96), (2, 4096, 128),
                                      (2, 14336, 128), (5, 1536, 96)])
@pytest.mark.parametrize("bf16", [False, True])
def test_prep_group_emulation_matches_w4a8_prep(m, k, gs, bf16):
    """The codes and scales are the bits of the JAX package's w4a8_prep and
    of the port's plain one; t = 8 sum(lo) differs only in the order of its
    float32 sum: within 1e-5 of 8 sum |lo| of its group."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from ktransformers_tpu.quant.w4a8 import w4a8_prep as j_prep

    rng = np.random.default_rng(m * k + gs)
    x = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32))
    if bf16:
        x = x.bfloat16().float()
    got = prep_group_emulation(x.numpy(), gs)
    with jax.default_device(jax.devices("cpu")[0]):  # XLA's CPU numerics
        ref_j = [np.asarray(v) for v in j_prep(jnp.asarray(x.numpy()), k,
                                               gs)]
    ref_t = [v.numpy() for v in w4a8_prep(x, k, gs)]
    mag = 8 * np.abs(x.numpy()).reshape(m, k // gs, gs)[..., :gs // 2].sum(-1)
    for ref in (ref_j, ref_t):
        for g, r in zip(got[:4], ref[:4]):
            assert np.array_equal(g, r)
        assert (np.abs(got[4] - ref[4]) <= 1e-5 * mag).all()


# ------------------------------------------------------------ on the card


def _draw(device, seed=0):
    from ktransformers_tpu_torch.models.init import _Draw

    rd = _Draw(seed, device, torch.bfloat16)

    def w(shape, gs=128):
        return repack_offset_lo(rd.q(shape, "int4_g", gs))

    def x(*shape, dtype=torch.bfloat16):
        return torch.randn(*shape, generator=rd.gen, device=device).to(dtype)

    return w, x, rd.gen


def _ids(gen, n, e):
    """n expert ids in [0, e), int32, on the generator's device."""
    return torch.randint(0, e, (n,), generator=gen, device=gen.device,
                         dtype=torch.int32)


def _sizes(gen, rows, e):
    """Group sizes [e] int32 of ``rows`` rows routed at random."""
    return torch.bincount(_ids(gen, rows, e).long(), minlength=e).to(
        torch.int32)


def _same_bits(launcher, what):
    """Run ``launcher(fold)`` folded and unfolded; the outputs must be the
    same bits, and only the unfolded call launches the prep."""
    prep0 = LAUNCHES["w4a8_prep"]
    launch, out = launcher(True)
    launch()
    torch.cuda.synchronize()
    assert LAUNCHES["w4a8_prep"] == prep0, what
    ulaunch, uout = launcher(False)
    ulaunch()
    torch.cuda.synchronize()
    assert LAUNCHES["w4a8_prep"] == prep0 + 1, what
    assert torch.equal(out, uout), what
    assert bool(torch.isfinite(out.float()).all()), what
    return out


def _same_bits_or_refused(launcher, what, fits):
    """_same_bits where the folded A tile fits; where it does not, the
    folded launch raises (the kernel refuses it) and nothing falls back."""
    if fits:
        return _same_bits(launcher, what)
    with pytest.raises(RuntimeError, match="cudaError"):
        launcher(True)[0]()
    return None


def _rel(out, ref):
    out, ref = out.float(), ref.float()
    return float((out - ref).abs().max() / ref.abs().max())


DTYPES = [torch.bfloat16, torch.float32]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("k, n, gs", [(2048, 3648, 128), (2048, 102400, 128),
                                      (10944, 2048, 96)])
def test_dense_gemv_fold(cuda, dtype, k, n, gs):
    """Row 1 at M = 1 (qkv_a, lm_head, the layer-0 down at group 96)."""
    w, x, _ = _draw(cuda, k + n)
    wt, xs = w((k, n), gs), x(1, k, dtype=dtype)
    assert MM.route(1, "dense", gs, n) == "gemv"
    out = _same_bits(lambda fold: MM.dense_w4a8_launcher(xs, wt, "gemv",
                                                         fold), "gemv")
    assert _rel(out, MM.w4a8_matmul_ref(xs, wt)) <= 1e-2


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("rows", [1, 2, 6, 48])
@pytest.mark.parametrize("e, k, n", [(64, 1408, 2048), (8, 4096, 28672),
                                     (8, 14336, 4096)])
def test_gathered_gemv_fold(cuda, dtype, rows, e, k, n):
    """Row 7 and the FFN's one-row down shape: DeepSeek-V2-Lite's experts
    and Mixtral-8x7B's gate_up / down, experts repeated where rows exceed
    them (two rows a tile)."""
    w, x, gen = _draw(cuda, rows + n)
    wt, xs = w((e, k, n)), x(rows, k, dtype=dtype)
    ids = _ids(gen, rows, e)
    out = _same_bits(lambda fold: MM.gathered_launcher(xs, wt, ids, "gemv",
                                                       fold), "gathered")
    assert _rel(out, MM.gathered_w4a8_matmul_ref(xs, wt, ids)) <= 1e-2


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("m", [2, 8, 48, 64, 256])
@pytest.mark.parametrize("k, n, gs", [(2048, 3648, 128), (10944, 2048, 96),
                                      (7168, 2112, 128), (1536, 24576, 128)])
def test_dense_mma_fold(cuda, dtype, m, k, n, gs):
    """Row 1 from M = 2 on w4a8_mma_kernel, on both sides of the
    crossover; DeepSeek-V3's qkv_a and q_b."""
    w, x, _ = _draw(cuda, m + k)
    wt, xs = w((k, n), gs), x(m, k, dtype=dtype)
    fits = MM.mma_fold_fits(m, k, gs, MM.MMA_STAGES, 64)
    out = _same_bits_or_refused(
        lambda fold: MM.dense_w4a8_launcher(xs, wt, "mma", fold), "mma",
        fits)
    if out is not None:
        assert _rel(out, MM.w4a8_matmul_ref(xs, wt)) <= 1e-2


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("m", [8, 64, 256])
def test_grouped_mma_fold(cuda, dtype, m):
    """Row 8 at Mixtral-8x7B's gate_up: rows sorted by expert, a few rows
    past the grouped total (zero)."""
    w, x, gen = _draw(cuda, m)
    wt, xs = w((8, 4096, 28672)), x(m, 4096, dtype=dtype)
    sizes = _sizes(gen, m - 2, 8)
    fits = MM.mma_fold_fits(m, 4096, 128, MM.MMA_STAGES, 64)
    out = _same_bits_or_refused(
        lambda fold: MM.grouped_launcher(xs, wt, sizes, "mma", fold),
        "grouped", fits)
    if out is not None:
        assert _rel(out, MM.grouped_w4a8_matmul_ref(xs, wt, sizes)) <= 1e-2


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("rows", [1, 6, 48])
def test_gathered_ffn_gemv_fold(cuda, dtype, rows):
    """Row 2: DeepSeek-V2-Lite's routed experts, one-row tiles."""
    w, x, gen = _draw(cuda, rows)
    gu, dn = w((64, 2048, 2816)), w((64, 1408, 2048))
    xs = x(rows, 2048, dtype=dtype)
    ids = _ids(gen, rows, 64)
    out = _same_bits(lambda fold: F.gathered_launcher(xs, gu, dn, ids,
                                                      "silu", "gemv", fold),
                     "ffn gemv")
    assert _rel(out, F.gathered_w4a8_ffn_ref(xs, gu, dn, ids)) <= 3e-2


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("k, inter, gs", [(2048, 2816, 128), (1536, 256, 96)])
def test_dense_ffn_gemv_fold(cuda, dtype, k, inter, gs):
    """Row 3 at M = 1: the shared experts, and a gate_up group of 96."""
    w, x, _ = _draw(cuda, inter)
    gu, dn = w((k, 2 * inter), gs), w((inter, k))
    xs = x(1, k, dtype=dtype)
    out = _same_bits(lambda fold: F.dense_launcher(xs, gu, dn, "silu", "gemv",
                                                   fold), "ffn gemv dense")
    assert _rel(out, F.dense_w4a8_ffn_ref(xs, gu, dn)) <= 3e-2


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("m", [2, 8, 48, 64, 256])
@pytest.mark.parametrize("k, inter, gs", [(2048, 2816, 128), (1536, 256, 96),
                                          (7168, 2048, 128),
                                          (7168, 18432, 128)])
def test_dense_ffn_mma_fold(cuda, dtype, m, k, inter, gs):
    """Row 3 from M = 2 on w4a8_ffn_mma_kernel, on both sides of the
    crossover; a gate_up group of 96; DeepSeek-V3's shared expert and
    dense MLP, whose folded A tile at K = 7168 nearly fills the shared
    memory beside the ring."""
    w, x, _ = _draw(cuda, m + inter)
    gu, dn = w((k, 2 * inter), gs), w((inter, k))
    xs = x(m, k, dtype=dtype)
    fits = MM.mma_fold_fits(m, k, gs, F.FFN_MMA_STAGES, 256)
    out = _same_bits_or_refused(
        lambda fold: F.dense_launcher(xs, gu, dn, "silu", "mma", fold),
        "ffn mma dense", fits)
    if out is not None:
        assert _rel(out, F.dense_w4a8_ffn_ref(xs, gu, dn)) <= 3e-2


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("m", [48, 256])
def test_grouped_ffn_mma_fold(cuda, dtype, m):
    """Row 4: DeepSeek-V2-Lite's routed experts over sorted rows."""
    w, x, gen = _draw(cuda, m)
    gu, dn = w((64, 2048, 2816)), w((64, 1408, 2048))
    xs = x(m, 2048, dtype=dtype)
    sizes = _sizes(gen, m, 64)
    fits = MM.mma_fold_fits(m, 2048, 128, F.FFN_MMA_STAGES, 256)
    out = _same_bits_or_refused(
        lambda fold: F.grouped_launcher(xs, gu, dn, sizes, "silu", "mma",
                                        fold), "ffn mma grouped", fits)
    if out is not None:
        assert _rel(out, F.grouped_w4a8_ffn_ref(xs, gu, dn, sizes)) <= 3e-2


@pytest.mark.cuda
def test_wrappers_launch_the_preps_the_rules_say(cuda):
    """Through the public wrappers: no prep launch at the single-user decode
    shapes (M = 1, 6 routed rows) nor at 4 rows; at 8 rows one for the
    dense matmul (past w4a8_mma_kernel's crossover) and none for the FFN;
    at 9 one for each."""
    w, x, gen = _draw(cuda, 7)
    wt, gu, dn = w((2048, 3648)), w((64, 2048, 2816)), w((64, 1408, 2048))
    sgu, sdn = w((2048, 5632)), w((2816, 2048))
    ids = _ids(gen, 6, 64)
    prep0 = LAUNCHES["w4a8_prep"]
    MM.dense_w4a8_matmul(x(1, 2048), wt)
    MM.dense_w4a8_matmul(x(4, 2048), wt)
    F.gathered_w4a8_ffn(x(6, 2048), gu, dn, ids)
    F.dense_w4a8_ffn(x(1, 2048), sgu, sdn)
    F.dense_w4a8_ffn(x(4, 2048), sgu, sdn)
    torch.cuda.synchronize()
    assert LAUNCHES["w4a8_prep"] == prep0
    MM.dense_w4a8_matmul(x(8, 2048), wt)
    F.dense_w4a8_ffn(x(8, 2048), sgu, sdn)
    torch.cuda.synchronize()
    assert LAUNCHES["w4a8_prep"] == prep0 + 1
    MM.dense_w4a8_matmul(x(9, 2048), wt)
    F.dense_w4a8_ffn(x(9, 2048), sgu, sdn)
    torch.cuda.synchronize()
    assert LAUNCHES["w4a8_prep"] == prep0 + 3
