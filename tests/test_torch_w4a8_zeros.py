"""W4A8 on int4 weights with a zero point and a per-channel group: int4_gz
at group 32 (GGUF Q4_K, Q4_1) and 16 (Q2_K), and int4 with one group of
all K (per channel).

On the CPU (JAX imported inside the tests, the JAX package's Pallas kernels
in interpret mode):
- the offset-lo repack takes all three kinds, bit-exact with the JAX
  package's, keeping the zero points and the group (0: per channel);
- each W4A8 entry's plain version (dense, gathered and grouped matmul;
  dense, gathered and grouped FFN) against the Pallas kernel: the zero
  term - xsum * z of every scale group (and of every down group of the
  FFN's requantized activation), group_size or K;
- the routes: groups 32, 16 and K take the tensor-core kernels from two
  rows on, the GEMVs at one-row tiles; a per-channel down group takes the
  FFN's "split" route; the GEMV's split plan cuts a per-channel group into
  whole units.

On the card (the ``cuda`` fixture; they skip here), at DeepSeek-V2-Lite's
widths: each kernel held to its plain version on the same operands, folded
= unfolded bits, a second call bit-identical (-m cuda: the JAX tests are
for the CPU, where the JAX package runs its Pallas kernels interpreted):

    python -m pytest --noconftest -m cuda tests/test_torch_w4a8_zeros.py -q

Tolerances, as a share of the reference's largest magnitude: 1e-4 for the
matmuls (both sides run the same integer dots and differ in the order of
float32 sums, as tests/test_torch_kernels.py), 1e-2 for the FFNs (a
reordered float32 sum can move an int8 code of the requant by one step,
1/127 of its group's largest value, as tests/test_torch_w4a8_gemv.py). On
the card: 1e-2 for the matmuls and 3e-2 for the FFNs, chip_smoke.py's.
"""

import numpy as np
import pytest
import torch

from ktransformers_tpu_torch.ops.cuda import LAUNCHES, ROUTED_LAUNCHES
from ktransformers_tpu_torch.ops.cuda import w4a8_ffn as F
from ktransformers_tpu_torch.ops.cuda import w4a8_matmul as MM
from ktransformers_tpu_torch.quant import formats as tf
from ktransformers_tpu_torch.quant.w4a8 import repack_offset_lo

TOL = 1e-4
FFN_TOL = 1e-2
CARD_TOL = 1e-2
CARD_FFN_TOL = 3e-2
SMS = 132
# (kind, group): GGUF Q4_K / Q4_1 blocks, Q2_K blocks, per-channel int4
KINDS = [("int4_gz", 32), ("int4_gz", 16), ("int4", 0)]
K, N, E, INTER = 128, 128, 4, 128
FK, FINTER = 64, 32  # the FFN tests' K and I (the Pallas FFNs compile
# one dot pair a scale group, so their trace grows with K / group)


def _rel(out, ref):
    out = np.asarray(torch.as_tensor(out).detach().float().cpu())
    ref = np.asarray(torch.as_tensor(ref).detach().float().cpu())
    return float(np.abs(out - ref).max() / np.abs(ref).max())


def _jax():
    """The JAX package's pieces these tests hold the port against."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp

    from ktransformers_tpu.ops.pallas import w4a8_matmul as jwm
    from ktransformers_tpu.quant.formats import quantize as jq
    from ktransformers_tpu.quant.w4a8 import repack_offset_lo as jr

    return jax, jnp, jwm, jq, jr


_JIT_QUANTIZE = {}


def _weights(rng, shape, kind, gs):
    """(JAX repacked, port repacked) of one random weight [.., K, N]: the
    JAX package's quantize under one jit (one compile a shape where eager
    ops compile one by one; both sides take its codes, so its rounding is
    theirs), its repack as it is."""
    jax, jnp, _, jq, jr = _jax()
    from ktransformers_tpu_torch.convert import qtensor_from_jax

    if (kind, gs) not in _JIT_QUANTIZE:
        _JIT_QUANTIZE[kind, gs] = jax.jit(
            lambda v: jq(v, kind, group_size=gs) if gs else jq(v, kind))
    w = jnp.asarray(rng.standard_normal(shape).astype(np.float32) * 0.1)
    jw = jr(_JIT_QUANTIZE[kind, gs](w))
    return jw, qtensor_from_jax(jax.device_get(jw), "cpu")


@pytest.mark.parametrize("kind, gs", KINDS)
def test_repack_bit_exact(kind, gs):
    """The port's in-place repack of the JAX package's unrepacked codes is
    the JAX package's repack, bytes and all; zeros and group kept."""
    jax, jnp, _, jq, jr = _jax()
    from ktransformers_tpu_torch.convert import qtensor_from_jax

    rng = np.random.default_rng(1)
    w = jnp.asarray(rng.standard_normal((E, K, N)).astype(np.float32))
    q = jq(w, kind, group_size=gs) if gs else jq(w, kind)
    t = qtensor_from_jax(jax.device_get(q), "cpu")
    assert t.data.dtype == torch.uint8 and not t.act_quant
    zeros = None if t.zeros is None else t.zeros.clone()
    out = repack_offset_lo(t)
    want = qtensor_from_jax(jax.device_get(jr(q)), "cpu")
    assert out is t and t.act_quant and t.group_size == gs
    assert torch.equal(t.data, want.data) and t.data.dtype == torch.int8
    assert torch.equal(t.scales, want.scales)
    if kind == "int4_gz":
        assert torch.equal(t.zeros, zeros) and torch.equal(t.zeros,
                                                           want.zeros)
    assert repack_offset_lo(t) is t and torch.equal(t.data, want.data)


@pytest.mark.parametrize("kind, gs", KINDS)
def test_dense_matmul_matches_pallas(kind, gs):
    _, jnp, jwm, _, _ = _jax()
    rng = np.random.default_rng(2)
    jw, tw = _weights(rng, (K, N), kind, gs)
    x = rng.standard_normal((5, K)).astype(np.float32)
    ref = np.asarray(jwm.dense_w4a8_matmul(jnp.asarray(x), jw,
                                           interpret=True))
    out = MM.dense_w4a8_matmul(torch.from_numpy(x), tw)
    assert _rel(out, ref) <= TOL


@pytest.mark.parametrize("kind, gs", KINDS)
def test_gathered_matmul_matches_pallas(kind, gs):
    _, jnp, jwm, _, _ = _jax()
    rng = np.random.default_rng(3)
    jw, tw = _weights(rng, (E, K, N), kind, gs)
    x = rng.standard_normal((6, K)).astype(np.float32)
    ids = np.array([2, 0, 2, 3, 1, 2], np.int32)
    ref = np.asarray(jwm.gathered_w4a8_matmul(
        jnp.asarray(x), jw, jnp.asarray(ids), interpret=True))
    out = MM.gathered_w4a8_matmul(torch.from_numpy(x), tw,
                                  torch.from_numpy(ids))
    assert _rel(out, ref) <= TOL


@pytest.mark.parametrize("kind, gs", KINDS)
def test_grouped_matmul_matches_pallas(kind, gs):
    _, jnp, jwm, _, _ = _jax()
    rng = np.random.default_rng(4)
    jw, tw = _weights(rng, (E, K, N), kind, gs)
    x = rng.standard_normal((12, K)).astype(np.float32)
    sizes = np.array([3, 0, 5, 2], np.int32)  # rows 10, 11 past the groups
    ref = np.asarray(jwm.grouped_w4a8_matmul(
        jnp.asarray(x), jw, jnp.asarray(sizes), interpret=True))
    out = MM.grouped_w4a8_matmul(torch.from_numpy(x), tw,
                                 torch.from_numpy(sizes))
    assert _rel(out, ref) <= TOL
    assert not out[10:].any()


def _ffn_weights(rng, kind, gs, lead=(E,)):
    jgu, tgu = _weights(rng, (*lead, FK, 2 * FINTER), kind, gs)
    jdn, tdn = _weights(rng, (*lead, FINTER, FK), kind, gs)
    return jgu, tgu, jdn, tdn


@pytest.mark.parametrize("kind, gs", KINDS)
def test_gathered_ffn_matches_pallas(kind, gs):
    _, jnp, jwm, _, _ = _jax()
    rng = np.random.default_rng(5)
    jgu, tgu, jdn, tdn = _ffn_weights(rng, kind, gs)
    x = rng.standard_normal((6, FK)).astype(np.float32)
    ids = np.array([1, 3, 1, 0, 2, 3], np.int32)
    ref = np.asarray(jwm.gathered_w4a8_ffn(
        jnp.asarray(x), jgu, jdn, jnp.asarray(ids), act="silu",
        interpret=True))
    out = F.gathered_w4a8_ffn(torch.from_numpy(x), tgu, tdn,
                              torch.from_numpy(ids))
    assert _rel(out, ref) <= FFN_TOL


@pytest.mark.parametrize("kind, gs", KINDS)
def test_dense_ffn_matches_pallas(kind, gs):
    _, jnp, jwm, _, _ = _jax()
    rng = np.random.default_rng(6)
    jgu, tgu, jdn, tdn = _ffn_weights(rng, kind, gs, lead=())
    x = rng.standard_normal((7, FK)).astype(np.float32)
    ref = np.asarray(jwm.dense_w4a8_ffn(jnp.asarray(x), jgu, jdn, "silu",
                                        FINTER, interpret=True))
    out = F.dense_w4a8_ffn(torch.from_numpy(x), tgu, tdn)
    assert _rel(out, ref) <= FFN_TOL


@pytest.mark.parametrize("kind, gs", KINDS)
def test_grouped_ffn_matches_pallas(kind, gs):
    _, jnp, jwm, _, _ = _jax()
    rng = np.random.default_rng(7)
    jgu, tgu, jdn, tdn = _ffn_weights(rng, kind, gs)
    x = rng.standard_normal((10, FK)).astype(np.float32)
    sizes = np.array([2, 4, 0, 3], np.int32)
    ref = np.asarray(jwm.grouped_w4a8_ffn(
        jnp.asarray(x), jgu, jdn, jnp.asarray(sizes), act="silu",
        interpret=True))
    out = F.grouped_w4a8_ffn(torch.from_numpy(x), tgu, tdn,
                             torch.from_numpy(sizes))
    assert _rel(out[:9], ref[:9]) <= FFN_TOL
    assert not out[9:].any()


# ------------------------------------------------------------- the routes


@pytest.mark.parametrize("m, entry, gs, n, k, want", [
    (2, "dense", 32, 2048, 2048, "mma"), (256, "dense", 16, 3072, 2048,
                                          "mma"),
    (264, "grouped", 32, 2816, 2048, "mma"), (8, "grouped", 16, 2048, 1408,
                                              "mma"),
    (8, "dense", 2048, 3072, 2048, "mma"),          # per channel
    (264, "dense", 10944, 2048, 10944, "mma"),      # per channel, K/2 % 64
    (1, "dense", 32, 2048, 2048, "gemv"), (6, "gathered", 16, 2816, 2048,
                                           "gemv"),
    (1, "dense", 2048, 2048, 2048, "gemv"),
    (8, "dense", 32, 2048, 1376, "rows"),           # K % 64 at group 32
    (8, "dense", 64, 2048, 2048, "rows"),           # group 64: no kernel
])
def test_zero_point_routes(m, entry, gs, n, k, want):
    """Groups 32 and 16 (K a multiple of 64) and one group of all K take
    the tensor-core kernel from two rows on; one-row tiles the GEMV."""
    assert MM.route(m, entry, gs, n, k) == want


@pytest.mark.parametrize("m, entry, gs_up, gs_dn, inter, k, want", [
    (1, "dense", 32, 32, 2816, 2048, "gemv"),
    (6, "gathered", 16, 16, 1408, 2048, "gemv"),
    (8, "dense", 32, 32, 2816, 2048, "mma"),
    (264, "grouped", 16, 16, 1408, 2048, "mma"),
    (8, "dense", 2048, 2816, 2816, 2048, "split"),   # per channel
    (1, "gathered", 2048, 1408, 1408, 2048, "split"),
    (8, "dense", 32, 64, 2816, 2048, "rows"),        # down group 64
])
def test_zero_point_ffn_routes(m, entry, gs_up, gs_dn, inter, k, want):
    assert F.ffn_route(m, entry, gs_up, gs_dn, inter, k) == want


def test_ffn_gemv_blocks_hold_whole_down_groups():
    """A block of the FFN's gate_up GEMV takes up to 128 columns of whole
    down groups: four of 32 at I = 1408, eight of 16, one of 128 or 96;
    the split plan counts those blocks."""
    assert F.ffn_gemv_bc(1408, 32) == 128 and F.ffn_gemv_bc(1408, 16) == 128
    assert F.ffn_gemv_bc(2816, 128) == 128 and F.ffn_gemv_bc(576, 96) == 96
    assert F.ffn_gemv_bc(10944, 32) == 96
    assert F.ffn_gemv_plan(1408, 32, 6, 1024, 16, SMS) == (4, 2)
    assert F.ffn_gemv_plan(1408, 128, 6, 1024, 64, SMS) == (4, 8)


@pytest.mark.parametrize("n, tiles, k2", [(3072, 1, 1024), (2048, 1, 5472),
                                          (2816, 6, 1024)])
def test_per_channel_split_plan(n, tiles, k2):
    """One group of all K is cut inside the group into runs of whole 8-row
    units: every storage row in exactly one split, the grid reaching two
    blocks an SM, and no fold (a fold quantizes whole groups)."""
    splits, gran = MM.w4a8_gemv_plan(n, tiles, k2, k2, SMS)
    assert gran == 1 and splits > 1
    spans = MM.gemv_split_rows(k2, splits, gran)
    seen = np.zeros(k2, np.int32)
    for lo, hi in spans:
        seen[lo:hi] += 1
    assert (seen == 1).all()
    blocks = -(-n // MM.GEMV_BN) * tiles
    assert blocks * splits >= MM.GEMV_BLOCKS_PER_SM * SMS
    assert not MM.gemv_call_folds(n, tiles, 64, 2 * k2, 2 * k2, SMS)


def test_check_takes_every_int4_kind_and_holds_zero_shapes():
    rng = np.random.default_rng(8)
    w = torch.from_numpy(rng.standard_normal((K, N)).astype(np.float32))
    for kind, gs in KINDS:
        q = repack_offset_lo(tf.quantize(w, kind, group_size=gs) if gs
                             else tf.quantize(w, kind))
        assert MM.check_w4a8_weight(q, 2, "t") == (gs or K) // 2
    q = repack_offset_lo(tf.quantize(w, "int4_gz", group_size=32))
    q.zeros = q.zeros[:-1]
    with pytest.raises(ValueError, match="zeros"):
        MM.check_w4a8_weight(q, 2, "t")


# ---------------------------------------------------------------- the card


@pytest.fixture
def cuda():
    """The card, or a skip: CUDA kernels cannot run on the CPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _card_weight(rng, shape, kind, gs, dev):
    w = torch.from_numpy(rng.standard_normal(shape).astype(np.float32) * 0.02)
    q = tf.quantize(w, kind, group_size=gs) if gs else tf.quantize(w, kind)
    return repack_offset_lo(q.to(dev))


def _bits(launch, out):
    launch()
    torch.cuda.synchronize()
    return out.clone()


@pytest.mark.cuda
@pytest.mark.parametrize("kind, gs", KINDS)
@pytest.mark.parametrize("m", [1, 8, 256, 264])
@pytest.mark.parametrize("k, n", [(2048, 3072), (10944, 2048)])
def test_card_dense_matmul(cuda, kind, gs, m, k, n):
    """Row 1 at V2-Lite's qkv_a / dense down widths: the kernel of the
    route against the plain version, folded = unfolded, bit-identical on a
    second call."""
    rng = np.random.default_rng(9)
    w = _card_weight(rng, (k, n), kind, gs, cuda)
    x = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32)).to(
        cuda, torch.bfloat16)
    kernel = MM.route(m, "dense", MM.group_of(w), n, k)
    assert kernel in ("gemv", "mma")
    launch, out = MM.dense_w4a8_launcher(x, w, kernel, fold=False)
    a = _bits(launch, out)
    assert torch.equal(_bits(launch, out), a)
    assert _rel(a, MM.w4a8_matmul_ref(x, w)) <= CARD_TOL
    folds = (MM.gemv_call_folds(n, 1, 1, k, MM.group_of(w), MM.sm_count(cuda))
             if kernel == "gemv" else MM.folds(kernel, m, k, MM.group_of(w),
                                               w.zeros is not None))
    if folds:
        launch, out = MM.dense_w4a8_launcher(x, w, kernel, fold=True)
        assert torch.equal(_bits(launch, out), a)


@pytest.mark.cuda
@pytest.mark.parametrize("kind, gs", KINDS)
@pytest.mark.parametrize("m", [8, 256, 264])
def test_card_expert_matmuls(cuda, kind, gs, m):
    """Rows 7 and 8 at V2-Lite's expert gate_up (64 experts of [2048,
    2816]): the gathered GEMV on 6 rows a token (m / 8 tokens, at most
    128 rows), the grouped tensor-core kernel on m sorted rows."""
    rng = np.random.default_rng(10)
    w = _card_weight(rng, (64, 2048, 2816), kind, gs, cuda)
    x = torch.from_numpy(rng.standard_normal((m, 2048)).astype(
        np.float32)).to(cuda, torch.bfloat16)
    ids = torch.from_numpy(rng.integers(0, 64, m).astype(np.int32)).to(cuda)
    r = min(m, 128)
    launch, out = MM.gathered_launcher(x[:r], w, ids[:r])
    a = _bits(launch, out)
    assert torch.equal(_bits(launch, out), a)
    assert _rel(a, MM.gathered_w4a8_matmul_ref(x[:r], w, ids[:r])) <= CARD_TOL
    sizes = torch.bincount(ids.long(), minlength=64).to(torch.int32)
    assert MM.route(m, "grouped", MM.group_of(w), 2816, 2048) == "mma"
    launch, out = MM.grouped_launcher(x, w, sizes, fold=False)
    a = _bits(launch, out)
    assert torch.equal(_bits(launch, out), a)
    assert _rel(a, MM.grouped_w4a8_matmul_ref(x, w, sizes)) <= CARD_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("kind, gs", KINDS)
@pytest.mark.parametrize("m", [1, 8, 256, 264])
def test_card_ffns(cuda, kind, gs, m):
    """Rows 2-4 at V2-Lite's widths: the shared experts' dense FFN (I =
    2816), the routed experts' gathered FFN (6 rows a token, at most 128)
    and grouped FFN (64 experts, I = 1408)."""
    rng = np.random.default_rng(11)
    x = torch.from_numpy(rng.standard_normal((m, 2048)).astype(
        np.float32)).to(cuda, torch.bfloat16)
    gu = _card_weight(rng, (2048, 2816 * 2), kind, gs, cuda)
    dn = _card_weight(rng, (2816, 2048), kind, gs, cuda)
    launch, out = F.dense_launcher(x, gu, dn)
    a = _bits(launch, out)
    assert torch.equal(_bits(launch, out), a)
    assert _rel(a, F.dense_w4a8_ffn_ref(x, gu, dn)) <= CARD_FFN_TOL
    gu3 = _card_weight(rng, (64, 2048, 2816), kind, gs, cuda)
    dn3 = _card_weight(rng, (64, 1408, 2048), kind, gs, cuda)
    ids = torch.from_numpy(rng.integers(0, 64, m).astype(np.int32)).to(cuda)
    r = min(m, 128)
    launch, out = F.gathered_launcher(x[:r], gu3, dn3, ids[:r])
    a = _bits(launch, out)
    assert _rel(a, F.gathered_w4a8_ffn_ref(x[:r], gu3, dn3, ids[:r])) \
        <= CARD_FFN_TOL
    sizes = torch.bincount(ids.long(), minlength=64).to(torch.int32)
    launch, out = F.grouped_launcher(x, gu3, dn3, sizes)
    a = _bits(launch, out)
    assert torch.equal(_bits(launch, out), a)
    assert _rel(a, F.grouped_w4a8_ffn_ref(x, gu3, dn3, sizes)) \
        <= CARD_FFN_TOL


def test_zero_point_calls_count_the_zero_term_instantiations():
    """A W4A8 call counts its redesigned kernels in ROUTED_LAUNCHES under
    the instantiation the C launchers pick: with the zero term ("<zp>")
    where the weight has zero points, each FFN kernel by its own weight
    (the gate_up kernel by gate_up, the down by down); every such name is
    a kernel of ROUTED_KERNELS."""
    from ktransformers_tpu_torch.ops.cuda import ROUTED_KERNELS

    rng = np.random.default_rng(13)
    gz = repack_offset_lo(tf.quantize(torch.from_numpy(
        rng.standard_normal((K, N)).astype(np.float32)), "int4_gz",
        group_size=32))
    g = repack_offset_lo(tf.quantize(torch.from_numpy(
        rng.standard_normal((K, N)).astype(np.float32)), "int4_g",
        group_size=128))
    assert MM.kernel_name("mma", gz) == "w4a8_mma_kernel<zp>"
    assert MM.kernel_name("gemv", gz) == "w4a8_gemv_kernel<zp>"
    assert MM.kernel_name("mma", g) == "w4a8_mma_kernel"
    assert F.route_kernels("mma", gz, g) == ("w4a8_ffn_mma_kernel<zp>",
                                             "w4a8_mma_kernel")
    assert F.route_kernels("mma", g, g) == ("w4a8_ffn_mma_kernel",
                                            "w4a8_mma_kernel")
    assert F.route_kernels("gemv", g, gz) == ("w4a8_ffn_gemv_kernel",
                                              "w4a8_gemv_kernel<zp>")
    assert F.route_kernels("rows", gz, gz) == ()
    for route in ("mma", "gemv"):
        for a in (g, gz):
            assert MM.kernel_name(route, a) in ROUTED_KERNELS
            for b in (g, gz):
                assert set(F.route_kernels(route, a, b)) <= set(
                    ROUTED_KERNELS)
    assert "w4a8_prep_block_kernel" in ROUTED_KERNELS


@pytest.mark.cuda
def test_card_zero_weights_launch_no_first_version(cuda):
    """int4_gz at group 32 through every entry at M = 8 counts only the
    redesigned kernels' instantiations with the zero term."""
    from ktransformers_tpu_torch.ops.cuda import reset_launches

    rng = np.random.default_rng(12)
    x = torch.from_numpy(rng.standard_normal((8, 2048)).astype(
        np.float32)).to(cuda, torch.bfloat16)
    w = _card_weight(rng, (2048, 3072), "int4_gz", 32, cuda)
    gu = _card_weight(rng, (2048, 5632), "int4_gz", 32, cuda)
    dn = _card_weight(rng, (2816, 2048), "int4_gz", 32, cuda)
    reset_launches()
    MM.dense_w4a8_matmul(x, w)
    F.dense_w4a8_ffn(x, gu, dn)
    F.dense_w4a8_ffn(x[:1], gu, dn)
    torch.cuda.synchronize()
    assert ROUTED_LAUNCHES["w4a8_mma_kernel<zp>"] == 2
    assert ROUTED_LAUNCHES["w4a8_ffn_mma_kernel<zp>"] == 1
    assert ROUTED_LAUNCHES["w4a8_ffn_gemv_kernel<zp>"] == 1
    assert ROUTED_LAUNCHES["w4a8_gemv_kernel<zp>"] == 1
    for name in F.ROUTE_KERNELS["mma"] + F.ROUTE_KERNELS["gemv"]:
        assert ROUTED_LAUNCHES[name] == 0, name
    assert LAUNCHES["dense_w4a8_ffn"] == 2
