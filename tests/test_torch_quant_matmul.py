"""The plain versions of the port's quant_matmul family and of
mla_decode_attention against the JAX package's Pallas kernels in interpret
mode (ops/pallas/quant_matmul.py, ops/pallas/mla_decode.py).

Weights are quantized by the JAX package from a numpy seed and carried
across with convert.qtensor_from_jax; activations are numpy arrays handed
to both sides.

Tolerances, as a share of the largest |output|: float32 activations 1e-5
(the two sides sum in another order; the MX kinds also differ by the JAX
package's exp2, which is off the exact power of two by ~1e-7 near 2^0);
bfloat16 activations 1e-2 (one bf16 rounding of the output, 2^-8, plus the
odd decoded weight that lands on the other side of a bf16 rounding).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ktransformers_tpu.ops.pallas import mla_decode as jmd
from ktransformers_tpu.ops.pallas import quant_matmul as jqm
from ktransformers_tpu.quant import formats as jf
from ktransformers_tpu.quant import w4a8 as jw
from ktransformers_tpu_torch.convert import qtensor_from_jax, tensor_from_numpy
from ktransformers_tpu_torch.ops.cuda import mla_decode as tmd
from ktransformers_tpu_torch.ops.cuda import quant_matmul as tqm
from ktransformers_tpu_torch.quant.formats import QTensor

KINDS = ("int8", "fp8", "int4", "int4_g", "int4_gz", "mxfp4", "mxfp8")
TOL = {"float32": 1e-5, "bfloat16": 1e-2}


def _weights(kind, shape, seed=0, group_size=128):
    w = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    jq = jf.quantize(jnp.asarray(w * 0.05), kind, group_size=group_size)
    return jq, qtensor_from_jax(jax.device_get(jq), "cpu")


def _x(shape, dtype, seed=1):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return jnp.asarray(x, dtype), torch.from_numpy(x).to(getattr(torch, dtype))


def _close(out: torch.Tensor, ref, dtype):
    ref = np.asarray(ref.astype(jnp.float32))
    out = out.float().numpy()
    assert out.shape == ref.shape
    assert np.isfinite(out).all()
    err = np.abs(out - ref).max() / max(np.abs(ref).max(), 1e-30)
    assert err <= TOL[dtype], err


def test_kinds_are_the_pallas_kinds():
    from ktransformers_tpu.ops.pallas import PALLAS_KINDS

    assert set(tqm.KINDS) == set(PALLAS_KINDS) == set(KINDS)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", KINDS)
def test_quant_matmul(kind, dtype):
    # N = 40 is no multiple of 128; x has a leading batch axis
    jq, tq = _weights(kind, (256, 40))
    jx, tx = _x((2, 5, 256), dtype)
    _close(tqm.quant_matmul(tx, tq), jqm.quant_matmul(jx, jq, interpret=True),
           dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", KINDS)
def test_gathered_quant_matmul(kind, dtype):
    jq, tq = _weights(kind, (6, 128, 72))
    ids = np.asarray([3, 0, 5, 3, 1, 1, 4], np.int32)  # expert 2 unused
    jx, tx = _x((7, 128), dtype)
    _close(tqm.gathered_quant_matmul(tx, tq, torch.from_numpy(ids)),
           jqm.gathered_quant_matmul(jx, jq, jnp.asarray(ids),
                                     interpret=True), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", KINDS)
def test_grouped_quant_matmul(kind, dtype):
    """Sorted rows with two empty experts and a tail of 5 masked rows, which
    must come back zero."""
    jq, tq = _weights(kind, (5, 128, 48))
    sizes = np.asarray([9, 0, 70, 0, 4], np.int32)  # 83 of 88 rows live
    jx, tx = _x((88, 128), dtype)
    out = tqm.grouped_quant_matmul(tx, tq, torch.from_numpy(sizes))
    _close(out, jqm.grouped_quant_matmul(jx, jq, jnp.asarray(sizes),
                                         interpret=True), dtype)
    assert not out[83:].float().abs().max()


@pytest.mark.parametrize("kind", ["int4_g", "int4_gz", "mxfp4", "mxfp8"])
def test_group_size_96_and_padded_scales(kind):
    """K = 192 with a group of 96 (int4 kinds; the MX kinds keep 32), and
    scale / zero-point tensors that carry padded group rows, as
    pad_scale_sublanes leaves them: the port reads only the true groups."""
    jq, _ = _weights(kind, (192, 40), group_size=96)
    assert jq.group_size == (32 if kind.startswith("mx") else 96)
    jq = jf.pad_scale_sublanes(jq)
    host = jax.device_get(jq)
    assert host.scales.shape[0] % 8 == 0
    assert host.scales.shape[0] > jf.true_group_count(jq) or kind == "mxfp4"
    tq = QTensor(
        tensor_from_numpy(host.data, "cpu"),
        tensor_from_numpy(host.scales, "cpu"),
        None if host.zeros is None else tensor_from_numpy(host.zeros, "cpu"),
        kind=kind, group_size=host.group_size)
    jx, tx = _x((3, 192), "float32")
    _close(tqm.quant_matmul(tx, tq), jqm.quant_matmul(jx, jq, interpret=True),
           "float32")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["int4", "int4_g"])
def test_offset_lo_dense(kind, dtype, monkeypatch):
    """Repacked (offset-lo) data given to quant_matmul is decoded as
    lo = (b & 15) - 8. The JAX package sends such weights here only past
    its W4A8 row limit, so that limit is set to 0 for the reference."""
    jq, _ = _weights(kind, (256, 40), seed=3)
    jr = jw.repack_offset_lo(jq)
    tr = qtensor_from_jax(jax.device_get(jr), "cpu")
    assert tr.act_quant and tr.data.dtype == torch.int8
    jx, tx = _x((4, 256), dtype)
    monkeypatch.setattr(jqm, "W4A8_DENSE_MAX_M", 0)
    ref = jqm.quant_matmul.__wrapped__(jx, jr, interpret=True)
    _close(tqm.quant_matmul(tx, tr), ref, dtype)
    # and it is the same function as on the data before the repack
    _close(tqm.quant_matmul(tx, tr),
           jqm.quant_matmul(jx, jq, interpret=True), dtype)


def test_offset_lo_grouped(monkeypatch):
    """The reference's bf16-dequant grouped kernel on offset-lo data
    (KT_GROUPED_IMPL=bf16)."""
    jq, _ = _weights("int4_g", (3, 128, 40), seed=4)
    jr = jw.repack_offset_lo(jq)
    tr = qtensor_from_jax(jax.device_get(jr), "cpu")
    sizes = np.asarray([5, 0, 11], np.int32)
    jx, tx = _x((16, 128), "float32")
    monkeypatch.setattr(jqm, "_GROUPED_IMPL", "bf16")
    ref = jqm.grouped_quant_matmul.__wrapped__(jx, jr, jnp.asarray(sizes),
                                               interpret=True)
    _close(tqm.grouped_quant_matmul(tx, tr, torch.from_numpy(sizes)), ref,
           "float32")


@pytest.mark.parametrize("kind", ["int8", "int4_g offset-lo", "mxfp4"])
def test_plain_versions_above_the_crossover(kind, monkeypatch):
    """bf16 calls of 96 rows (past MMA_MIN_ROWS and one 64-row tile: the
    tensor-core kernel's route on the card) against the Pallas kernels:
    dense, and grouped over sorted rows with an empty expert, a group longer
    than one 64-row tile and 6 masked rows."""
    base = "int4_g" if kind.endswith("offset-lo") else kind
    jq, tq = _weights(base, (256, 176), seed=21)
    jg, tg = _weights(base, (3, 256, 176), seed=22)
    if base != kind:
        jq, jg = jw.repack_offset_lo(jq), jw.repack_offset_lo(jg)
        tq = qtensor_from_jax(jax.device_get(jq), "cpu")
        tg = qtensor_from_jax(jax.device_get(jg), "cpu")
        monkeypatch.setattr(jqm, "W4A8_DENSE_MAX_M", 0)
        monkeypatch.setattr(jqm, "_GROUPED_IMPL", "bf16")
    jx, tx = _x((96, 256), "bfloat16", seed=23)
    assert tqm.route(tx.dtype, 96, "dense", tq.kind, 256, 176,
                     tqm.rows_per_group(tq)) == "mma"
    dense = getattr(jqm.quant_matmul, "__wrapped__", jqm.quant_matmul)
    _close(tqm.quant_matmul(tx, tq), dense(jx, jq, interpret=True),
           "bfloat16")
    sizes = np.asarray([70, 0, 20], np.int32)
    grouped = getattr(jqm.grouped_quant_matmul, "__wrapped__",
                      jqm.grouped_quant_matmul)
    out = tqm.grouped_quant_matmul(tx, tg, torch.from_numpy(sizes))
    _close(out, grouped(jx, jg, jnp.asarray(sizes), interpret=True),
           "bfloat16")
    assert not out[90:].float().abs().max()


@pytest.mark.parametrize("dtype, m, entry, kind, k, n, rpg, want", [
    (torch.bfloat16, 2, "dense", "int8", 2048, 3648, 2048, "mma"),
    (torch.bfloat16, 8, "dense", "int8", 2048, 3648, 2048, "mma"),
    (torch.bfloat16, 1, "dense", "int4_g", 2048, 3648, 64, "gemv"),
    (torch.float32, 256, "dense", "int8", 2048, 3648, 2048, "rows"),
    (torch.bfloat16, 48, "gathered", "int8", 2048, 2816, 2048, "gemv"),
    (torch.float32, 1, "dense", "int8", 10944, 2048, 10944, "gemv"),
    (torch.bfloat16, 1, "dense", "int8", 192, 40, 192, "rows"),
    (torch.bfloat16, 7, "gathered", "int8", 128, 72, 128, "rows"),
    (torch.bfloat16, 1, "dense", "int8", 2052, 48, 2052, "rows"),
    (torch.bfloat16, 1, "grouped", "int8", 2048, 3648, 2048, "rows"),
    (torch.bfloat16, 1536, "grouped", "int4_gz", 2048, 2816, 64, "mma"),
    (torch.bfloat16, 256, "dense", "int4_g", 10944, 2048, 48, "mma"),
    (torch.bfloat16, 256, "dense", "mxfp4", 2048, 3648, 16, "mma"),
    (torch.bfloat16, 256, "dense", "mxfp8", 2048, 3648, 32, "mma"),
    (torch.bfloat16, 256, "dense", "int4_g", 2048, 3648, 8, "rows"),
    (torch.bfloat16, 256, "dense", "mxfp8", 2048, 3648, 16, "rows"),
    (torch.bfloat16, 256, "dense", "int8", 192, 40, 192, "rows"),
    (torch.bfloat16, 256, "dense", "fp8", 2052, 48, 2052, "rows"),
])
def test_route_rule(dtype, m, entry, kind, k, n, rpg, want):
    """Which kernel a CUDA call takes, as a pure function of the call:
    one-row dense and every gathered call take quant_gemv_kernel where N
    is a multiple of 16 and K and the group's storage rows of 8; bf16, at
    least MMA_MIN_ROWS rows, dense or grouped, N a multiple of 16, K of 8,
    and a scale group of whole stages (16 storage rows for the nibble
    kinds, 32 for the others) take quant_mma_kernel."""
    assert tqm.MMA_MIN_ROWS == 2 and tqm.MMA_BM == 64
    assert tqm.route(dtype, m, entry, kind, k, n, rpg) == want


# storage rows of a scale group at DeepSeek-V2-Lite's qkv_a (K = 2048, the
# registry's group sizes: 128 for the int4 group kinds, 32 for MX)
QKV_A_RPG = {"int8": 2048, "fp8": 2048, "int4": 1024, "int4_g": 64,
             "int4_gz": 64, "mxfp4": 16, "mxfp8": 32}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("kind", KINDS)
def test_route_gemv_every_kind(kind, dtype):
    """Every kind and both dtypes: one-row dense calls and every gathered
    call (decode 6 rows, served batch-8 48 rows) take the GEMV; calls of
    two rows or more keep their routes (bf16: the tensor-core kernel;
    float32: the first version)."""
    rpg = QKV_A_RPG[kind]
    assert tqm.route(dtype, 1, "dense", kind, 2048, 3648, rpg) == "gemv"
    for rows in (6, 48):
        assert tqm.route(dtype, rows, "gathered", kind, 2048, 2816,
                         rpg) == "gemv"
    several = "mma" if dtype == torch.bfloat16 else "rows"
    for m in (2, 8, 256):
        assert tqm.route(dtype, m, "dense", kind, 2048, 3648, rpg) == several
    assert tqm.route(dtype, 1536, "grouped", kind, 2048, 2816,
                     rpg) == several


# (N, tiles, storage rows, storage rows a group): DeepSeek-V2-Lite's int8
# qkv_a / o_proj / lm_head / layer-0 down at M = 1, int4_g layer-0 down
# (group 96), int4_g and MX qkv_a, the gathered gate_up / down at 6 and 48
# rows; Mixtral-8x7B's int8 qkv / o_proj / lm_head
GEMV_SHAPES = [
    (3648, 1, 2048, 2048), (2048, 1, 2048, 2048), (102400, 1, 2048, 2048),
    (2048, 1, 10944, 10944), (2048, 1, 5472, 48), (3648, 1, 1024, 64),
    (3648, 1, 1024, 16), (3648, 1, 2048, 32), (2816, 6, 2048, 2048),
    (2048, 6, 1408, 1408), (2816, 48, 2048, 2048), (2048, 48, 1408, 1408),
    (6144, 1, 4096, 4096), (4096, 1, 4096, 4096), (32000, 1, 4096, 4096),
    (40, 1, 192, 96), (48, 1, 64, 8),
]


@pytest.mark.parametrize("kind", ["int8", "mxfp8"])
@pytest.mark.parametrize("n, tiles, kr, rpg", GEMV_SHAPES)
def test_gemv_plan(n, tiles, kr, rpg, kind):
    """The split rule of the GEMV: the splits (and within each, the row
    lanes of a block, as the kernel cuts them) cover every storage row
    exactly once; a split starts and ends on a scale group boundary where
    its granule is a group, and on a unit of 8 rows inside one group
    otherwise; every lane keeps a unit; the grid reaches
    gemv_blocks_per_sm(kind) blocks an SM where the rows allow."""
    sms = 132
    per_sm = tqm.gemv_blocks_per_sm(kind)
    splits, gran = tqm.gemv_plan(n, tiles, kr, rpg, sms, kind)
    unit = tqm.GEMV_UNIT
    assert rpg % unit == 0 and kr % (unit * gran) == 0
    spans = tqm.gemv_split_rows(kr, splits, gran)
    assert len(spans) == splits and spans[0][0] == 0 and spans[-1][1] == kr
    assert all(a[1] == b[0] for a, b in zip(spans, spans[1:]))
    seen = np.zeros(kr, np.int32)
    for lo, hi in spans:
        assert hi - lo >= tqm.GEMV_LANES * unit  # a unit for every lane
        assert lo % (unit * gran) == 0
        if gran > 1:
            assert gran * unit == rpg and lo % rpg == 0 and hi % rpg == 0
        elif rpg >= tqm.GEMV_LANES * unit and 1 < splits <= kr // rpg:
            raise AssertionError("groups of a unit a lane left unused")
        u0, u1 = lo // unit, hi // unit
        for ly in range(tqm.GEMV_LANES):  # the kernel's lane runs
            l0 = u0 + (u1 - u0) * ly // tqm.GEMV_LANES
            l1 = u0 + (u1 - u0) * (ly + 1) // tqm.GEMV_LANES
            seen[l0 * unit:l1 * unit] += 1
    assert (seen == 1).all()
    # no unit straddles a scale group
    assert all((u * unit) // rpg == (u * unit + unit - 1) // rpg
               for u in range(kr // unit))
    blocks = -(-n // tqm.GEMV_BN) * tiles * splits
    most = kr // unit // tqm.GEMV_LANES
    assert blocks >= per_sm * sms or splits == max(1, most)
    assert splits == 1 or blocks < (per_sm + 1) * sms \
        + -(-n // tqm.GEMV_BN) * tiles


def test_gemv_plan_reaches_the_card_at_decode():
    """DeepSeek-V2-Lite's qkv_a and layer-0 down at M = 1 (29 and 16 blocks
    of the first version) get at least two blocks an SM; o_proj (16 blocks
    of the first version) as many as its 2048 rows allow, 32 splits of
    eight 8-row units."""
    for n, kr in ((3648, 2048), (2048, 10944)):
        splits, _ = tqm.gemv_plan(n, 1, kr, kr, 132)
        assert -(-n // tqm.GEMV_BN) * splits >= 2 * 132
    assert tqm.gemv_plan(2048, 1, 2048, 2048, 132) == (32, 1)
    assert tqm.gemv_blocks_per_sm("int8") == 2
    assert {tqm.gemv_blocks_per_sm(k) for k in KINDS if k != "int8"} == {4}


@pytest.mark.parametrize("kind, shape, group, want", [
    ("int8", (2048, 3648), 128, 2048), ("fp8", (1408, 2048), 128, 1408),
    ("int4", (2048, 256), 128, 1024), ("int4_g", (2048, 256), 128, 64),
    ("int4_g", (10944, 256), 128, 48), ("mxfp4", (2048, 256), 128, 16),
    ("mxfp8", (2048, 256), 128, 32), ("int4_gz", (192, 64), 128, 48),
])
def test_rows_per_group(kind, shape, group, want):
    _, tq = _weights(kind, shape, group_size=group)
    assert tqm.rows_per_group(tq) == want


def test_ue8m0_exponent_zero_decodes_to_zero():
    """A ue8m0 exponent of 0 (2^-127, below float32's normal range) decodes
    to a scale of 0, as the JAX package's exp2 gives on the CPU: the group
    contributes nothing and the output stays finite and equal."""
    jq, tq = _weights("mxfp4", (64, 40), seed=5)
    s = np.asarray(jq.scales).copy()
    s[0] = 0  # the first of the two groups
    jq = dataclasses.replace(jq, scales=jnp.asarray(s))
    tq = dataclasses.replace(tq, scales=torch.from_numpy(s))
    jx, tx = _x((2, 64), "float32")
    out = tqm.quant_matmul(tx, tq)
    _close(out, jqm.quant_matmul(jx, jq, interpret=True), "float32")
    only_second = tqm.quant_matmul(
        torch.cat([torch.zeros(2, 32), tx[:, 32:]], dim=1), tq)
    np.testing.assert_array_equal(out.numpy(), only_second.numpy())


@pytest.mark.parametrize("kind", ["int8", "int4_gz", "mxfp4"])
def test_gathered_matmul_per_expert_inputs(kind):
    """ops/moe.gathered_matmul with x [T, K] and with per-expert inputs
    x [T, k, K], against the JAX package's with its gather hook in
    interpret mode."""
    from ktransformers_tpu.ops import moe as jmoe
    from ktransformers_tpu_torch.ops import moe as tmoe

    jq, tq = _weights(kind, (6, 128, 40), seed=6)
    ids = np.asarray([[0, 5], [2, 2], [4, 1]], np.int32)
    old = jmoe._PALLAS_GATHER
    jmoe.set_pallas_gather(
        lambda x, w, i: jqm.gathered_quant_matmul(x, w, i, interpret=True))
    try:
        for shape in ((3, 128), (3, 2, 128)):
            jx, tx = _x(shape, "float32", seed=len(shape))
            ref = jmoe.gathered_matmul(jx, jq, jnp.asarray(ids))
            out = tmoe.gathered_matmul(tx, tq, torch.from_numpy(ids))
            assert tuple(out.shape) == (3, 2, 40)
            _close(out, ref, "float32")
    finally:
        jmoe.set_pallas_gather(old)


def test_linear_dispatch_matches_jax():
    """ops/linear.qmatmul against the JAX package's with its qmatmul hook
    in interpret mode: a kernel kind goes to quant_matmul, int8_g (no
    kernel in either package) to the plain group contraction, bf16 to a
    plain matmul."""
    from ktransformers_tpu.ops import linear as jlinear
    from ktransformers_tpu.ops.pallas import PALLAS_KINDS
    from ktransformers_tpu_torch.ops import linear as tlinear

    old = jlinear._PALLAS_QMATMUL
    jlinear.set_pallas_qmatmul(
        lambda x, w: jqm.quant_matmul(x, w, interpret=True)
        if w.kind in PALLAS_KINDS else None)
    try:
        for kind in ("int8", "int8_g", "bf16"):
            jq, tq = _weights(kind, (256, 40), seed=10)
            jx, tx = _x((3, 256), "float32")
            _close(tlinear.qmatmul(tx, tq), jlinear.qmatmul(jx, jq),
                   "bfloat16" if kind == "bf16" else "float32")
    finally:
        jlinear.set_pallas_qmatmul(old)


def test_wrappers_refuse_what_the_kernel_does_not_take():
    _, tq = _weights("int8", (64, 40))
    x = torch.zeros(2, 64)
    with pytest.raises(ValueError, match="x must be"):
        tqm.quant_matmul(torch.zeros(2, 32), tq)
    with pytest.raises(ValueError, match="unsupported kind"):
        tqm.quant_matmul(x, dataclasses.replace(tq, kind="int8_g"))
    with pytest.raises(ValueError, match="scales"):
        tqm.quant_matmul(x, dataclasses.replace(tq, scales=tq.scales[:, :8]))
    with pytest.raises(ValueError, match="ids"):
        tqm.gathered_quant_matmul(
            x, tqm.lift(tq), torch.zeros(3, dtype=torch.int32))
    with pytest.raises(ValueError, match="group_sizes"):
        tqm.grouped_quant_matmul(
            x, tqm.lift(tq), torch.zeros(3, dtype=torch.int32))
    _, tz = _weights("int4_gz", (64, 40))
    with pytest.raises(ValueError, match="zero points"):
        tqm.quant_matmul(x, dataclasses.replace(tz, zeros=None))


def test_w4a8_experts_outside_the_fused_ffn_raise():
    """Repacked int4 experts that the fused FFN refuses (here: a
    swiglu_limit) run through the unfused W4A8 matmuls, as in the JAX
    package: gathered_w4a8_matmul at decode, grouped_w4a8_matmul at
    prefill, the GLU between them, never a plain product. Experts of a
    kind no kernel takes (int8_g) run the plain product; a kind that
    neither covers still raises NotImplementedError."""
    from ktransformers_tpu_torch.ops.activations import (
        ActivationConfig,
        glu_activate,
    )
    from ktransformers_tpu_torch.ops.cuda import w4a8_matmul as MM
    from ktransformers_tpu_torch.ops.moe import MoEWeights, moe_forward
    from ktransformers_tpu_torch.quant.formats import quantize
    from ktransformers_tpu_torch.quant.w4a8 import repack_offset_lo

    rng = np.random.default_rng(7)
    gu = repack_offset_lo(quantize(torch.from_numpy(
        rng.standard_normal((4, 128, 64)).astype(np.float32)), "int4_g"))
    dn = repack_offset_lo(quantize(torch.from_numpy(
        rng.standard_normal((4, 32, 128)).astype(np.float32)), "int4_g"))
    act = ActivationConfig(kind="silu", swiglu_limit=7.0)
    for t in (2, 12):  # gather path and grouped path
        idx = torch.from_numpy(rng.integers(0, 4, (t, 2)))
        x = torch.from_numpy(rng.standard_normal((t, 128)).astype(np.float32))
        w = torch.full((t, 2), 0.5)
        out = moe_forward(x, MoEWeights(gu, dn), idx, w, act)
        rows = x[:, None].expand(t, 2, 128).reshape(2 * t, 128)
        ids = idx.reshape(-1).to(torch.int32)
        h = MM.gathered_w4a8_matmul(rows, gu, ids)
        a = glu_activate(h[:, :32], h[:, 32:], act)
        want = MM.gathered_w4a8_matmul(a, dn, ids).reshape(t, 2, 128)
        np.testing.assert_allclose(out.numpy(), (0.5 * want).sum(1).numpy(),
                                   rtol=1e-5, atol=1e-5)
    g8 = quantize(torch.from_numpy(
        rng.standard_normal((4, 128, 64)).astype(np.float32)), "int8_g")
    d8 = quantize(torch.from_numpy(
        rng.standard_normal((4, 32, 128)).astype(np.float32)), "int8_g")
    x = torch.from_numpy(rng.standard_normal((2, 128)).astype(np.float32))
    idx = torch.zeros(2, 2, dtype=torch.int64)
    out = moe_forward(x, MoEWeights(g8, d8), idx, torch.ones(2, 2))
    assert out.shape == (2, 128) and bool(torch.isfinite(out).all())
    with pytest.raises(NotImplementedError, match="neither a kernel"):
        moe_forward(x, MoEWeights(dataclasses.replace(g8, kind="int2"), d8),
                    idx, torch.ones(2, 2))


# --------------------------------------------------- mla_decode_attention


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("block", [16, 512])
def test_mla_decode_attention(block, dtype):
    """Against mla_decode_attention(interpret=True) with NaN in every cache
    row at or past lengths[b], at lengths k * block and k * block + 1, a
    single row, the full cache and an empty sequence. Tolerance 2e-5 of the
    largest output in float32 (online softmax against one softmax), 1e-2
    in bfloat16."""
    rng = np.random.default_rng(8)
    b, h, r, dr, smax = 6, 4, 64, 16, 64
    lengths = np.asarray([32, 33, 1, 64, 0, 17], np.int32)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    qn, qp, ckv, kpe = f(b, h, r), f(b, h, dr), f(b, smax, r), f(b, smax, dr)
    for i, n in enumerate(lengths):
        ckv[i, n:] = np.nan
        kpe[i, n:] = np.nan
    scale = (r + dr) ** -0.5
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    ref = jmd.mla_decode_attention(
        jnp.asarray(qn, jdt), jnp.asarray(qp, jdt), jnp.asarray(ckv, jdt),
        jnp.asarray(kpe, jdt), jnp.asarray(lengths), scale=scale,
        block_s=block, interpret=True)
    t = lambda a: torch.from_numpy(a).to(tdt)  # noqa: E731
    out = tmd.mla_decode_attention(t(qn), t(qp), t(ckv), t(kpe),
                                   torch.from_numpy(lengths), scale)
    ref = np.asarray(ref.astype(jnp.float32))
    out = out.float().numpy()
    assert np.isfinite(out).all() and not np.abs(out[4]).max()
    err = np.abs(out - ref).max() / np.abs(ref).max()
    assert err <= (2e-5 if dtype == "float32" else 1e-2), err


def test_mla_decode_hook_matches_jax():
    """ops/attention.mla_decode ([B, H, 1, R] shaped) against the JAX
    package's with its decode hook in interpret mode."""
    from ktransformers_tpu.ops import attention as jatt
    from ktransformers_tpu_torch.ops import attention as tatt

    rng = np.random.default_rng(9)
    b, h, r, dr, smax = 2, 4, 64, 16, 32
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    qn, qp, ckv, kpe = f(b, h, 1, r), f(b, h, 1, dr), f(b, smax, r), f(b, smax, dr)
    lengths = np.asarray([7, 32], np.int32)
    old = jatt._PALLAS_MLA_DECODE
    jatt.set_pallas_mla_decode(
        lambda a, c, d, e, ln, s: jmd.mla_decode_attention(
            a, c, d, e, ln, s, interpret=True))
    try:
        ref = np.asarray(jatt.mla_decode(
            jnp.asarray(qn), jnp.asarray(qp), jnp.asarray(ckv),
            jnp.asarray(kpe), jnp.asarray(lengths), scale=0.125))
    finally:
        jatt.set_pallas_mla_decode(old)
    out = tatt.mla_decode(*(torch.from_numpy(a) for a in (qn, qp, ckv, kpe)),
                          torch.from_numpy(lengths), scale=0.125).numpy()
    assert out.shape == ref.shape == (b, h, 1, r)
    assert np.abs(out - ref).max() <= 2e-5 * np.abs(ref).max()
