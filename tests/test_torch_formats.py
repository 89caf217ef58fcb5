"""Every quant format of the port against the JAX package's
(quant/formats.py): quantize is bit-exact in data, scales, zero points and
exponents for the same numpy input, dequantize is bit-exact too, and
convert.qtensor_from_jax carries every format across (zero points, fp8
data, ue8m0 exponents, per-channel scales, padded group rows).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ktransformers_tpu.quant import formats as jf
from ktransformers_tpu_torch.convert import qtensor_from_jax
from ktransformers_tpu_torch.quant import formats as tf

KINDS = ("int8", "int4", "int4_g", "int4_gz", "int8_g", "fp8", "mxfp4",
         "mxfp8")
SHAPES = [(256, 96), (3, 192, 40), (10944, 8)]


def _bits(a) -> np.ndarray:
    """numpy / torch array as comparable bits (fp8 has no numpy dtype)."""
    if isinstance(a, torch.Tensor):
        return (a.view(torch.uint8) if a.element_size() == 1 else a).numpy()
    a = np.asarray(a)
    return a.view(np.uint8) if a.dtype.itemsize == 1 else a


def _input(shape, seed=1):
    w = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    # exact powers of two and a column of zeros: the edges of the MX
    # exponent and of the absmax clamp
    w[..., 0, 0] = 4.0
    w[..., 5, 1] = -0.5
    w[..., :, 2] = 0.0
    return w


def _same(tq: tf.QTensor, jq) -> None:
    assert tq.kind == jq.kind and tq.group_size == jq.group_size
    assert tq.act_quant == jq.act_quant
    for name in ("data", "scales", "zeros"):
        a, b = getattr(tq, name), getattr(jq, name)
        assert (a is None) == (b is None), name
        if a is not None:
            assert str(a.dtype).split(".")[-1] == str(np.asarray(b).dtype), name
            np.testing.assert_array_equal(_bits(a), _bits(b), err_msg=name)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("kind", KINDS)
def test_quantize_bit_exact(kind, shape):
    w = _input(shape)
    jq = jf.quantize(jnp.asarray(w), kind, group_size=128)
    tq = tf.quantize(torch.from_numpy(w), kind, group_size=128)
    _same(tq, jax.device_get(jq))
    assert tq.in_features == shape[-2] and tq.out_features == shape[-1]
    assert tf.true_group_count(tq) == jf.true_group_count(jq)
    np.testing.assert_array_equal(
        tf.dequantize(tq, torch.float32).numpy(),
        np.asarray(jf.dequantize(jq, jnp.float32)))
    np.testing.assert_array_equal(
        tf.dequantize(tq, torch.bfloat16).float().numpy(),
        np.asarray(jf.dequantize(jq, jnp.bfloat16).astype(jnp.float32)))


@pytest.mark.parametrize("kind", ["bf16", "f32"])
def test_quantize_plain_kinds(kind):
    w = _input((64, 8))
    tq = tf.quantize(torch.from_numpy(w), kind)
    jq = jf.quantize(jnp.asarray(w), kind)
    assert tq.kind == jq.kind == "bf16" and tq.scales is None
    np.testing.assert_array_equal(tq.data.float().numpy(),
                                  np.asarray(jq.data.astype(jnp.float32)))
    with pytest.raises(ValueError, match="unknown quant kind"):
        tf.quantize(torch.from_numpy(w), "int3")


def test_unpack_uint4_and_e2m1_tables():
    rng = np.random.default_rng(2)
    packed = rng.integers(0, 256, (2, 64, 8)).astype(np.uint8)
    for gs in (0, 32):
        np.testing.assert_array_equal(
            tf.unpack_uint4(torch.from_numpy(packed), gs).numpy(),
            np.asarray(jf.unpack_uint4(jnp.asarray(packed), gs)))
    codes = np.arange(16, dtype=np.uint8)
    np.testing.assert_array_equal(
        tf.e2m1_decode(torch.from_numpy(codes)).numpy(),
        np.asarray(jf.e2m1_decode(jnp.asarray(codes))))
    # encode: every midpoint, its neighbours, and values past saturation
    v = np.asarray([0, .24, .25, .26, .75, 1.25, 1.75, 2.5, 3.5, 5, 5.1, 6, 7,
                    100], np.float32)
    v = np.concatenate([v, -v])
    np.testing.assert_array_equal(
        tf.e2m1_encode(torch.from_numpy(v)).numpy(),
        np.asarray(jf.e2m1_encode(jnp.asarray(v))))


def test_ue8m0_scale_exponent():
    """Equal to the JAX package's on random magnitudes; at exact powers of
    two the port's is the exact floor(log2), the JAX package's log2 may
    land one below."""
    rng = np.random.default_rng(3)
    a = np.exp(rng.uniform(-40, 40, 4000)).astype(np.float32)
    a = np.concatenate([a, np.asarray([0.0, 1e-38, 3e38], np.float32)])
    for elem_max in (6.0, 448.0):
        np.testing.assert_array_equal(
            tf.ue8m0_scale_exponent(torch.from_numpy(a), elem_max).numpy(),
            np.asarray(jf.ue8m0_scale_exponent(jnp.asarray(a), elem_max)))
    p = np.ldexp(np.float32(1), np.arange(-100, 100)).astype(np.float32)
    got = tf.ue8m0_scale_exponent(torch.from_numpy(p), 6.0).numpy()
    np.testing.assert_array_equal(got, np.arange(-100, 100) - 2 + 127)


def test_ue8m0_to_scale_is_the_exact_power():
    e = np.arange(256, dtype=np.uint8)
    s = tf.ue8m0_to_scale(torch.from_numpy(e)).numpy()
    assert s[0] == 0.0 and np.isinf(s[255])
    np.testing.assert_array_equal(
        s[1:255], np.ldexp(np.float64(1), np.arange(1, 255) - 127).astype(
            np.float32))
    # the JAX package's exp2 on the CPU: 0 at e = 0, within 1e-5 elsewhere
    j = np.asarray(jnp.exp2(jnp.asarray(e, jnp.float32) - 127.0))
    assert j[0] == 0.0
    np.testing.assert_allclose(j[2:255], s[2:255], rtol=1e-5)


@pytest.mark.parametrize("kind", KINDS)
def test_convert_round_trip(kind):
    """qtensor_from_jax keeps every part of every format bit for bit."""
    w = _input((2, 192, 40), seed=4)
    jq = jax.device_get(jf.quantize(jnp.asarray(w), kind, group_size=128))
    tq = qtensor_from_jax(jq, "cpu")
    _same(tq, jq)
    for t in (tq.data, tq.scales, tq.zeros):
        assert t is None or t.is_contiguous()
    np.testing.assert_array_equal(
        tf.dequantize(tq, torch.float32).numpy(),
        np.asarray(jf.dequantize(jq, jnp.float32)))


@pytest.mark.parametrize("kind", ["int4_gz", "mxfp4", "mxfp8", "int8_g"])
def test_convert_slices_padded_scales_and_zeros(kind):
    """pad_scale_sublanes' padded group rows of scales, zero points and
    exponents are dropped, and so are padded output columns."""
    from ktransformers_tpu.utils.device_prep import _pad_out_cols

    w = _input((384, 40), seed=5)
    jq = jf.quantize(jnp.asarray(w), kind, group_size=128)
    ng = jf.true_group_count(jq)
    padded = _pad_out_cols(jf.pad_scale_sublanes(jq, multiple=16), 24)
    assert padded.scales.shape == (16, 64) and ng in (3, 12)
    tq = qtensor_from_jax(jax.device_get(padded), "cpu", out_cols=40)
    _same(tq, jax.device_get(jq))


def test_concat_out_carries_zeros():
    """fuse_qkv_projections' concatenation keeps zero points (and refuses
    parts of which only one has them), as the JAX package's does."""
    from ktransformers_tpu_torch.utils.device_prep import _concat_out

    a = tf.quantize(torch.from_numpy(_input((128, 24), 6)), "int4_gz")
    b = tf.quantize(torch.from_numpy(_input((128, 8), 7)), "int4_gz")
    both = _concat_out([a, b])
    assert tuple(both.zeros.shape) == (1, 32) == tuple(both.scales.shape)
    np.testing.assert_array_equal(
        tf.dequantize(both, torch.float32).numpy(),
        torch.cat([tf.dequantize(a, torch.float32),
                   tf.dequantize(b, torch.float32)], dim=-1).numpy())
    assert _concat_out([a, dataclasses.replace(b, zeros=None)]) is None
    c = tf.quantize(torch.from_numpy(_input((128, 8), 7)), "int4_g")
    assert _concat_out([a, c]) is None


def test_repack_refuses_int4_and_int4_gz(monkeypatch):
    """W4A8 takes every int4 kind now (the W4A8 kernels have the zero term
    and a per-channel group): int4 / int4_gz are repacked in place, their
    zero points and group kept, the other kinds left as they are; with
    KT_W4A8=0 prepare_params leaves every int4 kind as it is."""
    from ktransformers_tpu_torch.quant.w4a8 import repack_offset_lo
    from ktransformers_tpu_torch.utils.device_prep import prepare_params

    w = torch.from_numpy(_input((128, 8), 8))
    for kind in ("int4", "int4_gz"):
        q = tf.quantize(w, kind)
        raw, zeros, gs = q.data.clone(), q.zeros, q.group_size
        assert repack_offset_lo(q) is q and q.act_quant
        assert torch.equal(q.data.view(torch.uint8), raw ^ 8)
        assert q.zeros is zeros and q.group_size == gs
    for kind in ("int8", "fp8", "mxfp4", "mxfp8", "int8_g"):
        q = tf.quantize(w, kind)
        assert repack_offset_lo(q) is q and not q.act_quant
    monkeypatch.setenv("KT_W4A8", "0")
    tree = {"layers": [], "a": tf.quantize(w, "int4_gz"),
            "b": tf.quantize(w, "int4_g")}
    out = prepare_params(tree)
    assert not out["a"].act_quant and not out["b"].act_quant
    assert out["b"].data.dtype == torch.uint8
