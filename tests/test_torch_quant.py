"""The port's quant formats and W4A8 prep against the JAX package's:
packing, int4_g quantization, the offset-lo repack and the activation prep
are bit-exact; the params carry-over handles padded scales, padded fused
columns and both encodings of int4 data.

Inputs come from np.random.default_rng seeds and pass through both
packages as numpy arrays.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ktransformers_tpu.quant import formats as jf
from ktransformers_tpu.quant import w4a8 as jw
from ktransformers_tpu_torch.convert import qtensor_from_jax, tensor_from_numpy
from ktransformers_tpu_torch.quant import formats as tf
from ktransformers_tpu_torch.quant import w4a8 as tw


def _eq(t: torch.Tensor, a) -> None:
    np.testing.assert_array_equal(t.numpy(), np.asarray(a))


@pytest.mark.parametrize("group_size", [0, 64, 128])
def test_pack_unpack_int4_bit_exact(group_size):
    rng = np.random.default_rng(group_size)
    q = rng.integers(-8, 8, (3, 256, 40)).astype(np.int8)
    packed = tf.pack_int4(torch.from_numpy(q), group_size)
    _eq(packed, jf.pack_int4(jnp.asarray(q), group_size))
    _eq(tf.unpack_int4(packed, group_size), q)


@pytest.mark.parametrize("k, want", [(10944, 96), (2048, 128), (1408, 128),
                                     (256, 128), (192, 96), (40, 40), (6, 6)])
def test_effective_group_size(k, want):
    assert tf.effective_group_size(k, 128) == want
    assert jf.effective_group_size(k, 128) == want


@pytest.mark.parametrize("shape", [(256, 96), (4, 192, 64), (10944, 32)])
def test_quantize_int4_g_bit_exact(shape):
    w = np.random.default_rng(1).standard_normal(shape).astype(np.float32)
    jq = jf.quantize(jnp.asarray(w), "int4_g", group_size=128)
    tq = tf.quantize(torch.from_numpy(w), "int4_g", group_size=128)
    assert tq.group_size == jq.group_size
    _eq(tq.data, jq.data)
    _eq(tq.scales, jq.scales)
    np.testing.assert_array_equal(
        tf.dequantize(tq, torch.float32).numpy(),
        np.asarray(jf.dequantize(jq, jnp.float32)))


def test_split_x_for_int4():
    x = np.random.default_rng(2).standard_normal((3, 256)).astype(np.float32)
    for gs in (0, 64):
        for a, b in zip(tf.split_x_for_int4(torch.from_numpy(x), 256, gs),
                        jf.split_x_for_int4(jnp.asarray(x), 256, gs)):
            _eq(a, b)


def test_repack_offset_lo_bit_exact():
    w = np.random.default_rng(3).standard_normal((2, 256, 64)).astype(
        np.float32)
    jq = jf.quantize(jnp.asarray(w), "int4_g", group_size=128)
    tq = qtensor_from_jax(jax.device_get(jq), "cpu")
    assert not tq.act_quant and tq.data.dtype == torch.uint8
    before = tf.dequantize(tq, torch.float32).clone()
    tr = tw.repack_offset_lo(tq)
    jr = jw.repack_offset_lo(jq)
    assert tr.act_quant and tr.data.dtype == torch.int8
    _eq(tr.data, jr.data)
    assert tw.repack_offset_lo(tr) is tr  # idempotent
    # lossless: raw nibbles come back through raw_int4_data
    np.testing.assert_array_equal(tf.dequantize(tr, torch.float32).numpy(),
                                  before.numpy())


def test_enable_w4a8_walks_trees():
    w = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (128, 32)).astype(np.float32))
    tree = {"a": [tf.quantize(w, "int4_g")], "b": tf.quantize(w, "bf16")}
    out = tw.enable_w4a8(tree)
    assert out["a"][0].act_quant and not out["b"].act_quant


@pytest.mark.parametrize("m, k, gs", [(1, 256, 128), (5, 2048, 128),
                                      (3, 192, 96)])
def test_w4a8_prep_bit_exact(m, k, gs):
    """Codes and scales are bit-exact for any input. The group sums t and
    xsum depend on the summation order (XLA vs PyTorch), so they are
    bit-exact on inputs whose sums are exact in float32 (multiples of 1/64
    below 8 in magnitude), and on normal inputs within 1e-4, the float32
    rounding of a sum of 64 terms of magnitude up to 8*4."""
    rng = np.random.default_rng(m + k)
    exact = (rng.integers(-511, 512, (m, k)) / 64.0).astype(np.float32)
    normal = rng.standard_normal((m, k)).astype(np.float32)
    names = ("qa", "qb", "sa", "sb", "t", "xsum")
    for x in (exact, normal):
        tout = tw.w4a8_prep(torch.from_numpy(x), k, gs)
        jout = jw.w4a8_prep(jnp.asarray(x), k, gs)
        for name, a, b in zip(names, tout, jout):
            assert tuple(a.shape) == tuple(b.shape), name
            if x is exact or name in ("qa", "qb", "sa", "sb"):
                _eq(a, b)
            else:
                np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                           rtol=0, atol=1e-4)


def test_tensor_from_numpy_bfloat16():
    a = jnp.asarray(np.random.default_rng(5).standard_normal((4, 3)),
                    jnp.bfloat16)
    t = tensor_from_numpy(jax.device_get(a), "cpu")
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.float().numpy(),
                                  np.asarray(a.astype(jnp.float32)))


def test_convert_slices_padded_scales_and_columns():
    """pad_scale_sublanes' padded group rows and _pad_out_cols' padded
    output columns are dropped; the data encoding flag is kept."""
    from ktransformers_tpu.utils.device_prep import _pad_out_cols

    w = np.random.default_rng(6).standard_normal((384, 40)).astype(np.float32)
    jq = jf.quantize(jnp.asarray(w), "int4_g", group_size=128)  # ng = 3
    padded = jf.pad_scale_sublanes(jw.repack_offset_lo(jq))  # ngp = 8
    padded = _pad_out_cols(padded, 24)  # N 40 -> 64
    assert padded.scales.shape == (8, 64)
    tq = qtensor_from_jax(jax.device_get(padded), "cpu", out_cols=40)
    assert tq.act_quant and tq.data.dtype == torch.int8
    assert tuple(tq.scales.shape) == (3, 40) and tq.scales.is_contiguous()
    _eq(tq.data, jw.repack_offset_lo(jq).data)
    _eq(tq.scales, jq.scales)
    # raw (not repacked) data stays uint8 with act_quant False
    raw = qtensor_from_jax(jax.device_get(jq), "cpu")
    assert not raw.act_quant and raw.data.dtype == torch.uint8
    with pytest.raises(ValueError):
        qtensor_from_jax(dataclasses.replace(jax.device_get(jq),
                                             act_quant=True), "cpu")
