"""Plain versions of the port's CUDA kernels against the JAX package's
Pallas kernels (run with interpret=True, as tests/test_w4a8.py does).

On the CPU each wrapper takes its plain version, so these tests hold the
arithmetic the CUDA kernels repeat: the W4A8 group dots, the GLU and
per-group requant, and the fused MLA decode attention. Inputs come from
np.random.default_rng seeds and pass through both packages.

Tolerance: 1e-4 of the reference's largest magnitude for every kernel.
Both sides run the same integer dots exactly and the same float32
epilogue, and differ only in the order of float32 sums.

The CUDA kernels themselves are held against these plain versions on the
card by tests/test_torch_cuda.py and chip_smoke.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ktransformers_tpu.ops.moe import moe_dispatch
from ktransformers_tpu.ops.pallas import mla_decode as jmd
from ktransformers_tpu.ops.pallas import w4a8_matmul as jwm
from ktransformers_tpu.ops.rope import rope_rotation_matrix as j_rot
from ktransformers_tpu.quant.formats import quantize as j_quantize
from ktransformers_tpu.quant.w4a8 import repack_offset_lo as j_repack
from ktransformers_tpu_torch.convert import qtensor_from_jax
from ktransformers_tpu_torch.ops.cuda import w4a8_ffn as tffn
from ktransformers_tpu_torch.ops.cuda.mla_decode import mla_decode_fused
from ktransformers_tpu_torch.ops.cuda.w4a8_matmul import dense_w4a8_matmul
from ktransformers_tpu_torch.quant.formats import QTensor

TOL = 1e-4


def _rel(out, ref):
    return float(np.abs(out - ref).max() / np.abs(ref).max())


def _w4a8(rng, shape, group_size):
    w = jnp.asarray(rng.standard_normal(shape).astype(np.float32) * 0.1)
    jq = j_repack(j_quantize(w, "int4_g", group_size=group_size))
    return jq, qtensor_from_jax(jax.device_get(jq), "cpu")


@pytest.mark.parametrize("m", [1, 8, 72])
def test_dense_w4a8_matmul(m):
    rng = np.random.default_rng(m)
    jw, tw = _w4a8(rng, (256, 384), 128)
    x = rng.standard_normal((m, 256)).astype(np.float32)
    ref = np.asarray(jwm.dense_w4a8_matmul(jnp.asarray(x), jw, interpret=True))
    out = dense_w4a8_matmul(torch.from_numpy(x), tw).numpy()
    assert _rel(out, ref) <= TOL


@pytest.mark.parametrize("act", ["silu", "relu", "gelu"])
def test_gathered_w4a8_ffn(act):
    rng = np.random.default_rng(11)
    e, k, inter = 8, 256, 128
    jgu, tgu = _w4a8(rng, (e, k, 2 * inter), 64)
    jdn, tdn = _w4a8(rng, (e, inter, k), 64)
    x = rng.standard_normal((6, k)).astype(np.float32)
    ids = np.asarray([3, 0, 5, 3, 7, 1], np.int32)
    ref = np.asarray(jwm.gathered_w4a8_ffn(
        jnp.asarray(x), jgu, jdn, jnp.asarray(ids), act=act, interpret=True))
    out = tffn.gathered_w4a8_ffn(torch.from_numpy(x), tgu, tdn,
                                 torch.from_numpy(ids), act).numpy()
    assert _rel(out, ref) <= TOL


@pytest.mark.parametrize("m", [1, 33])
def test_dense_w4a8_ffn(m):
    rng = np.random.default_rng(20 + m)
    k, inter = 256, 512
    jgu, tgu = _w4a8(rng, (k, 2 * inter), 128)
    jdn, tdn = _w4a8(rng, (inter, k), 128)
    x = rng.standard_normal((m, k)).astype(np.float32)
    bc = jwm.dense_ffn_plan(jgu, jdn, "silu", None)
    ref = np.asarray(jwm.dense_w4a8_ffn(jnp.asarray(x), jgu, jdn, act="silu",
                                        bc=bc, interpret=True))
    out = tffn.dense_w4a8_ffn(torch.from_numpy(x), tgu, tdn, "silu").numpy()
    assert _rel(out, ref) <= TOL


def test_grouped_w4a8_ffn_with_empty_expert():
    rng = np.random.default_rng(5)
    e, k, inter, t, topk = 4, 256, 256, 24, 2
    jgu, tgu = _w4a8(rng, (e, k, 2 * inter), 128)
    jdn, tdn = _w4a8(rng, (e, inter, k), 128)
    ids = jnp.asarray(rng.integers(0, e - 1, (t, topk)), jnp.int32)  # e-1 empty
    x = rng.standard_normal((t, k)).astype(np.float32)
    _, token_of_row, sizes, _ = moe_dispatch(ids, e)
    assert int(sizes[e - 1]) == 0
    xs = np.array(jnp.asarray(x)[token_of_row])
    ref = np.asarray(jwm.grouped_w4a8_ffn(jnp.asarray(xs), jgu, jdn, sizes,
                                          act="silu", interpret=True))
    out = tffn.grouped_w4a8_ffn(torch.from_numpy(xs), tgu, tdn,
                                torch.from_numpy(np.array(sizes)),
                                "silu").numpy()
    assert _rel(out, ref) <= TOL


def test_grouped_w4a8_ffn_tail_rows_zero():
    """Rows past sum(group_sizes) come back zero."""
    rng = np.random.default_rng(6)
    e, k, inter = 4, 256, 256
    _, tgu = _w4a8(rng, (e, k, 2 * inter), 128)
    _, tdn = _w4a8(rng, (e, inter, k), 128)
    xs = torch.from_numpy(rng.standard_normal((20, k)).astype(np.float32))
    out = tffn.grouped_w4a8_ffn(xs, tgu, tdn,
                                torch.tensor([5, 0, 7, 2], dtype=torch.int32))
    assert torch.all(out[14:] == 0) and torch.all(out[:14].abs().sum(-1) > 0)


def _bad_group(qt: QTensor, gs: int) -> QTensor:
    """The same bytes labelled with a group that does not divide K."""
    return dataclasses.replace(qt, group_size=gs)


def test_ffn_rejects_truncating_gate_up_group():
    """K % gate_up.group_size != 0 raises (ktransformers_tpu's
    grouped_ffn_fits accepts it, and ng1 = K // gs1 drops the tail)."""
    rng = np.random.default_rng(9)
    e, k, inter = 2, 256, 128
    _, tgu = _w4a8(rng, (e, k, 2 * inter), 128)
    _, tdn = _w4a8(rng, (e, inter, k), 128)
    bad = _bad_group(tgu, 96)  # 256 % 96 != 0; JAX would use 2 groups
    assert jwm.grouped_ffn_fits(
        dataclasses.replace(j_quantize(jnp.ones((e, k, 2 * inter)),
                                       "int4_g", 128), group_size=96,
                            act_quant=True),
        j_repack(j_quantize(jnp.ones((e, inter, k)), "int4_g", 128)),
        "silu", None, bm=64)
    x = torch.zeros(4, k)
    with pytest.raises(ValueError, match="not a multiple of group"):
        tffn.grouped_w4a8_ffn(x, bad, tdn, torch.tensor([4, 0]))
    with pytest.raises(ValueError, match="not a multiple of group"):
        tffn.gathered_w4a8_ffn(x, bad, tdn, torch.zeros(4, dtype=torch.int32))
    lift = lambda q: dataclasses.replace(q, data=q.data[0],  # noqa: E731
                                         scales=q.scales[0])
    with pytest.raises(ValueError, match="not a multiple of group"):
        tffn.dense_w4a8_ffn(x, lift(bad), lift(tdn))


def test_linear_refuses_int4_g_not_repacked():
    """An int4_g weight reaches the W4A8 kernel only after the offset-lo
    repack; before it, linear() raises instead of dequantizing (that
    product is the JAX package's quant_matmul kernel, not ported)."""
    from ktransformers_tpu_torch.ops.linear import linear
    from ktransformers_tpu_torch.quant.formats import quantize

    w = quantize(torch.ones(256, 64), "int4_g", 128)
    with pytest.raises(ValueError, match="repacked"):
        linear(torch.ones(2, 256), w)


@pytest.mark.parametrize("interleaved", [True, False])
def test_mla_decode_fused(interleaved):
    rng = np.random.default_rng(2)
    b, h, nope, dr, r = 2, 4, 32, 16, 64
    smax = 64
    eps, scale = 1e-6, (nope + dr) ** -0.5
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    qn, qp, ckv_kpe = f(b, h, r), f(b, h, dr), f(b, 1, r + dr)
    gamma = f(r) * 0.1 + 1.0
    cos, sin = f(b, dr // 2), f(b, dr // 2)
    ckv, kpe = f(b, smax, r), f(b, smax, dr)
    lengths = np.asarray([37, 11], np.int32)
    rot = np.asarray(j_rot(jnp.asarray(cos), jnp.asarray(sin), interleaved))
    ref = jmd.mla_decode_fused(
        *map(jnp.asarray, (qn, qp, ckv_kpe, gamma, rot, ckv, kpe, lengths)),
        scale=scale, eps=eps, block_s=32, interpret=True)
    out = mla_decode_fused(
        *map(torch.from_numpy, (qn, qp, ckv_kpe, gamma, rot, ckv, kpe,
                                lengths)), scale, eps)
    for o, rf in zip(out, ref):
        assert _rel(o.numpy(), np.asarray(rf)) <= TOL
