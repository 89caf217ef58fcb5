"""The plain versions of the port's transposed matmuls (rows 16 and 17 of
the kernel table: dx = dy @ W^T on the packed weight, the input gradients
of LoRA SFT) against the JAX package's Pallas kernels in interpret mode
(ops/pallas/quant_matmul_t.py, and its gathered backward in
ops/pallas/vjp.py).

Weights are quantized by the JAX package from a numpy seed and carried
across with convert.qtensor_from_jax ("int4_g offset-lo" is the W4A8
repack with the JAX package's padded scales); dy is a numpy array handed
to both sides in bfloat16, the dtype of the SFT backward.

Tolerance: 1e-5 of the largest |dx|. Both sides round the same operands
to bf16 at the same places (dy * scale for int8 / fp8, dy and the decoded
weight for the others) and sum the products in float32; only the order of
the sums differs (seen: ~1e-7).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ktransformers_tpu.ops.pallas import quant_matmul as jqm
from ktransformers_tpu.ops.pallas import quant_matmul_t as jqt
from ktransformers_tpu.quant import formats as jf
from ktransformers_tpu.quant import w4a8 as jw
from ktransformers_tpu_torch.convert import qtensor_from_jax
from ktransformers_tpu_torch.ops.cuda import LAUNCHES
from ktransformers_tpu_torch.ops.cuda import quant_matmul_t as tqt

from tests.test_torch_model import one_torch_thread  # noqa: F401

KINDS = ("int8", "fp8", "int4", "int4_g", "int4_gz", "int4_g offset-lo",
         "mxfp4", "mxfp8")
TOL = 1e-5


def _weights(kind, shape, seed=0):
    w = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    jq = jf.quantize(jnp.asarray(w * 0.05), kind.split()[0], group_size=128)
    if kind.endswith("offset-lo"):
        jq = jf.pad_scale_sublanes(jw.repack_offset_lo(jq))
    return jq, qtensor_from_jax(jax.device_get(jq), "cpu")


def _dy(shape, seed=1):
    dy = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return (jnp.asarray(dy, jnp.bfloat16),
            torch.from_numpy(dy).to(torch.bfloat16))


def _close(out: torch.Tensor, ref):
    ref = np.asarray(ref, np.float32)
    out = out.numpy()
    assert out.dtype == np.float32 and out.shape == ref.shape
    assert np.isfinite(out).all()
    err = np.abs(out - ref).max() / max(np.abs(ref).max(), 1e-30)
    assert err <= TOL, err


@pytest.mark.parametrize("m, n", [(1, 1824), (9, 1824), (9, 384)])
@pytest.mark.parametrize("kind", KINDS)
def test_quant_matmul_t(kind, m, n):
    # N = 1824 has no multiple-of-128 divisor: the contraction's last
    # block is partial (the fused qkv_a's 3648, halved)
    jq, tq = _weights(kind, (256, n))
    jdy, tdy = _dy((m, n))
    before = dict(LAUNCHES)
    _close(tqt.quant_matmul_t(tdy, tq),
           jqt.quant_matmul_t(jdy, jq, interpret=True))
    assert LAUNCHES == before  # the CPU path launches nothing


def test_quant_matmul_t_leading_axes_and_group_96():
    # DeepSeek-V2-Lite's layer-0 down projection has group 96 (gs / 2 = 48)
    w = np.random.default_rng(2).standard_normal((576, 64)).astype(np.float32)
    jq = jf.quantize(jnp.asarray(w * 0.05), "int4_g", group_size=96)
    jq = jw.repack_offset_lo(jq)
    tq = qtensor_from_jax(jax.device_get(jq), "cpu")
    assert tq.group_size == 96
    jdy, tdy = _dy((2, 3, 64))
    _close(tqt.quant_matmul_t(tdy, tq),
           jqt.quant_matmul_t(jdy, jq, interpret=True))


def _tile_layout_ref(jq, sizes, dy_np):
    """The JAX grouped transposed kernel over the forward's tile layout
    (as ops/pallas/vjp.py:_gmm_bwd runs it)."""
    m = dy_np.shape[0]
    e = sizes.shape[0]
    dest, valid, tile_group, mpad = jqm.grouped_tile_layout(
        m, e, jnp.asarray(sizes), jqm.GROUP_BM)
    dy = jnp.asarray(dy_np, jnp.bfloat16)
    dy_tiles = jnp.zeros((mpad, dy.shape[-1]), dy.dtype).at[dest].set(
        jnp.where(valid[:, None], dy, 0))
    dx_tiles = jqt.grouped_quant_matmul_t(dy_tiles, jq, tile_group,
                                          bm=jqm.GROUP_BM, interpret=True)
    return jnp.where(valid[:, None], dx_tiles[dest], 0.0)


@pytest.mark.parametrize("n", [128, 1824])
@pytest.mark.parametrize("kind", KINDS)
def test_grouped_quant_matmul_t(kind, n):
    # ragged groups with an empty expert; the last 6 rows lie past
    # sum(group_sizes) and must come back zero
    jq, tq = _weights(kind, (4, 256, n))
    sizes = np.asarray([40, 0, 70, 34], np.int32)
    dy = np.random.default_rng(3).standard_normal((150, n)).astype(np.float32)
    out = tqt.grouped_quant_matmul_t(
        torch.from_numpy(dy).to(torch.bfloat16), tq, torch.from_numpy(sizes))
    _close(out, _tile_layout_ref(jq, sizes, dy))
    assert not out[144:].any()


@pytest.mark.parametrize("kind", KINDS)
def test_gathered_quant_matmul_t(kind):
    """Row r through expert ids[r], against the JAX package's gathered
    backward (ops/pallas/vjp.py:_gather_bwd: rows sorted by expert through
    the grouped kernel, then un-sorted; here before its cast to dy's
    dtype)."""
    jq, tq = _weights(kind, (6, 128, 200))
    ids = np.asarray([3, 0, 5, 3, 1, 1, 4], np.int32)  # expert 2 unused
    dy = np.random.default_rng(4).standard_normal((7, 200)).astype(np.float32)
    order = np.argsort(ids, kind="stable")
    dx_sorted = _tile_layout_ref(jq, np.bincount(ids, minlength=6), dy[order])
    ref = np.zeros((7, 128), np.float32)
    ref[order] = np.asarray(dx_sorted)
    out = tqt.gathered_quant_matmul_t(
        torch.from_numpy(dy).to(torch.bfloat16), tq, torch.from_numpy(ids))
    _close(out, ref)


def test_rejects_bad_operands():
    _, tq = _weights("int8", (64, 40))
    with pytest.raises(ValueError):
        tqt.quant_matmul_t(torch.zeros(3, 41), tq)
    with pytest.raises(ValueError):
        tqt.quant_matmul_t(torch.zeros(3, 40, dtype=torch.float16), tq)
    _, t3 = _weights("int8", (2, 64, 40))
    with pytest.raises(ValueError):
        tqt.grouped_quant_matmul_t(torch.zeros(3, 40), t3,
                                   torch.tensor([1, 1, 1]))
