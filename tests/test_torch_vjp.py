"""The port's input-gradient rules (ops/vjp.py) against jax.grad through
the JAX package's custom_vjp wrappers (ops/pallas/vjp.py), whose kernels
run in interpret mode (vjp._INTERPRET, restored after each test).

Each rule's forward is a kernel of the inference path and its backward the
transposed kernels (rows 16 / 17); on the CPU both run their plain
versions. Inputs, weights and cotangents come from numpy seeds.

Tolerances, as a share of the largest |dx|:
- the matmul rules, float32 inputs: 1e-5 (seen: ~1e-7). dx = dy @ W^T
  does not depend on x, and both sides round the same operands to bf16
  (the transposed kernels' rule), so only the order of float32 sums
  differs;
- the fused FFN rules: 1e-3 (seen: 7e-6). Their backward recomputes h
  through the W4A8 forward, whose int8 activation codes can land one step
  apart when the two sides sum in another order (each plain W4A8 kernel
  is held to 1e-4 of its Pallas kernel in test_torch_kernels.py), and the
  GLU's gradient carries that into dx;
- bfloat16 inputs: 1e-2 (dx is returned in bf16, one rounding of 2^-8;
  seen: 0).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ktransformers_tpu.ops.moe import moe_dispatch as jdispatch
from ktransformers_tpu.ops.pallas import vjp as jvjp
from ktransformers_tpu.ops.pallas.w4a8_matmul import dense_ffn_plan
from ktransformers_tpu.quant import formats as jf
from ktransformers_tpu.quant import w4a8 as jw
from ktransformers_tpu_torch.convert import qtensor_from_jax
from ktransformers_tpu_torch.ops import vjp as tvjp
from ktransformers_tpu_torch.ops.cuda import quant_matmul as tqm
from ktransformers_tpu_torch.ops.cuda import w4a8_matmul as twm

from tests.test_torch_model import one_torch_thread  # noqa: F401

KINDS = ("int8", "fp8", "int4_gz", "int4_g offset-lo", "mxfp4")


@pytest.fixture(autouse=True)
def interpret():
    old = jvjp._INTERPRET
    jvjp._INTERPRET = True
    try:
        yield
    finally:
        jvjp._INTERPRET = old


def _weights(kind, shape, seed=0):
    w = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    jq = jf.quantize(jnp.asarray(w * 0.05), kind.split()[0], group_size=128)
    if kind.endswith("offset-lo"):
        jq = jf.pad_scale_sublanes(jw.repack_offset_lo(jq))
    return jq, qtensor_from_jax(jax.device_get(jq), "cpu")


def _arr(shape, seed, dtype="float32"):
    a = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return jnp.asarray(a, dtype), torch.from_numpy(a).to(getattr(torch, dtype))


def _grads(jfn, tfn, shape, out_cols, dtype="float32"):
    """(port dx, JAX dx, port y, JAX y) of sum(f(x) * g) for a seeded x and
    cotangent g."""
    jx, tx = _arr(shape, 1, dtype)
    g = np.random.default_rng(2).standard_normal(
        shape[:-1] + (out_cols,)).astype(np.float32)
    jy, pull = jax.vjp(jfn, jx)
    (jdx,) = pull(jnp.asarray(g).astype(jy.dtype))
    tx.requires_grad_(True)
    ty = tfn(tx)
    (tdx,) = torch.autograd.grad((ty.float() * torch.from_numpy(g)).sum(),
                                 tx)
    return tdx, jdx, ty, jy


def _close(out: torch.Tensor, ref, tol):
    ref = np.asarray(ref.astype(jnp.float32))
    out = out.detach().float().numpy()
    assert out.shape == ref.shape and np.isfinite(out).all()
    err = np.abs(out - ref).max() / max(np.abs(ref).max(), 1e-30)
    assert err <= tol, err


def _pick(w, w4a8_kernel, quant_kernel):
    """The forward kernel ops/moe.py hands an expert rule."""
    return w4a8_kernel if tvjp.is_w4a8(w) else quant_kernel


def _frozen(*weights):
    """No tensor of a base weight takes part in autograd."""
    for w in weights:
        for t in (w.data, w.scales, w.zeros):
            assert t is None or (not t.requires_grad and t.grad is None)


@pytest.mark.parametrize("kind", KINDS)
def test_quant_matmul_fn(kind):
    jq, tq = _weights(kind, (256, 1824))
    tdx, jdx, _, _ = _grads(
        lambda x: jvjp.quant_matmul_diff(x, jq),
        lambda x: tvjp.QuantMatmulFn.apply(x, tq), (2, 5, 256), 1824)
    _close(tdx, jdx, 1e-5)
    _frozen(tq)


def test_quant_matmul_fn_bf16():
    jq, tq = _weights("int4_g offset-lo", (256, 384))
    tdx, jdx, ty, jy = _grads(
        lambda x: jvjp.quant_matmul_diff(x, jq),
        lambda x: tvjp.QuantMatmulFn.apply(x, tq), (9, 256), 384,
        "bfloat16")
    assert tdx.dtype == torch.bfloat16 and jdx.dtype == jnp.bfloat16
    _close(tdx, jdx, 1e-2)
    _close(ty, jy, 1e-2)


@pytest.mark.parametrize("kind", ("int8", "int4_g offset-lo", "mxfp8"))
def test_grouped_quant_matmul_fn(kind):
    # ragged groups with an empty expert; 6 rows past sum(group_sizes)
    jq, tq = _weights(kind, (4, 256, 384))
    sizes = np.asarray([40, 0, 70, 34], np.int32)
    tdx, jdx, _, _ = _grads(
        lambda x: jvjp.grouped_quant_matmul_diff(x, jq, jnp.asarray(sizes)),
        lambda x: tvjp.GroupedQuantMatmulFn.apply(
            x, tq, torch.from_numpy(sizes),
            _pick(tq, twm.grouped_w4a8_matmul, tqm.grouped_quant_matmul)),
        (150, 256), 384)
    _close(tdx, jdx, 1e-5)
    assert not tdx[144:].any()
    _frozen(tq)


@pytest.mark.parametrize("kind", ("int8", "int4_g offset-lo", "mxfp4"))
def test_gathered_quant_matmul_fn(kind):
    jq, tq = _weights(kind, (6, 256, 200))
    ids = np.asarray([3, 0, 5, 3, 1, 1, 4], np.int32)  # expert 2 unused
    tdx, jdx, _, _ = _grads(
        lambda x: jvjp.gathered_quant_matmul_diff(x, jq, jnp.asarray(ids)),
        lambda x: tvjp.GatheredQuantMatmulFn.apply(
            x, tq, torch.from_numpy(ids),
            _pick(tq, twm.gathered_w4a8_matmul, tqm.gathered_quant_matmul)),
        (7, 256), 200)
    _close(tdx, jdx, 1e-5)
    _frozen(tq)


def _ffn_weights(e=4, k=256, inter=256):
    jgu, tgu = _weights("int4_g offset-lo", (e, k, 2 * inter), seed=3)
    jdn, tdn = _weights("int4_g offset-lo", (e, inter, k), seed=4)
    return jgu, tgu, jdn, tdn


def test_grouped_w4a8_ffn_fn():
    jgu, tgu, jdn, tdn = _ffn_weights()
    ids = np.random.default_rng(5).integers(0, 4, (12, 2)).astype(np.int32)
    _, _, sizes, _ = jdispatch(jnp.asarray(ids), 4)
    sizes = np.array(sizes)
    tdx, jdx, _, _ = _grads(
        lambda x: jvjp.grouped_w4a8_ffn_diff(x, jgu, jdn, jnp.asarray(sizes),
                                             "silu"),
        lambda x: tvjp.GroupedW4A8FFNFn.apply(
            x, tgu, tdn, torch.from_numpy(sizes), "silu"), (24, 256), 256)
    _close(tdx, jdx, 1e-3)
    _frozen(tgu, tdn)


def test_dense_w4a8_ffn_fn():
    jgu, tgu, jdn, tdn = _ffn_weights(e=1)
    jgu2, jdn2 = (jax.tree.map(lambda a: a[0], q) for q in (jgu, jdn))
    bc = dense_ffn_plan(jgu2, jdn2, "silu", None)
    assert bc is not None
    from ktransformers_tpu_torch.ops.cuda.quant_matmul import expert_slice

    tgu2, tdn2 = expert_slice(tgu, 0), expert_slice(tdn, 0)
    tdx, jdx, _, _ = _grads(
        lambda x: jvjp.dense_w4a8_ffn_diff(x, jgu2, jdn2, "silu", bc),
        lambda x: tvjp.DenseW4A8FFNFn.apply(x, tgu2, tdn2, "silu"),
        (9, 256), 256)
    _close(tdx, jdx, 1e-3)
    _frozen(tgu2, tdn2)


def test_no_backward_without_input_grad():
    """An input that needs no gradient records nothing and launches no
    backward."""
    _, tq = _weights("int8", (256, 64))
    x = torch.ones(3, 256)
    y = tvjp.QuantMatmulFn.apply(x, tq)
    assert not y.requires_grad and y.grad_fn is None
