"""The port's plain expert products against the JAX package's.

The expert kinds no kernel takes in either package (bf16 experts with bf16
or float32 data, int8_g, int8_gz) run plain products: the JAX package's
gathered einsum (ops/moe.py:gathered_matmul) at decode and its ragged_dot
over dequantized weights (grouped_matmul) on sorted rows. The port runs
the same arithmetic in plain PyTorch (ktransformers_tpu_torch/ops/moe.py),
taking each row's expert on the device. Both sides get the same seeded
numpy weights and inputs; the JAX side has no Pallas hook installed, so it
runs its plain XLA products.

Tolerances: float32 within 1e-5 of the largest output (only the order of
float32 sums differs); bfloat16 within 1e-2 of the largest output (one
bf16 rounding of the output, or of the dequantized weight, in another
order).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ktransformers_tpu.ops import moe as jmoe
from ktransformers_tpu.quant import formats as jf
from ktransformers_tpu_torch.convert import qtensor_from_jax, tensor_from_numpy
from ktransformers_tpu_torch.ops import moe as tmoe
from ktransformers_tpu_torch.ops.activations import ActivationConfig
from ktransformers_tpu_torch.quant.formats import QTensor

from tests.test_torch_model import one_torch_thread  # noqa: F401

E, K, N, GS = 6, 64, 48, 32
TOL = {"float32": 1e-5, "bfloat16": 1e-2}
KINDS = ("bf16", "f32", "int8_g", "int8_gz")


def _weights(kind: str, shape, seed: int):
    """(JAX QTensor, port QTensor) of ``kind`` for a weight [E, K, N]: bf16
    / f32 / int8_g from the JAX quantize; int8_gz (which only the GGUF
    repack makes) from int8 codes, scales and zero points drawn here."""
    rng = np.random.default_rng(seed)
    w = rng.standard_normal(shape).astype(np.float32) * 0.1
    if kind == "int8_gz":
        gs = jf.effective_group_size(shape[-2], GS)
        ng = shape[-2] // gs
        data = rng.integers(-16, 16, shape).astype(np.int8)
        scales = (rng.random((*shape[:-2], ng, shape[-1])) * 0.02 + 0.005
                  ).astype(np.float32)
        zeros = rng.integers(-4, 5, (*shape[:-2], ng, shape[-1])).astype(
            np.float32)
        jq = jf.QTensor(jnp.asarray(data), jnp.asarray(scales),
                        jnp.asarray(zeros), kind="int8_gz", group_size=gs)
    else:
        jq = jf.quantize(jnp.asarray(w), kind, group_size=GS)
    return jq, qtensor_from_jax(jq, "cpu")


def _rel(out, ref) -> float:
    out, ref = np.asarray(out, np.float32), np.asarray(ref, np.float32)
    return float(np.abs(out - ref).max() / np.abs(ref).max())


def _x(shape, dtype, seed):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return (jnp.asarray(x).astype(dtype),
            torch.from_numpy(x).to(getattr(torch, dtype)))


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("per_expert_x", [False, True])
def test_gathered_matmul_matches_jax(kind, dtype, per_expert_x, monkeypatch):
    """x [T, K] (one input for the k experts) or [T, k, K]; ids with a
    repeated expert; the rows in chunks of 2 (PLAIN_CHUNK_BYTES made small)
    and in one, the same bits."""
    jw, tw = _weights(kind, (E, K, N), 0)
    t, k = 3, 2
    ids = np.array([[0, 5], [2, 2], [4, 1]], np.int32)
    jx, tx = _x((t, k, K) if per_expert_x else (t, K), dtype, 1)
    ref = jmoe.gathered_matmul(jx, jw, jnp.asarray(ids))
    out = tmoe.gathered_matmul(tx, tw, torch.from_numpy(ids))
    assert out.shape == (t, k, N) and out.dtype == tx.dtype
    assert _rel(out.float().numpy(), ref.astype(jnp.float32)) <= TOL[dtype]
    monkeypatch.setattr(tmoe, "PLAIN_CHUNK_BYTES", 2 * K * N * 4)
    assert torch.equal(tmoe.gathered_matmul(tx, tw, torch.from_numpy(ids)),
                       out)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_grouped_matmul_matches_jax(kind, dtype):
    """Rows sorted by expert, an empty expert, and 3 rows past
    sum(group_sizes) that must come back zero."""
    jw, tw = _weights(kind, (E, K, N), 2)
    sizes = np.array([3, 0, 2, 4, 1, 2], np.int32)
    m = int(sizes.sum()) + 3
    jx, tx = _x((m, K), dtype, 3)
    ref = jmoe.grouped_matmul(jx, jw, jnp.asarray(sizes), impl="ragged")
    out = tmoe.grouped_matmul(tx, tw, torch.from_numpy(sizes))
    assert out.shape == (m, N) and out.dtype == tx.dtype
    assert _rel(out.float().numpy(), ref.astype(jnp.float32)) <= TOL[dtype]
    assert not out[int(sizes.sum()):].any()


def test_sorted_row_experts_without_host_sync():
    """Each sorted row's expert from the group sizes, found on the device
    (searchsorted over their cumulative sum); rows past the total get -1."""
    from ktransformers_tpu_torch.ops.cuda.w4a8_matmul import (
        sorted_row_experts,
    )

    sizes = torch.tensor([2, 0, 3, 1], dtype=torch.int32)
    assert sorted_row_experts(sizes, 8).tolist() == [0, 0, 2, 2, 2, 3, -1,
                                                     -1]
    assert sorted_row_experts(sizes, 4).tolist() == [0, 0, 2, 2]


def _moe_pair(kind: str, seed: int):
    jgu, tgu = _weights(kind, (E, K, 2 * N), seed)
    jdn, tdn = _weights(kind, (E, N, K), seed + 1)
    return (jmoe.MoEWeights(gate_up=jgu, down=jdn),
            tmoe.MoEWeights(gate_up=tgu, down=tdn))


def _routing(t: int, seed: int):
    rng = np.random.default_rng(seed)
    idx = np.stack([rng.permutation(E)[:2] for _ in range(t)]).astype(
        np.int32)
    w = rng.random((t, 2)).astype(np.float32)
    return idx, w


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("t", [3, 12])
def test_moe_forward_matches_jax(kind, t):
    """The gather path (3 tokens) and the grouped path (12 tokens, past
    DECODE_GATHER_MAX_TOKENS), float32, against the JAX moe_forward; and
    both against the dense reference of each package."""
    jws, tws = _moe_pair(kind, 4)
    idx, w = _routing(t, 5)
    jx, tx = _x((t, K), "float32", 6)
    ref = jmoe.moe_forward(jx, jws, jnp.asarray(idx), jnp.asarray(w))
    out = tmoe.moe_forward(tx, tws, torch.from_numpy(idx),
                           torch.from_numpy(w))
    assert _rel(out.numpy(), ref) <= 1e-5
    dense = tmoe.moe_forward_dense_reference(
        tx, tws, torch.from_numpy(idx), torch.from_numpy(w))
    assert _rel(dense.numpy(), ref) <= 1e-5


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("act", ["silu", "relu"])
def test_moe_forward_dense_reference_matches_jax(kind, act):
    jws, tws = _moe_pair(kind, 7)
    idx, w = _routing(5, 8)
    jx, tx = _x((5, K), "float32", 9)
    from ktransformers_tpu.ops.activations import (
        ActivationConfig as JActivationConfig,
    )

    ref = jmoe.moe_forward_dense_reference(
        jx, jws, jnp.asarray(idx), jnp.asarray(w),
        jmoe.MoEConfig(activation=JActivationConfig(kind=act)))
    out = tmoe.moe_forward_dense_reference(
        tx, tws, torch.from_numpy(idx), torch.from_numpy(w),
        ActivationConfig(kind=act))
    assert _rel(out.numpy(), ref) <= 1e-5


def test_moe_forward_bf16_compute_matches_jax():
    """bf16 activations over bf16 experts on both paths, within 1e-2."""
    jws, tws = _moe_pair("bf16", 10)
    for t in (4, 16):
        idx, w = _routing(t, 11 + t)
        jx, tx = _x((t, K), "bfloat16", 12 + t)
        ref = jmoe.moe_forward(jx, jws, jnp.asarray(idx), jnp.asarray(w))
        out = tmoe.moe_forward(tx, tws, torch.from_numpy(idx),
                               torch.from_numpy(w))
        assert out.dtype == torch.bfloat16
        assert _rel(out.float().numpy(), ref.astype(jnp.float32)) <= 1e-2


def test_check_kernel_kind_raises_for_uncovered_kind():
    """A kind neither a kernel nor a plain product covers still raises, on
    both paths; the kernel kinds and the plain kinds pass."""
    _, tw = _weights("int8_g", (E, K, N), 0)
    odd = dataclasses.replace(tw, kind="int2")
    x = torch.zeros(2, K)
    ids = torch.zeros(2, 1, dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="int2"):
        tmoe.gathered_matmul(x, odd, ids)
    with pytest.raises(NotImplementedError, match="int2"):
        tmoe.grouped_matmul(x, odd, torch.tensor([2, 0, 0, 0, 0, 0]))
    for kind in tmoe.PLAIN_KINDS + ("int8", "int4_g", "mxfp4"):
        tmoe._check_kernel_kind(dataclasses.replace(tw, kind=kind), "t")


def test_plain_products_keep_gradients():
    """A float32 input that needs a gradient flows through the plain
    products (plain PyTorch autograd), on both paths."""
    _, tws = _moe_pair("f32", 13)
    for t in (3, 12):
        idx, w = _routing(t, 14)
        x = tensor_from_numpy(np.random.default_rng(15).standard_normal(
            (t, K)).astype(np.float32), "cpu").requires_grad_(True)
        out = tmoe.moe_forward(x, tws, torch.from_numpy(idx),
                               torch.from_numpy(w))
        out.square().sum().backward()
        assert x.grad is not None and bool(torch.isfinite(x.grad).all())
        assert float(x.grad.abs().max()) > 0
    assert isinstance(tws.gate_up, QTensor)
