"""The port's CUDA kernels on the card against their plain versions on the
CPU, at small and ragged shapes that chip_smoke.py's bench shapes do not
reach: row counts that leave partial tiles, a down group of 96, repeated
and missing experts, rows past the grouped total, an empty cache.

Needs an NVIDIA GPU and skips elsewhere (the decision is taken inside the
``cuda`` fixture, never at import). This file imports nothing of JAX, so
it runs on a machine without it:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

(``--noconftest`` because tests/conftest.py imports JAX.)

Tolerances, as a share of the reference's largest magnitude:
- 1e-5 for float32 outputs of the dense matmul, the activation prep and
  the MLA decode: the integer dots are exact on both sides and only the
  order of float32 sums differs;
- 1e-2 for the FFN kernels: the GLU output's float32 sums run in another
  order than on the CPU, which can move an int8 code of the requant by
  one step (1/127 of its group's largest value);
- 1e-2 for bfloat16 outputs (8 mantissa bits).
"""

import numpy as np
import pytest
import torch

from ktransformers_tpu_torch.ops.cuda import LAUNCHES
from ktransformers_tpu_torch.ops.cuda import w4a8_ffn as F
from ktransformers_tpu_torch.ops.cuda import w4a8_matmul as MM
from ktransformers_tpu_torch.ops.cuda.mla_decode import mla_decode_fused
from ktransformers_tpu_torch.ops.rope import rope_rotation_matrix
from ktransformers_tpu_torch.quant.formats import quantize
from ktransformers_tpu_torch.quant.w4a8 import repack_offset_lo, w4a8_prep


@pytest.fixture
def cuda():
    """The card, or a skip: CUDA kernels cannot run on the CPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _rel(out: torch.Tensor, ref: torch.Tensor) -> float:
    out, ref = out.detach().float().cpu(), ref.detach().float().cpu()
    return float((out - ref).abs().max() / ref.abs().max())


def _w(rng, shape, gs=128):
    w = rng.standard_normal(shape).astype(np.float32) * 0.1
    return repack_offset_lo(quantize(torch.from_numpy(w), "int4_g", gs))


def _x(rng, *shape):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))


def _counted(name, fn):
    before = LAUNCHES[name]
    out = fn()
    torch.cuda.synchronize()
    assert LAUNCHES[name] == before + 1, name
    return out


@pytest.mark.parametrize("m", [1, 3, 8, 72])
@pytest.mark.parametrize("gs", [64, 128])
def test_dense_w4a8_matmul(cuda, m, gs):
    rng = np.random.default_rng(m * gs)
    w, x = _w(rng, (256, 384), gs), _x(rng, m, 256)
    out = _counted("dense_w4a8_matmul",
                   lambda: MM.dense_w4a8_matmul(x.to(cuda), w.to(cuda)))
    assert out.dtype == torch.float32
    assert _rel(out, MM.w4a8_matmul_ref(x, w)) <= 1e-5
    xb = x.bfloat16()
    out = MM.dense_w4a8_matmul(xb.to(cuda), w.to(cuda))
    assert out.dtype == torch.bfloat16
    assert _rel(out, MM.w4a8_matmul_ref(xb, w)) <= 1e-2


@pytest.mark.parametrize("m, k, gs", [(1, 2048, 128), (5, 192, 96),
                                      (70, 256, 64)])
def test_w4a8_prep(cuda, m, k, gs):
    """Codes and scales bit-exact (the group maxima do not depend on the
    order of reduction), the sums t to float32 rounding."""
    x = _x(np.random.default_rng(m), m, k)
    out = _counted("w4a8_prep",
                   lambda: MM.prep_activations(x.to(cuda), k, gs))
    ref = w4a8_prep(x, k, gs)
    for name, a, b in zip(("qa", "qb", "sa", "sb"), out, ref):
        assert torch.equal(a.cpu(), b), name
    assert _rel(out[4], ref[4]) <= 1e-5


@pytest.mark.parametrize("act", ["silu", "relu", "gelu"])
def test_gathered_w4a8_ffn(cuda, act):
    rng = np.random.default_rng(11)
    gu, dn = _w(rng, (8, 256, 2 * 128), 64), _w(rng, (8, 128, 256), 64)
    x = _x(rng, 7, 256)
    ids = torch.tensor([3, 0, 5, 3, 7, 1, 3], dtype=torch.int32)
    out = _counted("gathered_w4a8_ffn", lambda: F.gathered_w4a8_ffn(
        x.to(cuda), gu.to(cuda), dn.to(cuda), ids.to(cuda), act))
    assert _rel(out, F.gathered_w4a8_ffn_ref(x, gu, dn, ids, act)) <= 1e-2


@pytest.mark.parametrize("m", [1, 33])
def test_dense_w4a8_ffn_down_group_96(cuda, m):
    """inter 576 takes a down group of 96, as the 10944 of
    DeepSeek-V2-Lite's dense layer does."""
    rng = np.random.default_rng(20 + m)
    gu, dn = _w(rng, (256, 2 * 576)), _w(rng, (576, 256))
    assert dn.group_size == 96
    x = _x(rng, m, 256)
    out = _counted("dense_w4a8_ffn", lambda: F.dense_w4a8_ffn(
        x.to(cuda), gu.to(cuda), dn.to(cuda)))
    assert _rel(out, F.dense_w4a8_ffn_ref(x, gu, dn)) <= 1e-2


def test_grouped_w4a8_ffn_empty_expert_and_tail(cuda):
    """Expert 1 has no rows, the group sizes cut tiles short, and the
    rows past their sum come back zero."""
    rng = np.random.default_rng(5)
    gu, dn = _w(rng, (4, 256, 2 * 256)), _w(rng, (4, 256, 256))
    xs = _x(rng, 24, 256)
    sizes = torch.tensor([5, 0, 11, 3], dtype=torch.int32)
    out = _counted("grouped_w4a8_ffn", lambda: F.grouped_w4a8_ffn(
        xs.to(cuda), gu.to(cuda), dn.to(cuda), sizes.to(cuda)))
    assert torch.all(out[19:] == 0)
    assert _rel(out, F.grouped_w4a8_ffn_ref(xs, gu, dn, sizes)) <= 1e-2


@pytest.mark.parametrize("dtype, tol", [(torch.float32, 1e-5),
                                        (torch.bfloat16, 1e-2)])
def test_mla_decode_fused(cuda, dtype, tol):
    """Cached lengths 0 (the current token alone), 37 and 63 of 64."""
    rng = np.random.default_rng(2)
    b, h, r, dr, smax = 3, 8, 512, 64, 64
    qn, qp, kv = _x(rng, b, h, r), _x(rng, b, h, dr), _x(rng, b, 1, r + dr)
    gamma = _x(rng, r) * 0.1 + 1.0
    rot = rope_rotation_matrix(_x(rng, b, dr // 2), _x(rng, b, dr // 2), True)
    ckv, kpe = _x(rng, b, smax, r), _x(rng, b, smax, dr)
    lengths = torch.tensor([0, 37, 63], dtype=torch.int32)
    cast = [t.to(dtype) for t in (qn, qp, kv)] + [gamma, rot] + [
        t.to(dtype) for t in (ckv, kpe)] + [lengths]
    args = (0.07, 1e-6)
    out = _counted("mla_decode_fused", lambda: mla_decode_fused(
        *[t.to(cuda) for t in cast], *args))
    ref = mla_decode_fused(*cast, *args)
    for o, rf in zip(out, ref):
        assert o.dtype == dtype
        assert _rel(o, rf) <= tol


def test_wrappers_raise_instead_of_falling_back(cuda):
    rng = np.random.default_rng(0)
    w = _w(rng, (256, 384)).to(cuda)
    x = _x(rng, 4, 512).to(cuda)
    with pytest.raises(ValueError, match="contiguous"):
        MM.dense_w4a8_matmul(x[:, ::2], w)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        MM.dense_w4a8_matmul(x[:, :256].half(), w)
