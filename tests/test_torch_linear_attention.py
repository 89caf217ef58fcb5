"""The port's GatedDeltaNet (ops/linear_attention.py) against the JAX
package's, float32, on seeded numpy inputs: the causal conv (with and
without a carried state, with padding rows), the gated delta-rule scan
(padding steps leave a row's state untouched; two chunks with the state
carried equal one chunk), the whole block through layer weights carried
across with convert.params_from_jax, and the in_proj_qkvz / in_proj_ba
column permutation of the HF import against the JAX loader's.

Tolerances: the conv is the same float32 terms in the same order (1e-6 of
the largest value); the scan and the block sum in another order inside
their einsums (1e-5 of the largest value).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ktransformers_tpu_torch.convert import params_from_jax
from ktransformers_tpu_torch.models.loading import linear_attn_perms
from ktransformers_tpu_torch.models.spec import spec_from_hf_config
from ktransformers_tpu_torch.ops import linear_attention as tla

from tests.test_hybrid_serving import TINY_NEXT
from tests.test_torch_model import one_torch_thread  # noqa: F401 (fixture)

CONV_TOL = 1e-6
SCAN_TOL = 1e-5


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.abs(a - b).max() / np.abs(b).max())


def _rn(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("carried", [False, True])
@pytest.mark.parametrize("padded", [False, True])
def test_causal_conv_matches_jax(carried, padded):
    from ktransformers_tpu.ops import linear_attention as jla

    rng = np.random.default_rng(int(carried) * 2 + int(padded))
    b, s, c, k = 2, 7, 24, 4
    x, w = _rn(rng, b, s, c), _rn(rng, c, k, scale=0.3)
    state = _rn(rng, b, k, c) if carried else None
    valid = np.asarray([7, 3], np.int32) if padded else None
    jy, jst = jla.causal_conv(
        jnp.asarray(x), jnp.asarray(w),
        None if state is None else jnp.asarray(state),
        None if valid is None else jnp.asarray(valid))
    ty, tst = tla.causal_conv(_t(x), _t(w),
                              None if state is None else _t(state),
                              None if valid is None else _t(valid))
    assert _rel(ty.numpy(), jy) <= CONV_TOL
    assert np.array_equal(tst.numpy(), np.asarray(jst))
    if padded:  # the state holds the last K inputs before the padding
        full = np.concatenate([state if carried else np.zeros((b, k, c),
                                                               np.float32),
                               x], 1)
        assert np.array_equal(tst.numpy()[1], full[1, 3:3 + k])


def _scan_inputs(rng, b=2, s=6, h=4, dk=8, dv=8):
    q, k = _rn(rng, b, s, h, dk), _rn(rng, b, s, h, dk)
    v = _rn(rng, b, s, h, dv)
    g = -np.abs(_rn(rng, b, s, h, scale=0.5))
    beta = 1 / (1 + np.exp(-_rn(rng, b, s, h)))
    return q, k, v, g, beta.astype(np.float32)


@pytest.mark.parametrize("padded", [False, True])
def test_gated_delta_scan_matches_jax(padded):
    from ktransformers_tpu.ops import linear_attention as jla

    rng = np.random.default_rng(10 + padded)
    ins = _scan_inputs(rng)
    state = _rn(rng, 2, 4, 8, 8, scale=0.1)
    valid = np.asarray([6, 2], np.int32) if padded else None
    jo, js = jla.gated_delta_scan(
        *map(jnp.asarray, ins), jnp.asarray(state),
        None if valid is None else jnp.asarray(valid))
    to, ts = tla.gated_delta_scan(*map(_t, ins), _t(state),
                                  None if valid is None else _t(valid))
    assert to.dtype == ts.dtype == torch.float32
    assert _rel(to.numpy(), jo) <= SCAN_TOL
    assert _rel(ts.numpy(), js) <= SCAN_TOL
    if padded:  # two live steps of row 1: its state is the one after them
        _, two = tla.gated_delta_scan(*(_t(a[1:, :2]) for a in ins),
                                      _t(state[1:]))
        assert torch.equal(ts[1:], two)


def test_gated_delta_scan_two_chunks_equal_one():
    """The state carried from a 4-step chunk into a 2-step one gives the
    one 6-step chunk's outputs and final state."""
    rng = np.random.default_rng(12)
    ins = [_t(a) for a in _scan_inputs(rng)]
    out, st = tla.gated_delta_scan(*ins)
    o1, s1 = tla.gated_delta_scan(*(a[:, :4] for a in ins))
    o2, s2 = tla.gated_delta_scan(*(a[:, 4:] for a in ins), s1)
    assert _rel(torch.cat([o1, o2], 1).numpy(), out.numpy()) <= SCAN_TOL
    assert _rel(s2.numpy(), st.numpy()) <= SCAN_TOL


@pytest.fixture(scope="module")
def layer():
    """Layer 0 (GatedDeltaNet) of the tiny Qwen3-Next: the JAX package's
    float32 weights and the port's, carried across."""
    from ktransformers_tpu.models.init import init_params_synthetic
    from ktransformers_tpu.models.spec import spec_from_hf_config as jspec

    js = jspec(dict(TINY_NEXT))
    jp = init_params_synthetic(js, seed=3, quant="bf16", dtype=jnp.float32)
    spec = spec_from_hf_config(dict(TINY_NEXT))
    tp = params_from_jax(jax.device_get(jp), spec, "cpu")
    return js, jp["layers"][0]["attn"], spec, tp["layers"][0]["attn"]


def test_gated_delta_net_matches_jax(layer):
    """The block over two chunks, the second padded (valid 3 of 5 and 5 of
    5): outputs of the live rows and both states within SCAN_TOL; the
    converted leaves keep the JAX dtypes."""
    from ktransformers_tpu.ops import linear_attention as jla

    js, jattn, spec, tattn = layer
    for key in ("in_proj_ba", "in_proj_qkvz", "out_proj"):
        assert str(tattn[key].data.dtype).split(".")[-1] == \
            str(jattn[key].data.dtype), key
    for key in ("conv_w", "A_log", "dt_bias", "norm_w"):
        assert tattn[key].dtype == torch.float32 and tuple(
            tattn[key].shape) == jattn[key].shape, key
    rng = np.random.default_rng(13)
    x1, x2 = _rn(rng, 2, 6, 64), _rn(rng, 2, 5, 64)
    valid = np.asarray([3, 5], np.int32)
    jy1, jc, jr = jla.gated_delta_net(jattn, js.linear_attn, jnp.asarray(x1),
                                      None, None, js.rms_norm_eps)
    jy2, jc, jr = jla.gated_delta_net(jattn, js.linear_attn, jnp.asarray(x2),
                                      jc, jr, js.rms_norm_eps,
                                      jnp.asarray(valid))
    with torch.no_grad():
        ty1, tc, tr = tla.gated_delta_net(tattn, spec.linear_attn, _t(x1),
                                          None, None, spec.rms_norm_eps)
        ty2, tc, tr = tla.gated_delta_net(tattn, spec.linear_attn, _t(x2),
                                          tc, tr, spec.rms_norm_eps,
                                          _t(valid))
    assert _rel(ty1.numpy(), jy1) <= SCAN_TOL
    jy2 = np.asarray(jy2)
    assert _rel(ty2.numpy()[0, :3], jy2[0, :3]) <= SCAN_TOL
    assert _rel(ty2.numpy()[1], jy2[1]) <= SCAN_TOL
    assert _rel(tc.numpy(), jc) <= SCAN_TOL
    assert _rel(tr.numpy(), jr) <= SCAN_TOL


def test_projection_permutation_matches_jax_loader():
    """in_proj_qkvz / in_proj_ba weights whose output feature o carries o:
    the columns the port's loader keeps, in order, are the JAX loader's
    (its _linear_attn_params) for Qwen3-Next's published heads (16 key
    heads of 128, 32 value heads of 128) and the tiny config's."""
    from ktransformers_tpu.models.loading import _linear_attn_params

    for cfg in (TINY_NEXT, None):
        if cfg is None:
            from ktransformers_tpu_torch.models.registry import REGISTRY

            cfg = REGISTRY["qwen3-next-80b-a3b"].config
        la = spec_from_hf_config(dict(cfg)).linear_attn
        n_qkvz = 2 * la.key_dim + 2 * la.value_dim
        n_ba = 2 * la.num_v_heads
        pre = "l"
        tensors = {
            f"{pre}.in_proj_qkvz.weight":
                np.tile(np.arange(n_qkvz, dtype=np.float32)[:, None], (1, 4)),
            f"{pre}.in_proj_ba.weight":
                np.tile(np.arange(n_ba, dtype=np.float32)[:, None], (1, 4)),
            f"{pre}.conv1d.weight": np.zeros((la.conv_dim, 1, 4), np.float32),
            f"{pre}.dt_bias": np.zeros(la.num_v_heads, np.float32),
            f"{pre}.A_log": np.zeros(la.num_v_heads, np.float32),
            f"{pre}.norm.weight": np.ones(la.head_v_dim, np.float32),
            f"{pre}.out_proj.weight": np.zeros((4, la.value_dim), np.float32),
        }
        got = _linear_attn_params(tensors.__getitem__, pre, la, "f32", 128)
        perm_qkvz, perm_ba = linear_attn_perms(la)
        assert np.array_equal(np.asarray(got["in_proj_qkvz"].data[0]),
                              perm_qkvz)
        assert np.array_equal(
            np.asarray(got["in_proj_ba"].data[0], np.float32), perm_ba)
        assert sorted(perm_qkvz) == list(range(n_qkvz))
