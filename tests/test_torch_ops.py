"""The port's small ops and spec against the JAX package's on the same
numpy inputs: rms_norm, activations, rope tables (YaRN included),
apply_rope, rope_rotation_matrix, route, absorbed MLA attention and the
deepseek_v2 spec translator.

Tolerances: routing ids are compared exactly on inputs without ties
(continuous random logits; ties have probability zero); the rope tables
are bit-exact (both packages compute them in float64 with numpy); the
float32 ops agree to 1e-6 relative (one or two float32 roundings in a
different order).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ktransformers_tpu.models import spec as jspec
from ktransformers_tpu.ops import activations as ja
from ktransformers_tpu.ops import attention as jatt
from ktransformers_tpu.ops import gate as jg
from ktransformers_tpu.ops import norm as jn
from ktransformers_tpu.ops import rope as jr
from ktransformers_tpu_torch.models import spec as tspec
from ktransformers_tpu_torch.ops import activations as ta
from ktransformers_tpu_torch.ops import attention as tatt
from ktransformers_tpu_torch.ops import gate as tg
from ktransformers_tpu_torch.ops import norm as tn
from ktransformers_tpu_torch.ops import rope as tr

RTOL = 1e-6


def _close(t, a, rtol=RTOL, atol=1e-6):
    np.testing.assert_allclose(t.numpy(), np.asarray(a), rtol=rtol, atol=atol)


def _f(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def test_rms_norm():
    rng = np.random.default_rng(0)
    x, w = _f(rng, 3, 5, 64), _f(rng, 64)
    _close(tn.rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-6),
           jn.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-6))


@pytest.mark.parametrize("kind", ["silu", "gelu", "relu", "swigluoai"])
def test_glu_activate(kind):
    rng = np.random.default_rng(1)
    g, u = _f(rng, 4, 32), _f(rng, 4, 32)
    _close(ta.glu_activate(torch.from_numpy(g), torch.from_numpy(u),
                           ta.ActivationConfig(kind=kind)),
           ja.glu_activate(jnp.asarray(g), jnp.asarray(u),
                           ja.ActivationConfig(kind=kind)), rtol=1e-5)


ROPES = [
    dict(dim=64, max_position=512, interleaved=True),
    dict(dim=64, max_position=512, interleaved=True, scaling_type="yarn",
         scaling_factor=40.0, original_max_position=4096, beta_fast=32.0,
         beta_slow=1.0, mscale=0.707, mscale_all_dim=0.707),
    dict(dim=32, max_position=256, scaling_type="yarn", scaling_factor=4.0,
         mscale=1.0, mscale_all_dim=0.0),
    dict(dim=32, max_position=256, scaling_type="linear", scaling_factor=2.0),
]


@pytest.mark.parametrize("cfg", ROPES)
def test_rope_tables_bit_exact(cfg):
    tc, ts = tr.precompute_rope_tables(tr.RopeConfig(**cfg), "cpu")
    jc, js = jr.precompute_rope_tables(jr.RopeConfig(**cfg))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert tr.rope_attention_scale(tr.RopeConfig(**cfg)) == \
        jr.rope_attention_scale(jr.RopeConfig(**cfg))


@pytest.mark.parametrize("interleaved", [True, False])
def test_apply_rope_and_rotation_matrix(interleaved):
    rng = np.random.default_rng(2)
    x = _f(rng, 2, 3, 7, 16)
    cos, sin = _f(rng, 7, 8), _f(rng, 7, 8)
    out = tr.apply_rope(torch.from_numpy(x), torch.from_numpy(cos),
                        torch.from_numpy(sin), interleaved=interleaved)
    _close(out, jr.apply_rope(jnp.asarray(x), jnp.asarray(cos),
                              jnp.asarray(sin), interleaved=interleaved))
    rot = tr.rope_rotation_matrix(torch.from_numpy(cos),
                                  torch.from_numpy(sin), interleaved)
    np.testing.assert_array_equal(
        rot.numpy(), np.asarray(jr.rope_rotation_matrix(
            jnp.asarray(cos), jnp.asarray(sin), interleaved)))
    # x @ R equals apply_rope per position
    _close(torch.einsum("bhsd,sde->bhse", torch.from_numpy(x), rot), out,
           rtol=1e-5, atol=1e-5)


GATES = [
    dict(num_experts=64, top_k=6),
    dict(num_experts=64, top_k=6, norm_topk_prob=True,
         routed_scaling_factor=2.5),
    dict(num_experts=64, top_k=6, group_method="group_max", n_group=8,
         topk_group=3),
    dict(num_experts=32, top_k=4, scoring="sigmoid", group_method="group_top2sum",
         n_group=4, topk_group=2, norm_topk_prob=True,
         has_correction_bias=True),
    dict(num_experts=16, top_k=2, scoring="sigmoid"),
]


@pytest.mark.parametrize("cfg", GATES)
def test_route(cfg):
    rng = np.random.default_rng(3)
    logits = _f(rng, 9, cfg["num_experts"]) * 3.0
    bias = _f(rng, cfg["num_experts"]) * 0.1
    b_t = torch.from_numpy(bias) if cfg.get("has_correction_bias") else None
    b_j = jnp.asarray(bias) if cfg.get("has_correction_bias") else None
    ti, tw = tg.route(torch.from_numpy(logits), tg.GateConfig(**cfg), b_t)
    ji, jw = jg.route(jnp.asarray(logits), jg.GateConfig(**cfg), b_j)
    assert ti.dtype == torch.int32
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    _close(tw, jw)


def test_mla_absorbed():
    rng = np.random.default_rng(4)
    b, h, s, r, dr, skv = 2, 3, 5, 16, 8, 9
    qn, qp = _f(rng, b, h, s, r), _f(rng, b, h, s, dr)
    ckv, kpe = _f(rng, b, skv, r), _f(rng, b, skv, dr)
    mask = np.where(np.arange(skv)[None] <= np.arange(s)[:, None] + 3, 0.0,
                    -1e30).astype(np.float32)
    out = tatt.mla_absorbed(*map(torch.from_numpy, (qn, qp, ckv, kpe)),
                            scale=0.3, mask=torch.from_numpy(mask))
    ref = jatt.mla_absorbed(*map(jnp.asarray, (qn, qp, ckv, kpe)),
                            scale=0.3, mask=jnp.asarray(mask))
    _close(out, ref, rtol=1e-5, atol=1e-5)


def test_spec_matches_jax_for_bench_config():
    t = tspec.spec_from_hf_config(tspec.DEEPSEEK_V2_LITE)
    j = jspec.spec_from_hf_config(tspec.DEEPSEEK_V2_LITE)
    for f in ("vocab_size", "hidden_size", "num_layers", "intermediate_size",
              "rms_norm_eps", "max_position"):
        assert getattr(t, f) == getattr(j, f), f
    for f in dataclasses.fields(t.attention):
        assert getattr(t.attention, f.name) == getattr(j.attention, f.name)
    assert dataclasses.asdict(t.rope) == dataclasses.asdict(j.rope)
    assert dataclasses.asdict(t.moe.gate) == dataclasses.asdict(j.moe.gate)
    for f in ("num_experts", "top_k", "moe_intermediate_size",
              "shared_expert_intermediate_size", "first_k_dense",
              "moe_layer_freq"):
        assert getattr(t.moe, f) == getattr(j.moe, f), f
    assert [t.moe.is_moe_layer(i) for i in range(27)] == \
        [j.moe.is_moe_layer(i) for i in range(27)]


@pytest.mark.parametrize("change", [
    dict(model_type="qwen3_moe"), dict(q_lora_rank=1536),
    dict(scoring_func="sigmoid"), dict(topk_method="noaux_tc"),
    dict(rope_scaling={"type": "dynamic", "factor": 2.0}),
    dict(attention_bias=True), dict(hidden_act="gelu"),
])
def test_spec_raises_on_unported_fields(change):
    with pytest.raises(ValueError):
        tspec.spec_from_hf_config(dict(tspec.DEEPSEEK_V2_LITE, **change))
