"""The port's Mixtral (GQA attention) forward against the JAX package's.

A Mixtral-shaped spec cut to 2 layers and narrow widths: vocab 512, hidden
1024, 8 query heads over 2 KV heads of 128, 8 experts top-2 of inter 5632.
Those widths make the JAX package's hooks refuse the fused expert FFN (the
gate_up + down blocks of one expert need 17.3 MB against its 15 MB budget,
as Mixtral-8x7B's 88 MB do), so the routed experts take the unfused W4A8
matmuls: gathered_w4a8_matmul at decode, grouped_w4a8_matmul at prefill.
The JAX package builds the params (int8 attention and lm_head, int4_g
experts repacked for W4A8: the served kinds) and runs its Pallas kernels in
interpret mode through the hooks of tests/test_torch_model.py; the port
runs the kernels' plain versions on the CPU. Both compute in float32.

Tolerances: on the W4A8 weights logits agree within 5e-2 of their largest
magnitude with equal greedy tokens (LOGIT_TOL of tests/test_torch_model.py,
which explains the int8 activation codes that float32 summation order
flips). With int8 experts as well (every matmul through the quant_matmul
kernels, no activation requant) nothing can flip a code and the logits
agree within 1e-4.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ktransformers_tpu_torch.convert import params_from_jax
from ktransformers_tpu_torch.engine.generate import GenerateConfig, Generator
from ktransformers_tpu_torch.models import model as tmodel
from ktransformers_tpu_torch.models.spec import (
    MIXTRAL_8X7B,
    spec_from_hf_config,
)
from ktransformers_tpu_torch.ops import moe as tmoe

from tests.test_torch_model import (
    LOGIT_TOL,
    jax_interpret_hooks,
    one_torch_thread,  # noqa: F401 (a fixture)
)

MIXTRAL_SMALL = dict(
    MIXTRAL_8X7B, vocab_size=512, hidden_size=1024, intermediate_size=5632,
    num_hidden_layers=2, num_attention_heads=8, num_key_value_heads=2,
    max_position_embeddings=256,
)
SPEC = spec_from_hf_config(MIXTRAL_SMALL)
PROMPT_LEN, DECODE_STEPS, MAX_LEN = 16, 3, 32
TIGHT = 1e-4


def jax_mixtral_params(cfg, seed: int, moe_quant: str):
    """JAX spec and prepared params: int8 attention and lm_head, routed
    experts in ``moe_quant`` (int4_g is repacked for W4A8)."""
    from ktransformers_tpu.models.init import init_params_synthetic
    from ktransformers_tpu.models.spec import spec_from_hf_config as jspec
    from ktransformers_tpu.utils.device_prep import prepare_params

    spec = jspec(cfg)
    params = init_params_synthetic(spec, seed=seed, quant="int8",
                                   moe_quant=moe_quant, dtype=jnp.float32)
    return spec, prepare_params(params, True, spec)


def _jax_run(spec, params, tokens):
    """Prefill + greedy decode in JAX: (last-row logits per step, tokens)."""
    from ktransformers_tpu.models.model import KVCache, forward
    from ktransformers_tpu.ops.rope import precompute_rope_tables

    rope = precompute_rope_tables(spec.rope)
    cache = KVCache.create(spec, 1, MAX_LEN, dtype=jnp.float32)
    logits, cache = forward(params, spec, jnp.asarray(tokens), cache,
                            rope_tables=rope, compute_dtype=jnp.float32)
    outs = [np.asarray(logits[:, -1])]
    toks = [int(np.argmax(outs[-1][0]))]
    for _ in range(DECODE_STEPS):
        logits, cache = forward(params, spec,
                                jnp.asarray([[toks[-1]]], jnp.int32), cache,
                                rope_tables=rope, compute_dtype=jnp.float32)
        outs.append(np.asarray(logits[:, -1]))
        toks.append(int(np.argmax(outs[-1][0])))
    return outs, toks


def _port_run(params, tokens, feed):
    """The port's forward on the JAX side's greedy tokens."""
    cache = tmodel.KVCache.create(SPEC, 1, MAX_LEN, torch.float32, "cpu")
    assert cache.bufs_a[0].shape == (1, MAX_LEN, 2, 128)
    logits, cache = tmodel.forward(params, SPEC, torch.as_tensor(tokens),
                                   cache, compute_dtype=torch.float32)
    outs = [logits[:, -1].numpy()]
    for tok in feed[:DECODE_STEPS]:
        logits, cache = tmodel.forward(params, SPEC, torch.tensor([[tok]]),
                                       cache, compute_dtype=torch.float32)
        outs.append(logits[:, -1].numpy())
    assert int(cache.lengths[0]) == PROMPT_LEN + DECODE_STEPS
    return outs


def _carry(moe_quant: str, seed: int):
    tokens = np.random.default_rng(7).integers(
        0, MIXTRAL_SMALL["vocab_size"], (1, PROMPT_LEN)).astype(np.int32)
    with jax_interpret_hooks() as calls:
        jspec, jparams = jax_mixtral_params(MIXTRAL_SMALL, seed, moe_quant)
        ref_logits, ref_toks = _jax_run(jspec, jparams, tokens)
    experts = jparams["layers"][0]["moe"]["experts"]
    port = params_from_jax(jax.device_get(jparams), SPEC, "cpu")
    return dict(calls=dict(calls), experts=experts, tokens=tokens,
                params=port, ref_logits=ref_logits, ref_toks=ref_toks)


@pytest.fixture(scope="module")
def w4a8():
    return _carry("int4_g", seed=3)


@pytest.fixture(scope="module")
def int8():
    return _carry("int8", seed=4)


def _rel(a, b) -> float:
    return float(np.abs(a - b).max() / np.abs(b).max())


def test_spec_matches_jax():
    """spec_from_hf_config of the registry's Mixtral-8x7B config equals the
    JAX package's, field by field."""
    from ktransformers_tpu.models.registry import REGISTRY
    from ktransformers_tpu.models.spec import spec_from_hf_config as jspec

    entry = REGISTRY["mixtral-8x7b"]
    assert entry.config == MIXTRAL_8X7B
    j, t = jspec(dict(entry.config)), spec_from_hf_config(MIXTRAL_8X7B)
    for f in dataclasses.fields(t):
        if f.name in ("attention", "rope", "moe", "activation"):
            continue
        assert getattr(t, f.name) == getattr(j, f.name), f.name
    for f in dataclasses.fields(t.attention):
        assert getattr(t.attention, f.name) == getattr(j.attention, f.name), \
            f.name
    # the knobs of other GQA families, which the port refuses, are off
    assert not (j.attention.attention_bias or j.attention.qk_norm
                or j.attention.partial_rotary_dim or j.attention.gated_output
                or j.attention.sliding_window)
    assert j.attention.rotary_dim == t.attention.head_dim == 128
    assert dataclasses.asdict(t.rope) == dataclasses.asdict(j.rope)
    assert not t.rope.interleaved
    assert dataclasses.asdict(t.activation) == dataclasses.asdict(j.activation)
    assert dataclasses.asdict(t.moe.gate) == dataclasses.asdict(j.moe.gate)
    for f in ("num_experts", "top_k", "moe_intermediate_size",
              "shared_expert_intermediate_size", "first_k_dense",
              "moe_layer_freq"):
        assert getattr(t.moe, f) == getattr(j.moe, f), f
    assert all(t.moe.is_moe_layer(i) == j.moe.is_moe_layer(i)
               for i in range(32))


@pytest.mark.parametrize("change", [
    dict(qk_norm=True), dict(use_qk_norm=True), dict(gated_output=True),
    dict(partial_rotary_factor=0.5), dict(sliding_window=4096),
    dict(rope_scaling=dict(type="dynamic", factor=2.0)),
    dict(tie_word_embeddings=True),
    dict(hidden_act="gelu"), dict(model_type="qwen3_next"),
    dict(model_type="llama"),
])
def test_spec_refuses_unported_gqa_knobs(change):
    """Mixtral with a knob of another GQA family raises (q / k norm, a
    Mistral sliding window, dynamic rope scaling, another activation);
    projection biases (attention_bias) are ported and Qwen3-MoE is
    (tests/test_torch_qwen_moe.py). Partial rotary, tied embeddings, gated
    output and the llama family, which GLM4-MoE, the dense families and
    Qwen3-Next need, build: rope over the leading half of each head, no
    lm_head, the output gated per head, a dense model. The qwen3_next
    model type reads its own keys, which a Mixtral config lacks, and
    builds from the registry's preset."""
    if "gated_output" in change:
        spec = spec_from_hf_config(dict(MIXTRAL_8X7B, **change))
        assert spec.attention.gated_output and spec.model_type == "mixtral"
        return
    if change.get("model_type") == "qwen3_next":
        from ktransformers_tpu_torch.models.registry import REGISTRY

        with pytest.raises(KeyError):
            spec_from_hf_config(dict(MIXTRAL_8X7B, **change))
        spec = spec_from_hf_config(dict(
            REGISTRY["qwen3-next-80b-a3b"].config))
        assert spec.attention.gated_output and spec.layer_kind(0) == "linear"
        return
    if "sliding_window" in change:
        with pytest.raises(ValueError, match="sliding_window_layout"):
            spec_from_hf_config(dict(MIXTRAL_8X7B, **change))
        return
    if "partial_rotary_factor" in change:
        spec = spec_from_hf_config(dict(MIXTRAL_8X7B, **change))
        assert spec.attention.rotary_dim == spec.rope.dim == 64
        return
    if "tie_word_embeddings" in change:
        assert spec_from_hf_config(dict(MIXTRAL_8X7B, **change)) \
            .tie_word_embeddings
        return
    if change.get("model_type") == "llama":
        spec = spec_from_hf_config(dict(MIXTRAL_8X7B, **change))
        assert spec.moe is None and spec.model_type == "llama"
        return
    with pytest.raises(ValueError):
        spec_from_hf_config(dict(MIXTRAL_8X7B, **change))


def _shape_pair(k, n, e):
    """A repacked int4_g expert weight [e, K/2, N] as a JAX QTensor over an
    unallocated numpy array and a port QTensor on the meta device."""
    from ktransformers_tpu.quant.formats import QTensor as JQ
    from ktransformers_tpu.quant.formats import effective_group_size
    from ktransformers_tpu_torch.quant.formats import QTensor as TQ

    gs = effective_group_size(k, 128)
    d, s = (e, k // 2, n), (e, k // gs, n)
    j = JQ(np.empty(d, np.int8), np.empty(s, np.float32), None,
           kind="int4_g", group_size=gs, act_quant=True)
    t = TQ(torch.empty(d, dtype=torch.int8, device="meta"),
           torch.empty(s, device="meta"), None, kind="int4_g",
           group_size=gs, act_quant=True)
    return j, t


@pytest.mark.parametrize("hidden, inter, rows", [
    (4096, 14336, 2),     # Mixtral-8x7B, single-user decode
    (4096, 14336, 16),    # ... decode batch of 8
    (1024, 5632, 2),      # the test model
    (256, 512, 2),        # narrow enough for the fused FFN
    (256, 512, 128),
])
def test_fused_ffn_refusal_matches_jax(hidden, inter, rows):
    """The port refuses the fused expert FFN (and so takes rows 7-8)
    exactly where the JAX package's hooks do (shapes only)."""
    from ktransformers_tpu.ops.pallas import quant_matmul as jqm
    from ktransformers_tpu.ops.pallas import w4a8_matmul as jwm
    from ktransformers_tpu_torch.ops.cuda import w4a8_ffn as tffn

    (jgu, tgu), (jdn, tdn) = (_shape_pair(hidden, 2 * inter, 8),
                              _shape_pair(inter, hidden, 8))
    want = jwm.ffn_fits(jgu, jdn, "silu", None, rows=rows)
    assert tffn.ffn_fits(tgu, tdn, "silu", None, rows) == want
    want_g = jwm.grouped_ffn_fits(jgu, jdn, "silu", None, bm=jqm.GROUP_BM)
    assert tffn.grouped_ffn_fits(tgu, tdn, "silu", None) == want_g
    assert want == want_g == (hidden == 256)


@pytest.fixture
def port_routes(monkeypatch):
    """Counts the port's calls of the W4A8 expert matmuls (rows 7-8) and
    of the fused expert FFN."""
    calls = {}

    def counted(name, fn):
        def wrapped(*a, **kw):
            calls[name] = calls.get(name, 0) + 1
            return fn(*a, **kw)
        return wrapped

    for name in ("gathered_w4a8_matmul", "grouped_w4a8_matmul",
                 "gathered_w4a8_ffn", "grouped_w4a8_ffn"):
        monkeypatch.setattr(tmoe, name, counted(name, getattr(tmoe, name)))
    return calls


def test_forward_matches_jax_on_w4a8_experts(w4a8, port_routes):
    """Both sides took the unfused W4A8 expert matmuls: the JAX package's
    gather / grouped hooks on repacked int4 weights (which its
    quant_matmul hands to gathered_w4a8_matmul / grouped_w4a8_matmul), no
    fused FFN; the port's rows 7-8."""
    calls, experts = w4a8["calls"], w4a8["experts"]
    assert experts.gate_up.kind == "int4_g" and experts.gate_up.act_quant
    assert calls.get("gather", 0) > 0 and calls.get("gmm", 0) > 0
    assert "gathered_ffn" not in calls and "grouped_ffn" not in calls
    outs = _port_run(w4a8["params"], w4a8["tokens"], w4a8["ref_toks"])
    assert port_routes == {"grouped_w4a8_matmul": 4,
                           "gathered_w4a8_matmul": 4 * DECODE_STEPS}
    for step, (a, b) in enumerate(zip(outs, w4a8["ref_logits"])):
        assert _rel(a, b) <= LOGIT_TOL, step
        assert a.argmax() == b.argmax(), step


def test_forward_matches_jax_tightly_on_int8_experts(int8, port_routes):
    """int8 experts and attention: no activation requant anywhere, so the
    two packages differ only in float32 summation order."""
    outs = _port_run(int8["params"], int8["tokens"], int8["ref_toks"])
    assert port_routes == {}
    for step, (a, b) in enumerate(zip(outs, int8["ref_logits"])):
        assert _rel(a, b) <= TIGHT, step


def test_generator_generate_matches_jax(w4a8):
    gen = Generator(w4a8["params"], SPEC, max_len=MAX_LEN, device="cpu",
                    cache_dtype=torch.float32, compute_dtype=torch.float32)
    out = gen.generate(w4a8["tokens"].tolist(), GenerateConfig(
        max_new_tokens=DECODE_STEPS + 1, prefill_chunk=PROMPT_LEN))
    assert out == [w4a8["ref_toks"]]


def test_qkv_fusion_keeps_the_function(int8):
    """prepare_params merges q_proj, k_proj and v_proj into one "qkv"
    weight (the JAX package's fuse_qkv_projections did so for the carried
    params); the unfused projections compute the same logits."""
    from ktransformers_tpu_torch.quant.formats import QTensor

    fused = int8["params"]
    attn = fused["layers"][0]["attn"]
    assert set(attn) == {"qkv", "o_proj"}
    qkv = attn["qkv"]
    split = dict(fused, layers=[])
    for lp in fused["layers"]:
        w = lp["attn"]["qkv"]
        cols = np.cumsum([0, 8 * 128, 2 * 128, 2 * 128])
        parts = {name: QTensor(w.data[:, a:b], w.scales[:, a:b], None,
                               kind=w.kind, group_size=w.group_size)
                 for name, a, b in zip(("q_proj", "k_proj", "v_proj"),
                                       cols[:-1], cols[1:])}
        parts["o_proj"] = lp["attn"]["o_proj"]
        split["layers"].append(dict(lp, attn=parts))
    from ktransformers_tpu_torch.utils.device_prep import fuse_qkv_projections

    outs = [tmodel.forward(p, SPEC, torch.as_tensor(int8["tokens"]),
                           tmodel.KVCache.create(SPEC, 1, MAX_LEN,
                                                 torch.float32, "cpu"),
                           compute_dtype=torch.float32)[0]
            for p in (fused, split)]
    np.testing.assert_allclose(outs[0].numpy(), outs[1].numpy(), rtol=1e-5,
                               atol=1e-5)
    refused = fuse_qkv_projections(split, SPEC)
    assert set(refused["layers"][0]["attn"]) == {"qkv", "o_proj"}
    assert torch.equal(refused["layers"][0]["attn"]["qkv"].data, qkv.data)
