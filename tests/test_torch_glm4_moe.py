"""The port's GLM4-MoE against HF torch and the JAX package.

GLM4-MoE (GLM-4.5 / 4.5-Air): GQA attention with rope over the leading
half of each head, the per-head q / k RMSNorm (use_qk_norm) and q / k / v
biases where attention_bias is set; DeepSeek-V3's router (sigmoid scores
plus the correction bias, groups ranked by their top-2 sum,
renormalized, times routed_scaling_factor); a dense first layer; one
ungated shared expert. Tiny sizes, one torch thread:
- the counterpart of tests/test_models_parity.py:test_glm4_moe_parity
  (its config and seed; correction bias, q / k norms and biases drawn), and
  the same with attention_bias: the port within 2e-3 of HF's logits with
  the same argmax, and within 2e-4 of the JAX forward on the JAX package's
  params_from_hf carried across, float32;
- int4_g weights repacked for W4A8 (drawn by the JAX package, a random
  correction bias): the JAX forward (Pallas in interpret mode) with every
  router call recorded, and the port's (plain versions) with the
  reference's expert set put in wherever its own differs: every step within
  LOGIT_TOL (tests/test_torch_model.py), greedy tokens equal off near-ties,
  and every row the port's own router sent elsewhere a tie of the
  reference's (the rule of tests/test_torch_deepseek_v3.py);
- float32 weights: the paged forward and a 3-request ServeEngine token for
  token with the single-user Generator.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ktransformers_tpu_torch.convert import params_from_jax
from ktransformers_tpu_torch.models import model as tmodel
from ktransformers_tpu_torch.models.hf_import import params_from_hf
from ktransformers_tpu_torch.models.spec import spec_from_hf_config

from tests.test_torch_deepseek_v3 import (  # noqa: F401 (hooks: a fixture)
    _choice,
    _group_scores,
    _margin,
    _port_router,
    hooks,
)
from tests.test_torch_dense_family import (
    hold_engine_against_generator,
    hold_paged_against_forward,
)
from tests.test_torch_hf_import import _assert_same_tree
from tests.test_torch_model import (
    LOGIT_TOL,
    one_torch_thread,  # noqa: F401 (a fixture)
)

HF_TOL = 2e-3  # of the largest HF logit
F32_TOL = 2e-4  # of the largest JAX logit, float32 weights
ROUTE_TOL = LOGIT_TOL / 2  # as tests/test_torch_deepseek_v3.py
# the W4A8 and engine model: widths the W4A8 kernels take (groups of 128),
# 8 query heads over 2 KV heads of 64 (rope over 32 of them), 16 experts
# of inter 128 top-4 in 2 groups (top-1 group), a dense first layer
TINY = dict(model_type="glm4_moe", vocab_size=512, hidden_size=256,
            intermediate_size=512, moe_intermediate_size=128,
            num_hidden_layers=2, num_attention_heads=8,
            num_key_value_heads=2, head_dim=64, partial_rotary_factor=0.5,
            use_qk_norm=True, attention_bias=True, n_routed_experts=16,
            num_experts_per_tok=4, n_shared_experts=1, n_group=2,
            topk_group=1, norm_topk_prob=True, routed_scaling_factor=1.5,
            first_k_dense_replace=1, rms_norm_eps=1e-5,
            rope_theta=1000000.0, max_position_embeddings=256)
PROMPT_LEN, DECODE_STEPS, MAX_LEN = 12, 3, 48
FEED = (11, 222, 333)  # fixed decode tokens of the W4A8 runs


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-6))


def _hf_model(attention_bias: bool):
    """tests/test_models_parity.py:test_glm4_moe_parity's model (seed 7),
    optionally with attention_bias; the correction bias uniform in (-0.1,
    0.1) as there, the q / k norms, layer norms and biases drawn."""
    from transformers import Glm4MoeConfig, Glm4MoeForCausalLM

    cfg = Glm4MoeConfig(
        vocab_size=128, hidden_size=64, intermediate_size=128,
        moe_intermediate_size=32, num_hidden_layers=3, num_attention_heads=4,
        num_key_value_heads=2, head_dim=16, partial_rotary_factor=0.5,
        use_qk_norm=True, n_routed_experts=8, num_experts_per_tok=2,
        n_shared_experts=1, n_group=2, topk_group=1, norm_topk_prob=True,
        routed_scaling_factor=1.5, first_k_dense_replace=1,
        max_position_embeddings=64, attention_bias=attention_bias,
        attn_implementation="eager")
    torch.manual_seed(7)
    model = Glm4MoeForCausalLM(cfg)
    gen = torch.Generator().manual_seed(8)
    with torch.no_grad():
        for layer in model.model.layers[cfg.first_k_dense_replace:]:
            layer.mlp.gate.e_score_correction_bias.uniform_(-0.1, 0.1)
        for name, prm in model.named_parameters():
            if name.endswith("_proj.bias"):
                prm.copy_(torch.randn(prm.shape, generator=gen) * 0.1)
            elif name.endswith("norm.weight"):
                prm.copy_(1 + 0.1 * torch.randn(prm.shape, generator=gen))
    return model.eval().float(), cfg


@pytest.mark.parametrize("attention_bias", [False, True])
def test_hf_and_jax_parity(attention_bias):
    """Half rotary, q / k norm, correction bias, routed_scaling_factor 1.5,
    with and without q / k / v biases: the port within 2e-3 of HF, the same
    argmax; within 2e-4 of the JAX forward on the JAX package's import,
    which equals the port's own bit for bit."""
    from ktransformers_tpu.models.hf_import import (
        params_from_hf as j_params_from_hf,
    )
    from ktransformers_tpu.models.model import KVCache
    from ktransformers_tpu.models.model import forward as jforward
    from ktransformers_tpu.models.spec import spec_from_hf_config as jspec_of

    model, cfg = _hf_model(attention_bias)
    spec, jspec = spec_from_hf_config(cfg), jspec_of(cfg.to_dict())
    assert spec.attention.rotary_dim == spec.rope.dim == 8
    params = params_from_hf(model, spec, quant="f32", device="cpu")
    jparams = j_params_from_hf(model, jspec, quant="f32")
    _assert_same_tree(params, params_from_jax(jax.device_get(jparams), spec,
                                              "cpu"))
    tokens = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 12))
    with torch.no_grad():
        ref = model(torch.from_numpy(tokens)).logits.numpy()
        cache = tmodel.KVCache.create(spec, 2, 20, torch.float32, "cpu")
        out, _ = tmodel.forward(params, spec, torch.from_numpy(tokens),
                                cache, compute_dtype=torch.float32)
    out = out.numpy()
    assert _rel(out, ref) < HF_TOL
    np.testing.assert_array_equal(out[:, -1].argmax(-1),
                                  ref[:, -1].argmax(-1))
    fwd = jax.jit(jforward, static_argnames=("spec", "compute_dtype"))
    jout, _ = fwd(jparams, jspec, jnp.asarray(tokens, jnp.int32),
                  KVCache.create(jspec, 2, 20, dtype=jnp.float32),
                  compute_dtype=jnp.float32)
    assert _rel(out, np.asarray(jout)) <= F32_TOL
    attn = params["layers"][0]["attn"]
    assert ("q_bias" in attn) == attention_bias and "q_norm" in attn
    moe = params["layers"][1]["moe"]
    assert moe["router_bias_corr"].abs().max() > 0 and "shared" in moe
    assert "shared_gate" not in moe and "mlp" in params["layers"][0]


# ------------------------------------------------- W4A8 against JAX


def _carried(quant: str, seed: int):
    """(JAX spec, prepared JAX params, port spec, port params): quant
    everywhere (float32 data for "bf16"), a random correction bias in the
    MoE layer; the JAX package's prepare_params (fused QKV with its
    concatenated bias, the W4A8 repack) carried across."""
    from ktransformers_tpu.models.init import init_params_synthetic
    from ktransformers_tpu.models.spec import spec_from_hf_config as jspec_of
    from ktransformers_tpu.utils.device_prep import prepare_params

    jspec = jspec_of(dict(TINY))
    kw = dict(dtype=jnp.float32) if quant == "bf16" else {}
    params = init_params_synthetic(jspec, seed=seed, quant=quant,
                                   moe_quant=quant, **kw)
    rng = np.random.default_rng(seed)
    for lp in params["layers"]:
        if "moe" in lp:
            lp["moe"]["router_bias_corr"] = jnp.asarray(
                rng.uniform(-0.1, 0.1, TINY["n_routed_experts"]),
                jnp.float32)
    jparams = prepare_params(params, True, jspec)
    spec = spec_from_hf_config(dict(TINY))
    return jspec, jparams, spec, params_from_jax(jax.device_get(jparams),
                                                 spec, "cpu")


def _tokens(n=PROMPT_LEN, seed=7):
    return np.random.default_rng(seed).integers(
        0, TINY["vocab_size"], (1, n)).astype(np.int32)


def _jax_run(jspec, jparams, tokens):
    """Prefill + the FEED decode steps in JAX (jitted): last logits rows,
    greedy tokens."""
    from ktransformers_tpu.models.model import KVCache
    from ktransformers_tpu.models.model import forward as jforward
    from ktransformers_tpu.ops.rope import precompute_rope_tables

    fwd = jax.jit(jforward, static_argnames=("spec", "compute_dtype"))
    rope = precompute_rope_tables(jspec.rope)
    cache = KVCache.create(jspec, 1, MAX_LEN, dtype=jnp.float32)
    outs = []
    for toks in [tokens] + [[[t]] for t in FEED]:
        logits, cache = fwd(jparams, jspec, jnp.asarray(toks, jnp.int32),
                            cache, rope_tables=rope,
                            compute_dtype=jnp.float32)
        outs.append(np.asarray(logits[:, -1]))
    return outs, [int(np.argmax(o[0])) for o in outs]


def _port_run(spec, params, tokens):
    cache = tmodel.KVCache.create(spec, 1, MAX_LEN, torch.float32, "cpu")
    outs = []
    with torch.no_grad():
        for toks in [tokens] + [[[t]] for t in FEED]:
            logits, cache = tmodel.forward(params, spec, torch.as_tensor(
                np.asarray(toks, np.int64)), cache,
                compute_dtype=torch.float32)
            outs.append(logits[:, -1].numpy())
    return outs, [int(o[0].argmax()) for o in outs]


@pytest.fixture(scope="module")
def w4a8_runs(hooks):
    """The JAX run with every router call's (choice scores, expert ids)
    recorded, and the port's run forced to the reference's expert sets,
    its own calls recorded."""
    from ktransformers_tpu.models import model as jmodel

    jspec, jparams, spec, params = _carried("int4_g", 6)
    gate = spec.moe.gate
    ref_calls, jroute = [], jmodel.route

    def jrecord(logits, g, bias=None):
        idx, w = jroute(logits, g, bias)
        jax.debug.callback(
            lambda lg, b, ix: ref_calls.append(
                (_choice(np.asarray(lg), np.asarray(b), gate),
                 np.asarray(ix))),
            logits, bias, idx, ordered=True)
        return idx, w

    tokens = _tokens()
    jmodel.route = jrecord
    try:
        ref = _jax_run(jspec, jparams, tokens)
        jax.effects_barrier()
    finally:
        jmodel.route = jroute
    calls = []
    with _port_router(ref_calls, calls):
        out = _port_run(spec, params, tokens)
    return spec, params, ref, ref_calls, out, calls


def test_forward_w4a8_matches_jax(w4a8_runs, hooks):
    """int4_g weights repacked for W4A8 (the fused QKV with its bias, the
    dense layer's MLP, the shared expert, the experts, lm_head) under equal
    routing: every step within LOGIT_TOL of the JAX forward, greedy tokens
    equal except at a near-tie of the reference (its top-2 gap below
    LOGIT_TOL of its largest logit). Both sides ran the W4A8 kernels (JAX:
    Pallas in interpret mode; the port: their plain versions)."""
    spec, params, (ref, ref_toks), _, (out, toks), _ = w4a8_runs
    errs = [_rel(a, b) for a, b in zip(out, ref)]
    assert max(errs) <= LOGIT_TOL, errs
    for step, b in enumerate(ref):
        top2 = np.sort(b[0])[-2:]
        if (top2[1] - top2[0]) / np.abs(b[0]).max() >= LOGIT_TOL:
            assert toks[step] == ref_toks[step], step
    attn = params["layers"][0]["attn"]
    assert attn["qkv"].act_quant and "qkv_bias" in attn
    assert hooks.get("qmatmul", 0) > 0


def test_w4a8_reroutes_are_ties(w4a8_runs):
    """Every row where the port's own router chose another expert set than
    the reference's is a tie of the reference's router: where the group
    choice flipped, the gap at the last chosen group score (group_top2sum)
    is at most twice the row's largest group score difference; where only
    the experts flipped, the gap at the k-th bias-corrected score within
    the chosen groups is at most twice the row's largest choice score
    difference; and every gap is at most ROUTE_TOL."""
    spec, _, _, ref_calls, _, calls = w4a8_runs
    cfg = spec.moe.gate
    assert len(calls) == len(ref_calls) == 1 + len(FEED)
    for c, ((choice, own), (rchoice, ridx)) in enumerate(zip(calls,
                                                             ref_calls)):
        gs, rgs = _group_scores(choice, cfg), _group_scores(rchoice, cfg)
        for r in range(own.shape[0]):
            if set(own[r]) == set(ridx[r]):
                continue
            if set(np.argsort(gs[r])[-cfg.topk_group:]) != set(
                    np.argsort(rgs[r])[-cfg.topk_group:]):
                gap = _margin(np.sort(rgs[r])[::-1], cfg.topk_group)
                d = float(np.abs(gs[r] - rgs[r]).max())
            else:
                groups = np.argsort(rgs[r])[-cfg.topk_group:]
                mask = np.repeat(np.isin(np.arange(cfg.n_group), groups),
                                 cfg.num_experts // cfg.n_group)
                gap = _margin(np.sort(np.where(mask, rchoice[r], -np.inf))
                              [::-1], cfg.top_k)
                d = float(np.abs(choice[r] - rchoice[r]).max())
            assert gap <= 2 * d and gap <= ROUTE_TOL, (c, r, gap, d)


# ------------------------------------------------- paged and engine


@pytest.fixture(scope="module")
def f32(hooks):
    return _carried("bf16", 5)


def test_forward_paged_matches_forward(f32):
    """A padded chunk (12 and 9 live of 12), a second chunk and a decode
    step through forward_paged against the contiguous forward
    (tests/test_torch_dense_family.py:hold_paged_against_forward)."""
    hold_paged_against_forward(*f32[2:], ((12, [12, 9]), (8, [8, 8]),
                                          (1, None)))


def test_serve_engine_matches_generator(f32):
    """Three prompts through the ServeEngine (a fused mixed step: the half
    rope and q / k norm on the mixed path) give the single-user
    Generator's tokens."""
    hold_engine_against_generator(*f32[2:], 3)
