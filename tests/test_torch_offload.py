"""Routed experts in host memory (ktransformers_tpu_torch/offload) against
the JAX package's offload modules and against the port's resident path.

Weights are drawn by the JAX package's init_params from a seed and carried
across by convert.params_from_jax. Everything runs on the CPU: the port's
wrappers take their plain versions, and both packages' host FFN is their
own build of csrc/host_moe.cpp (g++ at first use; the tests skip only
where g++ is missing, and a failed build fails them).

Tolerances:
- the host layout packer and the C++ forward are bit-exact against the
  JAX package's (the same codes, the same arithmetic); the C++ is within
  2e-4 / 2e-5 (rtol / atol) of the dense float32 expert product, the JAX
  test's bound;
- streamed experts within 1e-4 of the resident moe_forward, equal tokens;
- the offloaded Generator against the port's resident Generator (KT_W4A8=0
  on both sides, so nothing but the order of float32 sums differs): equal
  greedy tokens, last logits within 1e-4; against the JAX
  HostOffloadGenerator on the same weights: logits within 1e-4 with
  float32 hops, equal greedy tokens with bf16 hops.
"""

import dataclasses
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ktransformers_tpu_torch.convert import params_from_jax, qtensor_from_jax
from ktransformers_tpu_torch.engine.generate import GenerateConfig, Generator
from ktransformers_tpu_torch.models.model import KVCache, forward
from ktransformers_tpu_torch.models.spec import spec_from_hf_config
from ktransformers_tpu_torch.offload import (
    HostMoELayer,
    HostOffloadGenerator,
    offload_moe_weights,
    split_params_for_offload,
)
from ktransformers_tpu_torch.offload import host_moe as thost
from ktransformers_tpu_torch.ops.activations import ActivationConfig
from ktransformers_tpu_torch.ops.moe import (
    MoEWeights,
    moe_forward,
    moe_forward_dense_reference,
)

from tests.test_torch_model import one_torch_thread  # noqa: F401 (a fixture)

# the JAX package's tests/test_host_offload.py TINY_DS: 3 layers (layer 0
# dense), 8 experts top-2 of inter 64, a shared expert
TINY_DS = dict(
    model_type="deepseek_v2", vocab_size=128, hidden_size=64,
    intermediate_size=128, moe_intermediate_size=64, num_hidden_layers=3,
    num_attention_heads=4, num_key_value_heads=4, n_routed_experts=8,
    num_experts_per_tok=2, n_shared_experts=1, first_k_dense_replace=1,
    kv_lora_rank=32, q_lora_rank=None, qk_rope_head_dim=16,
    qk_nope_head_dim=16, v_head_dim=16, max_position_embeddings=256,
    rms_norm_eps=1e-6, rope_theta=10000.0, norm_topk_prob=True,
    moe_layer_freq=1, topk_method="greedy", n_group=1, topk_group=1,
    routed_scaling_factor=1.0, scoring_func="softmax", hidden_act="silu")
# a tiny Qwen3-MoE (GQA 8 / 2 of 64 with q / k norms, every layer MoE: 16
# experts top-4 of inter 128, no shared expert)
TINY_QWEN3 = dict(
    model_type="qwen3_moe", vocab_size=256, hidden_size=128,
    intermediate_size=256, moe_intermediate_size=64, num_hidden_layers=2,
    num_attention_heads=8, num_key_value_heads=2, head_dim=32,
    num_experts=16, num_experts_per_tok=4, norm_topk_prob=True,
    decoder_sparse_step=1, mlp_only_layers=[], rms_norm_eps=1e-6,
    rope_theta=1000000.0, max_position_embeddings=256, hidden_act="silu")
F32 = dict(cache_dtype=torch.float32, compute_dtype=torch.float32,
           device="cpu")
LOGIT_TOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def gxx():
    """The host FFN is built with g++ at first use: skip without one."""
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed: the host expert FFN cannot be "
                    "built")


@pytest.fixture
def no_w4a8(monkeypatch):
    """KT_W4A8=0 on both packages: int4_g runs un-repacked everywhere."""
    monkeypatch.setenv("KT_W4A8", "0")


def _jax_host_moe():
    """The JAX package's host_moe with its library loaded. Its loader
    (make at first use, the result cached per process) can meet a library
    another test process is still writing; such a miss is tried once more
    here, after which a library that does not load fails the test."""
    from ktransformers_tpu.offload import host_moe

    if not host_moe.available():
        host_moe._tried, host_moe._lib = False, None
    assert host_moe.available(), "the JAX package's libhost_moe.so did not " \
        "build"
    return host_moe


def _draw(cfg, quant="bf16", moe_quant="int4_g", group_size=32, seed=0):
    """(JAX spec, JAX params, port spec, port params on the CPU)."""
    from ktransformers_tpu.models.init import init_params
    from ktransformers_tpu.models.spec import spec_from_hf_config as jspec

    js = jspec(dict(cfg))
    jp = jax.device_get(init_params(js, seed=seed, quant=quant,
                                    moe_quant=moe_quant,
                                    group_size=group_size))
    spec = spec_from_hf_config(dict(cfg))
    return js, jp, spec, params_from_jax(jp, spec, "cpu")


def bf16_absorbed(jp):
    """The JAX params with the absorbed MLA mats rounded to bf16, as the
    port's prepare_params stores them (the JAX package's offload engines
    keep them float32 on the CPU), in place; returns jp."""
    for lp in jp["layers"]:
        for key in ("w_uk", "w_uv"):
            lp["attn"][key] = np.asarray(jnp.asarray(
                lp["attn"][key], jnp.bfloat16).astype(jnp.float32))
    return jp


def _copy(params, spec):
    """A second port tree of the same values (prepare_params works in
    place)."""
    from ktransformers_tpu_torch.utils.device_prep import params_to

    return params_to(params, "cpu")


def _experts(rng, e, k, n, gs, kind="int4_g"):
    from ktransformers_tpu.quant.formats import quantize

    gu = quantize(jnp.asarray(rng.standard_normal((e, k, 2 * n)),
                              jnp.float32) * 0.1, kind, group_size=gs)
    dn = quantize(jnp.asarray(rng.standard_normal((e, n, k)),
                              jnp.float32) * 0.1, kind, group_size=gs)
    return gu, dn


# ------------------------------------------------------------ the host FFN


@pytest.mark.parametrize("gs", [32, 128])
def test_pack_host_bit_exact(gs):
    """The port's packer (torch, any device) gives the JAX packer's bytes
    and scales, from the stored and from the W4A8-repacked codes."""
    from ktransformers_tpu_torch.quant.w4a8 import repack_offset_lo

    jh = _jax_host_moe()
    rng = np.random.default_rng(gs)
    for jq in _experts(rng, 4, 256, 128, gs):
        want = jh.pack_host_from_qtensor(jq)
        tq = qtensor_from_jax(jax.device_get(jq), "cpu")
        for q in (tq, repack_offset_lo(dataclasses.replace(
                tq, data=tq.data.clone()))):
            got = thost.pack_host_from_qtensor(q)
            for g, w in zip(got, want):
                assert g.dtype == torch.from_numpy(w).dtype
                np.testing.assert_array_equal(g.numpy(), w)


@pytest.mark.parametrize("gs", [32, 128])
def test_host_moe_matches_jax_bits(gs):
    """HostMoELayer.forward gives the JAX one's float32 bits on the same
    arrays (at 1 and 3 OpenMP threads), within 2e-4 / 2e-5 of the port's
    dense float32 expert product; ids < 0 and zero weights skip a pair."""
    jh = _jax_host_moe()
    rng = np.random.default_rng(7 + gs)
    e, k, n, t, topk = 8, 256, 64, 5, 2
    jgu, jdn = _experts(rng, e, k, n, gs)
    x = rng.standard_normal((t, k)).astype(np.float32)
    ids = rng.integers(0, e, (t, topk)).astype(np.int32)
    w = rng.random((t, topk)).astype(np.float32)
    ids[1, 1], w[2, 0] = -1, 0.0
    want = jh.HostMoELayer.from_qtensors(jgu, jdn, "silu").forward(x, ids, w)
    tgu, tdn = (qtensor_from_jax(jax.device_get(q), "cpu")
                for q in (jgu, jdn))
    for threads in (1, 3):
        layer = HostMoELayer.from_qtensors(tgu, tdn, threads=threads)
        got = layer.forward(torch.from_numpy(x), torch.from_numpy(ids),
                            torch.from_numpy(w))
        np.testing.assert_array_equal(got.numpy(), want)
    keep = torch.from_numpy((ids >= 0) & (w != 0))
    ref = moe_forward_dense_reference(
        torch.from_numpy(x), MoEWeights(tgu, tdn),
        torch.from_numpy(np.maximum(ids, 0)),
        torch.from_numpy(w) * keep)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=2e-4,
                               atol=2e-5)


# ------------------------------------------------------- streamed experts


@pytest.mark.parametrize("kind", ["int8", "int4_g"])
@pytest.mark.parametrize("t", [4, 12])
def test_streamed_experts_match_resident(kind, t):
    """Experts streamed from the host (every T on the gathered matmuls,
    the distinct routed experts gathered once) within 1e-4 of the resident
    moe_forward (gather path at 4 tokens, grouped at 12)."""
    from ktransformers_tpu_torch.ops.gate import GateConfig, route

    rng = np.random.default_rng(1)
    e, d, f, k = 8, 64, 96, 2
    jgu, jdn = _experts(rng, e, d, f, 32, kind)
    w = MoEWeights(qtensor_from_jax(jax.device_get(jgu), "cpu"),
                   qtensor_from_jax(jax.device_get(jdn), "cpu"))
    x = torch.from_numpy(rng.standard_normal((t, d)).astype(np.float32))
    idx, wts = route(torch.from_numpy(
        rng.standard_normal((t, e)).astype(np.float32)),
        GateConfig(num_experts=e, top_k=k))
    ref = moe_forward(x, w, idx, wts)
    off = offload_moe_weights(w)
    got = moe_forward(x, off, idx, wts)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-4,
                               atol=1e-4)
    # each distinct routed expert crosses once, however many rows read it
    assert off.bytes_streamed == sum(
        q.data[0].numel() * q.data.element_size()
        + q.scales[0].numel() * 4 for q in (w.gate_up, w.down)) * len(
        idx.unique())


def test_generation_with_streamed_experts():
    """The resident Generator with every MoE layer's experts streamed from
    the host generates the resident tokens (the JAX test's int8 model)."""
    from tests.test_generate import TINY_DS as GEN_DS

    _, jp, spec, params = _draw(GEN_DS, quant="int8", moe_quant="int8")
    prompt = list(range(10))
    cfg = GenerateConfig(max_new_tokens=8)
    want = Generator(_copy(params, spec), spec, max_len=64,
                     **F32).generate([prompt], cfg)
    off = dict(params, layers=[
        dict(lp, moe=dict(lp["moe"], experts=offload_moe_weights(
            lp["moe"]["experts"]))) if "moe" in lp else lp
        for lp in params["layers"]])
    assert Generator(off, spec, max_len=64, **F32).generate(
        [prompt], cfg) == want


# ------------------------------------------------ the offloaded Generator


def _offload_gen(params, spec, batch=2, **kw):
    dev, host = split_params_for_offload(params, spec)
    return HostOffloadGenerator(dev, spec, host, max_len=64, batch=batch,
                                **F32, **kw)


@pytest.mark.parametrize("cfg", [TINY_DS, TINY_QWEN3],
                         ids=["deepseek_v2", "qwen3_moe"])
def test_offloaded_generation_matches_resident(cfg, no_w4a8):
    """Greedy generation with host experts == the resident Generator's
    (DeepSeek-V2 with a dense prefix and a shared expert; Qwen3-MoE, GQA,
    every layer MoE)."""
    _, _, spec, params = _draw(cfg)
    prompts = [list(range(5, 13)), list(range(40, 48))]
    want = Generator(_copy(params, spec), spec, max_len=64, batch=2,
                     **F32).generate(prompts, GenerateConfig(max_new_tokens=8))
    got = _offload_gen(params, spec).generate(prompts, max_new_tokens=8,
                                              prefill_chunk=8)
    assert got == want


def test_offloaded_logits_match_forward(no_w4a8):
    """One chunk: the offloaded last logits within 1e-4 of forward()'s."""
    _, _, spec, params = _draw(TINY_DS)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, 128, (2, 12)))
    ref = _copy(params, spec)
    from ktransformers_tpu_torch.utils.device_prep import prepare_params

    ref = prepare_params(ref, spec)
    want, _ = forward(ref, spec, tokens,
                      KVCache.create(spec, 2, 64, torch.float32, "cpu"),
                      compute_dtype=torch.float32)
    gen = _offload_gen(params, spec)
    tok, got, cache = gen.forward_chunk(tokens, gen.new_cache())
    want = want[:, -1]
    assert float((got - want).abs().max() / want.abs().max()) <= LOGIT_TOL
    assert torch.equal(tok, want.argmax(-1))
    assert cache.lengths.tolist() == [12, 12]


def test_offload_microbatch_pipeline_matches(no_w4a8):
    """microbatches=2 (each half with its own cache, the hops of all
    layers on one shared staging) == the one-microbatch run."""
    from ktransformers_tpu_torch.offload import HostExperts

    _, _, spec, params = _draw(TINY_DS)
    prompts = [list(range(3, 13)), list(range(40, 50))]
    gen = _offload_gen(params, spec)
    want = gen.generate(prompts, max_new_tokens=6, prefill_chunk=8)
    assert gen.generate(prompts, max_new_tokens=6, prefill_chunk=8,
                        microbatches=2) == want
    experts = [lp["moe"]["experts"] for lp in gen.params["layers"]
               if "moe" in lp]
    assert all(isinstance(e, HostExperts) for e in experts)
    assert len({id(e.staging) for e in experts}) == 1


def test_offloaded_varlen_prompts_match_single(no_w4a8):
    """Unequal prompt lengths in one batch (the teacher-forced tail): each
    row's greedy output equals its own single-prompt resident run."""
    _, _, spec, params = _draw(TINY_DS)
    prompts = [list(range(5, 13)), list(range(40, 52))]
    gen = Generator(_copy(params, spec), spec, max_len=64, **F32)
    want = [gen.generate([p], GenerateConfig(max_new_tokens=6))[0]
            for p in prompts]
    got = _offload_gen(params, spec).generate(prompts, max_new_tokens=6,
                                              prefill_chunk=8)
    assert got == want


@pytest.mark.parametrize("transfer", [None, "bf16"])
def test_offload_generator_matches_jax(transfer, no_w4a8):
    """The port's HostOffloadGenerator against the JAX package's on the
    same weights (the JAX absorbed mats rounded to bf16, as the port's
    prepare_params stores them): float32 hops give the last logits of a
    chunk and of two decode steps within 1e-4; bf16 hops, which round x,
    the combine weights and the expert output alike on both sides, give
    the same greedy tokens."""
    from ktransformers_tpu.offload.host_engine import (
        HostOffloadGenerator as JGen,
        split_params_for_offload as jsplit,
    )

    _jax_host_moe()
    js, jp, spec, params = _draw(TINY_DS)
    jdev, jhost = jsplit(bf16_absorbed(jp), js)
    jtd = None if transfer is None else jnp.bfloat16
    jgen = JGen(jdev, js, jhost, max_len=64, batch=2,
                cache_dtype=jnp.float32, compute_dtype=jnp.float32,
                transfer_dtype=jtd)
    gen = _offload_gen(params, spec, transfer_dtype=None
                       if transfer is None else torch.bfloat16)
    if transfer is None:
        tokens = np.random.default_rng(2).integers(0, 128, (2, 12))
        jcache, cache = jgen.new_cache(), gen.new_cache()
        for step in range(3):
            jtok, jlog, jcache = jgen.forward_chunk(
                tokens.astype(np.int32), jcache)
            tok, lg, cache = gen.forward_chunk(torch.from_numpy(tokens),
                                               cache)
            want = np.asarray(jlog)
            err = np.abs(lg.numpy() - want).max() / np.abs(want).max()
            assert err <= LOGIT_TOL, (step, err)
            tokens = np.asarray(jtok).reshape(2, 1)
    else:
        prompts = [list(range(5, 13)), list(range(40, 50))]
        assert gen.generate(prompts, max_new_tokens=8, prefill_chunk=8) == \
            jgen.generate(prompts, max_new_tokens=8, prefill_chunk=8)


# --------------------------------------------------------------- refusals


def _refusal_cases():
    from ktransformers_tpu_torch.models import registry as treg

    st = dict(treg.REGISTRY["smallthinker-21b"].config, vocab_size=128,
              hidden_size=64, num_hidden_layers=4, num_attention_heads=4,
              num_key_value_heads=2, head_dim=16, sliding_window_size=8,
              rope_layout=[1, 1, 1, 0], sliding_window_layout=[1, 1, 1, 0],
              moe_num_primary_experts=4, moe_num_active_primary_experts=2,
              moe_ffn_hidden_size=32, dense_ffn_hidden_size=64)
    nx = dict(treg.REGISTRY["qwen3-next-80b-a3b"].config, vocab_size=128,
              hidden_size=64, num_hidden_layers=4, num_attention_heads=4,
              num_key_value_heads=2, head_dim=16, num_experts=4,
              num_experts_per_tok=2, moe_intermediate_size=32,
              shared_expert_intermediate_size=32,
              layer_types=["linear_attention"] * 3 + ["full_attention"])
    return {
        "hybrid": (nx, "hybrid linear-attention layers"),
        "window": (st, "sliding-window layers"),
        "nope": (dict(st, sliding_window_layout=[0] * 4), "NoPE layers"),
        "early_router": (dict(st, sliding_window_layout=[0] * 4,
                              rope_layout=[1] * 4), "the early router"),
        "relu": (dict(st, sliding_window_layout=[0] * 4, rope_layout=[1] * 4,
                      moe_enable_early_router=False), "'relu'"),
    }


@pytest.mark.parametrize("case", ["hybrid", "window", "nope",
                                  "early_router", "relu"])
def test_unsupported_specs_raise(case):
    """Each layout the offloaded segments would compute wrongly raises,
    naming it, before any weight moves (smallthinker's windows, NoPE
    layers, early router and ReLU experts; qwen3-next's linear layers)."""
    cfg, what = _refusal_cases()[case]
    spec = spec_from_hf_config(dict(cfg))
    with pytest.raises(ValueError, match=what):
        split_params_for_offload({"layers": []}, spec)


@pytest.mark.parametrize("case", ["gelu", "swiglu_limit", "int8_experts",
                                  "expert_lora", "streamed_lora"])
def test_unsupported_experts_raise(case):
    """The host FFN refuses what it does not compute: gelu (its C++ gelu
    is the tanh form), a swiglu_limit clamp, experts not int4_g, experts
    with LoRA factors (host or streamed)."""
    rng = np.random.default_rng(3)
    kind = "int8" if case == "int8_experts" else "int4_g"
    gu, dn = (qtensor_from_jax(jax.device_get(q), "cpu")
              for q in _experts(rng, 2, 64, 32, 32, kind))
    act = {"gelu": ActivationConfig("gelu"),
           "swiglu_limit": ActivationConfig("silu", swiglu_limit=7.0)}.get(
        case, ActivationConfig())
    lora = {"gate_up_a": torch.zeros(2, 64, 1)}
    if case == "streamed_lora":
        with pytest.raises(ValueError, match="LoRA"):
            offload_moe_weights(MoEWeights(gu, dn, lora))
        return
    if case == "expert_lora":
        _, _, spec, params = _draw(TINY_DS)
        params["layers"][1]["moe"]["experts"].lora = lora
        with pytest.raises(ValueError, match="LoRA"):
            split_params_for_offload(params, spec)
        return
    with pytest.raises(ValueError, match={"gelu": "gelu",
                                          "swiglu_limit": "swiglu_limit",
                                          "int8_experts": "int8"}[case]):
        HostMoELayer.from_qtensors(gu, dn, act)
