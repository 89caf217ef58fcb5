"""The port's dense families (Llama, Qwen2, Qwen3) against HF torch and the
JAX package.

Tiny random HF models (transformers 4.57.6, float32, eager attention):
Llama untied; Qwen2 with tied embeddings and its q / k / v biases drawn;
Qwen3 with tied embeddings and its q / k norms drawn (HF initialises
biases and norms to constants, which would leave a missing bias or a norm
applied twice unseen). One params_from_hf of each feeds all three
runs: the JAX package's (quant="f32") is carried across with
convert.params_from_jax and equals the port's own params_from_hf bit for
bit. The port's forward:
- within 2e-3 of HF's logits (of the largest logit), greedy argmax equal
  (the JAX package's _run_parity rule);
- within 2e-4 of the JAX forward (jitted) on those weights.
Llama-3.1's ``rope_type: llama3`` is held against HF alone, at a head dim
and original context where the smoothing moves some frequencies: the JAX
translator drops the scaling, and its rope misses HF. The paged forward
and a 3-request ServeEngine on the Llama model match the single-user
path.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ktransformers_tpu_torch.cache.paged import PagedKVCache
from ktransformers_tpu_torch.convert import params_from_jax
from ktransformers_tpu_torch.engine.generate import GenerateConfig, Generator
from ktransformers_tpu_torch.models import model as tmodel
from ktransformers_tpu_torch.models.hf_import import params_from_hf
from ktransformers_tpu_torch.models.paged import forward_paged
from ktransformers_tpu_torch.models.spec import spec_from_hf_config
from ktransformers_tpu_torch.ops import rope as trope
from ktransformers_tpu_torch.serving import SchedulerConfig, ServeEngine

from tests.test_torch_hf_import import _assert_same_tree
from tests.test_torch_model import one_torch_thread  # noqa: F401

HF_TOL = 2e-3  # of the largest HF logit
JAX_TOL = 2e-4  # of the largest JAX logit, float32 weights
FAMILIES = ("llama", "qwen2", "qwen3")
LLAMA3 = dict(rope_type="llama3", factor=8.0, low_freq_factor=1.0,
              high_freq_factor=4.0, original_max_position_embeddings=64)
F32 = dict(cache_dtype=torch.float32, compute_dtype=torch.float32,
           device="cpu")


def _rel(out, ref) -> float:
    out, ref = np.asarray(out, np.float32), np.asarray(ref, np.float32)
    return float(np.abs(out - ref).max() / (np.abs(ref).max() + 1e-6))


def _hf_model(family: str, rope_scaling=None):
    """A tiny HF model of ``family``: 2 layers, hidden 64, 4 query heads
    over 2 KV heads (head 32 for the llama3 case, 16 for Qwen3)."""
    from transformers import (
        LlamaConfig,
        LlamaForCausalLM,
        Qwen2Config,
        Qwen2ForCausalLM,
        Qwen3Config,
        Qwen3ForCausalLM,
    )

    kw = dict(vocab_size=128, hidden_size=64, intermediate_size=128,
              num_hidden_layers=2, num_attention_heads=4,
              num_key_value_heads=2, max_position_embeddings=64,
              attn_implementation="eager")
    if family == "llama":
        if rope_scaling:
            kw.update(head_dim=32, rope_scaling=rope_scaling)
        cfg, cls, seed = LlamaConfig(**kw), LlamaForCausalLM, 5
    elif family == "qwen2":
        cfg = Qwen2Config(tie_word_embeddings=True, **kw)
        cls, seed = Qwen2ForCausalLM, 8
    else:
        cfg = Qwen3Config(head_dim=16, tie_word_embeddings=True, **kw)
        cls, seed = Qwen3ForCausalLM, 9
    torch.manual_seed(seed)
    model = cls(cfg)
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, prm in model.named_parameters():
            if name.endswith("_proj.bias"):
                prm.copy_(torch.randn(prm.shape, generator=gen) * 0.1)
            elif name.endswith("norm.weight"):
                prm.copy_(1 + 0.1 * torch.randn(prm.shape, generator=gen))
    return model.eval().float(), cfg


def _tokens(vocab, n=12, batch=2, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, (batch, n))


def _port_logits(spec, params, tokens, max_len=20):
    cache = tmodel.KVCache.create(spec, tokens.shape[0], max_len,
                                  torch.float32, "cpu")
    with torch.no_grad():
        out, _ = tmodel.forward(params, spec, torch.from_numpy(tokens),
                                cache, compute_dtype=torch.float32)
    return out.numpy()


def _jax_logits(jspec, jparams, tokens, max_len=20):
    from ktransformers_tpu.models.model import KVCache
    from ktransformers_tpu.models.model import forward as jforward

    fwd = jax.jit(jforward, static_argnames=("spec", "compute_dtype"))
    cache = KVCache.create(jspec, tokens.shape[0], max_len, dtype=jnp.float32)
    out, _ = fwd(jparams, jspec, jnp.asarray(tokens, jnp.int32), cache,
                 compute_dtype=jnp.float32)
    return np.asarray(out)


@pytest.mark.parametrize("family", FAMILIES)
def test_hf_and_jax_parity(family):
    """One tiny HF model of each family: the port within 2e-3 of HF with
    the same greedy argmax, and within 2e-4 of the JAX forward on the JAX
    package's params_from_hf carried across (equal to the port's own
    import); tied embeddings leave no lm_head in either tree."""
    from ktransformers_tpu.models.hf_import import (
        params_from_hf as j_params_from_hf,
    )
    from ktransformers_tpu.models.spec import spec_from_hf_config as jspec_of

    model, cfg = _hf_model(family)
    spec, jspec = spec_from_hf_config(cfg), jspec_of(cfg.to_dict())
    params = params_from_hf(model, spec, quant="f32", device="cpu")
    jparams = j_params_from_hf(model, jspec, quant="f32")
    _assert_same_tree(params, params_from_jax(jax.device_get(jparams), spec,
                                              "cpu"))
    tokens = _tokens(cfg.vocab_size)
    with torch.no_grad():
        ref = model(torch.from_numpy(tokens)).logits.numpy()
    out = _port_logits(spec, params, tokens)
    assert _rel(out, ref) < HF_TOL
    np.testing.assert_array_equal(out[:, -1].argmax(-1),
                                  ref[:, -1].argmax(-1))
    assert _rel(out, _jax_logits(jspec, jparams, tokens)) <= JAX_TOL
    attn = params["layers"][0]["attn"]
    assert ("lm_head" in params) == (family == "llama")
    assert ("q_bias" in attn) == (family == "qwen2")
    assert ("q_norm" in attn) == (family == "qwen3")
    assert spec.moe is None and spec.tie_word_embeddings == (family != "llama")


def test_llama3_rope_parity():
    """rope_type llama3 (factor 8, low / high_freq_factor 1 / 4, original
    context 64) at head dim 32: the smoothing divides some frequencies by 8,
    interpolates others and keeps the rest, its inverse frequencies equal
    HF's own, and the logits match HF within 2e-3. The JAX translator maps
    the type to no scaling: with its rope the port misses HF by more than
    the tolerance."""
    from transformers.modeling_rope_utils import ROPE_INIT_FUNCTIONS

    from ktransformers_tpu.models.spec import spec_from_hf_config as jspec_of

    model, cfg = _hf_model("llama", LLAMA3)
    spec = spec_from_hf_config(cfg)
    assert spec.rope.scaling_type == "llama3" and spec.rope.dim == 32
    plain = 1.0 / spec.rope.base ** (np.arange(0, 32, 2) / 32)
    scaled = trope.llama3_inv_freq(plain, spec.rope)
    kept = np.isclose(scaled, plain, rtol=1e-12)
    divided = np.isclose(scaled, plain / 8, rtol=1e-12)
    assert kept.any() and divided.any() and (~kept & ~divided).any()
    hf_inv, _ = ROPE_INIT_FUNCTIONS["llama3"](cfg, "cpu")
    np.testing.assert_allclose(scaled, hf_inv.double().numpy(), rtol=1e-6)

    params = params_from_hf(model, spec, quant="f32", device="cpu")
    tokens = _tokens(cfg.vocab_size)
    with torch.no_grad():
        ref = model(torch.from_numpy(tokens)).logits.numpy()
    out = _port_logits(spec, params, tokens)
    assert _rel(out, ref) < HF_TOL
    np.testing.assert_array_equal(out[:, -1].argmax(-1),
                                  ref[:, -1].argmax(-1))
    jrope = jspec_of(cfg.to_dict()).rope
    assert jrope.scaling_type is None
    jax_rule = dataclasses.replace(spec, rope=dataclasses.replace(
        spec.rope, scaling_type=jrope.scaling_type))
    assert _rel(_port_logits(jax_rule, params, tokens), ref) > HF_TOL


@pytest.fixture(scope="module")
def llama():
    model, cfg = _hf_model("llama")
    spec = spec_from_hf_config(cfg)
    return spec, params_from_hf(model, spec, quant="f32", device="cpu")


def hold_paged_against_forward(spec, params, steps):
    """Two sequences on shuffled pages through forward_paged, each step (S
    tokens, the live count of each sequence or None for all) fed the next
    tokens of each sequence's stream: every sequence's last live logits
    row within 2e-4 of the contiguous forward fed the same tokens."""
    rng = np.random.default_rng(21)
    page, pmax = 8, 4
    tables = torch.as_tensor((rng.permutation(11)[:8] + 1).reshape(2, pmax),
                             dtype=torch.int32)
    stream = rng.integers(0, spec.vocab_size, (2, 24))
    kv = PagedKVCache.create(spec, 12, page, dtype=torch.float32,
                             device="cpu")
    lengths = torch.zeros(2, dtype=torch.int32)
    caches = [tmodel.KVCache.create(spec, 1, 32, torch.float32, "cpu")
              for _ in range(2)]
    done = [0, 0]
    with torch.no_grad():
        for s, valid in steps:
            toks = torch.as_tensor(np.stack(
                [stream[b, done[b] : done[b] + s] for b in range(2)]))
            v = None if valid is None else torch.tensor(valid,
                                                        dtype=torch.int32)
            out, kv = forward_paged(params, spec, toks, kv, tables, lengths,
                                    valid=v, compute_dtype=torch.float32)
            for b in range(2):
                n = s if valid is None else valid[b]
                ref, caches[b] = tmodel.forward(
                    params, spec, toks[b : b + 1, :n], caches[b],
                    compute_dtype=torch.float32, logits_last_only=True)
                assert _rel(out[b, -1], ref[0, -1]) <= JAX_TOL, (s, b)
                done[b] += n
            lengths = lengths + (s if v is None else v)


def hold_engine_against_generator(spec, params, new_tokens: int):
    """Three prompts through the ServeEngine (the third joins after two
    steps, so a fused mixed step runs) give the single-user Generator's
    tokens, float32."""
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, spec.vocab_size, n).tolist()
               for n in (7, 17, 5)]
    eng = ServeEngine(params, spec, SchedulerConfig(
        max_batch_size=4, prefill_chunk=8, page_size=8,
        max_pages_per_query=8), num_pages=64, **F32)
    qs = [eng.submit(p, max_new_tokens=new_tokens) for p in prompts[:2]]
    eng.step()
    eng.step()
    qs.append(eng.submit(prompts[2], max_new_tokens=new_tokens))
    for _ in range(3000):
        if all(q.state == "done" for q in qs):
            break
        eng.step()
    assert eng.mixed_steps_fused >= 1
    gen = Generator(params, spec, max_len=64, **F32)
    single = [gen.generate(p, GenerateConfig(max_new_tokens=new_tokens,
                                             prefill_chunk=8))[0]
              for p in prompts]
    assert [list(q.output_ids) for q in qs] == single


def test_forward_paged_matches_forward(llama):
    """A padded prefill chunk (12 and 9 live tokens of 12), a second chunk
    of 8, then two decode steps (hold_paged_against_forward)."""
    hold_paged_against_forward(*llama, ((12, [12, 9]), (8, [8, 8]),
                                        (1, None), (1, None)))


def test_serve_engine_matches_generator(llama):
    hold_engine_against_generator(*llama, 4)
