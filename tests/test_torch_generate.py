"""The port's single-user Generator with sampling penalties against the JAX
package's.

One 2-layer DeepSeek-V2 model at narrow widths (both layers dense) with
unquantized float32 weights is built by the JAX package's
init_params_synthetic and prepare_params (with the transforms the port's
prepare_params applies too: bf16 absorbed mats, fused qkv) and carried
across with convert.params_from_jax. No Pallas kernel runs on either side and both
compute in float32, so the logits differ only by the order of float32 sums
and greedy tokens agree exactly. Greedy generation with repetition,
presence and frequency penalties runs through both Generators: the JAX one
carries the generated-token counts and the prompt mask on the device
(_decode_step_penalized), the port's must do the same.
"""

import jax
import numpy as np
import pytest
import torch

from ktransformers_tpu_torch.convert import params_from_jax
from ktransformers_tpu_torch.engine.generate import (
    GenerateConfig,
    Generator,
    _count,
)
from ktransformers_tpu_torch.engine.sampler import SamplingConfig
from ktransformers_tpu_torch.models.spec import spec_from_hf_config

from tests.test_torch_model import (
    SMALL,
    one_torch_thread,  # noqa: F401 (a fixture)
)

CFG = dict(SMALL, num_hidden_layers=2, first_k_dense_replace=2)
PROMPT_LEN, NEW_TOKENS, MAX_LEN = 12, 16, 64
PENALTIES = dict(repetition_penalty=1.3, presence_penalty=0.5,
                 frequency_penalty=0.25)


@pytest.fixture(scope="module")
def models():
    """(JAX Generator, port Generator, prompt) over the same weights."""
    import jax.numpy as jnp

    from ktransformers_tpu.engine.generate import Generator as JGenerator
    from ktransformers_tpu.models.init import init_params_synthetic
    from ktransformers_tpu.models.spec import spec_from_hf_config as jspec_of
    from ktransformers_tpu.utils.device_prep import prepare_params

    jspec = jspec_of(CFG)
    jparams = prepare_params(init_params_synthetic(
        jspec, seed=5, quant="bf16", dtype=jnp.float32), True, jspec)
    jgen = JGenerator(jparams, jspec, max_len=MAX_LEN,
                      cache_dtype=jnp.float32, compute_dtype=jnp.float32)
    spec = spec_from_hf_config(CFG)
    gen = Generator(params_from_jax(jax.device_get(jgen.params), spec, "cpu"),
                    spec, max_len=MAX_LEN, cache_dtype=torch.float32,
                    compute_dtype=torch.float32, device="cpu")
    prompt = np.random.default_rng(11).integers(
        0, CFG["vocab_size"], PROMPT_LEN).tolist()
    return jgen, gen, prompt


def _greedy(**penalties) -> GenerateConfig:
    return GenerateConfig(max_new_tokens=NEW_TOKENS, prefill_chunk=PROMPT_LEN,
                          sampling=SamplingConfig(**penalties))


def test_penalized_greedy_tokens_match_jax(models):
    jgen, gen, prompt = models
    cfg = _greedy(**PENALTIES)
    assert gen.generate(prompt, cfg) == jgen.generate([prompt], cfg)


@pytest.mark.parametrize("penalty", sorted(PENALTIES))
def test_each_penalty_matches_jax(models, penalty):
    """One penalty at a time: the repetition penalty sees the prompt too,
    the additive ones only the generated tokens."""
    jgen, gen, prompt = models
    cfg = _greedy(**{penalty: PENALTIES[penalty]})
    assert gen.generate(prompt, cfg) == jgen.generate([prompt], cfg)


def test_penalties_change_the_tokens(models):
    """Not vacuous: on the same prompt the unpenalized port repeats tokens
    and its greedy tokens differ from the penalized ones."""
    _, gen, prompt = models
    plain = gen.generate(prompt, _greedy())[0]
    penalized = gen.generate(prompt, _greedy(**PENALTIES))[0]
    assert plain != penalized
    assert len(set(plain)) < len(plain)


def test_decode_step_counts_the_sampled_token(models):
    """decode_step with counts applies the penalties and adds one at the
    token it returns, in place."""
    _, gen, prompt = models
    cache = gen.new_cache()
    last, cache = gen.prefill(cache, torch.tensor([prompt]), PROMPT_LEN)
    tok = last.argmax(-1)
    v = last.shape[-1]
    counts = torch.zeros(1, v, dtype=torch.int32)
    counts[0, tok] = 3
    mask = torch.zeros(1, v, dtype=torch.bool)
    nxt, _ = gen.decode_step(tok, cache, SamplingConfig(**PENALTIES),
                             counts=counts, prompt_mask=mask)
    assert int(counts.sum()) == 4
    assert int(counts[0, nxt[0]]) == (4 if int(nxt[0]) == int(tok[0]) else 1)


def test_count_adds_one_per_row():
    counts = torch.zeros(3, 5, dtype=torch.int32)
    _count(counts, torch.tensor([1, 1, 4]))
    _count(counts, torch.tensor([1, 0, 4]))
    assert counts.tolist() == [[0, 2, 0, 0, 0], [1, 1, 0, 0, 0],
                               [0, 0, 0, 0, 2]]


def test_unpenalized_config_needs_no_counts():
    assert not SamplingConfig().needs_counts
    assert SamplingConfig(presence_penalty=0.5).needs_counts
