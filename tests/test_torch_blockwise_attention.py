"""The port's blockwise (online-softmax) attention against the JAX
package's and against its own dense attention, and the long-context switch
through the whole model.

- mla_absorbed_blockwise and mha_blockwise on the same numpy inputs as the
  JAX functions: blocks of 8 and 16 keys, a cache length that is no
  multiple of either, positions that start past 0, G = 4 query heads a KV
  head; within 2e-4 of both the JAX function and the port's dense
  mla_absorbed / mha under the causal mask;
- the port's forward() with BLOCKWISE_KV_THRESHOLD lowered (a
  monkeypatched module attribute, as tests/test_blockwise_attention.py
  lowers the JAX package's) on the tiny MLA model (TINY_DS, bf16-kind
  weights carried from the JAX package) and a tiny GQA (Llama) model, over
  a cache of two 2048-key blocks: a prefill and decode steps within 2e-4
  of the same forward with the threshold high and of the JAX forward run
  the same way (jitted after the patch, so its trace reads the lowered
  threshold);
- a Generator on the GQA model decoding past the lowered threshold (every
  step blockwise) gives the dense path's tokens.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ktransformers_tpu_torch.convert import params_from_jax
from ktransformers_tpu_torch.engine.generate import GenerateConfig, Generator
from ktransformers_tpu_torch.models import model as tmodel
from ktransformers_tpu_torch.models.spec import spec_from_hf_config
from ktransformers_tpu_torch.ops import attention as tatt

from tests.test_generate import TINY_DS
from tests.test_torch_model import one_torch_thread  # noqa: F401

TOL = 2e-4  # of the largest output
# a tiny Llama: 8 query heads over 2 KV heads (G = 4), head 16
TINY_LLAMA = dict(model_type="llama", vocab_size=96, hidden_size=64,
                  intermediate_size=96, num_hidden_layers=2,
                  num_attention_heads=8, num_key_value_heads=2,
                  rms_norm_eps=1e-5, rope_theta=10000.0,
                  max_position_embeddings=4096)
LONG = 2100  # cache positions: one 2048-key block and a cut one
PROMPT, STEPS = 20, 3


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.abs(a - b).max() / np.abs(b).max())


def _f(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _mask(offs, sq, skv):
    """The dense path's additive causal mask [B, Sq, Skv]."""
    return tmodel._attn_mask(torch.as_tensor(offs), sq, skv)


@pytest.mark.parametrize("block", [8, 16])
def test_mla_blockwise_matches_jax_and_dense(block):
    from ktransformers_tpu.ops.attention import mla_absorbed_blockwise

    rng = np.random.default_rng(block)
    b, h, sq, r, dr, skv = 2, 4, 5, 32, 16, 75
    qn, qp = _f(rng, b, h, sq, r), _f(rng, b, h, sq, dr)
    ckv, kpe = _f(rng, b, skv, r), _f(rng, b, skv, dr)
    offs = np.asarray([13, 70], np.int32)
    qpos = offs[:, None] + np.arange(sq)[None, :]
    t = [torch.from_numpy(a) for a in (qn, qp, ckv, kpe)]
    out = tatt.mla_absorbed_blockwise(*t, torch.from_numpy(qpos),
                                      scale=0.11, block_size=block)
    ref = mla_absorbed_blockwise(*map(jnp.asarray, (qn, qp, ckv, kpe)),
                                 jnp.asarray(qpos), scale=0.11,
                                 block_size=block)
    dense = tatt.mla_absorbed(*t, scale=0.11, mask=_mask(offs, sq, skv))
    assert out.shape == (b, h, sq, r)
    assert _rel(out, np.asarray(ref)) <= TOL
    assert _rel(out, dense) <= TOL


@pytest.mark.parametrize("block", [8, 16])
def test_mha_blockwise_matches_jax_and_dense(block):
    from ktransformers_tpu.ops.attention import mha_blockwise

    rng = np.random.default_rng(10 + block)
    b, h, hkv, sq, d, dv, skv = 2, 8, 2, 3, 16, 24, 53
    q, k, v = _f(rng, b, h, sq, d), _f(rng, b, hkv, skv, d), \
        _f(rng, b, hkv, skv, dv)
    offs = np.asarray([9, 50], np.int32)
    qpos = offs[:, None] + np.arange(sq)[None, :]
    t = [torch.from_numpy(a) for a in (q, k, v)]
    out = tatt.mha_blockwise(*t, torch.from_numpy(qpos), scale=0.25,
                             block_size=block)
    ref = mha_blockwise(*map(jnp.asarray, (q, k, v)), jnp.asarray(qpos),
                        scale=0.25, block_size=block)
    dense = tatt.mha(*t, scale=0.25, mask=_mask(offs, sq, skv))
    assert out.shape == (b, h, sq, dv)
    assert _rel(out, np.asarray(ref)) <= TOL
    assert _rel(out, dense) <= TOL


def test_mha_blockwise_keeps_dtype_and_refuses_bad_groups():
    rng = np.random.default_rng(3)
    q = torch.from_numpy(_f(rng, 1, 4, 2, 8)).to(torch.bfloat16)
    k = torch.from_numpy(_f(rng, 1, 2, 9, 8)).to(torch.bfloat16)
    pos = torch.tensor([[7, 8]])
    assert tatt.mha_blockwise(q, k, k, pos, scale=0.3,
                              block_size=4).dtype == torch.bfloat16
    with pytest.raises(ValueError):
        tatt.mha_blockwise(q[:, :3], k, k, pos, scale=0.3)


def _model(name):
    """(JAX spec, JAX params, port spec, port params): bf16-kind weights
    drawn by the JAX package, carried across, float32 data."""
    from ktransformers_tpu.models.init import init_params
    from ktransformers_tpu.models.spec import spec_from_hf_config as jspec

    cfg = {"mla": TINY_DS, "gqa": TINY_LLAMA}[name]
    js = jspec(dict(cfg))
    jp = init_params(js, seed=0, quant="bf16")
    spec = spec_from_hf_config(dict(cfg))
    return js, jp, spec, params_from_jax(jax.device_get(jp), spec, "cpu")


def _tokens(n=PROMPT + STEPS):
    return np.random.default_rng(4).integers(0, 96, (1, n)).astype(np.int32)


def _port_rows(spec, params):
    """Logits of a PROMPT-token prefill and STEPS decode steps over a cache
    of LONG positions, float32."""
    toks = torch.as_tensor(_tokens(), dtype=torch.int64)
    cache = tmodel.KVCache.create(spec, 1, LONG, torch.float32, "cpu")
    with torch.no_grad():
        out, cache = tmodel.forward(params, spec, toks[:, :PROMPT], cache,
                                    compute_dtype=torch.float32)
        rows = [out[0]]
        for i in range(PROMPT, PROMPT + STEPS):
            out, cache = tmodel.forward(params, spec, toks[:, i : i + 1],
                                        cache, compute_dtype=torch.float32)
            rows.append(out[0])
    return torch.cat(rows).numpy()


def _jax_rows(js, jp):
    from ktransformers_tpu.models.model import KVCache
    from ktransformers_tpu.models.model import forward as jforward
    from ktransformers_tpu.ops.rope import precompute_rope_tables

    # a new function object: its trace, made now, reads the lowered
    # threshold (a jit of jforward itself could reuse another's trace)
    fwd = jax.jit(lambda p, t, c, rope: jforward(
        p, js, t, c, rope_tables=rope, compute_dtype=jnp.float32))
    rope = precompute_rope_tables(js.rope)
    toks = jnp.asarray(_tokens())
    cache = KVCache.create(js, 1, LONG, dtype=jnp.float32)
    out, cache = fwd(jp, toks[:, :PROMPT], cache, rope)
    rows = [np.asarray(out[0])]
    for i in range(PROMPT, PROMPT + STEPS):
        out, cache = fwd(jp, toks[:, i : i + 1], cache, rope)
        rows.append(np.asarray(out[0]))
    return np.concatenate(rows)


@pytest.mark.parametrize("name", ["mla", "gqa"])
def test_forward_threshold_matches_dense_and_jax(name, monkeypatch):
    """The cache of LONG = 2100 positions crosses the lowered threshold
    (2048), so the blockwise forms walk a block of 2048 keys and one of 52:
    MLA at the prefill (its decode stays on mla_decode), GQA at every step.
    Every logits row within 2e-4 of the dense path's and of the JAX
    forward's with its threshold lowered the same way."""
    import ktransformers_tpu.models.model as jmodel

    js, jp, spec, params = _model(name)
    calls = {"n": 0}
    blockwise = {"mla": "mla_absorbed_blockwise",
                 "gqa": "mha_blockwise"}[name]
    real = getattr(tmodel, blockwise)

    def counted(*a, **kw):
        calls["n"] += 1
        return real(*a, **kw)

    dense = _port_rows(spec, params)
    assert calls["n"] == 0
    monkeypatch.setattr(tatt, "BLOCKWISE_KV_THRESHOLD", 2048)
    monkeypatch.setattr(tmodel, blockwise, counted)
    out = _port_rows(spec, params)
    layers = spec.num_layers
    assert calls["n"] == (layers if name == "mla"
                          else layers * (1 + STEPS))
    monkeypatch.setattr(jmodel, "BLOCKWISE_KV_THRESHOLD", 2048)
    ref = _jax_rows(js, jp)
    assert _rel(out, dense) <= TOL
    assert _rel(out, ref) <= TOL
    assert (out.argmax(-1) == ref.argmax(-1)).all()


def test_generator_decodes_past_threshold(monkeypatch):
    """A Generator on the GQA model at max_len 48 with the threshold at 32:
    its prefill chunks and every decode step run mha_blockwise, and its
    greedy tokens equal the dense path's."""
    _, _, spec, params = _model("gqa")
    prompt = _tokens(12)[0].tolist()
    cfg = GenerateConfig(max_new_tokens=8, prefill_chunk=8)
    f32 = dict(max_len=48, cache_dtype=torch.float32,
               compute_dtype=torch.float32, device="cpu")
    dense = Generator(params, spec, **f32).generate(prompt, cfg)
    calls = {"n": 0}
    real = tmodel.mha_blockwise

    def counted(*a, **kw):
        calls["n"] += 1
        return real(*a, **kw)

    monkeypatch.setattr(tatt, "BLOCKWISE_KV_THRESHOLD", 32)
    monkeypatch.setattr(tmodel, "mha_blockwise", counted)
    out = Generator(params, spec, **f32).generate(prompt, cfg)
    # 2 prefill chunks and 7 decode steps, 2 layers each
    assert calls["n"] == spec.num_layers * (2 + 7)
    assert out == dense
