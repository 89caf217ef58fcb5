"""The port's paged serving path on a GQA (Mixtral-family) model: the paged
forward, the fused mixed step and the ServeEngine against the JAX package
and against the port's own single-user path.

The model is a Mixtral spec cut to 2 layers: vocab 512, hidden 512, 4 query
heads over 2 KV heads of 128, 4 experts top-2 of inter 256. At these widths
the fused expert FFN would fit, so the module refuses it on both sides (the
fits tests of the two packages return False, as they do at Mixtral-8x7B's
widths; tests/test_torch_gqa_model.py holds that refusal): the routed
experts run through the unfused W4A8 matmuls, the path Mixtral-8x7B
serves on. The JAX package builds the params and runs every Pallas kernel
in interpret mode (the generation hooks of tests/test_torch_model.py plus
the paged-attention hooks); the port runs the plain versions on the CPU,
float32 throughout.

Two weight variants:
- ``w4a8``: int8 attention and lm_head, int4_g experts repacked for W4A8
  (the served kinds). Logits within 5e-2 of the largest with equal greedy
  tokens (LOGIT_TOL: float32 summation order flips an int8 activation code
  now and then); layer 0's live pool rows within 1e-5, deeper layers within
  5e-2;
- ``int8``: every weight int8, so no activation requant: logits within
  1e-4 and every layer's live pool rows within 1e-5.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ktransformers_tpu_torch.cache.paged import PagedKVCache
from ktransformers_tpu_torch.cache.tiers import HostDiskTier
from ktransformers_tpu_torch.convert import (
    paged_cache_from_jax,
    params_from_jax,
)
from ktransformers_tpu_torch.engine.generate import GenerateConfig, Generator
from ktransformers_tpu_torch.models import model as tmodel
from ktransformers_tpu_torch.models.paged import (
    forward_paged,
    forward_paged_mixed,
)
from ktransformers_tpu_torch.models.spec import (
    MIXTRAL_8X7B,
    spec_from_hf_config,
)
from ktransformers_tpu_torch.ops import moe as tmoe
from ktransformers_tpu_torch.ops.cuda.paged_attention import gather_pages
from ktransformers_tpu_torch.serving import SchedulerConfig, ServeEngine

from tests.test_torch_gqa_model import jax_mixtral_params
from tests.test_torch_model import (
    LOGIT_TOL,
    jax_interpret_hooks,
    one_torch_thread,  # noqa: F401 (a fixture)
)

CFG = dict(MIXTRAL_8X7B, vocab_size=512, hidden_size=512,
           intermediate_size=256, num_hidden_layers=2, num_attention_heads=4,
           num_key_value_heads=2, num_local_experts=4,
           max_position_embeddings=256)
SPEC = spec_from_hf_config(CFG)
VOCAB = CFG["vocab_size"]
F32 = dict(cache_dtype=torch.float32, compute_dtype=torch.float32,
           device="cpu")
TIGHT, POOL_TOL = 1e-4, 1e-5


@pytest.fixture(scope="module")
def both():
    """Both packages' hooks with the fused expert FFN refused, and the
    ``w4a8`` and ``int8`` variants (JAX spec and params, the port's
    params)."""
    from ktransformers_tpu.models import paged as jpaged
    from ktransformers_tpu.ops.pallas import paged_attention as jpa
    from ktransformers_tpu.ops.pallas import w4a8_matmul as jwm

    old = (jpaged._PAGED_MLA_DECODE, jpaged._PAGED_GQA_DECODE,
           jpaged._PAGED_MLA_PREFILL, jpaged._PAGED_GQA_PREFILL)
    calls = {}

    def counted(name, fn):
        def wrapped(*a, **kw):
            calls[name] = calls.get(name, 0) + 1
            return fn(*a, **kw, interpret=True)
        return wrapped

    refuse = lambda *a, **kw: False  # noqa: E731
    with pytest.MonkeyPatch.context() as mp, jax_interpret_hooks() as hooks:
        for mod in (jwm, tmoe):
            mp.setattr(mod, "ffn_fits", refuse)
            mp.setattr(mod, "grouped_ffn_fits", refuse)
        jpaged.set_pallas_paged_decode(
            counted("mla_paged_decode", jpa.mla_paged_decode),
            counted("gqa_paged_decode", jpa.gqa_paged_decode))
        jpaged.set_pallas_paged_prefill(
            counted("mla_paged_prefill", jpa.mla_paged_prefill),
            counted("gqa_paged_prefill", jpa.gqa_paged_prefill))
        try:
            variants = {}
            for name, moe_quant, seed in (("w4a8", "int4_g", 1),
                                          ("int8", "int8", 2)):
                jspec, jparams = jax_mixtral_params(CFG, seed, moe_quant)
                variants[name] = types.SimpleNamespace(
                    jspec=jspec, jparams=jparams,
                    params=params_from_jax(jax.device_get(jparams), SPEC,
                                           "cpu"),
                    tight=name == "int8")
            yield types.SimpleNamespace(calls=calls, hooks=hooks, **variants)
        finally:
            jpaged.set_pallas_paged_decode(old[0], old[1])
            jpaged.set_pallas_paged_prefill(old[2], old[3])


@pytest.fixture(params=["w4a8", "int8"])
def variant(request, both):
    return getattr(both, request.param)


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.abs(a - b).max() / np.abs(b).max())


def _ti(a, dtype=torch.int32):
    return torch.as_tensor(np.asarray(a), dtype=dtype)


def _ji(a):
    return jnp.asarray(np.asarray(a), jnp.int32)


def _close(out, ref, tight: bool, tol=TIGHT):
    out, ref = np.asarray(out), np.asarray(ref)
    if tight:
        np.testing.assert_allclose(out, ref, rtol=tol, atol=tol)
    else:
        assert _rel(out, ref) <= LOGIT_TOL
        assert (out.argmax(-1) == ref.argmax(-1)).all()


def _check_pools(kv, jkv, tables, live, tight: bool):
    """Live rows of the k and v pools: layer 0 within 1e-5, deeper layers
    within 1e-5 (int8) or LOGIT_TOL (W4A8)."""
    for li in range(len(kv.bufs_a)):
        for mine, ref in ((kv.bufs_a[li], jkv.bufs_a[li]),
                          (kv.bufs_b[li], jkv.bufs_b[li])):
            assert mine.shape[2:] == (2, 128)
            got = gather_pages(mine, _ti(tables)).numpy()
            want = gather_pages(torch.from_numpy(np.array(ref)),
                                _ti(tables)).numpy()
            for b, n in enumerate(live):
                err = _rel(got[b, :n], want[b, :n])
                assert err <= (POOL_TOL if li == 0 or tight else LOGIT_TOL), \
                    (li, b, err)


def test_forward_paged_matches_jax(both, variant):
    """Two sequences on shuffled page tables, two chunks each (the second
    sequence's first chunk padded: valid 9 of 12), then three decode steps
    on the JAX side's greedy tokens; logits and live pool rows."""
    from ktransformers_tpu.cache.paged import PagedKVCache as JKV
    from ktransformers_tpu.models.paged import forward_paged as jforward

    rng = np.random.default_rng(21)
    page, pmax = 8, 4
    tokens = rng.integers(0, VOCAB, (2, 20))
    tables = (rng.permutation(11)[:8] + 1).reshape(2, pmax).astype(np.int32)
    jkv = JKV.create(variant.jspec, num_pages=12, page_size=page,
                     dtype=jnp.float32)
    kv = PagedKVCache.create(SPEC, 12, page, dtype=torch.float32,
                             device="cpu")
    before = dict(both.calls)
    lengths = np.zeros(2, np.int32)
    steps = [(tokens[:, :12], np.asarray([12, 9], np.int32)),
             (tokens[:, 12:], np.asarray([8, 8], np.int32))]
    greedy = None
    for i in range(5):
        toks, valid = steps[i] if i < 2 else (greedy[:, None], None)
        ref, jkv = jforward(
            variant.jparams, variant.jspec, _ji(toks), jkv, _ji(tables),
            _ji(lengths), valid=None if valid is None else _ji(valid),
            compute_dtype=jnp.float32)
        out, kv = forward_paged(
            variant.params, SPEC, _ti(toks, torch.int64), kv, _ti(tables),
            _ti(lengths), valid=None if valid is None else _ti(valid),
            compute_dtype=torch.float32)
        ref = np.asarray(ref)
        assert out.shape == ref.shape == (2, 1, VOCAB)
        _close(out.numpy(), ref, variant.tight)
        greedy = ref[:, -1].argmax(-1)
        lengths = lengths + (1 if valid is None else valid)
    for name in ("gqa_paged_decode", "gqa_paged_prefill"):
        assert both.calls[name] > before.get(name, 0)
    _check_pools(kv, jkv, tables, lengths, variant.tight)


def test_forward_paged_mixed_matches_jax(both, variant):
    """A fused mixed step: two decode rows continue their sequences, two
    chunks (one padded) start on fresh pages."""
    from ktransformers_tpu.cache.paged import PagedKVCache as JKV
    from ktransformers_tpu.models.paged import (
        forward_paged as jforward,
        forward_paged_mixed as jmixed,
    )

    rng = np.random.default_rng(22)
    page, pmax, b_dec, ctx, c_pre, s = 8, 4, 2, 11, 2, 8
    n_pages = 1 + (b_dec + c_pre) * pmax
    tables = np.arange(1, n_pages, dtype=np.int32).reshape(-1, pmax)
    dec_tables, pre_tables = tables[:b_dec], tables[b_dec:]
    prompts = rng.integers(0, VOCAB, (b_dec, ctx))
    dec_tokens = rng.integers(0, VOCAB, (b_dec,))
    pre_tokens = rng.integers(0, VOCAB, (c_pre, s))
    dec_lengths = np.full(b_dec, ctx, np.int32)
    pre_lengths = np.zeros(c_pre, np.int32)
    pre_valid = np.asarray([6, 8], np.int32)

    jkv = JKV.create(variant.jspec, num_pages=n_pages, page_size=page,
                     dtype=jnp.float32)
    _, jkv = jforward(variant.jparams, variant.jspec, _ji(prompts), jkv,
                      _ji(dec_tables), _ji(np.zeros(b_dec)),
                      compute_dtype=jnp.float32)
    rd, rp, jkv = jmixed(
        variant.jparams, variant.jspec, _ji(dec_tokens), _ji(pre_tokens), jkv,
        _ji(dec_tables), _ji(dec_lengths), _ji(pre_tables), _ji(pre_lengths),
        _ji(pre_valid), compute_dtype=jnp.float32)

    kv = PagedKVCache.create(SPEC, n_pages, page, dtype=torch.float32,
                             device="cpu")
    forward_paged(variant.params, SPEC, _ti(prompts, torch.int64), kv,
                  _ti(dec_tables), _ti(np.zeros(b_dec)),
                  compute_dtype=torch.float32)
    od, op, kv = forward_paged_mixed(
        variant.params, SPEC, _ti(dec_tokens, torch.int64),
        _ti(pre_tokens, torch.int64), kv, _ti(dec_tables), _ti(dec_lengths),
        _ti(pre_tables), _ti(pre_lengths), _ti(pre_valid),
        compute_dtype=torch.float32)
    _close(od.numpy(), rd, variant.tight)
    _close(op.numpy(), rp, variant.tight)
    _check_pools(kv, jkv, tables, [ctx + 1, ctx + 1, 6, 8], variant.tight)


@pytest.mark.parametrize("c_pre", [1, 2])
def test_mixed_equals_separate(both, c_pre):
    """Inside the port (int8 weights): the fused mixed step equals the
    decode step and the chunks run apart, logits and pools."""
    params = both.int8.params
    rng = np.random.default_rng(c_pre)
    page, pmax, b_dec, ctx, s = 8, 4, 2, 11, 8
    n_pages = 1 + (b_dec + c_pre) * pmax
    tables = torch.arange(1, n_pages, dtype=torch.int32).reshape(-1, pmax)
    dec_tables, pre_tables = tables[:b_dec], tables[b_dec:]
    f32 = dict(compute_dtype=torch.float32)
    prompts = torch.as_tensor(rng.integers(0, VOCAB, (b_dec, ctx)))
    dec_tokens = torch.as_tensor(rng.integers(0, VOCAB, (b_dec,)))
    pre_tokens = torch.as_tensor(rng.integers(0, VOCAB, (c_pre, s)))
    dec_lengths = _ti(np.full(b_dec, ctx))
    pre_lengths = _ti(np.zeros(c_pre))
    pre_valid = _ti([6, 8][:c_pre])

    def primed():
        kv = PagedKVCache.create(SPEC, n_pages, page, dtype=torch.float32,
                                 device="cpu")
        forward_paged(params, SPEC, prompts, kv, dec_tables,
                      _ti(np.zeros(b_dec)), **f32)
        return kv

    kv_ref = primed()
    dref, _ = forward_paged(params, SPEC, dec_tokens[:, None], kv_ref,
                            dec_tables, dec_lengths, **f32)
    prefs = [forward_paged(params, SPEC, pre_tokens[i][None], kv_ref,
                           pre_tables[i][None], pre_lengths[i][None],
                           valid=pre_valid[i][None], **f32)[0][:, -1]
             for i in range(c_pre)]
    kv = primed()
    dout, pout, _ = forward_paged_mixed(
        params, SPEC, dec_tokens, pre_tokens if c_pre > 1 else pre_tokens[0],
        kv, dec_tables, dec_lengths, pre_tables, pre_lengths, pre_valid,
        **f32)
    _close(dout.numpy(), dref[:, -1].numpy(), True, 2e-4)
    _close(pout.numpy(), torch.cat(prefs).numpy(), True, 2e-4)
    for a, b in zip(kv.bufs_a + kv.bufs_b, kv_ref.bufs_a + kv_ref.bufs_b):
        np.testing.assert_allclose(a[1:].numpy(), b[1:].numpy(),
                                   rtol=POOL_TOL, atol=POOL_TOL)


def test_paged_forward_matches_contiguous(both):
    """The paged forward (two chunks, then a decode step) against the
    contiguous one on the same int8 weights."""
    params = both.int8.params
    tokens = torch.as_tensor(np.random.default_rng(0).integers(
        0, VOCAB, (1, 20)))
    cache = tmodel.KVCache.create(SPEC, 1, 64, torch.float32, "cpu")
    ref, _ = tmodel.forward(params, SPEC, tokens, cache,
                            compute_dtype=torch.float32)
    kv = PagedKVCache.create(SPEC, 16, 8, dtype=torch.float32, device="cpu")
    pt = torch.arange(8, dtype=torch.int32)[None]
    forward_paged(params, SPEC, tokens[:, :12], kv, pt, _ti([0]),
                  compute_dtype=torch.float32)
    out, _ = forward_paged(params, SPEC, tokens[:, 12:], kv, pt, _ti([12]),
                           compute_dtype=torch.float32)
    _close(out[:, -1].numpy(), ref[:, -1].numpy(), True)
    tok = ref[:, -1].argmax(-1)[:, None]
    ref2, _ = tmodel.forward(params, SPEC, tok, cache,
                             compute_dtype=torch.float32)
    out2, _ = forward_paged(params, SPEC, tok, kv, pt, _ti([20]),
                            compute_dtype=torch.float32)
    _close(out2[:, -1].numpy(), ref2[:, -1].numpy(), True)
    # the cached k / v rows agree (k roped in both caches)
    got = gather_pages(kv.bufs_a[1], pt)[0, :21].numpy()
    np.testing.assert_allclose(got, cache.bufs_a[1][0, :21].numpy(),
                               rtol=POOL_TOL, atol=POOL_TOL)


SCHED = dict(max_batch_size=4, prefill_chunk=8, page_size=8,
             max_pages_per_query=8)


def _run(eng, queries, limit=2000):
    for _ in range(limit):
        if all(q.state == "done" for q in queries):
            return
        eng.step()
    raise AssertionError([q.state for q in queries])


def test_serve_engine_matches_generator_and_jax_engine(both):
    """The W4A8 variant served: two prompts at once, a third after two
    steps (mixed steps run), then a fourth that repeats the first 16 tokens
    (two full pages) of the first after it finished, so the prefix cache
    hits. The port's engine equals its single-user Generator and the JAX
    engine token for token."""
    from ktransformers_tpu.serving.engine import ServeEngine as JEngine
    from ktransformers_tpu.serving.scheduler import SchedulerConfig as JCfg

    v = both.w4a8
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, VOCAB, n).tolist() for n in (19, 11, 6)]
    prompts.append(prompts[0][:16] + rng.integers(0, VOCAB, 5).tolist())

    def serve(eng):
        qs = [eng.submit(p, max_new_tokens=6) for p in prompts[:2]]
        eng.step()
        eng.step()
        qs.append(eng.submit(prompts[2], max_new_tokens=6))
        _run(eng, qs)
        qs.append(eng.submit(prompts[3], max_new_tokens=6))
        _run(eng, qs)
        assert all(q.finish_reason == "length" for q in qs)
        assert qs[3].matched_len == 16
        return [list(q.output_ids) for q in qs]

    ref = serve(JEngine(v.jparams, v.jspec, JCfg(**SCHED), num_pages=48,
                        cache_dtype=jnp.float32, compute_dtype=jnp.float32))
    eng = ServeEngine(v.params, SPEC, SchedulerConfig(**SCHED), num_pages=48,
                      **F32)
    got = serve(eng)
    assert eng.mixed_steps_fused >= 1
    assert eng.alloc.free_count + eng.prefix.stats()["nodes"] == 47
    gen = Generator(v.params, SPEC, max_len=64, **F32)
    single = [gen.generate(p, GenerateConfig(max_new_tokens=6,
                                             prefill_chunk=8))[0]
              for p in prompts]
    assert got == single
    assert got == ref


def test_gqa_pools_spill_and_restore(both, tmp_path):
    """GQA pools: [P, page, Hkv, D] per layer and pool; evicted prefix
    pages spill to host and disk as their bits (bfloat16 pages too) and
    come back with identical output."""
    kv = PagedKVCache.create(SPEC, 4, 8, dtype=torch.bfloat16, device="cpu")
    assert kv.bufs_a[0].shape == kv.bufs_b[1].shape == (4, 8, 2, 128)
    assert kv.bytes_per_page() == 2 * 2 * 8 * 2 * 128 * 2
    params = both.int8.params
    spill = HostDiskTier(max_host_bytes=1 << 14,
                         disk_dir=str(tmp_path / "kv"))
    eng = ServeEngine(params, SPEC,
                      SchedulerConfig(**{**SCHED, "max_batch_size": 2}),
                      num_pages=12, spill_tier=spill,
                      **{**F32, "cache_dtype": torch.bfloat16})
    p1 = list(range(24))  # 3 pages
    out1 = eng.generate_sync(p1, max_new_tokens=3)
    for start in (100, 200):
        eng.generate_sync(list(range(start, start + 24)), max_new_tokens=3)
        eng.prefix.trim(10)
    assert spill.stats["spilled"] >= 1
    assert eng.generate_sync(p1, max_new_tokens=3) == out1
    assert spill.stats["host_hits"] + spill.stats["disk_hits"] >= 1


def test_paged_cache_from_jax_carries_gqa_pools(both):
    """A JAX prefill's GQA pools carried across continue on the port: the
    next decode step equals the JAX one (int8 weights)."""
    from ktransformers_tpu.cache.paged import PagedKVCache as JKV
    from ktransformers_tpu.models.paged import forward_paged as jforward

    v = both.int8
    tokens = np.random.default_rng(8).integers(0, VOCAB, (1, 13))
    tables = np.asarray([[3, 1, 2, 4]], np.int32)
    jkv = JKV.create(v.jspec, num_pages=6, page_size=8, dtype=jnp.float32)
    _, jkv = jforward(v.jparams, v.jspec, _ji(tokens), jkv, _ji(tables),
                      _ji([0]), compute_dtype=jnp.float32)
    kv = paged_cache_from_jax(jax.device_get(jkv), SPEC, "cpu")
    assert kv.page_size == 8 and kv.bufs_a[0].shape == (6, 8, 2, 128)
    tok = np.asarray([[7]])
    ref, _ = jforward(v.jparams, v.jspec, _ji(tok), jkv, _ji(tables),
                      _ji([13]), compute_dtype=jnp.float32)
    out, _ = forward_paged(v.params, SPEC, _ti(tok, torch.int64), kv,
                           _ti(tables), _ti([13]), compute_dtype=torch.float32)
    _close(out.numpy(), ref, True)
