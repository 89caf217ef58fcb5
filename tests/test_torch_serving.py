"""The port's paged forward (models/paged.py) against the JAX package and
against the port's contiguous forward. The ServeEngine (against the
single-user Generator and the JAX engine) and its scheduling behaviour are
tested in tests/test_torch_serving_engine.py, on the fixtures of this
module.

One module-wide fixture builds the 3-layer SMALL DeepSeek-V2 spec of
test_torch_model.py with W4A8 weights in the JAX package, installs its
Pallas kernels as interpret-mode hooks (the five of the generation path
plus the four paged-attention hooks, restored afterwards) and carries the
prepared params across with convert.params_from_jax. Everything computes
in float32 on the CPU, where the port's wrappers take their plain versions.

Tolerances:
- port against JAX: logits within 5e-2 of the largest, greedy tokens
  equal. Both run the same W4A8 arithmetic; float32 sums in another order
  now and then flip an int8 activation code, which random synthetic
  weights carry through the layers (test_torch_model.py explains and
  bounds this). The KV pools are held where no such flip can reach them
  yet: layer 0's rows within 1e-5, deeper layers within the logits' 5e-2.
  On unquantized float32 weights built in the JAX package (all layers
  dense) there is no such flip: logits within 1e-4 and every layer's live
  pool rows within 1e-5;
- inside the port, on an all-dense variant of the spec with unquantized
  float32 weights (``dense``), nothing differs but the order of float32
  sums: the paged forward equals the contiguous one to 1e-4 and the fused
  mixed step the separate steps to 2e-4. With the W4A8 MoE weights
  (``synth``) the same comparisons hold to the 5e-2 above with equal greedy
  tokens, for the same reason; engines that chunk alike agree token for
  token.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ktransformers_tpu_torch.cache.paged import PagedKVCache
from ktransformers_tpu_torch.convert import params_from_jax
from ktransformers_tpu_torch.engine.generate import Generator
from ktransformers_tpu_torch.models import model as tmodel
from ktransformers_tpu_torch.models.init import init_params_synthetic
from ktransformers_tpu_torch.models.paged import (
    forward_paged,
    forward_paged_mixed,
)
from ktransformers_tpu_torch.models.spec import spec_from_hf_config
from ktransformers_tpu_torch.ops.cuda.paged_attention import gather_pages
from ktransformers_tpu_torch.serving import SchedulerConfig, ServeEngine
from ktransformers_tpu_torch.utils.device_prep import prepare_params

from tests.test_torch_model import (
    LOGIT_TOL,
    SMALL,
    _jax_params,
    jax_interpret_hooks,
    one_torch_thread,  # noqa: F401 (a fixture)
)

SPEC = spec_from_hf_config(SMALL)
VOCAB = SMALL["vocab_size"]
F32 = dict(cache_dtype=torch.float32, compute_dtype=torch.float32,
           device="cpu")


@pytest.fixture(scope="module")
def both():
    """JAX spec + prepared params with every Pallas hook in interpret mode,
    and the same params carried over to the port."""
    from ktransformers_tpu.models import paged as jpaged
    from ktransformers_tpu.ops.pallas import paged_attention as jpa

    old = (jpaged._PAGED_MLA_DECODE, jpaged._PAGED_GQA_DECODE,
           jpaged._PAGED_MLA_PREFILL, jpaged._PAGED_GQA_PREFILL)
    calls = {}

    def counted(name, fn):
        def wrapped(*a, **kw):
            calls[name] = calls.get(name, 0) + 1
            return fn(*a, **kw, interpret=True)
        return wrapped

    with jax_interpret_hooks():
        jpaged.set_pallas_paged_decode(
            counted("mla_paged_decode", jpa.mla_paged_decode),
            counted("gqa_paged_decode", jpa.gqa_paged_decode))
        jpaged.set_pallas_paged_prefill(
            counted("mla_paged_prefill", jpa.mla_paged_prefill),
            counted("gqa_paged_prefill", jpa.gqa_paged_prefill))
        try:
            jspec, jparams = _jax_params()
            yield types.SimpleNamespace(
                jspec=jspec, jparams=jparams, calls=calls,
                params=params_from_jax(jax.device_get(jparams), SPEC, "cpu"))
        finally:
            jpaged.set_pallas_paged_decode(old[0], old[1])
            jpaged.set_pallas_paged_prefill(old[2], old[3])


@pytest.fixture(scope="module")
def synth():
    """The port's own synthetic W4A8 params (float32 activations)."""
    return prepare_params(init_params_synthetic(
        SPEC, seed=1, dtype=torch.float32, device="cpu"), SPEC)


DENSE_SPEC = spec_from_hf_config(dict(SMALL, first_k_dense_replace=3))


@pytest.fixture(scope="module")
def dense():
    """All layers dense, unquantized float32 weights: no int8 activation
    code to flip, so float32 tolerances hold."""
    return prepare_params(init_params_synthetic(
        DENSE_SPEC, seed=2, quant="bf16", dtype=torch.float32, device="cpu"),
        DENSE_SPEC)


@pytest.fixture(params=["dense", "w4a8"])
def weights(request, dense, synth):
    """(params, spec, tolerance scale): float32-tight on ``dense``, the
    W4A8 rounding-order tolerance on ``synth``."""
    if request.param == "dense":
        return dense, DENSE_SPEC, None
    return synth, SPEC, LOGIT_TOL


def _close(out, ref, tight: float, loose):
    """Within ``tight`` (rtol = atol) where loose is None; else within
    ``loose`` of the largest logit with equal greedy tokens."""
    out, ref = out.numpy(), ref.numpy()
    if loose is None:
        np.testing.assert_allclose(out, ref, rtol=tight, atol=tight)
    else:
        assert _rel(out, ref) <= loose
        assert (out.argmax(-1) == ref.argmax(-1)).all()


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.abs(a - b).max() / np.abs(b).max())


def _ti(a, dtype=torch.int32):
    return torch.as_tensor(np.asarray(a), dtype=dtype)


def _ji(a):
    return jnp.asarray(np.asarray(a), jnp.int32)


def _check_pools(kv, jkv, tables, live, deep=LOGIT_TOL):
    """Live rows of both pools: layer 0 within 1e-5, deeper layers within
    ``deep``."""
    for li in range(len(kv.bufs_a)):
        for mine, ref in ((kv.bufs_a[li], jkv.bufs_a[li]),
                          (kv.bufs_b[li], jkv.bufs_b[li])):
            got = gather_pages(mine, _ti(tables)).numpy()
            want = gather_pages(torch.from_numpy(np.array(ref)),
                                _ti(tables)).numpy()
            for b, n in enumerate(live):
                err = _rel(got[b, :n], want[b, :n])
                assert err <= (1e-5 if li == 0 else deep), (li, b, err)


# ------------------------------------------------------- against the JAX side


def test_forward_paged_matches_jax(both):
    """Two sequences, two chunks each (the second sequence's first chunk is
    padded: valid 9 of 12), then three decode steps on the JAX side's greedy
    tokens."""
    from ktransformers_tpu.cache.paged import PagedKVCache as JKV
    from ktransformers_tpu.models.paged import forward_paged as jforward

    rng = np.random.default_rng(21)
    page, pmax = 8, 4
    tokens = rng.integers(0, VOCAB, (2, 20))
    tables = (rng.permutation(11)[:8] + 1).reshape(2, pmax).astype(np.int32)
    jkv = JKV.create(both.jspec, num_pages=12, page_size=page,
                     dtype=jnp.float32)
    kv = PagedKVCache.create(SPEC, 12, page, dtype=torch.float32,
                             device="cpu")
    f32j, f32t = dict(compute_dtype=jnp.float32), dict(
        compute_dtype=torch.float32)
    lengths = np.zeros(2, np.int32)
    steps = [(tokens[:, :12], np.asarray([12, 9], np.int32)),
             (tokens[:, 12:], np.asarray([8, 8], np.int32))]
    greedy = None
    for i in range(5):
        if i < 2:
            toks, valid = steps[i]
        else:
            toks, valid = greedy[:, None], None
        ref, jkv = jforward(
            both.jparams, both.jspec, _ji(toks), jkv, _ji(tables),
            _ji(lengths), valid=None if valid is None else _ji(valid), **f32j)
        out, kv = forward_paged(
            both.params, SPEC, _ti(toks, torch.int64), kv, _ti(tables),
            _ti(lengths), valid=None if valid is None else _ti(valid), **f32t)
        ref = np.asarray(ref)
        assert out.shape == ref.shape == (2, 1, VOCAB)
        assert _rel(out.numpy(), ref) <= LOGIT_TOL, i
        greedy = ref[:, -1].argmax(-1)
        assert (out[:, -1].argmax(-1).numpy() == greedy).all(), i
        lengths = lengths + (1 if valid is None else valid)
    assert both.calls["mla_paged_decode"] and both.calls["mla_paged_prefill"]
    _check_pools(kv, jkv, tables, lengths)


def test_forward_paged_mixed_matches_jax(both):
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

    jkv = JKV.create(both.jspec, num_pages=n_pages, page_size=page,
                     dtype=jnp.float32)
    _, jkv = jforward(both.jparams, both.jspec, _ji(prompts), jkv,
                      _ji(dec_tables), _ji(np.zeros(b_dec)),
                      compute_dtype=jnp.float32)
    rd, rp, jkv = jmixed(
        both.jparams, both.jspec, _ji(dec_tokens), _ji(pre_tokens), jkv,
        _ji(dec_tables), _ji(dec_lengths), _ji(pre_tables), _ji(pre_lengths),
        _ji(pre_valid), compute_dtype=jnp.float32)

    kv = PagedKVCache.create(SPEC, n_pages, page, dtype=torch.float32,
                             device="cpu")
    forward_paged(both.params, SPEC, _ti(prompts, torch.int64), kv,
                  _ti(dec_tables), _ti(np.zeros(b_dec)),
                  compute_dtype=torch.float32)
    od, op, kv = forward_paged_mixed(
        both.params, SPEC, _ti(dec_tokens, torch.int64),
        _ti(pre_tokens, torch.int64), kv, _ti(dec_tables), _ti(dec_lengths),
        _ti(pre_tables), _ti(pre_lengths), _ti(pre_valid),
        compute_dtype=torch.float32)
    for out, ref in ((od, rd), (op, rp)):
        ref = np.asarray(ref)
        assert _rel(out.numpy(), ref) <= LOGIT_TOL
        assert (out.argmax(-1).numpy() == ref.argmax(-1)).all()
    _check_pools(kv, jkv, tables, [ctx + 1, ctx + 1, 6, 8])


def test_paged_steps_match_jax_tightly_on_float32_weights(both):
    """Unquantized float32 weights (all layers dense) built in the JAX
    package and carried over: nothing can flip an int8 code, so the logits
    of two chunks (one padded), two decode steps and a fused mixed step
    agree within 1e-4 and the live rows of every layer's pools within
    1e-5. ``both`` keeps the paged Pallas kernels installed (interpret)."""
    from ktransformers_tpu.cache.paged import PagedKVCache as JKV
    from ktransformers_tpu.models.init import init_params_synthetic as jinit
    from ktransformers_tpu.models.paged import (
        forward_paged as jforward,
        forward_paged_mixed as jmixed,
    )
    from ktransformers_tpu.models.spec import spec_from_hf_config as jspec_of
    from ktransformers_tpu.utils.device_prep import prepare_params as jprep

    jspec = jspec_of(dict(SMALL, first_k_dense_replace=3))
    jparams = jprep(jinit(jspec, seed=4, quant="bf16", dtype=jnp.float32),
                    True, jspec)
    params = params_from_jax(jax.device_get(jparams), DENSE_SPEC, "cpu")
    before = dict(both.calls)
    rng = np.random.default_rng(23)
    page, pmax, n_pages = 8, 4, 17
    tables = (rng.permutation(n_pages - 1) + 1).reshape(4, pmax).astype(
        np.int32)
    tokens = rng.integers(0, VOCAB, (2, 20))
    jkv = JKV.create(jspec, num_pages=n_pages, page_size=page,
                     dtype=jnp.float32)
    kv = PagedKVCache.create(DENSE_SPEC, n_pages, page, dtype=torch.float32,
                             device="cpu")
    f32j, f32t = dict(compute_dtype=jnp.float32), dict(
        compute_dtype=torch.float32)

    def close(out, ref):
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-4,
                                   atol=1e-4)

    lengths = np.zeros(2, np.int32)
    steps = [(tokens[:, :12], np.asarray([12, 9], np.int32)),
             (tokens[:, 12:], np.asarray([8, 8], np.int32)),
             (rng.integers(0, VOCAB, (2, 1)), None),
             (rng.integers(0, VOCAB, (2, 1)), None)]
    for toks, valid in steps:
        ref, jkv = jforward(
            jparams, jspec, _ji(toks), jkv, _ji(tables[:2]), _ji(lengths),
            valid=None if valid is None else _ji(valid), **f32j)
        out, kv = forward_paged(
            params, DENSE_SPEC, _ti(toks, torch.int64), kv, _ti(tables[:2]),
            _ti(lengths), valid=None if valid is None else _ti(valid), **f32t)
        close(out, ref)
        lengths = lengths + (1 if valid is None else valid)
    # a fused mixed step: both sequences decode on, two chunks (one padded)
    # start on the other pages
    dec_tokens = rng.integers(0, VOCAB, (2,))
    pre_tokens = rng.integers(0, VOCAB, (2, 8))
    pre_valid = np.asarray([6, 8], np.int32)
    rd, rp, jkv = jmixed(
        jparams, jspec, _ji(dec_tokens), _ji(pre_tokens), jkv,
        _ji(tables[:2]), _ji(lengths), _ji(tables[2:]), _ji(np.zeros(2)),
        _ji(pre_valid), **f32j)
    od, op, kv = forward_paged_mixed(
        params, DENSE_SPEC, _ti(dec_tokens, torch.int64),
        _ti(pre_tokens, torch.int64), kv, _ti(tables[:2]), _ti(lengths),
        _ti(tables[2:]), _ti(np.zeros(2)), _ti(pre_valid), **f32t)
    close(od, rd)
    close(op, rp)
    _check_pools(kv, jkv, tables, list(lengths + 1) + [6, 8], deep=1e-5)
    for name in ("mla_paged_decode", "mla_paged_prefill"):
        assert both.calls[name] > before.get(name, 0)


# seeded prompts of 7, 17 and 5 tokens whose greedy continuations have no
# near-tie on this synthetic model (rounding-order noise decides those)
_PROMPT_RNG = np.random.default_rng(5)
PROMPTS = [_PROMPT_RNG.integers(0, 512, n).tolist() for n in (7, 17, 5)]
SCHED = dict(max_batch_size=4, prefill_chunk=8, page_size=8,
             max_pages_per_query=8)


def _run(eng, queries, limit=3000):
    for _ in range(limit):
        if all(q.state == "done" for q in queries):
            return
        eng.step()
    raise AssertionError([q.state for q in queries])


# ------------------------------------------------------------ inside the port


def test_paged_forward_matches_contiguous(weights):
    params, spec, loose = weights
    rng = np.random.default_rng(0)
    tokens = torch.as_tensor(rng.integers(0, VOCAB, (1, 20)))
    cache = tmodel.KVCache.create(spec, 1, 64, torch.float32, "cpu")
    ref, _ = tmodel.forward(params, spec, tokens, cache,
                            compute_dtype=torch.float32)
    kv = PagedKVCache.create(spec, 16, 8, dtype=torch.float32, device="cpu")
    pt = torch.arange(8, dtype=torch.int32)[None]
    forward_paged(params, spec, tokens[:, :12], kv, pt, _ti([0]),
                  compute_dtype=torch.float32)
    out, _ = forward_paged(params, spec, tokens[:, 12:], kv, pt, _ti([12]),
                           compute_dtype=torch.float32)
    _close(out[:, -1], ref[:, -1], 1e-4, loose)
    # a decode step on both caches
    tok = ref[:, -1].argmax(-1)[:, None]
    ref2, _ = tmodel.forward(params, spec, tok, cache,
                             compute_dtype=torch.float32)
    out2, _ = forward_paged(params, spec, tok, kv, pt, _ti([20]),
                            compute_dtype=torch.float32)
    _close(out2[:, -1], ref2[:, -1], 1e-4, loose)


@pytest.mark.parametrize("c_pre", [1, 2])
def test_mixed_equals_separate(weights, c_pre):
    params, spec, loose = weights
    rng = np.random.default_rng(c_pre)
    page, pmax, b_dec, ctx, s = 8, 4, 2, 11, 8
    n_pages = 1 + (b_dec + c_pre) * pmax
    tables = torch.arange(1, n_pages, dtype=torch.int32).reshape(-1, pmax)
    dec_tables, pre_tables = tables[:b_dec], tables[b_dec:]
    f32 = dict(compute_dtype=torch.float32)

    def primed():
        kv = PagedKVCache.create(spec, n_pages, page, dtype=torch.float32,
                                 device="cpu")
        forward_paged(params, spec, prompts, kv, dec_tables,
                      _ti(np.zeros(b_dec)), **f32)
        return kv

    prompts = torch.as_tensor(rng.integers(0, VOCAB, (b_dec, ctx)))
    dec_tokens = torch.as_tensor(rng.integers(0, VOCAB, (b_dec,)))
    pre_tokens = torch.as_tensor(rng.integers(0, VOCAB, (c_pre, s)))
    dec_lengths = _ti(np.full(b_dec, ctx))
    pre_lengths = _ti(np.zeros(c_pre))
    pre_valid = _ti([6, 8][:c_pre])

    kv_ref = primed()
    dref, _ = forward_paged(params, spec, dec_tokens[:, None], kv_ref,
                            dec_tables, dec_lengths, **f32)
    prefs = [forward_paged(params, spec, pre_tokens[i][None], kv_ref,
                           pre_tables[i][None], pre_lengths[i][None],
                           valid=pre_valid[i][None], **f32)[0][:, -1]
             for i in range(c_pre)]
    kv = primed()
    dout, pout, _ = forward_paged_mixed(
        params, spec, dec_tokens, pre_tokens if c_pre > 1 else pre_tokens[0],
        kv, dec_tables, dec_lengths, pre_tables, pre_lengths, pre_valid,
        **f32)
    _close(dout, dref[:, -1], 2e-4, loose)
    _close(pout, torch.cat(prefs), 2e-4, loose)
    if loose is None:
        for a, b in zip(kv.bufs_a + kv.bufs_b, kv_ref.bufs_a + kv_ref.bufs_b):
            np.testing.assert_allclose(a[1:].numpy(), b[1:].numpy(),
                                       rtol=1e-5, atol=1e-5)


def _engine(params, num_pages=64, prefix=True, spill=None, spec=SPEC,
            **sched):
    return ServeEngine(params, spec, SchedulerConfig(**{**SCHED, **sched}),
                       num_pages=num_pages, enable_prefix_cache=prefix,
                       spill_tier=spill, **F32)


def test_entry_points_default_to_the_card_and_refuse_unported(synth):
    import inspect

    for fn in (ServeEngine.__init__, PagedKVCache.create, Generator.__init__):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    # re-placement reads routing statistics: none were collected
    with pytest.raises(ValueError, match="collect_routing"):
        ServeEngine(synth, SPEC, **F32).apply_expert_rebalance(2)
    # sparse decode is ported; a retrieval MLA does not take is refused
    with pytest.raises(ValueError, match="kvhead"):
        ServeEngine(synth, SPEC, sparse_budget=4, sparse_retrieval="kvhead",
                    **F32)
    # parameters already on the engine's device are shared, not copied
    qkv = _engine(synth).params["layers"][0]["attn"]["qkv_a"]
    assert qkv.data is synth["layers"][0]["attn"]["qkv_a"].data
