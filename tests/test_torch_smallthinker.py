"""The port's SmallThinker against the JAX package.

SmallThinker (PowerInfer/SmallThinker-21BA3B-Instruct): GQA attention
whose layers each take rope or not (rope_layout: NoPE layers see positions
only through the mask) and a sliding window or not
(sliding_window_layout), ReLU-GLU experts behind an early router (it reads
the layer input, before the attention norm), sigmoid top-k without
renormalization, dense layers where moe_layer_layout says so. Tiny sizes,
one torch thread, a window of 8 that the 12-token prompts outrun:
- the specs of the registry's preset, of tests/test_smallthinker.py's
  config and of the tiny one equal the JAX package's field by field;
- float32 weights carried across (convert.params_from_jax): the port's
  forward within 2e-4 of the JAX forward over a prompt and decode steps,
  greedy tokens equal; the paged forward (windows through the plain
  versions of rows 13 and 15) within 2e-4 of the JAX package's paged
  forward (its Pallas kernels in interpret mode) and of the contiguous
  forward; a 3-request ServeEngine (a fused mixed step) token for token
  with the single-user Generator;
- int4_g weights repacked for W4A8 (ReLU on the fused FFN's plain
  version): under equal routing every step within LOGIT_TOL of the JAX
  forward, greedy tokens equal off near-ties, and every row the port's
  own router sent elsewhere a tie of the reference's sigmoid top-k.
"""

import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ktransformers_tpu_torch.cache.paged import PagedKVCache
from ktransformers_tpu_torch.convert import params_from_jax
from ktransformers_tpu_torch.models import model as tmodel
from ktransformers_tpu_torch.models import registry as treg
from ktransformers_tpu_torch.models.paged import forward_paged
from ktransformers_tpu_torch.models.spec import spec_from_hf_config

from tests.test_smallthinker import CFG as JAX_TEST_CFG
from tests.test_torch_deepseek_v3 import hooks  # noqa: F401 (a fixture)
from tests.test_torch_dense_family import (
    hold_engine_against_generator,
    hold_paged_against_forward,
)
from tests.test_torch_model import (
    LOGIT_TOL,
    one_torch_thread,  # noqa: F401 (a fixture)
)

F32_TOL = 2e-4  # of the largest JAX logit, float32 weights
# 4 layers at the widths the W4A8 kernels take (groups of 128): 8 query
# heads over 2 KV heads of 64; layer 3 NoPE and unwindowed (the preset's
# pattern), the others windowed at 8; layer 1 dense; 16 experts of inter
# 128 top-4, sigmoid scores without renormalization
TINY = dict(
    treg.REGISTRY["smallthinker-21b"].config, vocab_size=512,
    hidden_size=256, num_hidden_layers=4, num_attention_heads=8,
    num_key_value_heads=2, head_dim=64, sliding_window_size=8,
    rope_layout=[1, 1, 1, 0], sliding_window_layout=[1, 1, 1, 0],
    moe_layer_layout=[1, 0, 1, 1], moe_num_primary_experts=16,
    moe_num_active_primary_experts=4, moe_ffn_hidden_size=128,
    dense_ffn_hidden_size=256, max_position_embeddings=256)
PROMPT_LEN, MAX_LEN = 12, 48
FEED = (11, 222, 333)  # decode tokens of the runs


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-6))


def _same_fields(t, j, path=""):
    """Every field of the port's spec dataclass t (recursively) equals the
    JAX spec's attribute of that name."""
    for f in dataclasses.fields(t):
        tv, jv = getattr(t, f.name), getattr(j, f.name)
        if dataclasses.is_dataclass(tv):
            _same_fields(tv, jv, path + f.name + ".")
        else:
            assert tv == jv, path + f.name


@pytest.mark.parametrize("which", ["preset", "jax_test", "tiny"])
def test_spec_matches_jax(which):
    from ktransformers_tpu.models.spec import spec_from_hf_config as jspec

    cfg = {"preset": treg.REGISTRY["smallthinker-21b"].config,
           "jax_test": JAX_TEST_CFG, "tiny": TINY}[which]
    t = spec_from_hf_config(dict(cfg))
    _same_fields(t, jspec(dict(cfg)))
    assert t.moe.early_router and t.activation.kind == "relu"
    assert t.moe.gate.scoring == "sigmoid" and not t.moe.gate.norm_topk_prob
    n = t.num_layers
    assert [t.layer_uses_rope(i) for i in range(n)] == \
        [bool(x) for x in cfg["rope_layout"]]
    assert [t.layer_window(i) for i in range(n)] == [
        cfg["sliding_window_size"] if w else 0
        for w in cfg["sliding_window_layout"]]
    with pytest.raises(NotImplementedError, match="secondary"):
        spec_from_hf_config(dict(cfg, moe_enable_secondary_experts=True))


def _carried(quant: str, seed: int):
    """(JAX spec, prepared JAX params, port spec, port params): quant
    everywhere (float32 data for "bf16"), the JAX package's prepare_params
    (fused QKV, the W4A8 repack) carried across."""
    from ktransformers_tpu.models.init import init_params_synthetic
    from ktransformers_tpu.models.spec import spec_from_hf_config as jspec_of
    from ktransformers_tpu.utils.device_prep import prepare_params

    jspec = jspec_of(dict(TINY))
    kw = dict(dtype=jnp.float32) if quant == "bf16" else {}
    jparams = prepare_params(init_params_synthetic(
        jspec, seed=seed, quant=quant, moe_quant=quant, **kw), True, jspec)
    spec = spec_from_hf_config(dict(TINY))
    return jspec, jparams, spec, params_from_jax(jax.device_get(jparams),
                                                 spec, "cpu")


def _tokens(vocab: int, n=PROMPT_LEN, seed=7):
    return np.random.default_rng(seed).integers(0, vocab, (1, n)).astype(
        np.int32)


def jax_run(jspec, jparams, tokens, feed=FEED, max_len=MAX_LEN):
    """Prefill + decode steps on ``feed`` in JAX (jitted): last logits
    rows, greedy tokens."""
    from ktransformers_tpu.models.model import KVCache
    from ktransformers_tpu.models.model import forward as jforward
    from ktransformers_tpu.ops.rope import precompute_rope_tables

    fwd = jax.jit(jforward, static_argnames=("spec", "compute_dtype"))
    rope = precompute_rope_tables(jspec.rope)
    cache = KVCache.create(jspec, 1, max_len, dtype=jnp.float32)
    outs = []
    for toks in [tokens] + [[[t]] for t in feed]:
        logits, cache = fwd(jparams, jspec, jnp.asarray(toks, jnp.int32),
                            cache, rope_tables=rope,
                            compute_dtype=jnp.float32)
        outs.append(np.asarray(logits[:, -1]))
    return outs, [int(np.argmax(o[0])) for o in outs]


def port_run(spec, params, tokens, feed=FEED, max_len=MAX_LEN):
    """The port's forward over the same steps."""
    cache = tmodel.KVCache.create(spec, 1, max_len, torch.float32, "cpu")
    outs = []
    with torch.no_grad():
        for toks in [tokens] + [[[t]] for t in feed]:
            logits, cache = tmodel.forward(params, spec, torch.as_tensor(
                np.asarray(toks, np.int64)), cache,
                compute_dtype=torch.float32)
            outs.append(logits[:, -1].numpy())
    return outs, [int(o[0].argmax()) for o in outs]


@contextlib.contextmanager
def forced_router(ref_calls, calls):
    """The port's router, each call's (logits, own expert ids) appended to
    ``calls``; the reference's expert set put in wherever its own differs
    (test only), the weights the port's own gate gives those experts."""
    troute, seen = tmodel.route, [0]

    def record(logits, gate, bias=None):
        idx, w = troute(logits, gate, bias)
        calls.append((logits.float().numpy().copy(), idx.numpy().copy()))
        want = torch.as_tensor(ref_calls[seen[0]][1].copy())
        seen[0] += 1
        differ = torch.tensor([set(a) != set(b) for a, b in zip(
            idx.tolist(), want.tolist())])
        lf = logits.float()
        scores = torch.softmax(lf, -1) if gate.scoring == "softmax" \
            else torch.sigmoid(lf)
        rw = torch.gather(scores, 1, want.long())
        if gate.norm_topk_prob:
            rw = rw / (rw.sum(dim=-1, keepdim=True) + 1e-20)
        rw = rw * gate.routed_scaling_factor
        return (torch.where(differ[:, None], want.to(idx.dtype), idx),
                torch.where(differ[:, None], rw, w))

    tmodel.route = record
    try:
        yield
    finally:
        tmodel.route = troute


def routed_w4a8_runs(jspec, jparams, spec, params, tokens):
    """The JAX run with every router call's (logits, expert ids) recorded,
    and the port's run forced to the reference's expert sets, its own
    calls recorded: (ref, ref_calls, out, calls)."""
    from ktransformers_tpu.models import model as jmodel

    ref_calls, jroute = [], jmodel.route

    def jrecord(logits, gate, bias=None):
        idx, w = jroute(logits, gate, bias)
        jax.debug.callback(
            lambda lg, ix: ref_calls.append((np.asarray(lg, np.float32),
                                             np.asarray(ix))),
            logits, idx, ordered=True)
        return idx, w

    jmodel.route = jrecord
    try:
        ref = jax_run(jspec, jparams, tokens)
        jax.effects_barrier()
    finally:
        jmodel.route = jroute
    calls = []
    with forced_router(ref_calls, calls):
        out = port_run(spec, params, tokens)
    return ref, ref_calls, out, calls


def hold_w4a8(runs, choice):
    """The W4A8 rules: every step within LOGIT_TOL of the reference, greedy
    tokens equal off its near-ties (top-2 gap below LOGIT_TOL of its
    largest logit); every row the port's own router sent elsewhere a tie
    of the reference's top-k: the gap at the k-th choice score at most
    twice the row's largest choice-score difference (``choice`` maps
    router logits to the scores its top-k ranks)."""
    (ref, ref_toks), ref_calls, (out, toks), calls = runs
    errs = [_rel(a, b) for a, b in zip(out, ref)]
    assert max(errs) <= LOGIT_TOL, errs
    for step, b in enumerate(ref):
        top2 = np.sort(b[0])[-2:]
        if (top2[1] - top2[0]) / np.abs(b[0]).max() >= LOGIT_TOL:
            assert toks[step] == ref_toks[step], step
    assert len(calls) == len(ref_calls) > 0
    for c, ((lg, own), (rlg, ridx)) in enumerate(zip(calls, ref_calls)):
        ch, rch = choice(lg), choice(rlg)
        k = own.shape[1]
        for r in range(own.shape[0]):
            if set(own[r]) == set(ridx[r]):
                continue
            srt = np.sort(rch[r])[::-1]
            gap = float(srt[k - 1] - srt[k])
            assert gap <= 2 * float(np.abs(ch[r] - rch[r]).max()), (c, r)


@pytest.fixture(scope="module")
def f32(hooks):
    return _carried("bf16", 5)


def test_forward_f32_matches_jax(f32):
    """A 12-token prompt past the window of 8 and 3 decode steps: every
    step within 2e-4 of the JAX forward, greedy tokens equal; the NoPE
    layer took no rope, the windowed ones their mask, the router the
    layer input."""
    jspec, jparams, spec, params = f32
    tokens = _tokens(spec.vocab_size)
    ref, ref_toks = jax_run(jspec, jparams, tokens)
    out, toks = port_run(spec, params, tokens)
    for step, (a, b) in enumerate(zip(out, ref)):
        assert _rel(a, b) <= F32_TOL, step
    assert toks == ref_toks
    # each knob matters at these sizes: without it the port leaves 2e-4
    for knob in (dict(rope_layout=None), dict(swa_layout=None),
                 dict(moe=dataclasses.replace(spec.moe, early_router=False))):
        other, _ = port_run(dataclasses.replace(spec, **knob), params,
                            tokens)
        assert max(_rel(a, b) for a, b in zip(other, ref)) > 100 * F32_TOL


def test_forward_paged_matches_jax_paged(f32):
    """Two sequences on shuffled pages, a padded 12-token chunk, a second
    chunk of 8 (past the window) and a decode step through the JAX
    package's paged forward (jitted, its GQA paged kernels in interpret
    mode with the window) and the port's (the plain versions): within
    2e-4, the same greedy tokens."""
    from ktransformers_tpu.cache.paged import PagedKVCache as JKV
    from ktransformers_tpu.models import paged as jpaged
    from ktransformers_tpu.ops.pallas import paged_attention as jpa

    jspec, jparams, spec, params = f32
    interp = lambda fn: lambda *a, **kw: fn(*a, **kw, interpret=True)  # noqa: E731
    old = (jpaged._PAGED_MLA_DECODE, jpaged._PAGED_GQA_DECODE,
           jpaged._PAGED_MLA_PREFILL, jpaged._PAGED_GQA_PREFILL)
    jpaged.set_pallas_paged_decode(old[0], interp(jpa.gqa_paged_decode))
    jpaged.set_pallas_paged_prefill(old[2], interp(jpa.gqa_paged_prefill))
    try:
        rng = np.random.default_rng(21)
        page, pmax = 8, 4
        tables = (rng.permutation(11)[:8] + 1).reshape(2, pmax).astype(
            np.int32)
        tokens = rng.integers(0, spec.vocab_size, (2, 20))
        jkv = JKV.create(jspec, num_pages=12, page_size=page,
                         dtype=jnp.float32)
        kv = PagedKVCache.create(spec, 12, page, dtype=torch.float32,
                                 device="cpu")
        fwd = jax.jit(jpaged.forward_paged,
                      static_argnames=("spec", "compute_dtype"))
        lengths = np.zeros(2, np.int32)
        greedy = None
        for i in range(3):
            if i < 2:
                toks = tokens[:, :12] if i == 0 else tokens[:, 12:]
                valid = np.asarray([12, 9] if i == 0 else [8, 8], np.int32)
            else:
                toks, valid = greedy[:, None], None
            ji = lambda a: jnp.asarray(np.asarray(a), jnp.int32)  # noqa: E731
            ti = lambda a, dt=torch.int32: torch.as_tensor(  # noqa: E731
                np.asarray(a), dtype=dt)
            ref, jkv = fwd(jparams, jspec, ji(toks), jkv, ji(tables),
                           ji(lengths), valid=None if valid is None
                           else ji(valid), compute_dtype=jnp.float32)
            out, kv = forward_paged(
                params, spec, ti(toks, torch.int64), kv, ti(tables),
                ti(lengths), valid=None if valid is None else ti(valid),
                compute_dtype=torch.float32)
            ref = np.asarray(ref)
            assert _rel(out.numpy(), ref) <= F32_TOL, i
            assert (out.numpy()[:, -1].argmax(-1)
                    == ref[:, -1].argmax(-1)).all()
            greedy = ref[:, -1].argmax(-1)
            lengths = lengths + (1 if valid is None else valid)
    finally:
        jpaged.set_pallas_paged_decode(old[0], old[1])
        jpaged.set_pallas_paged_prefill(old[2], old[3])


def test_forward_paged_matches_forward(f32):
    """A padded chunk (12 and 9 live of 12), a second chunk and a decode
    step through forward_paged against the contiguous forward
    (tests/test_torch_dense_family.py:hold_paged_against_forward): the
    windows of the paged path, the contiguous path's masks."""
    hold_paged_against_forward(*f32[2:], ((12, [12, 9]), (8, [8, 8]),
                                          (1, None)))


def test_serve_engine_matches_generator(f32):
    """Three prompts (17 tokens: past the window) through the ServeEngine
    (a fused mixed step: NoPE, windows and the early router on the mixed
    path) give the single-user Generator's tokens."""
    hold_engine_against_generator(*f32[2:], 4)


def test_reroute_check_sees_the_paged_knobs(f32):
    """chip_smoke.py's reroute_check on a 20-token prompt (past the window)
    and 3 tokens in bf16 compute: no route differs, and the engine's model
    step under the single-user routes stays within SPREAD_FACTOR times the
    rounding spread (the single-user step in float32 against bf16). Under
    the same forced routes a paged step without the window, with rope on
    the NoPE layer or routing on the normed input leaves that bound: the
    hold sees what the routes do not explain."""
    import chip_smoke as cs
    from ktransformers_tpu_torch.engine.generate import Generator

    spec, params = f32[2:]
    gen = Generator(params, spec, max_len=MAX_LEN, device="cpu")
    prompt = _tokens(spec.vocab_size, 20)[0].tolist()
    toks = [int(t) for t in FEED]
    first, held = cs.reroute_check(gen, prompt, toks, "tiny")
    assert first is None and held["steps"] == 4
    assert 0 < held["spread"] and held["max_rel_err"] <= held["tol"]
    ref, routes = cs.model_steps(gen, prompt, toks)
    for knob in (dict(swa_layout=None), dict(rope_layout=None),
                 dict(moe=dataclasses.replace(spec.moe, early_router=False))):
        gen.spec = dataclasses.replace(spec, **knob)
        out, _ = cs.model_steps(gen, prompt, toks, paged=True, forced=routes)
        gen.spec = spec
        err = ((out - ref).abs().amax(-1) / ref.abs().amax(-1)).max()
        assert float(err) > held["tol"], knob


def test_forward_w4a8_matches_jax(hooks):
    """int4_g weights repacked for W4A8 (the fused QKV, the dense layer's
    MLP, the ReLU experts, lm_head) under equal routing (hold_w4a8). Both
    sides ran the W4A8 kernels (JAX: Pallas in interpret mode; the port:
    their plain versions)."""
    jspec, jparams, spec, params = _carried("int4_g", 6)
    runs = routed_w4a8_runs(jspec, jparams, spec, params,
                            _tokens(spec.vocab_size))
    hold_w4a8(runs, lambda lg: lg)  # sigmoid without a bias: logit order
    assert params["layers"][0]["attn"]["qkv"].act_quant
    assert hooks.get("qmatmul", 0) > 0
