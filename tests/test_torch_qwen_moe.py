"""The port's Qwen2-MoE / Qwen3-MoE against HF torch and the JAX package.

Qwen2-MoE: GQA attention with q / k / v biases, softmax top-k routing
without renormalization, a shared expert scaled by sigmoid(x @
shared_gate.T). Qwen3-MoE: GQA attention with a per-head RMSNorm of q and
k before rope, an explicit head_dim, softmax top-k renormalized, no shared
expert. Tiny sizes, one torch thread (the logits against HF torch, which
needs transformers imported, are held in tests/test_torch_hf_import.py):
- the specs of the registry's presets and of the tiny configs equal the
  JAX package's field by field; the knobs the port does not run raise;
- the JAX package's float32 params carried across (convert.params_from_jax,
  QKV fused with its concatenated bias by the JAX package): the port's
  forward within 2e-4 of the JAX forward, greedy tokens equal; the paged
  forward and the ServeEngine token for token with the JAX package's;
- W4A8 weights (int4_g everywhere, repacked): within LOGIT_TOL (5e-2, of
  tests/test_torch_model.py) under equal routing: every router call of
  the JAX forward is recorded and put in wherever the port's softmax top-k
  chose another expert set, and each such row must be a tie of the
  reference's router;
- fuse_qkv_projections and the converter's new leaves bit-equal to the
  JAX package's; the W4A8 expert route at the presets' widths equal to
  the JAX package's.
"""

import dataclasses
import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ktransformers_tpu_torch.cache.paged import PagedKVCache
from ktransformers_tpu_torch.convert import params_from_jax
from ktransformers_tpu_torch.engine.generate import GenerateConfig, Generator
from ktransformers_tpu_torch.models import model as tmodel
from ktransformers_tpu_torch.models import registry as treg
from ktransformers_tpu_torch.models.paged import forward_paged
from ktransformers_tpu_torch.models.spec import spec_from_hf_config
from ktransformers_tpu_torch.serving import SchedulerConfig, ServeEngine

from tests.test_torch_model import (
    LOGIT_TOL,
    jax_interpret_hooks,
    one_torch_thread,  # noqa: F401 (a fixture)
)

F32_TOL = 2e-4  # of the largest JAX logit, float32 weights
QWEN_PRESETS = ("qwen3-30b-a3b", "qwen2-57b-a14b", "qwen3-235b-a22b")
# tiny configs of both families, 2 layers: 16 experts top-4 of inter 128, 8
# query heads over 2 KV heads; Qwen2 with a shared expert of 256 and its
# layer 1 dense (mlp_only_layers), Qwen3 with a head_dim of 64 (not hidden /
# heads)
TINY = {
    "qwen2_moe": dict(
        treg.REGISTRY["qwen2-57b-a14b"].config, vocab_size=512,
        hidden_size=256, intermediate_size=512, moe_intermediate_size=128,
        shared_expert_intermediate_size=256, num_hidden_layers=2,
        num_attention_heads=8, num_key_value_heads=2, num_experts=16,
        num_experts_per_tok=4, mlp_only_layers=[1],
        max_position_embeddings=256),
    "qwen3_moe": dict(
        treg.REGISTRY["qwen3-30b-a3b"].config, vocab_size=512,
        hidden_size=256, intermediate_size=512, moe_intermediate_size=128,
        num_hidden_layers=2, num_attention_heads=8, num_key_value_heads=2,
        head_dim=64, num_experts=16, num_experts_per_tok=4,
        max_position_embeddings=256),
}
FAMILIES = tuple(TINY)
PROMPT_LEN, DECODE_STEPS, MAX_LEN = 12, 3, 48
F32 = dict(cache_dtype=torch.float32, compute_dtype=torch.float32,
           device="cpu")


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.abs(a - b).max() / np.abs(b).max())


def _same_fields(t, j, path=""):
    """Every field of the port's spec dataclass t (recursively) equals the
    JAX spec's attribute of that name."""
    for f in dataclasses.fields(t):
        tv, jv = getattr(t, f.name), getattr(j, f.name)
        if dataclasses.is_dataclass(tv):
            _same_fields(tv, jv, path + f.name + ".")
        else:
            assert tv == jv, path + f.name


@pytest.mark.parametrize("name", QWEN_PRESETS + FAMILIES)
def test_spec_matches_jax(name):
    """spec_from_hf_config (and the registry's spec()) of the Qwen presets
    and the tiny configs equal the JAX package's spec field by field:
    Qwen2's forced biases and gated shared expert, Qwen3's q / k norm, the
    MoE layer rule (HF's own config dicts: tests/test_torch_hf_import.py)."""
    from ktransformers_tpu.models.spec import spec_from_hf_config as jspec

    if name in QWEN_PRESETS:
        cfg = treg.REGISTRY[name].config
        assert treg.REGISTRY[name].spec() == spec_from_hf_config(dict(cfg))
    else:
        cfg = TINY[name]
    t, j = spec_from_hf_config(dict(cfg)), jspec(dict(cfg))
    _same_fields(t, j)
    q2 = t.model_type == "qwen2_moe"
    assert t.attention.attention_bias == q2 and t.attention.qk_norm != q2
    assert t.moe.shared_expert_gate == q2 and t.moe.moe_layer_offset == 1
    assert (t.moe.shared_expert_intermediate_size > 0) == q2
    assert [t.moe.is_moe_layer(i) for i in range(t.num_layers)] == \
        [j.moe.is_moe_layer(i) for i in range(j.num_layers)]
    assert not (j.attention.partial_rotary_dim or j.attention.gated_output
                or j.attention.sliding_window or j.tie_word_embeddings)


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("change", [
    dict(partial_rotary_factor=0.5),
    dict(sliding_window=4096, use_sliding_window=True),
    dict(gated_output=True), dict(tie_word_embeddings=True),
    dict(hidden_act="gelu"), dict(use_qk_norm=True),
])
def test_spec_refuses_unported_knobs(family, change):
    """A Qwen sliding window in use (the JAX package reads a window only
    from SmallThinker's layouts) and another activation raise; so does a
    q / k norm asked of Qwen2 (Qwen3 applies its own). Partial rotary,
    tied embeddings and gated output, which every GQA family takes
    (GLM4-MoE, the dense families and Qwen3-Next need them), build: rope
    over the leading half of each head (tables sized to it), no lm_head,
    the output gated per head."""
    if "gated_output" in change:
        assert spec_from_hf_config(dict(TINY[family], **change)).attention \
            .gated_output
        return
    if "sliding_window" in change:
        with pytest.raises(ValueError, match="sliding_window_layout"):
            spec_from_hf_config(dict(TINY[family], **change))
        return
    if family == "qwen3_moe" and "use_qk_norm" in change:
        assert spec_from_hf_config(dict(TINY[family], **change)).attention \
            .qk_norm
        return
    if "partial_rotary_factor" in change:
        spec = spec_from_hf_config(dict(TINY[family], **change))
        hd = spec.attention.head_dim
        assert spec.attention.rotary_dim == spec.rope.dim == hd // 2
        return
    if "tie_word_embeddings" in change:
        assert spec_from_hf_config(dict(TINY[family], **change)) \
            .tie_word_embeddings
        return
    with pytest.raises(ValueError):
        spec_from_hf_config(dict(TINY[family], **change))


def test_moe_layer_rule():
    """(layer + 1) % decoder_sparse_step == 0 outside mlp_only_layers."""
    spec = spec_from_hf_config(dict(TINY["qwen3_moe"], num_hidden_layers=6,
                                    decoder_sparse_step=2,
                                    mlp_only_layers=[3]))
    assert [spec.moe.is_moe_layer(i) for i in range(6)] == [
        False, True, False, False, False, True]


# ---------------------------------------------------- against the JAX package


@functools.lru_cache(maxsize=None)
def _jax_init(family: str, quant: str, seed: int):
    """JAX spec and unprepared params: float32 data ("bf16" kind) or quant
    everywhere; biases, q / k norms and the shared gate as its
    init_params_synthetic draws them."""
    from ktransformers_tpu.models.init import init_params_synthetic
    from ktransformers_tpu.models.spec import spec_from_hf_config as jspec

    spec = jspec(dict(TINY[family]))
    kw = dict(dtype=jnp.float32) if quant == "bf16" else {}
    return spec, init_params_synthetic(spec, seed=seed, quant=quant,
                                       moe_quant=quant, **kw)


def _jax_tree_of(family: str, quant: str, seed: int):
    """A copy of _jax_init's tree, leaves included (the JAX package's
    prepare_params rewrites the dicts in place and frees the arrays it
    repacks)."""
    spec, tree = _jax_init(family, quant, seed)
    return spec, jax.tree.map(lambda a: jnp.array(a, copy=True), tree)


def _jax_params(family: str, quant: str, seed: int):
    """_jax_init's params prepared by the JAX package's prepare_params:
    fused QKV (with the concatenated bias) and the W4A8 repack."""
    from ktransformers_tpu.utils.device_prep import prepare_params

    spec, tree = _jax_tree_of(family, quant, seed)
    return spec, prepare_params(tree, True, spec)


@pytest.fixture(scope="module")
def hooks():
    """The interpret-mode hooks of the generation path and of the paged
    attention kernels, the expert matmul hooks gated by kind as
    ops/pallas.enable() gates them (float32 experts take the plain XLA
    products)."""
    from ktransformers_tpu.models import paged as jpaged
    from ktransformers_tpu.ops import moe as jmoe
    from ktransformers_tpu.ops.pallas import PALLAS_KINDS
    from ktransformers_tpu.ops.pallas import paged_attention as jpa

    def gated(fn):
        return lambda x, w, arg: fn(x, w, arg) if w.kind in PALLAS_KINDS \
            else None

    old = (jpaged._PAGED_MLA_DECODE, jpaged._PAGED_GQA_DECODE,
           jpaged._PAGED_MLA_PREFILL, jpaged._PAGED_GQA_PREFILL)
    interp = lambda fn: lambda *a, **kw: fn(*a, **kw, interpret=True)  # noqa: E731
    with jax_interpret_hooks() as calls:
        jmoe.set_pallas_gather(gated(jmoe._PALLAS_GATHER))
        jmoe.set_pallas_gmm(gated(jmoe._PALLAS_GMM))
        jpaged.set_pallas_paged_decode(interp(jpa.mla_paged_decode),
                                       interp(jpa.gqa_paged_decode))
        jpaged.set_pallas_paged_prefill(interp(jpa.mla_paged_prefill),
                                        interp(jpa.gqa_paged_prefill))
        try:
            yield calls
        finally:
            jpaged.set_pallas_paged_decode(old[0], old[1])
            jpaged.set_pallas_paged_prefill(old[2], old[3])


def _carried(family, quant, seed):
    jspec, jparams = _jax_params(family, quant, seed)
    spec = spec_from_hf_config(dict(TINY[family]))
    return types.SimpleNamespace(
        jspec=jspec, jparams=jparams, spec=spec,
        params=params_from_jax(jax.device_get(jparams), spec, "cpu"))


@pytest.fixture(scope="module")
def f32(hooks):
    return {f: _carried(f, "bf16", 5) for f in FAMILIES}


@pytest.fixture(scope="module")
def w4a8(hooks):
    return {f: _carried(f, "int4_g", 6) for f in FAMILIES}


def _tokens(family, n=PROMPT_LEN, seed=7):
    return np.random.default_rng(seed).integers(
        0, TINY[family]["vocab_size"], (1, n)).astype(np.int32)


def _jit(fn):
    """fn jitted (spec and compute_dtype static): one compile a shape
    instead of one a primitive of the eager forward."""
    return jax.jit(fn, static_argnames=("spec", "compute_dtype"))


def _jax_run(c, tokens, feed=None):
    """Prefill + DECODE_STEPS steps in JAX (jitted), each fed the last
    greedy token or the tokens of ``feed``: (last logits rows, greedy
    tokens)."""
    from ktransformers_tpu.models.model import KVCache
    from ktransformers_tpu.models.model import forward as jforward
    from ktransformers_tpu.ops.rope import precompute_rope_tables

    forward = _jit(jforward)
    rope = precompute_rope_tables(c.jspec.rope)
    cache = KVCache.create(c.jspec, 1, MAX_LEN, dtype=jnp.float32)
    logits, cache = forward(c.jparams, c.jspec, jnp.asarray(tokens), cache,
                            rope_tables=rope, compute_dtype=jnp.float32)
    outs = [np.asarray(logits[:, -1])]
    toks = [int(np.argmax(outs[-1][0]))]
    for i in range(DECODE_STEPS):
        tok = toks[-1] if feed is None else feed[i]
        logits, cache = forward(c.jparams, c.jspec,
                                jnp.asarray([[tok]], jnp.int32), cache,
                                rope_tables=rope, compute_dtype=jnp.float32)
        outs.append(np.asarray(logits[:, -1]))
        toks.append(int(np.argmax(outs[-1][0])))
    return outs, toks


def _port_run(c, tokens, feed):
    """The port's forward, decode steps fed ``feed``."""
    cache = tmodel.KVCache.create(c.spec, 1, MAX_LEN, torch.float32, "cpu")
    with torch.no_grad():
        logits, cache = tmodel.forward(c.params, c.spec,
                                       torch.as_tensor(tokens), cache,
                                       compute_dtype=torch.float32)
        outs = [logits[:, -1].numpy()]
        for tok in feed[:DECODE_STEPS]:
            logits, cache = tmodel.forward(c.params, c.spec,
                                           torch.tensor([[tok]]), cache,
                                           compute_dtype=torch.float32)
            outs.append(logits[:, -1].numpy())
    return outs, [int(o[0].argmax()) for o in outs]


@pytest.mark.parametrize("family", FAMILIES)
def test_forward_f32_matches_jax(f32, family):
    """Float32 weights (plain expert products on both sides): every step
    within 2e-4 of the JAX forward, greedy tokens equal; the fused QKV
    carries its bias (Qwen2) and q / k norms (Qwen3) across."""
    c = f32[family]
    tokens = _tokens(family)
    ref, ref_toks = _jax_run(c, tokens)
    out, toks = _port_run(c, tokens, ref_toks[:-1])
    for step, (a, b) in enumerate(zip(out, ref)):
        assert _rel(a, b) <= F32_TOL, step
    assert toks == ref_toks
    attn = c.params["layers"][0]["attn"]
    assert "qkv" in attn and "q_proj" not in attn
    assert ("qkv_bias" in attn) == (family == "qwen2_moe")
    assert ("q_norm" in attn) == (family == "qwen3_moe")
    assert ("mlp" in c.params["layers"][1]) == (family == "qwen2_moe")


def test_generator_matches_jax(f32):
    c = f32["qwen2_moe"]
    tokens = _tokens("qwen2_moe")
    _, ref_toks = _jax_run(c, tokens)
    gen = Generator(c.params, c.spec, max_len=MAX_LEN, **F32)
    out = gen.generate(tokens.tolist(), GenerateConfig(
        max_new_tokens=DECODE_STEPS + 1, prefill_chunk=8))
    assert out == [ref_toks]


def _ti(a, dtype=torch.int32):
    return torch.as_tensor(np.asarray(a), dtype=dtype)


def _ji(a):
    return jnp.asarray(np.asarray(a), jnp.int32)


@pytest.mark.parametrize("family", ["qwen2_moe"])
def test_forward_paged_f32_matches_jax(f32, family):
    """Two sequences on shuffled pages, two chunks each (one padded), then
    a decode step on the JAX side's greedy tokens, through the JAX
    package's paged forward (jitted, its GQA paged kernels in interpret
    mode) and
    the port's: within 2e-4, the same greedy tokens (Qwen3's paged path:
    test_serve_engine_f32_matches_jax_engine)."""
    from ktransformers_tpu.cache.paged import PagedKVCache as JKV
    from ktransformers_tpu.models import paged as jpaged

    c = f32[family]
    vocab = TINY[family]["vocab_size"]
    rng = np.random.default_rng(21)
    page, pmax = 8, 4
    tables = (rng.permutation(11)[:8] + 1).reshape(2, pmax).astype(np.int32)
    tokens = rng.integers(0, vocab, (2, 20))
    jkv = JKV.create(c.jspec, num_pages=12, page_size=page,
                     dtype=jnp.float32)
    kv = PagedKVCache.create(c.spec, 12, page, dtype=torch.float32,
                             device="cpu")
    lengths = np.zeros(2, np.int32)
    greedy = None
    for i in range(3):
        if i < 2:
            toks = tokens[:, :12] if i == 0 else tokens[:, 12:]
            valid = np.asarray([12, 9] if i == 0 else [8, 8], np.int32)
        else:
            toks, valid = greedy[:, None], None
        ref, jkv = _jit(jpaged.forward_paged)(
            c.jparams, c.jspec, _ji(toks), jkv, _ji(tables), _ji(lengths),
            valid=None if valid is None else _ji(valid),
            compute_dtype=jnp.float32)
        out, kv = forward_paged(
            c.params, c.spec, _ti(toks, torch.int64), kv, _ti(tables),
            _ti(lengths), valid=None if valid is None else _ti(valid),
            compute_dtype=torch.float32)
        ref = np.asarray(ref)
        assert _rel(out.numpy(), ref) <= F32_TOL, i
        assert (out.numpy()[:, -1].argmax(-1) == ref[:, -1].argmax(-1)).all()
        greedy = ref[:, -1].argmax(-1)
        lengths = lengths + (1 if valid is None else valid)


@pytest.mark.parametrize("family", ["qwen3_moe"])
def test_serve_engine_f32_matches_jax_engine(f32, family):
    """Three prompts through the port's ServeEngine, the JAX engine and
    the port's single-user Generator, float32 weights: the same tokens (the
    third prompt joins after two steps, so a fused mixed step runs: the
    per-head q / k norm on the mixed path; Qwen2's biases and gated shared
    expert run the same projections and MLP on every path)."""
    from ktransformers_tpu.serving.engine import ServeEngine as JEngine
    from ktransformers_tpu.serving.scheduler import SchedulerConfig as JCfg

    c = f32[family]
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, TINY[family]["vocab_size"], n).tolist()
               for n in (7, 17, 5)]
    sched = dict(max_batch_size=4, prefill_chunk=8, page_size=8,
                 max_pages_per_query=8)

    def serve(eng):
        qs = [eng.submit(p, max_new_tokens=3) for p in prompts[:2]]
        eng.step()
        eng.step()
        qs.append(eng.submit(prompts[2], max_new_tokens=3))
        for _ in range(3000):
            if all(q.state == "done" for q in qs):
                break
            eng.step()
        return [list(q.output_ids) for q in qs]

    ref = serve(JEngine(c.jparams, c.jspec, JCfg(**sched), num_pages=64,
                        cache_dtype=jnp.float32, compute_dtype=jnp.float32))
    eng = ServeEngine(c.params, c.spec, SchedulerConfig(**sched),
                      num_pages=64, **F32)
    got = serve(eng)
    assert eng.mixed_steps_fused >= 1
    gen = Generator(c.params, c.spec, max_len=64, **F32)
    single = [gen.generate(p, GenerateConfig(max_new_tokens=3,
                                             prefill_chunk=8))[0]
              for p in prompts]
    assert got == single == ref


# the widest margin of a softmax routing tie: the router's input carries the
# W4A8 spread that LOGIT_TOL allows the logits, a softmax probability moves
# by at most 1/4 of its logit's move, and a margin is a gap between two of
# them: 2 x LOGIT_TOL / 4
ROUTE_TOL = LOGIT_TOL / 2


def _routed_w4a8(c, family):
    """The W4A8 runs: the JAX forward with every router call's (softmax
    scores, expert ids) recorded, then the port's forward fed the same
    decode tokens with the reference's expert set put in wherever its own
    differs (test only; the weights from the port's own scores at those
    experts, renormalized as its GateConfig says), each of its calls'
    (scores, own ids) recorded."""
    from ktransformers_tpu.models import model as jmodel

    ref_calls, jroute = [], jmodel.route

    def jrecord(logits, gate, bias=None):
        idx, w = jroute(logits, gate, bias)
        jax.debug.callback(
            lambda sc, ix: ref_calls.append((np.asarray(sc), np.asarray(ix))),
            jax.nn.softmax(logits, -1), idx, ordered=True)
        return idx, w

    tokens = _tokens(family)
    jmodel.route = jrecord
    try:
        ref, ref_toks = _jax_run(c, tokens)
        jax.effects_barrier()
    finally:
        jmodel.route = jroute
    calls, troute = [], tmodel.route

    def forced(logits, gate, bias=None):
        idx, w = troute(logits, gate, bias)
        scores = torch.softmax(logits.float(), -1)
        calls.append((scores.numpy(), idx.numpy().copy()))
        want = torch.as_tensor(ref_calls[len(calls) - 1][1].copy())
        differ = torch.tensor([set(a) != set(b) for a, b in zip(
            idx.tolist(), want.tolist())])
        rw = torch.gather(scores, 1, want.long())
        if gate.norm_topk_prob:
            rw = rw / (rw.sum(dim=-1, keepdim=True) + 1e-20)
        return (torch.where(differ[:, None], want.to(idx.dtype), idx),
                torch.where(differ[:, None], rw, w))

    tmodel.route = forced
    try:
        out, toks = _port_run(c, tokens, ref_toks[:-1])
    finally:
        tmodel.route = troute
    return ref, ref_toks, ref_calls, out, toks, calls


@pytest.mark.parametrize("family", FAMILIES)
def test_forward_w4a8_matches_jax(w4a8, hooks, family):
    """int4_g weights repacked for W4A8 (the fused QKV with its bias, the
    shared FFN, the experts' fused FFN, lm_head): under equal routing every
    step within LOGIT_TOL and the greedy tokens equal except at a near-tie
    of the reference (its top-2 gap below LOGIT_TOL of its largest logit);
    every row the port's router sent elsewhere is a tie of the reference's
    softmax top-k (its gap at the k-th expert at most twice the row's
    largest score difference and at most ROUTE_TOL). Both sides ran the
    W4A8 kernels (JAX: Pallas in interpret mode; the port: their plain
    versions)."""
    c = w4a8[family]
    k = c.spec.moe.top_k
    ref, ref_toks, ref_calls, out, toks, calls = _routed_w4a8(c, family)
    assert len(calls) == len(ref_calls) > 0
    for (scores, own), (rscores, ridx) in zip(calls, ref_calls):
        for r in range(own.shape[0]):
            if set(own[r]) == set(ridx[r]):
                continue
            srt = np.sort(rscores[r])[::-1]
            gap = float(srt[k - 1] - srt[k])
            d = float(np.abs(scores[r] - rscores[r]).max())
            assert gap <= 2 * d and gap <= ROUTE_TOL, (r, gap, d)
    errs = [_rel(a, b) for a, b in zip(out, ref)]
    assert max(errs) <= LOGIT_TOL, errs
    for step, b in enumerate(ref):
        top2 = np.sort(b[0])[-2:]
        if (top2[1] - top2[0]) / np.abs(b[0]).max() >= LOGIT_TOL:
            assert toks[step] == ref_toks[step], step
    assert c.params["layers"][0]["attn"]["qkv"].act_quant
    for name in ("qmatmul", "gathered_ffn", "grouped_ffn"):
        assert hooks.get(name, 0) > 0, name
    if family == "qwen2_moe":
        assert hooks.get("dense_ffn", 0) > 0


# ---------------------------------------------- fusion, converter, routes


def _jax_tree(family: str):
    """Unprepared JAX params of the tiny config (int4_g everywhere, the
    W4A8 variant's draw before its prepare_params)."""
    return _jax_tree_of(family, "int4_g", 6)


@pytest.mark.parametrize("family", FAMILIES)
def test_fuse_qkv_matches_jax(family):
    """The port's fuse_qkv_projections on the carried unfused leaves gives
    the JAX package's fused weight and concatenated bias bit for bit (a
    Qwen3 layer has no bias and gets none)."""
    from ktransformers_tpu.utils.device_prep import (
        fuse_qkv_projections as jfuse,
    )
    from ktransformers_tpu_torch.utils.device_prep import fuse_qkv_projections

    jspec, jtree = _jax_tree(family)
    spec = spec_from_hf_config(dict(TINY[family]))
    port = params_from_jax(jax.device_get(jtree), spec, "cpu")
    jfused = jax.device_get(jfuse(jtree, jspec))
    fuse_qkv_projections(port, spec)
    for lp, jlp in zip(port["layers"], jfused["layers"]):
        attn, jattn = lp["attn"], jlp["attn"]
        assert set(attn) == set(jattn)
        for f in ("data", "scales"):
            assert np.array_equal(getattr(attn["qkv"], f).numpy(),
                                  np.asarray(getattr(jattn["qkv"], f)))
        if family == "qwen2_moe":
            assert attn["qkv_bias"].dtype == torch.float32
            assert np.array_equal(attn["qkv_bias"].numpy(),
                                  np.asarray(jattn["qkv_bias"]))
        else:
            assert "qkv_bias" not in attn


def test_fuse_qkv_zero_fills_a_missing_bias():
    """A layer with only a q bias fuses with zeros for k and v, as the JAX
    package's does."""
    from ktransformers_tpu_torch.utils.device_prep import fuse_qkv_projections

    jspec, jtree = _jax_tree("qwen2_moe")
    spec = spec_from_hf_config(dict(TINY["qwen2_moe"]))
    port = params_from_jax(jax.device_get(jtree), spec, "cpu")
    attn = port["layers"][0]["attn"]
    q_bias = attn["q_bias"].clone()
    del attn["k_bias"], attn["v_bias"]
    fuse_qkv_projections(port, spec)
    want = torch.cat([q_bias, torch.zeros(2 * 2 * 32)])
    assert torch.equal(attn["qkv_bias"], want)


@pytest.mark.parametrize("family", FAMILIES)
def test_converter_carries_new_leaves(family):
    """params_from_jax carries q / k / v biases, q / k norms and the shared
    gate as they are, and the fused bias trimmed to the fused columns."""
    from ktransformers_tpu.utils.device_prep import prepare_params

    jspec, jtree = _jax_tree(family)
    spec = spec_from_hf_config(dict(TINY[family]))
    port = params_from_jax(jax.device_get(jtree), spec, "cpu")
    keys = {"qwen2_moe": ("q_bias", "k_bias", "v_bias"),
            "qwen3_moe": ("q_norm", "k_norm")}[family]
    for lp, jlp in zip(port["layers"], jtree["layers"]):
        for key in keys:
            assert np.array_equal(lp["attn"][key].numpy(),
                                  np.asarray(jlp["attn"][key]))
        if "moe" in jlp and family == "qwen2_moe":
            assert np.array_equal(lp["moe"]["shared_gate"].numpy(),
                                  np.asarray(jlp["moe"]["shared_gate"]))
    fused = params_from_jax(jax.device_get(prepare_params(jtree, True,
                                                          jspec)),
                            spec, "cpu")
    a = spec.attention
    cols = (a.num_heads + 2 * a.num_kv_heads) * a.head_dim
    assert fused["layers"][0]["attn"]["qkv"].data.shape[-1] == cols
    if family == "qwen2_moe":
        assert fused["layers"][0]["attn"]["qkv_bias"].shape == (cols,)


@pytest.mark.parametrize("name", ["qwen2-57b-a14b", "qwen3-30b-a3b"])
def test_softmax_top8_of_128_routes_as_jax(name):
    """The presets' routers (softmax over 64 / 128 experts, top-8; Qwen2
    without renormalization, Qwen3 with) on the same random logits: the
    same expert ids in the same order, weights within 1e-6."""
    from ktransformers_tpu.ops.gate import route as jroute

    from ktransformers_tpu_torch.ops.gate import route

    spec = treg.REGISTRY[name].spec()
    assert spec.moe.gate.norm_topk_prob == (name == "qwen3-30b-a3b")
    logits = np.random.default_rng(0).standard_normal(
        (64, spec.moe.num_experts)).astype(np.float32)
    jidx, jw = jroute(jnp.asarray(logits), spec.moe.gate)
    idx, w = route(torch.from_numpy(logits), spec.moe.gate)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), rtol=0,
                               atol=1e-6)


def _shape_pair(k, n, e):
    from tests.test_torch_gqa_model import _shape_pair as pair

    return pair(k, n, e)


@pytest.mark.parametrize("name, rows, fused", [
    ("qwen3-30b-a3b", 8, True),      # one token x top-8: the fused FFN
    ("qwen3-30b-a3b", 64, True),     # the engine's batch of 8 x top-8
    ("qwen2-57b-a14b", 8, False),    # inter 2560: rows 7-8
    ("qwen2-57b-a14b", 64, False),
    ("qwen3-235b-a22b", 8, False),   # inter 1536 at hidden 4096: rows 7-8
])
def test_w4a8_expert_route_matches_jax(name, rows, fused):
    """The W4A8 expert route of the Qwen presets' experts (int4_g,
    repacked) is the JAX package's: the fused FFN (rows 2 and 4) where its
    hooks take it, the unfused matmuls (rows 7 and 8) elsewhere."""
    from ktransformers_tpu.ops.pallas import quant_matmul as jqm
    from ktransformers_tpu.ops.pallas import w4a8_matmul as jwm
    from ktransformers_tpu_torch.ops.cuda import w4a8_ffn as tffn

    spec = treg.REGISTRY[name].spec()
    d, f, e = spec.hidden_size, spec.moe.moe_intermediate_size, \
        spec.moe.num_experts
    (jgu, tgu), (jdn, tdn) = _shape_pair(d, 2 * f, e), _shape_pair(f, d, e)
    want = jwm.ffn_fits(jgu, jdn, "silu", None, rows=rows)
    assert tffn.ffn_fits(tgu, tdn, "silu", None, rows) == want == fused
    want_g = jwm.grouped_ffn_fits(jgu, jdn, "silu", None, bm=jqm.GROUP_BM)
    assert tffn.grouped_ffn_fits(tgu, tdn, "silu", None) == want_g == fused


@pytest.mark.parametrize("name, gb", [("qwen3-30b-a3b", 17.13),
                                      ("qwen2-57b-a14b", 34.71)])
def test_presets_fit_one_h100(name, gb):
    """At the registry's kinds (int8 attention and lm_head, int4_g
    experts) both presets fit one H100 whole."""
    est = treg.estimate_bytes(treg.REGISTRY[name].config, "int8", "int4_g")
    assert round(est["total_gb"], 2) == gb and est["fits_h100"]
