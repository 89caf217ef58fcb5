"""The port's DeepSeek-V3 against the JAX package's.

A V3 spec cut to 3 layers at narrow widths (layer 0 dense, layers 1-2 MoE
with one shared expert): q_lora (q_a -> q_a_norm -> q_b, fused with kv_a
into qkv_a), the sigmoid noaux_tc router over 16 experts in 4 groups (top
2 groups, top-4 experts) with a random correction bias, and YaRN
rope_scaling at V3's published factor and mscales. The JAX package builds
the params (init_params_synthetic, prepare_params), the correction bias is
drawn into its tree, and convert.params_from_jax carries them across. The
JAX side runs its Pallas kernels in interpret mode through the hooks of
tests/test_torch_model.py; the port runs their plain versions on the CPU.
Both compute in float32.

The softmax scale: the port's V3 spec follows HF's DeepseekV3Attention
(m_all^2 times qk_head_dim^-0.5), the JAX package its own rule, which
gives 1 at these mscales (ROADMAP Queue 3); the JAX spec is given the
port's softmax_scale so that both compute the same function.

Tolerances: on unquantized float32 weights (whose experts run the plain
expert products on both sides) logits within 1e-4 of the largest, the
same greedy tokens. On W4A8 weights, under equal routing: each layer,
fed the JAX layer's own input, within 1e-2 of that layer's output
(LAYER_TOL), greedy tokens equal except at a near-tie (the reference's
top-2 gap below 5e-2 of its largest logit, chip_smoke.py's rule), and
the end-to-end logits within twice the reference's own spread. The two
packages part at their first op and at float32 orders the port cannot
take from XLA (tests/parting_v3_w4a8.py), and the int8 activation
codes that float32 summation order flips (LOGIT_TOL of
tests/test_torch_model.py explains them) carry this tiny model's W4A8
logits as far as LOGIT_TOL under one ulp. This model's
sigmoid group router turns a flipped code into another expert set now and
then, on one machine's float32 summation order and not on another's (the
first token it reroutes moves the logits by up to 0.27): the test records
every router call of both packages, puts the reference's expert set in
wherever the port's differs, and holds every such row to be a tie of the
reference's router (test_w4a8_reroutes_are_ties). The decode steps take
fixed tokens that a tie cannot change. The JAX forward moves by a
comparable amount when its embedding moves by one float32 ulp
(test_jax_self_sensitivity_bounds_tolerance).
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
from ktransformers_tpu_torch.engine.generate import GenerateConfig, Generator
from ktransformers_tpu_torch.models import model as tmodel
from ktransformers_tpu_torch.models.paged import forward_paged
from ktransformers_tpu_torch.ops.linear import linear
from ktransformers_tpu_torch.models.spec import (
    DEEPSEEK_V3,
    spec_from_hf_config,
)
from ktransformers_tpu_torch.ops.rope import yarn_get_mscale
from ktransformers_tpu_torch.serving import SchedulerConfig, ServeEngine

from tests.test_torch_model import (
    LOGIT_TOL,
    jax_interpret_hooks,
    one_torch_thread,  # noqa: F401 (a fixture)
)

TINY_V3 = dict(
    DEEPSEEK_V3, vocab_size=512, hidden_size=256, intermediate_size=512,
    moe_intermediate_size=128, num_hidden_layers=3, num_attention_heads=4,
    num_key_value_heads=4, n_routed_experts=16, num_experts_per_tok=4,
    n_group=4, topk_group=2, first_k_dense_replace=1, kv_lora_rank=64,
    q_lora_rank=128, qk_rope_head_dim=16, qk_nope_head_dim=32, v_head_dim=32,
    max_position_embeddings=256,
    rope_scaling=dict(DEEPSEEK_V3["rope_scaling"],
                      original_max_position_embeddings=32),
)
SPEC = spec_from_hf_config(TINY_V3)
PROMPT_LEN, DECODE_STEPS, MAX_LEN = 16, 4, 64
F32 = dict(cache_dtype=torch.float32, compute_dtype=torch.float32,
           device="cpu")


def _jspec():
    """The JAX spec with the port's (HF's) V3 softmax scale."""
    from ktransformers_tpu.models.spec import spec_from_hf_config as jspec

    j = jspec(TINY_V3)
    return dataclasses.replace(j, attention=dataclasses.replace(
        j.attention, softmax_scale=SPEC.attention.softmax_scale))


def _jax_params(quant: str):
    """Prepared JAX params (float32 data for quant "bf16") with a random
    correction bias in every MoE layer."""
    from ktransformers_tpu.models.init import init_params_synthetic
    from ktransformers_tpu.utils.device_prep import prepare_params

    jspec = _jspec()
    kw = dict(dtype=jnp.float32) if quant == "bf16" else {}
    params = init_params_synthetic(jspec, seed=3, quant=quant,
                                   moe_quant=quant, **kw)
    rng = np.random.default_rng(11)
    for lp in params["layers"]:
        if "moe" in lp:
            lp["moe"]["router_bias_corr"] = jnp.asarray(
                rng.uniform(-0.1, 0.1, TINY_V3["n_routed_experts"]),
                jnp.float32)
    return jspec, prepare_params(params, True, jspec)


@pytest.fixture(scope="module")
def hooks():
    """The interpret-mode hooks, the expert matmul hooks gated by kind as
    ops/pallas.enable() gates them (bf16 experts take the plain XLA
    products)."""
    from ktransformers_tpu.ops import moe as jmoe
    from ktransformers_tpu.ops.pallas import PALLAS_KINDS

    def gated(fn):
        return lambda x, w, arg: fn(x, w, arg) if w.kind in PALLAS_KINDS \
            else None

    with jax_interpret_hooks() as calls:
        jmoe.set_pallas_gather(gated(jmoe._PALLAS_GATHER))
        jmoe.set_pallas_gmm(gated(jmoe._PALLAS_GMM))
        yield calls


@pytest.fixture(scope="module")
def w4a8(hooks):
    jspec, jparams = _jax_params("int4_g")
    return jspec, jparams, params_from_jax(jax.device_get(jparams), SPEC,
                                           "cpu")


@pytest.fixture(scope="module")
def f32(hooks):
    jspec, jparams = _jax_params("bf16")
    return jspec, jparams, params_from_jax(jax.device_get(jparams), SPEC,
                                           "cpu")


def _tokens():
    return np.random.default_rng(7).integers(
        0, TINY_V3["vocab_size"], (1, PROMPT_LEN)).astype(np.int32)


FEED = (11, 222, 333, 444)  # fixed decode tokens of the W4A8 runs
NEAR_TIE = 5e-2


def _jax_run(jspec, jparams, tokens, feed=None):
    """Prefill + DECODE_STEPS decode steps in JAX, each fed the last greedy
    token or, with ``feed``, the fixed tokens; (last logits rows, greedy
    tokens)."""
    from ktransformers_tpu.models.model import KVCache, forward
    from ktransformers_tpu.ops.rope import precompute_rope_tables

    rope = precompute_rope_tables(jspec.rope)
    cache = KVCache.create(jspec, 1, MAX_LEN, dtype=jnp.float32)
    logits, cache = forward(jparams, jspec, jnp.asarray(tokens), cache,
                            rope_tables=rope, compute_dtype=jnp.float32)
    outs = [np.asarray(logits[:, -1])]
    toks = [int(np.argmax(outs[-1][0]))]
    for i in range(DECODE_STEPS):
        tok = toks[-1] if feed is None else feed[i]
        logits, cache = forward(jparams, jspec,
                                jnp.asarray([[tok]], jnp.int32), cache,
                                rope_tables=rope, compute_dtype=jnp.float32)
        outs.append(np.asarray(logits[:, -1]))
        toks.append(int(np.argmax(outs[-1][0])))
    return outs, toks


def _port_run(params, tokens, feed=None):
    cache = tmodel.KVCache.create(SPEC, 1, MAX_LEN, torch.float32, "cpu")
    with torch.no_grad():
        logits, cache = tmodel.forward(params, SPEC, torch.as_tensor(tokens),
                                       cache, compute_dtype=torch.float32)
        outs = [logits[:, -1].numpy()]
        toks = [int(np.argmax(outs[-1][0]))]
        for i in range(DECODE_STEPS):
            tok = toks[-1] if feed is None else feed[i]
            logits, cache = tmodel.forward(
                params, SPEC, torch.tensor([[tok]]), cache,
                compute_dtype=torch.float32)
            outs.append(logits[:, -1].numpy())
            toks.append(int(np.argmax(outs[-1][0])))
    return outs, toks


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.abs(a - b).max() / np.abs(b).max())


def _leaf(tree, *path):
    for k in path:
        tree = tree[k]
    return tree


@pytest.mark.parametrize("name", ["deepseek-v2-lite", "deepseek-v2",
                                  "deepseek-v3", "deepseek-r1", "kimi-k2",
                                  "kimi_k2", "tiny"])
def test_spec_matches_jax(name):
    """spec_from_hf_config of the registry's DeepSeek / Kimi configs (and
    of Kimi's own model_type, and TINY_V3) equals the JAX package's field
    by field; the one difference is V3's softmax_scale, HF's m_all^2 *
    qk_head_dim^-0.5 (0.1353 at V3) where the JAX spec leaves None (its
    rope_attention_scale then gives (m / m_all)^2 = 1)."""
    from ktransformers_tpu.models.registry import REGISTRY
    from ktransformers_tpu.models.spec import spec_from_hf_config as jspec
    from ktransformers_tpu.ops.rope import rope_attention_scale

    if name == "tiny":
        cfg = TINY_V3
    elif name == "kimi_k2":
        cfg = dict(REGISTRY["kimi-k2"].config, model_type="kimi_k2")
    else:
        cfg = REGISTRY[name].config
    j, t = jspec(dict(cfg)), spec_from_hf_config(dict(cfg))
    for f in dataclasses.fields(t):
        if f.name not in ("attention", "rope", "moe", "activation"):
            assert getattr(t, f.name) == getattr(j, f.name), f.name
    v3 = j.model_type == "deepseek_v3"
    for f in dataclasses.fields(t.attention):
        want = getattr(j.attention, f.name)
        if f.name == "softmax_scale" and v3:
            qk = t.attention.head_dim
            sc = cfg["rope_scaling"]
            want = qk ** -0.5 * yarn_get_mscale(sc["factor"],
                                                sc["mscale_all_dim"]) ** 2
            assert j.attention.softmax_scale is None
            assert rope_attention_scale(j.rope) == 1.0
        assert getattr(t.attention, f.name) == want, f.name
    if name == "deepseek-v3":
        assert t.attention.softmax_scale == pytest.approx(0.13523, abs=1e-5)
    assert not (j.attention.attention_bias or j.tie_word_embeddings)
    assert dataclasses.asdict(t.rope) == dataclasses.asdict(j.rope)
    assert dataclasses.asdict(t.activation) == dataclasses.asdict(j.activation)
    assert dataclasses.asdict(t.moe.gate) == dataclasses.asdict(j.moe.gate)
    for f in ("num_experts", "top_k", "moe_intermediate_size",
              "shared_expert_intermediate_size", "first_k_dense",
              "moe_layer_freq"):
        assert getattr(t.moe, f) == getattr(j.moe, f), f
    assert [t.moe.is_moe_layer(i) for i in range(t.num_layers)] == \
        [j.moe.is_moe_layer(i) for i in range(j.num_layers)]


def test_forward_f32_matches_jax(f32, hooks):
    """Unquantized float32 weights: the plain expert products on both
    sides, every step within 1e-4, the same greedy tokens."""
    jspec, jparams, params = f32
    tokens = _tokens()
    ref, ref_toks = _jax_run(jspec, jparams, tokens)
    out, toks = _port_run(params, tokens)
    for step, (a, b) in enumerate(zip(out, ref)):
        assert _rel(a, b) <= 1e-4, step
    assert toks == ref_toks
    attn = params["layers"][1]["attn"]
    assert "qkv_a" in attn and "q_b" in attn and "q_a_norm" in attn
    assert attn["qkv_a"].data.shape[-1] == 128 + 64 + 16
    assert hooks.get("mla_fused", 0) > 0


def _routed_runs(jspec, jparams, params, tokens):
    """The W4A8 runs of test_forward_w4a8_matches_jax, every router call
    recorded (one per MoE layer a forward, in call order, on both sides):
    - ref: the JAX forward, its calls' (choice scores, expert ids);
    - free: the port's own forward, its calls' expert ids;
    - forced: the port's forward with the reference's expert set put in
      wherever its own differs (test only): the weights come from the
      port's own scores at those experts, normalized as its GateConfig
      says; its calls' (choice scores, own expert ids).
    Each run: (last logits rows, greedy tokens, calls)."""
    from ktransformers_tpu.models import model as jmodel

    cfg = SPEC.moe.gate
    ref_calls, jroute = [], jmodel.route

    def jrecord(logits, gate, bias=None):
        idx, w = jroute(logits, gate, bias)
        ref_calls.append((_choice(np.asarray(logits), bias, cfg),
                          np.asarray(idx)))
        return idx, w

    jmodel.route = jrecord
    try:
        ref = _jax_run(jspec, jparams, tokens, FEED)
    finally:
        jmodel.route = jroute

    def port(force: bool):
        calls = []
        with _port_router(ref_calls if force else None, calls):
            return (*_port_run(params, tokens, FEED), calls)

    assert cfg.scoring == "sigmoid" and cfg.has_correction_bias
    return (*ref, ref_calls), port(False), port(True)


@contextlib.contextmanager
def _port_router(ref_calls=None, calls=None):
    """The port's router, each call's (choice scores, own expert ids)
    appended to ``calls``; with ``ref_calls``, the reference's expert set
    put in wherever its own differs (test only), the weights taken from
    the port's own scores at those experts, normalized as its GateConfig
    says."""
    troute = tmodel.route
    seen = [0]

    def record(logits, gate, bias=None):
        idx, w = troute(logits, gate, bias)
        if calls is not None:
            calls.append((_choice(logits.numpy(), bias, gate),
                          idx.numpy().copy()))
        if ref_calls is not None:
            want = torch.as_tensor(ref_calls[seen[0]][1].copy())
            differ = torch.tensor([set(a) != set(b) for a, b in zip(
                idx.tolist(), want.tolist())])
            scores = torch.sigmoid(logits.float())
            rw = torch.gather(scores, 1, want.long())
            if gate.norm_topk_prob:
                rw = rw / (rw.sum(dim=-1, keepdim=True) + 1e-20)
            rw = rw * gate.routed_scaling_factor
            idx = torch.where(differ[:, None], want.to(idx.dtype), idx)
            w = torch.where(differ[:, None], rw, w)
        seen[0] += 1
        return idx, w

    tmodel.route = record
    try:
        yield
    finally:
        tmodel.route = troute


def _choice(logits, bias, cfg) -> np.ndarray:
    """The sigmoid router's choice scores: sigmoid(logits) + the
    correction bias (ops/gate.route), float32 [T, E]."""
    logits = np.asarray(logits, np.float32)
    return (1.0 / (1.0 + np.exp(-logits)) + np.asarray(bias, np.float32)
            ).astype(np.float32)


def _group_scores(choice, cfg) -> np.ndarray:
    """group_top2sum of the choice scores: [T, n_group]."""
    g = np.sort(choice.reshape(choice.shape[0], cfg.n_group, -1), axis=-1)
    return g[..., -2:].sum(axis=-1)


def _margin(sorted_desc_row, k) -> float:
    """The gap between the k-th and the (k+1)-th largest value."""
    return float(sorted_desc_row[k - 1] - sorted_desc_row[k])


@pytest.fixture(scope="module")
def w4a8_runs(w4a8, hooks):
    jspec, jparams, params = w4a8
    return _routed_runs(jspec, jparams, params, _tokens())


# the widest margin of a tie, in choice-score units (sigmoid(logit) + bias,
# in (-0.1, 1.1)): the router's input carries the W4A8 spread that LOGIT_TOL
# allows the logits, the sigmoid's slope is at most 1/4, and a margin is a
# gap between two scores, each moved that much: 2 x LOGIT_TOL / 4
ROUTE_TOL = LOGIT_TOL / 2


# a port layer fed the JAX layer's own input: a flipped int8 activation
# code moves a W4A8 layer's output by ~1e-3 of its largest value
LAYER_TOL = 1e-2


def _jax_layers(jspec, jparams, tokens):
    """The W4A8 reference run of _routed_runs (FEED decode tokens), each
    decoder layer call's (x in, cache buffers in, x out) and the final
    logits rows, float32 numpy."""
    from ktransformers_tpu.models import model as jmodel

    layers, jlayer = [], jmodel.decoder_layer

    def record(lp, spec, x, layer_cache, lengths, *a, **kw):
        out = jlayer(lp, spec, x, layer_cache, lengths, *a, **kw)
        layers.append(tuple(np.array(v, np.float32) for v in (
            x, layer_cache[0], layer_cache[1], out[0])))
        return out

    jmodel.decoder_layer = record
    try:
        ref, _ = _jax_run(jspec, jparams, tokens, FEED)
    finally:
        jmodel.decoder_layer = jlayer
    return layers, ref


def test_forward_w4a8_matches_jax(w4a8, w4a8_runs):
    """Each port layer, fed the JAX layer's own input and cache with the
    reference's expert set put in wherever the port's router chose another
    (each such row a tie: test_w4a8_reroutes_are_ties), lies within
    LAYER_TOL of that layer's output; so do the final norm and lm_head fed
    the JAX last hidden state. Greedy tokens of the end-to-end forced run
    equal the reference's except at a near-tie. The two packages part at
    their first op, the layer-0 input RMSNorm, and keep parting however
    many float32 orders the port takes from XLA (tests/parting_v3_w4a8.py
    aligns them one at a time): its mean of squares summed in XLA's order
    still leaves XLA's rsqrt (the processor's estimate refined by two
    Newton steps, which no PyTorch op gives); with XLA's own rsqrt bits
    fed in as well, the first W4A8 product parts, fed equal codes, scales
    and sums, in the float32 accumulation that XLA compiles from the
    interpreted Pallas kernel. Each W4A8 layer turns such float32 noise
    into a flipped int8 code now and then and grows what came in 3-10x:
    the forced run's end-to-end error moves between 4.8e-2 and 7.4e-2
    with these last-bit changes, on either side of LOGIT_TOL
    (test_w4a8_forced_error_within_jax_forced_spread holds that bound)."""
    jspec, jparams, params = w4a8
    (ref, ref_toks, ref_calls), _, (_, toks, _) = w4a8_runs
    layers, jref = _jax_layers(jspec, jparams, _tokens())
    assert all(np.array_equal(a, b) for a, b in zip(jref, ref))
    tlayer, errs, fed = tmodel.decoder_layer, [], iter(layers)

    def feed(lp, spec, x, layer_cache, lengths, *a):
        jx, ja, jb, jout = next(fed)
        out = tlayer(lp, spec, torch.from_numpy(jx.copy()),
                     (torch.from_numpy(ja.copy()),
                      torch.from_numpy(jb.copy())), lengths, *a)
        errs.append(_rel(out[0].numpy(), jout))
        return out

    tmodel.decoder_layer = feed
    try:
        with _port_router(ref_calls):
            _port_run(params, _tokens(), FEED)
    finally:
        tmodel.decoder_layer = tlayer
    assert len(errs) == len(layers) == SPEC.num_layers * (DECODE_STEPS + 1)
    assert max(errs) <= LAYER_TOL, errs
    n = SPEC.num_layers
    with torch.no_grad():
        for step, b in enumerate(ref):
            h = torch.from_numpy(layers[(step + 1) * n - 1][3][:, -1:])
            h = tmodel.rms_norm(h, params["final_norm"], SPEC.rms_norm_eps)
            assert _rel(linear(h, params["lm_head"])[:, 0].numpy(),
                        b) <= LAYER_TOL, step
    for step, b in enumerate(ref):
        top2 = np.sort(b[0])[-2:]
        if (top2[1] - top2[0]) / np.abs(b[0]).max() >= NEAR_TIE:
            assert toks[step] == ref_toks[step], step


def test_w4a8_steps_past_tolerance_follow_a_reroute(w4a8_runs, w4a8,
                                                    hooks):
    """Unforced, a step past LOGIT_TOL must follow a token the port sent to
    other experts at or before its position: the sigmoid group router turns
    an int8 activation code that float32 summation order flips into
    another top-k choice now and then, on one machine and not on another.
    Both packages ran their W4A8 routes (the JAX package its Pallas
    kernels in interpret mode)."""
    (ref, _, ref_calls), free, _ = w4a8_runs
    # the calls of each step's forward: two MoE layers a forward
    moe_layers = len(ref_calls) // (DECODE_STEPS + 1)
    rerouted = [any(set(a) != set(b) for a, b in zip(f[1], r[1]))
                for f, r in zip(free[2], ref_calls)]
    for step, (a, b) in enumerate(zip(free[0], ref)):
        if _rel(a, b) > LOGIT_TOL:
            assert any(rerouted[:(step + 1) * moe_layers]), step
    assert _leaf(w4a8[2], "layers", 1, "attn", "qkv_a").act_quant
    for name in ("qmatmul", "gathered_ffn", "grouped_ffn", "dense_ffn",
                 "mla_fused"):
        assert hooks.get(name, 0) > 0, name


def test_w4a8_reroutes_are_ties(w4a8_runs):
    """Every row (under equal routing upstream) where the port's own router
    chose another expert set is a tie of the reference's router: where the
    group choice flipped, the gap between the reference's last chosen and
    first unchosen group score (group_top2sum) is at most twice the row's
    largest group score difference; where only the experts flipped, the gap
    between its last chosen and first unchosen bias-corrected score within
    the chosen groups is at most twice the row's largest choice score
    difference. Both are the most a top-k can move when every score moves
    by at most that much, so a flip beyond them is a fault of the port's
    router; and the gap is at most ROUTE_TOL, so a flip at a wide margin (a
    router or expert product that is off) fails too."""
    (_, _, ref_calls), _, (_, _, calls) = w4a8_runs
    cfg = SPEC.moe.gate
    assert len(calls) == len(ref_calls) == 2 * (DECODE_STEPS + 1)
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


def test_jax_self_sensitivity_bounds_tolerance(w4a8):
    """The JAX forward on the W4A8 weights moves by a comparable amount
    when its embedding moves by one float32 ulp: LOGIT_TOL is within twice
    that spread."""
    jspec, jparams, _ = w4a8
    tokens = _tokens()
    ref, _ = _jax_run(jspec, jparams, tokens, FEED)
    nudged = dict(jparams)
    e = np.asarray(jparams["embed"])
    nudged["embed"] = jnp.asarray(np.nextafter(e, np.inf).astype(np.float32))
    out, _ = _jax_run(jspec, nudged, tokens, FEED)
    assert LOGIT_TOL <= 2 * max(_rel(a, b) for a, b in zip(out, ref))


def _jax_forced_nudged_run(jspec, jparams, tokens, ref_calls):
    """The JAX forward on the W4A8 weights with its embedding moved by one
    float32 ulp and the reference's expert set put in wherever its own
    router chose another (the port's forced run's substitution, test only):
    the reference's own spread under equal routing. (last logits rows,
    greedy tokens)."""
    from ktransformers_tpu.models import model as jmodel

    jroute, n = jmodel.route, [0]

    def forced(logits, gate, bias=None):
        idx, w = jroute(logits, gate, bias)
        want = ref_calls[n[0]][1]
        n[0] += 1
        own = np.asarray(idx)
        differ = np.array([set(a) != set(b) for a, b in zip(own.tolist(),
                                                            want.tolist())])
        if not differ.any():
            return idx, w
        scores = 1.0 / (1.0 + np.exp(-np.asarray(logits, np.float32)))
        rw = np.take_along_axis(scores, want.astype(np.int64), 1)
        if gate.norm_topk_prob:
            rw = rw / (rw.sum(axis=-1, keepdims=True) + 1e-20)
        rw = (rw * gate.routed_scaling_factor).astype(np.float32)
        return (jnp.asarray(np.where(differ[:, None], want, own), jnp.int32),
                jnp.asarray(np.where(differ[:, None], rw, np.asarray(w))))

    nudged = dict(jparams)
    e = np.asarray(jparams["embed"])
    nudged["embed"] = jnp.asarray(np.nextafter(e, np.inf).astype(np.float32))
    jmodel.route = forced
    try:
        out = _jax_run(jspec, nudged, tokens, FEED)
    finally:
        jmodel.route = jroute
    assert n[0] == len(ref_calls)
    return out


def test_w4a8_forced_error_within_jax_forced_spread(w4a8, w4a8_runs):
    """Under equal routing the port's error is the reference's own float32
    spread: the JAX forward against itself, its embedding moved by one ulp
    and its routing forced to the un-nudged run's, moves each step by
    `spread`; the port's forced run (test_forward_w4a8_matches_jax's) lies
    within twice the largest step of it. One nudge is one draw of that
    spread, and the port's summation order differs from the reference's
    in every op, not in one input ulp: hence twice, the factor of
    test_jax_self_sensitivity_bounds_tolerance. An expert product or a
    router that is off moves the logits by far more (the first token the
    port reroutes unforced moves them by up to 0.27)."""
    jspec, jparams, _ = w4a8
    (ref, _, ref_calls), _, (out, _, _) = w4a8_runs
    nudged, _ = _jax_forced_nudged_run(jspec, jparams, _tokens(), ref_calls)
    spread = [_rel(a, b) for a, b in zip(nudged, ref)]
    errs = [_rel(a, b) for a, b in zip(out, ref)]
    assert max(errs) <= 2 * max(spread), (errs, spread)


def test_generator_matches_jax(f32):
    """The port's Generator on the float32 weights gives the JAX greedy
    tokens."""
    jspec, jparams, params = f32
    tokens = _tokens()
    _, ref_toks = _jax_run(jspec, jparams, tokens)
    gen = Generator(params, SPEC, max_len=MAX_LEN, **F32)
    out = gen.generate(tokens.tolist(), GenerateConfig(
        max_new_tokens=DECODE_STEPS + 1, prefill_chunk=PROMPT_LEN))
    assert out == [ref_toks]


def _ti(a, dtype=torch.int32):
    return torch.as_tensor(np.asarray(a), dtype=dtype)


def _ji(a):
    return jnp.asarray(np.asarray(a), jnp.int32)


def test_forward_paged_f32_matches_jax(f32):
    """Two sequences on shuffled pages, two chunks each (one padded), then
    two decode steps, through the JAX package's paged forward (its Pallas
    paged kernels in interpret mode) and the port's: within 1e-4."""
    from ktransformers_tpu.cache.paged import PagedKVCache as JKV
    from ktransformers_tpu.models import paged as jpaged
    from ktransformers_tpu.ops.pallas import paged_attention as jpa

    jspec, jparams, params = f32
    old = (jpaged._PAGED_MLA_DECODE, jpaged._PAGED_GQA_DECODE,
           jpaged._PAGED_MLA_PREFILL, jpaged._PAGED_GQA_PREFILL)
    interp = lambda fn: lambda *a, **kw: fn(*a, **kw, interpret=True)  # noqa: E731
    jpaged.set_pallas_paged_decode(interp(jpa.mla_paged_decode),
                                   interp(jpa.gqa_paged_decode))
    jpaged.set_pallas_paged_prefill(interp(jpa.mla_paged_prefill),
                                    interp(jpa.gqa_paged_prefill))
    try:
        rng = np.random.default_rng(21)
        page, pmax, vocab = 8, 4, TINY_V3["vocab_size"]
        tables = (rng.permutation(11)[:8] + 1).reshape(2, pmax).astype(
            np.int32)
        tokens = rng.integers(0, vocab, (2, 20))
        jkv = JKV.create(jspec, num_pages=12, page_size=page,
                         dtype=jnp.float32)
        kv = PagedKVCache.create(SPEC, 12, page, dtype=torch.float32,
                                 device="cpu")
        lengths = np.zeros(2, np.int32)
        steps = [(tokens[:, :12], np.asarray([12, 9], np.int32)),
                 (tokens[:, 12:], np.asarray([8, 8], np.int32)),
                 (rng.integers(0, vocab, (2, 1)), None),
                 (rng.integers(0, vocab, (2, 1)), None)]
        for toks, valid in steps:
            ref, jkv = jpaged.forward_paged(
                jparams, jspec, _ji(toks), jkv, _ji(tables), _ji(lengths),
                valid=None if valid is None else _ji(valid),
                compute_dtype=jnp.float32)
            out, kv = forward_paged(
                params, SPEC, _ti(toks, torch.int64), kv, _ti(tables),
                _ti(lengths), valid=None if valid is None else _ti(valid),
                compute_dtype=torch.float32)
            assert _rel(out.numpy(), ref) <= 1e-4
            lengths = lengths + (1 if valid is None else valid)
    finally:
        jpaged.set_pallas_paged_decode(old[0], old[1])
        jpaged.set_pallas_paged_prefill(old[2], old[3])


def test_serve_engine_f32_matches_jax_engine_and_generator(f32):
    """Three prompts through the port's ServeEngine, the JAX engine and the
    port's single-user Generator, float32 weights: the same tokens (the
    third prompt joins after two steps, so a mixed step runs)."""
    from ktransformers_tpu.serving.engine import ServeEngine as JEngine
    from ktransformers_tpu.serving.scheduler import SchedulerConfig as JCfg

    jspec, jparams, params = f32
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, TINY_V3["vocab_size"], n).tolist()
               for n in (7, 17, 5)]
    sched = dict(max_batch_size=4, prefill_chunk=8, page_size=8,
                 max_pages_per_query=8)

    def serve(eng):
        qs = [eng.submit(p, max_new_tokens=5) for p in prompts[:2]]
        eng.step()
        eng.step()
        qs.append(eng.submit(prompts[2], max_new_tokens=5))
        for _ in range(3000):
            if all(q.state == "done" for q in qs):
                break
            eng.step()
        return [list(q.output_ids) for q in qs]

    ref = serve(JEngine(jparams, jspec, JCfg(**sched), num_pages=64,
                        cache_dtype=jnp.float32, compute_dtype=jnp.float32))
    eng = ServeEngine(params, SPEC, SchedulerConfig(**sched), num_pages=64,
                      **F32)
    got = serve(eng)
    assert eng.mixed_steps_fused >= 1
    gen = Generator(params, SPEC, max_len=96, **F32)
    single = [gen.generate(p, GenerateConfig(max_new_tokens=5,
                                             prefill_chunk=8))[0]
              for p in prompts]
    assert got == single == ref


def test_synthetic_init_has_q_lora_and_correction_bias():
    """The port's init_params_synthetic draws q_a / q_a_norm / q_b and a
    zero router correction bias for V3, as the JAX package does, and
    prepare_params fuses q_a with kv_a."""
    from ktransformers_tpu_torch.models.init import init_params_synthetic
    from ktransformers_tpu_torch.utils.device_prep import prepare_params

    params = init_params_synthetic(SPEC, seed=1, dtype=torch.float32,
                                   device="cpu")
    attn = params["layers"][0]["attn"]
    assert attn["q_a"].data.shape == (256 // 2, 128)
    assert attn["q_b"].data.shape == (128 // 2, 4 * 48)
    assert "q_proj" not in attn and attn["q_a_norm"].shape == (128,)
    bias = params["layers"][1]["moe"]["router_bias_corr"]
    assert bias.shape == (16,) and not bias.any()
    prepare_params(params, SPEC)
    assert "qkv_a" in attn and "q_a" not in attn and "kv_a" not in attn
    gen = Generator(params, SPEC, max_len=MAX_LEN, **F32)
    assert len(gen.generate(_tokens().tolist(), GenerateConfig(
        max_new_tokens=3, prefill_chunk=PROMPT_LEN))[0]) == 3
