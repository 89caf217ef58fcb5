"""The port's Qwen3-Next against HF torch and the JAX package.

Qwen3-Next (Qwen/Qwen3-Next-80B-A3B-Instruct): 3 of every 4 layers are
GatedDeltaNet linear attention over O(1) state per sequence, the 4th gated
full attention (q_proj emits each head's [q | gate], the output times
sigmoid(gate), rope over a quarter of each head, per-head q / k norm);
Qwen2-MoE-style experts with a gated shared expert; zero-centred RMSNorm
weights in the checkpoint. Tiny sizes, one torch thread:
- the specs of the registry's preset, of tests/test_hybrid_serving.py's
  config and of the tiny one equal the JAX package's field by field;
- tests/test_models_parity.py:test_qwen3_next_parity's HF model: the port
  (models/hf_import, its column permutation and +1 norms) within 4e-3 of
  HF's logits with the same argmax, its params equal to the JAX package's
  import carried across, and within 2e-4 of the JAX forward;
- synthetic float32 weights carried across (convert.params_from_jax): the
  port's forward within 2e-4 of the JAX forward over a prompt and decode
  steps (the states carried), greedy tokens equal; a JAX paged cache
  after a chunk carried across (convert.paged_cache_from_jax, the conv
  tails and recurrent states) and continued in the port as in JAX;
- int4_g weights repacked for W4A8: under equal routing each layer fed
  the JAX layer's own input and state within 1e-2 of its output, as
  tests/test_torch_deepseek_v3.py holds DeepSeek-V3;
- the cases of tests/test_hybrid_serving.py on the port's ServeEngine:
  engine = single user over multi-chunk padded prefills, a reused slot
  starts clean, decode rows leave a prefilling slot's state alone; no
  prefix cache, no fused mixed step, spill and the mixed forward refused.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ktransformers_tpu_torch.cache.paged import PagedKVCache
from ktransformers_tpu_torch.convert import (
    paged_cache_from_jax,
    params_from_jax,
)
from ktransformers_tpu_torch.engine.generate import GenerateConfig, Generator
from ktransformers_tpu_torch.models import model as tmodel
from ktransformers_tpu_torch.models import registry as treg
from ktransformers_tpu_torch.models.hf_import import params_from_hf
from ktransformers_tpu_torch.models.paged import (
    forward_paged,
    forward_paged_mixed,
)
from ktransformers_tpu_torch.models.spec import spec_from_hf_config
from ktransformers_tpu_torch.serving import SchedulerConfig, ServeEngine

from tests.test_hybrid_serving import TINY_NEXT
from tests.test_torch_deepseek_v3 import hooks  # noqa: F401 (a fixture)
from tests.test_torch_hf_import import _assert_same_tree
from tests.test_torch_model import one_torch_thread  # noqa: F401 (fixture)
from tests.test_torch_smallthinker import (
    _same_fields,
    forced_router,
    jax_run,
    port_run,
)

HF_TOL = 4e-3  # of the largest HF logit (the JAX package's own bound)
F32_TOL = 2e-4  # of the largest JAX logit, float32 weights
# 4 layers (3 GatedDeltaNet, 1 gated full attention) at the widths the
# W4A8 kernels take: hidden 256, 4 query heads over 2 KV heads of 64 (rope
# over 16), linear 2 key heads and 4 value heads of 64, 16 experts of inter
# 128 top-4 renormalized, a gated shared expert of 128
TINY = dict(
    treg.REGISTRY["qwen3-next-80b-a3b"].config, vocab_size=512,
    hidden_size=256, intermediate_size=512, moe_intermediate_size=128,
    shared_expert_intermediate_size=128, num_hidden_layers=4,
    num_attention_heads=4, num_key_value_heads=2, head_dim=64,
    linear_num_value_heads=4, linear_num_key_heads=2,
    linear_key_head_dim=64, linear_value_head_dim=64, num_experts=16,
    num_experts_per_tok=4, max_position_embeddings=256,
    layer_types=["linear_attention"] * 3 + ["full_attention"])
F32 = dict(cache_dtype=torch.float32, compute_dtype=torch.float32,
           device="cpu")


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-6))


@pytest.mark.parametrize("which", ["preset", "jax_test", "tiny"])
def test_spec_matches_jax(which):
    from ktransformers_tpu.models.spec import spec_from_hf_config as jspec

    cfg = {"preset": treg.REGISTRY["qwen3-next-80b-a3b"].config,
           "jax_test": TINY_NEXT, "tiny": TINY}[which]
    t = spec_from_hf_config(dict(cfg))
    _same_fields(t, jspec(dict(cfg)))
    a = t.attention
    assert a.gated_output and a.qk_norm
    assert a.rotary_dim == t.rope.dim == a.head_dim // 4
    assert [t.layer_kind(i) for i in range(t.num_layers)] == [
        "linear" if k == "linear_attention" else "full"
        for k in cfg["layer_types"]]
    assert t.moe.shared_expert_gate and t.moe.gate.norm_topk_prob


def test_hf_and_jax_parity():
    """tests/test_models_parity.py:test_qwen3_next_parity's model (seed 0):
    the port within 4e-3 of HF's logits, the same last argmax; the port's
    import equals the JAX package's carried across, and its forward is
    within 2e-4 of the JAX forward."""
    from transformers import Qwen3NextConfig, Qwen3NextForCausalLM

    from ktransformers_tpu.models.hf_import import (
        params_from_hf as j_params_from_hf,
    )
    from ktransformers_tpu.models.model import KVCache
    from ktransformers_tpu.models.model import forward as jforward
    from ktransformers_tpu.models.spec import spec_from_hf_config as jspec_of

    cfg = Qwen3NextConfig(
        vocab_size=96, hidden_size=64, intermediate_size=128,
        moe_intermediate_size=48, shared_expert_intermediate_size=48,
        num_hidden_layers=4, num_attention_heads=4, num_key_value_heads=2,
        head_dim=16, linear_num_value_heads=4, linear_num_key_heads=2,
        linear_key_head_dim=16, linear_value_head_dim=16,
        linear_conv_kernel_dim=4, num_experts=8, num_experts_per_tok=2,
        norm_topk_prob=True, decoder_sparse_step=1,
        max_position_embeddings=128, attn_implementation="eager")
    torch.manual_seed(0)
    model = Qwen3NextForCausalLM(cfg).eval().float()
    spec, jspec = spec_from_hf_config(cfg), jspec_of(cfg.to_dict())
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
    lin = params["layers"][0]["attn"]
    assert lin["in_proj_ba"].data.dtype == torch.bfloat16
    assert "qkv" not in lin and "in_proj_qkvz" in lin


def _carried(quant: str, seed: int):
    """(JAX spec, prepared JAX params, port spec, port params) of TINY, as
    tests/test_torch_smallthinker.py's _carried, but drawn by the JAX
    package's init_params ("f32": float32 data): its init_params_synthetic
    compiles one layer builder per (MoE, kinds) and so gives a hybrid
    spec's full-attention layers the linear layers' weights (ROADMAP
    Queue 3)."""
    from ktransformers_tpu.models.init import init_params
    from ktransformers_tpu.models.spec import spec_from_hf_config as jspec_of
    from ktransformers_tpu.utils.device_prep import prepare_params

    jspec = jspec_of(dict(TINY))
    jparams = prepare_params(init_params(
        jspec, seed=seed, quant=quant, moe_quant=quant), True, jspec)
    spec = spec_from_hf_config(dict(TINY))
    return jspec, jparams, spec, params_from_jax(jax.device_get(jparams),
                                                 spec, "cpu")


@pytest.fixture(scope="module")
def f32(hooks):
    return _carried("f32", 5)


def test_forward_f32_matches_jax(f32):
    """A 12-token prompt and 3 decode steps (the conv tails and recurrent
    states carried in the contiguous cache): within 2e-4 of the JAX
    forward, greedy tokens equal; the gated q_proj inside the fused qkv."""
    jspec, jparams, spec, params = f32
    tokens = np.random.default_rng(7).integers(0, spec.vocab_size, (1, 12))
    ref, ref_toks = jax_run(jspec, jparams, tokens)
    out, toks = port_run(spec, params, tokens)
    for step, (a, b) in enumerate(zip(out, ref)):
        assert _rel(a, b) <= F32_TOL, step
    assert toks == ref_toks
    a = spec.attention
    assert params["layers"][3]["attn"]["qkv"].data.shape[-1] == \
        (2 * a.num_heads + 2 * a.num_kv_heads) * a.head_dim


def test_paged_cache_from_jax_continues(f32):
    """Two sequences prefill a chunk (one padded) through the JAX package's
    paged forward; its cache carried across (slot state rows of the linear
    layers, pages of the full one) and a decode step run on each side:
    within 2e-4, the states equal to 1e-5."""
    from ktransformers_tpu.cache.paged import PagedKVCache as JKV
    from ktransformers_tpu.models import paged as jpaged

    jspec, jparams, spec, params = f32
    rng = np.random.default_rng(3)
    tables = (rng.permutation(7)[:6] + 1).reshape(2, 3).astype(np.int32)
    toks = rng.integers(0, spec.vocab_size, (2, 12))
    valid = np.asarray([12, 7], np.int32)
    fwd = jax.jit(jpaged.forward_paged,
                  static_argnames=("spec", "compute_dtype"))
    ji = lambda a: jnp.asarray(np.asarray(a), jnp.int32)  # noqa: E731
    jkv = JKV.create(jspec, num_pages=8, page_size=8, dtype=jnp.float32,
                     linear_slots=2)
    _, jkv = fwd(jparams, jspec, ji(toks), jkv, ji(tables), ji([0, 0]),
                 valid=ji(valid), compute_dtype=jnp.float32)
    kv = paged_cache_from_jax(jax.device_get(jkv), spec, "cpu")
    assert kv.linear_layers == (0, 1, 2) and kv.num_pages == 8
    assert kv.bufs_a[0].shape == (2, 4, spec.linear_attn.conv_dim)
    assert kv.bufs_b[0].dtype == torch.float32
    dec = rng.integers(0, spec.vocab_size, (2, 1))
    ref, jkv = fwd(jparams, jspec, ji(dec), jkv, ji(tables), ji(valid),
                   compute_dtype=jnp.float32)
    with torch.no_grad():
        out, kv = forward_paged(
            params, spec, torch.as_tensor(dec), kv,
            torch.as_tensor(tables), torch.as_tensor(valid),
            compute_dtype=torch.float32)
    assert _rel(out.numpy(), np.asarray(ref)) <= F32_TOL
    jkv = jax.device_get(jkv)
    for li in range(3):
        assert _rel(kv.bufs_b[li].numpy(), jkv.bufs_b[li]) <= 1e-5, li
        assert _rel(kv.bufs_a[li].numpy(), jkv.bufs_a[li]) <= 1e-5, li


# a port layer fed the JAX layer's own input and state: a flipped int8
# activation code moves a W4A8 layer's output by ~1e-3 of its largest value
# (tests/test_torch_deepseek_v3.py's LAYER_TOL)
LAYER_TOL = 1e-2


def _jax_layers(jspec, jparams, tokens):
    """The W4A8 reference run with every router call and every decoder
    layer call (x in, its two state / cache buffers in, x out) recorded,
    float32 numpy: (logits rows, greedy tokens), router calls, layers."""
    from ktransformers_tpu.models import model as jmodel

    ref_calls, layers = [], []
    jroute, jlayer = jmodel.route, jmodel.decoder_layer

    def jrecord(logits, gate, bias=None):
        idx, w = jroute(logits, gate, bias)
        jax.debug.callback(
            lambda lg, ix: ref_calls.append((np.asarray(lg, np.float32),
                                             np.asarray(ix))),
            logits, idx, ordered=True)
        return idx, w

    def lrecord(lp, spec, x, layer_cache, lengths, *a, **kw):
        out = jlayer(lp, spec, x, layer_cache, lengths, *a, **kw)
        jax.debug.callback(
            lambda *vs: layers.append(tuple(np.array(v, np.float32)
                                            for v in vs)),
            x, layer_cache[0], layer_cache[1], out[0], ordered=True)
        return out

    jmodel.route, jmodel.decoder_layer = jrecord, lrecord
    try:
        ref = jax_run(jspec, jparams, tokens)
        jax.effects_barrier()
    finally:
        jmodel.route, jmodel.decoder_layer = jroute, jlayer
    return ref, ref_calls, layers


def test_forward_w4a8_matches_jax(hooks):
    """int4_g weights repacked for W4A8 (in_proj_qkvz / out_proj of the
    linear layers, the fused gated QKV, the shared expert, the experts,
    lm_head; in_proj_ba stays bf16), as tests/test_torch_deepseek_v3.py
    holds DeepSeek-V3: each port layer, fed the JAX layer's own input and
    state (conv tail and recurrent state, or k / v cache) with the
    reference's expert set put in wherever the port's router chose
    another (tests/test_torch_smallthinker.py:forced_router), within
    LAYER_TOL of that layer's output over the prompt and 3 decode steps;
    so are the final norm and lm_head fed the JAX last hidden state; the
    rows the port's own router sent elsewhere are ties of the reference's
    softmax top-k (hold_w4a8's rule). End to end the forced run leaves
    LOGIT_TOL (0.136 of the largest logit at the first decode step): the
    first layer's output parts by 4e-3 (an int8 activation code flipped by
    float32 summation order) and the random-weight recurrence and the
    layers after it grow that."""
    from ktransformers_tpu_torch.ops.linear import linear

    jspec, jparams, spec, params = _carried("int4_g", 6)
    tokens = np.random.default_rng(7).integers(0, spec.vocab_size, (1, 12))
    (ref, ref_toks), ref_calls, layers = _jax_layers(jspec, jparams, tokens)
    n = spec.num_layers
    assert len(layers) == 4 * n and len(ref_calls) == 4 * n
    tlayer, errs, fed, calls = tmodel.decoder_layer, [], iter(layers), []

    def feed(lp, spec_, x, layer_cache, lengths, *a):
        jx, ja, jb, jout = next(fed)
        out = tlayer(lp, spec_, torch.from_numpy(jx.copy()),
                     (torch.from_numpy(ja.copy()),
                      torch.from_numpy(jb.copy())), lengths, *a)
        errs.append(_rel(out[0].numpy(), jout))
        return out

    tmodel.decoder_layer = feed
    try:
        with forced_router(ref_calls, calls):
            _, toks = port_run(spec, params, tokens)
    finally:
        tmodel.decoder_layer = tlayer
    assert max(errs) <= LAYER_TOL, errs
    with torch.no_grad():
        for step, b in enumerate(ref):
            h = torch.from_numpy(layers[(step + 1) * n - 1][3][:, -1:])
            h = tmodel.rms_norm(h, params["final_norm"], spec.rms_norm_eps)
            assert _rel(linear(h, params["lm_head"])[:, 0].numpy(),
                        b) <= LAYER_TOL, step
    for c, ((lg, own), (rlg, ridx)) in enumerate(zip(calls, ref_calls)):
        for r in range(own.shape[0]):
            if set(own[r]) != set(ridx[r]):
                srt = np.sort(rlg[r])[::-1]  # softmax keeps logit order
                k = own.shape[1]
                assert srt[k - 1] - srt[k] <= 2 * float(
                    np.abs(lg[r] - rlg[r]).max()), (c, r)
    lin = params["layers"][0]["attn"]
    assert lin["in_proj_qkvz"].act_quant and lin["out_proj"].act_quant
    assert lin["in_proj_ba"].kind == "bf16"
    assert params["layers"][3]["attn"]["qkv"].act_quant
    assert hooks.get("qmatmul", 0) > 0


# ------------------------------------------ serving (test_hybrid_serving)


@pytest.fixture(scope="module")
def served():
    """tests/test_hybrid_serving.py's model: its config, float32 weights
    (the port's synthetic draw)."""
    from ktransformers_tpu_torch.models.init import init_params_synthetic

    spec = spec_from_hf_config(dict(TINY_NEXT))
    return spec, init_params_synthetic(spec, seed=0, quant="bf16",
                                       dtype=torch.float32, device="cpu")


def _engine(spec, params, max_batch=2):
    return ServeEngine(params, spec, SchedulerConfig(
        max_batch_size=max_batch, prefill_chunk=8, page_size=8,
        max_pages_per_query=8), num_pages=64, **F32)


def _single(spec, params, prompt, n):
    gen = Generator(params, spec, max_len=64, **F32)
    return gen.generate([prompt], GenerateConfig(max_new_tokens=n,
                                                 prefill_chunk=8))[0]


def test_hybrid_serving_matches_single_user(served):
    """Greedy serving equals the Generator for prompts of 9 and 21 tokens
    (multi-chunk prefill with bucket padding: the state's valid masking);
    no prefix cache, no fused mixed step; the pool holds pages only for
    the full-attention layer."""
    spec, params = served
    prompts = [list(range(9)), list(range(20, 41))]
    expected = [_single(spec, params, p, 6) for p in prompts]
    eng = _engine(spec, params)
    assert eng.prefix is None and eng.kv.linear_layers == (0, 1, 2)
    assert eng.kv.bufs_a[0].shape[0] == 2  # one state row a slot
    queries = [eng.submit(p, max_new_tokens=6) for p in prompts]
    for _ in range(400):
        if not eng.step() and all(q.state == "done" for q in queries):
            break
    assert [list(q.output_ids) for q in queries] == expected
    assert eng.mixed_steps_fused == 0


def test_hybrid_slot_reuse_resets_state(served):
    """One slot: the second query starts from a clean state."""
    spec, params = served
    p1, p2 = list(range(12)), list(range(50, 60))
    want2 = _single(spec, params, p2, 5)
    eng = _engine(spec, params, max_batch=1)
    eng.generate_sync(p1, max_new_tokens=5)
    assert eng.generate_sync(p2, max_new_tokens=5) == want2


def test_hybrid_decode_does_not_corrupt_prefilling_slot(served):
    """Query A decodes while query B prefills: A's decode steps (B's row
    inactive in them) leave B's state alone."""
    spec, params = served
    p1, p2 = list(range(7)), list(range(30, 51))
    want1, want2 = _single(spec, params, p1, 10), _single(spec, params, p2, 6)
    eng = _engine(spec, params)
    q1 = eng.submit(p1, max_new_tokens=10)
    while len(q1.output_ids) < 2:
        eng.step()
    q2 = eng.submit(p2, max_new_tokens=6)
    for _ in range(400):
        if not eng.step() and q1.state == "done" and q2.state == "done":
            break
    assert list(q1.output_ids) == want1 and list(q2.output_ids) == want2


def test_hybrid_refusals(served):
    """The fused mixed forward and a spill tier refuse a hybrid model."""
    spec, params = served
    kv = PagedKVCache.create(spec, 8, 8, dtype=torch.float32, device="cpu",
                             linear_slots=2)
    z = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="hybrid"):
        forward_paged_mixed(params, spec, torch.zeros(1, dtype=torch.int64),
                            torch.zeros((1, 8), dtype=torch.int64), kv,
                            torch.zeros((1, 2), dtype=torch.int32), z,
                            torch.zeros((1, 2), dtype=torch.int32), z,
                            torch.ones(1, dtype=torch.int32),
                            compute_dtype=torch.float32)
    with pytest.raises(ValueError, match="spill"):
        ServeEngine(params, spec, SchedulerConfig(max_batch_size=2),
                    num_pages=16, spill_tier=object(), **F32)
