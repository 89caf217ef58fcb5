"""The PyTorch port's DeepSeek-V2 forward against the JAX package's.

A 3-layer deepseek_v2 spec at narrow widths (layer 0 dense, layers 1-2 MoE
with 2 shared experts) is built by the JAX package's init_params_synthetic
and prepare_params (bf16 absorbed mats, fused qkv_a, W4A8 repack, padded
scales), then carried across with convert.params_from_jax. The JAX side
runs its Pallas kernels in interpret mode through the same hooks that
ops/pallas.enable() installs; the port runs the kernels' plain versions on
the CPU. Both compute in float32.

Tolerance: logits agree to 5e-2 of their largest magnitude, and greedy
tokens agree exactly. The two sides run the same W4A8 arithmetic; what
differs is the order of float32 sums (XLA vs PyTorch reductions), which
now and then moves an int8 activation code across a rounding boundary.
Each such flip shifts a group's product by one quantization step, and the
random synthetic weights carry it through three layers: the JAX forward
against itself, with the embedding moved by one float32 ulp, differs by
the same order (test_jax_self_sensitivity_bounds_tolerance checks that the
tolerance is no wider than twice that spread). Each kernel's plain version
is held much tighter against its Pallas kernel in test_torch_kernels.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ktransformers_tpu_torch.convert import params_from_jax, qtensor_from_jax
from ktransformers_tpu_torch.engine.generate import GenerateConfig, Generator
from ktransformers_tpu_torch.models import model as tmodel
from ktransformers_tpu_torch.models.spec import (
    DEEPSEEK_V2_LITE,
    spec_from_hf_config as t_spec_from_hf_config,
)

SMALL = dict(
    DEEPSEEK_V2_LITE,
    vocab_size=512, hidden_size=256, intermediate_size=512,
    moe_intermediate_size=128, num_hidden_layers=3, num_attention_heads=4,
    num_key_value_heads=4, n_routed_experts=8, num_experts_per_tok=3,
    kv_lora_rank=64, qk_rope_head_dim=16, qk_nope_head_dim=32, v_head_dim=32,
)
PROMPT_LEN, DECODE_STEPS, MAX_LEN = 16, 4, 64
LOGIT_TOL = 5e-2


@pytest.fixture
def jax_interpret_kernels():
    """Install the JAX package's Pallas hooks as interpret-mode wrappers
    (the routing of ops/pallas.enable()), restoring the old hooks after."""
    from ktransformers_tpu.ops import attention, linear, moe
    from ktransformers_tpu.ops.pallas import mla_decode as md
    from ktransformers_tpu.ops.pallas import quant_matmul as qm
    from ktransformers_tpu.ops.pallas import w4a8_matmul as wm

    old = (linear._PALLAS_QMATMUL, moe._PALLAS_FFN, moe._PALLAS_GROUPED_FFN,
           moe._PALLAS_DENSE_FFN, attention._PALLAS_MLA_FUSED)

    def ffn(x_rows, gu, dn, ids, act):
        if x_rows.shape[0] > 128 or not wm.ffn_fits(
                gu, dn, act.kind, act.swiglu_limit, rows=x_rows.shape[0]):
            return None
        return wm.gathered_w4a8_ffn(x_rows, gu, dn, ids, act=act.kind,
                                    interpret=True)

    def grouped_ffn(xs, gu, dn, sizes, act):
        if not wm.grouped_ffn_fits(gu, dn, act.kind, act.swiglu_limit,
                                   bm=qm.GROUP_BM):
            return None
        return wm.grouped_w4a8_ffn(xs, gu, dn, sizes, act=act.kind,
                                   interpret=True)

    def dense_ffn(rows, gu, dn, act):
        bc = wm.dense_ffn_plan(gu, dn, act.kind, act.swiglu_limit)
        if bc is None:
            return None
        return wm.dense_w4a8_ffn(rows, gu, dn, act=act.kind, bc=bc,
                                 interpret=True)

    def fused(qn, qp, ckv_kpe, gamma, rot, ckv, kpe, lengths, scale, eps):
        return md.mla_decode_fused(qn, qp, ckv_kpe, gamma, rot, ckv, kpe,
                                   lengths, scale=scale, eps=eps,
                                   interpret=True)

    calls = {}

    def counted(name, fn):
        def wrapped(*a):
            out = fn(*a)
            if out is not None:
                calls[name] = calls.get(name, 0) + 1
            return out
        return wrapped

    linear.set_pallas_qmatmul(counted(
        "qmatmul", lambda x, w: qm.quant_matmul(x, w, interpret=True)))
    moe.set_pallas_ffn(counted("gathered_ffn", ffn))
    moe.set_pallas_grouped_ffn(counted("grouped_ffn", grouped_ffn))
    moe.set_pallas_dense_ffn(counted("dense_ffn", dense_ffn))
    attention.set_pallas_mla_fused(counted("mla_fused", fused))
    try:
        yield calls
    finally:
        linear.set_pallas_qmatmul(old[0])
        moe.set_pallas_ffn(old[1])
        moe.set_pallas_grouped_ffn(old[2])
        moe.set_pallas_dense_ffn(old[3])
        attention.set_pallas_mla_fused(old[4])


def _jax_params():
    from ktransformers_tpu.models.init import init_params_synthetic
    from ktransformers_tpu.models.spec import spec_from_hf_config
    from ktransformers_tpu.utils.device_prep import prepare_params

    spec = spec_from_hf_config(SMALL)
    params = init_params_synthetic(spec, seed=3, quant="int4_g",
                                   moe_quant="int4_g")
    return spec, prepare_params(params, True, spec)


def _jax_run(spec, params, tokens):
    """Prefill + greedy decode in JAX; returns (logits list, tokens)."""
    from ktransformers_tpu.models.model import KVCache, forward
    from ktransformers_tpu.ops.rope import precompute_rope_tables

    rope = precompute_rope_tables(spec.rope)
    cache = KVCache.create(spec, 1, MAX_LEN, dtype=jnp.float32)
    logits, cache = forward(params, spec, jnp.asarray(tokens), cache,
                            rope_tables=rope, compute_dtype=jnp.float32)
    outs = [np.asarray(logits[:, -1])]
    toks = [int(np.argmax(outs[-1][0]))]
    for _ in range(DECODE_STEPS):
        logits, cache = forward(params, spec,
                                jnp.asarray([[toks[-1]]], jnp.int32), cache,
                                rope_tables=rope, compute_dtype=jnp.float32)
        outs.append(np.asarray(logits[:, -1]))
        toks.append(int(np.argmax(outs[-1][0])))
    return outs, toks


def _port_run(params, tokens):
    spec = t_spec_from_hf_config(SMALL)
    cache = tmodel.KVCache.create(spec, 1, MAX_LEN, torch.float32, "cpu")
    logits, cache = tmodel.forward(params, spec, torch.as_tensor(tokens),
                                   cache, compute_dtype=torch.float32)
    outs = [logits[:, -1].numpy()]
    toks = [int(np.argmax(outs[-1][0]))]
    for _ in range(DECODE_STEPS):
        logits, cache = tmodel.forward(params, spec,
                                       torch.tensor([[toks[-1]]]), cache,
                                       compute_dtype=torch.float32)
        outs.append(logits[:, -1].numpy())
        toks.append(int(np.argmax(outs[-1][0])))
    assert int(cache.lengths[0]) == PROMPT_LEN + DECODE_STEPS
    return outs, toks


@pytest.fixture
def carried(jax_interpret_kernels):
    spec, params = _jax_params()
    tokens = np.random.default_rng(7).integers(
        0, SMALL["vocab_size"], (1, PROMPT_LEN)).astype(np.int32)
    ref_logits, ref_toks = _jax_run(spec, params, tokens)
    port_params = params_from_jax(jax.device_get(params),
                                  t_spec_from_hf_config(SMALL), "cpu")
    return jax_interpret_kernels, tokens, port_params, ref_logits, ref_toks


def test_forward_matches_jax(carried):
    calls, tokens, port_params, ref_logits, ref_toks = carried
    # every Pallas route of the main path ran on the JAX side
    for name in ("qmatmul", "gathered_ffn", "grouped_ffn", "dense_ffn",
                 "mla_fused"):
        assert calls.get(name, 0) > 0, name
    logits, toks = _port_run(port_params, tokens)
    for step, (a, b) in enumerate(zip(logits, ref_logits)):
        err = np.abs(a - b).max() / np.abs(b).max()
        assert err <= LOGIT_TOL, (step, err)
    assert toks == ref_toks


def _max_rel(xs, refs):
    return max(float(np.abs(a - b).max() / np.abs(b).max())
               for a, b in zip(xs, refs))


def test_jax_self_sensitivity_bounds_tolerance(jax_interpret_kernels):
    """The JAX forward moves by a comparable amount when its embedding
    moves by one float32 ulp: LOGIT_TOL is within twice that spread, so it
    admits rounding-order noise and nothing an order larger."""
    spec, params = _jax_params()
    tokens = np.random.default_rng(7).integers(
        0, SMALL["vocab_size"], (1, PROMPT_LEN)).astype(np.int32)
    ref, _ = _jax_run(spec, params, tokens)
    nudged = dict(params)
    e = np.asarray(params["embed"])
    nudged["embed"] = jnp.asarray(np.nextafter(e, np.inf).astype(np.float32))
    out, _ = _jax_run(spec, nudged, tokens)
    assert LOGIT_TOL <= 2 * _max_rel(out, ref)


def test_generator_generate_matches_jax(carried):
    _, tokens, port_params, _, ref_toks = carried
    spec = t_spec_from_hf_config(SMALL)
    gen = Generator(port_params, spec, max_len=MAX_LEN, device="cpu",
                    cache_dtype=torch.float32, compute_dtype=torch.float32)
    out = gen.generate(tokens.tolist(), GenerateConfig(
        max_new_tokens=DECODE_STEPS + 1, prefill_chunk=PROMPT_LEN))
    assert out == [ref_toks]


def _jax_dense_mlp_route(gu, dn, rows):
    """The route the JAX package's Pallas hooks (ops/pallas/__init__.py)
    give a dense GLU MLP: the dense FFN kernel, the gathered FFN kernel
    over the weights as one expert, or None (two dense W4A8 matmuls)."""
    from ktransformers_tpu.ops.pallas import w4a8_matmul as wm

    if rows <= 4096 and wm.dense_ffn_plan(gu, dn, "silu", None) is not None:
        return "dense"
    lift = lambda q: dataclasses.replace(  # noqa: E731
        q, data=q.data[None], scales=q.scales[None])
    if rows <= 128 and wm.ffn_fits(lift(gu), lift(dn), "silu", None,
                                   rows=rows):
        return "gathered"
    return None


@pytest.mark.parametrize("hidden, inter, rows", [
    (2048, 10944, 1),    # DeepSeek-V2-Lite layer 0, decode
    (2048, 10944, 256),  # ... prefill chunk
    (2048, 1408 * 2, 1),  # its two shared experts, decode
    (2048, 1408 * 2, 256),
    (256, 480, 1),       # down group 96, no chunk plan: gathered
    (256, 480, 136),     # ... too many rows for it: two matmuls
    (256, 512, 136),
    (256, 512, 5000),    # past the dense kernel's row limit
])
def test_dense_mlp_route_matches_jax(hidden, inter, rows):
    """The port takes the fused FFN kernel for a dense MLP exactly where
    the JAX package takes one of its fused FFN kernels (shapes only: the weights live on the meta
    device and as unallocated numpy arrays)."""
    from ktransformers_tpu.quant.formats import QTensor as JQ
    from ktransformers_tpu.quant.formats import effective_group_size
    from ktransformers_tpu_torch.ops.cuda.w4a8_ffn import dense_mlp_fused
    from ktransformers_tpu_torch.quant.formats import QTensor as TQ

    def pair(k, n):
        gs = effective_group_size(k, 128)
        d, s = (k // 2, n), (k // gs, n)
        j = JQ(np.empty(d, np.int8), np.empty(s, np.float32), None,
               kind="int4_g", group_size=gs, act_quant=True)
        t = TQ(torch.empty(d, dtype=torch.int8, device="meta"),
               torch.empty(s, device="meta"), None, kind="int4_g",
               group_size=gs, act_quant=True)
        return j, t

    (jgu, tgu), (jdn, tdn) = pair(hidden, 2 * inter), pair(inter, hidden)
    want = _jax_dense_mlp_route(jgu, jdn, rows)
    assert dense_mlp_fused(tgu, tdn, "silu", None, rows) == (want is not None)
    if (hidden, inter) == (2048, 10944):
        assert want is None  # the layer-0 MLP of DeepSeek-V2-Lite


@pytest.mark.parametrize("rows", [1, 136])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dense_mlp_matches_jax_where_fused_ffn_is_refused(
        jax_interpret_kernels, rows, dtype):
    """The dense MLP at I = 480 with down group 96, where the JAX package
    has no dense FFN chunk plan (as for DeepSeek-V2-Lite's layer 0): there
    one row takes the gathered FFN kernel (the port: its dense FFN, the
    same function), 136 rows two W4A8 matmuls with the gate_up output and
    the GLU rounded to the compute dtype.

    Tolerance, in both dtypes: the mean |error| within 1e-3 of the mean
    |output|, and the largest within 1e-2 of the largest |output| (an int8
    activation code that float32 summation order moved by one step). On
    the same route the two packages differ by rounding alone (mean at most
    6e-4 in bf16 over eight seeds); the fused FFN taken in place of the two
    matmuls keeps the GLU in float32 and is off by 1.4e-2 or more in bf16."""
    from ktransformers_tpu.models import model as jmodel
    from ktransformers_tpu.models.spec import spec_from_hf_config
    from ktransformers_tpu.quant.formats import quantize as jq
    from ktransformers_tpu.quant.w4a8 import repack_offset_lo as jr

    cfg = dict(SMALL, intermediate_size=480)
    rng = np.random.default_rng(rows)

    def w(shape):
        q = jr(jq(jnp.asarray(rng.standard_normal(shape).astype(np.float32)
                              * 0.05), "int4_g", group_size=128))
        return q, qtensor_from_jax(jax.device_get(q), "cpu")

    (jgu, tgu), (jdn, tdn) = w((256, 960)), w((480, 256))
    assert tdn.group_size == 96
    x = rng.standard_normal((rows, 256)).astype(np.float32)
    ref = np.asarray(jmodel._dense_mlp(
        {"gate_up": jgu, "down": jdn}, spec_from_hf_config(cfg),
        jnp.asarray(x, dtype)).astype(jnp.float32))
    assert jax_interpret_kernels == (
        {"gathered_ffn": 1} if rows == 1 else {"qmatmul": 2})
    out = tmodel._dense_mlp(
        {"gate_up": tgu, "down": tdn}, t_spec_from_hf_config(cfg),
        torch.from_numpy(x).to(getattr(torch, dtype))).float().numpy()
    err = np.abs(out - ref)
    assert err.mean() <= 1e-3 * np.abs(ref).mean()
    assert err.max() <= 1e-2 * np.abs(ref).max()


def test_two_generators_from_one_params_tree():
    """prepare_params works on the caller's tree in place; a second
    Generator over the same tree finds it prepared and leaves it so."""
    from ktransformers_tpu_torch.models.init import init_params_synthetic

    spec = t_spec_from_hf_config(SMALL)
    params = init_params_synthetic(spec, seed=1, dtype=torch.float32,
                                   device="cpu")
    toks = np.random.default_rng(2).integers(
        0, SMALL["vocab_size"], PROMPT_LEN).tolist()
    cfg = GenerateConfig(max_new_tokens=3, prefill_chunk=PROMPT_LEN)
    outs = []
    for _ in range(2):
        gen = Generator(params, spec, max_len=MAX_LEN, device="cpu",
                        cache_dtype=torch.float32,
                        compute_dtype=torch.float32)
        outs.append(gen.generate(toks, cfg))
        qkv = gen.params["layers"][0]["attn"]["qkv_a"]
        assert qkv.act_quant and qkv.data.dtype == torch.int8
        assert params["layers"][0]["attn"]["qkv_a"] is qkv
    assert outs[0] == outs[1]
