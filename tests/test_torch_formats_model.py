"""The port's DeepSeek-V2 forward, Generator and ServeEngine on weight
formats other than W4A8, against the JAX package.

The 3-layer narrow spec of test_torch_model.py (layer 0 dense, layers 1-2
MoE with shared experts) with every weight in one format: int8, fp8,
int4_gz (not repacked: both packages under KT_W4A8=0) and mxfp4. Weights
are made by the JAX package's init_params (numpy seed, real quantization),
prepared by its prepare_params, and carried across with
convert.params_from_jax. The JAX side runs its Pallas kernels in interpret
mode through the hooks of ops/pallas.enable(); the port runs the plain
versions. Both compute in float32.

Tolerance: without an activation requant the two sides differ by float32
summation order alone, so every logits row is held within 2e-4 of its
largest logit (the W4A8 path needs 5e-2) and greedy tokens are equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ktransformers_tpu_torch.convert import params_from_jax
from ktransformers_tpu_torch.engine.generate import GenerateConfig, Generator
from ktransformers_tpu_torch.models.spec import spec_from_hf_config
from ktransformers_tpu_torch.ops import attention as tattention
from ktransformers_tpu_torch.ops.cuda import LAUNCHES
from ktransformers_tpu_torch.serving import SchedulerConfig, ServeEngine
from tests.test_torch_model import (
    DECODE_STEPS,
    MAX_LEN,
    PROMPT_LEN,
    SMALL,
    _jax_run,
    _port_run,
    jax_interpret_hooks,
    one_torch_thread,  # noqa: F401 (a fixture)
)

SPEC = spec_from_hf_config(SMALL)
FORMAT_TOL = 2e-4
F32 = dict(cache_dtype=torch.float32, compute_dtype=torch.float32,
           device="cpu")


def _jax_params(kind: str):
    from ktransformers_tpu.models.init import init_params
    from ktransformers_tpu.models.spec import spec_from_hf_config as jspec
    from ktransformers_tpu.utils.device_prep import prepare_params

    spec = jspec(SMALL)
    params = init_params(spec, seed=11, quant=kind, moe_quant=kind)
    return spec, prepare_params(params, True, spec)


def _tokens():
    return np.random.default_rng(7).integers(
        0, SMALL["vocab_size"], (1, PROMPT_LEN)).astype(np.int32)


@pytest.fixture
def no_w4a8(monkeypatch):
    """KT_W4A8=0: the switch both packages read in prepare_params."""
    monkeypatch.setenv("KT_W4A8", "0")


@pytest.mark.parametrize("kind", ["int8", "fp8", "int4_gz", "mxfp4"])
def test_forward_matches_jax_per_format(kind, no_w4a8):
    with jax_interpret_hooks() as calls:
        jspec, jparams = _jax_params(kind)
        tokens = _tokens()
        ref_logits, ref_toks = _jax_run(jspec, jparams, tokens)
    # the JAX side went through the three quant_matmul kernels and the
    # fused decode, and through no W4A8 FFN kernel
    for name in ("qmatmul", "gather", "gmm", "mla_fused"):
        assert calls.get(name, 0) > 0, (name, calls)
    assert not any(n in calls for n in ("gathered_ffn", "grouped_ffn",
                                        "dense_ffn", "mla_decode"))
    params = params_from_jax(jax.device_get(jparams), SPEC, "cpu")
    assert params["layers"][0]["attn"]["qkv_a"].kind == kind
    assert not params["layers"][1]["moe"]["experts"].gate_up.act_quant
    logits, toks = _port_run(params, tokens)
    for step, (a, b) in enumerate(zip(logits, ref_logits)):
        err = np.abs(a - b).max() / np.abs(b).max()
        assert err <= FORMAT_TOL, (kind, step, err)
    assert toks == ref_toks


@pytest.fixture
def fused_off(monkeypatch):
    monkeypatch.setattr(tattention, "MLA_FUSED", False)


def test_unfused_decode_matches_jax_and_fused(no_w4a8, monkeypatch):
    """With the fused decode switched off, single-token decode norms,
    ropes, writes the cache row and runs mla_decode with lengths + 1: held
    to the JAX package without its fused hook (its mla_decode_attention in
    interpret mode), and equal in tokens to the port's fused route."""
    with jax_interpret_hooks(mla_fused=False) as calls:
        jspec, jparams = _jax_params("int8")
        tokens = _tokens()
        ref_logits, ref_toks = _jax_run(jspec, jparams, tokens)
    assert calls.get("mla_decode", 0) == DECODE_STEPS * 3
    assert "mla_fused" not in calls
    params = params_from_jax(jax.device_get(jparams), SPEC, "cpu")
    fused_logits, fused_toks = _port_run(params, tokens)
    monkeypatch.setattr(tattention, "MLA_FUSED", False)
    logits, toks = _port_run(params, tokens)
    for step, (a, b, c) in enumerate(zip(logits, ref_logits, fused_logits)):
        assert np.abs(a - b).max() <= FORMAT_TOL * np.abs(b).max(), step
        assert np.abs(a - c).max() <= FORMAT_TOL * np.abs(c).max(), step
    assert step == DECODE_STEPS
    assert toks == ref_toks == fused_toks


def test_rope_rotation_only_on_the_fused_route(monkeypatch):
    """forward() builds the rope rotation matrix only when the fused route
    is on, as the JAX package does."""
    from ktransformers_tpu_torch.models import model as tmodel
    from ktransformers_tpu_torch.models.init import init_params_synthetic
    from ktransformers_tpu_torch.utils.device_prep import prepare_params

    params = prepare_params(init_params_synthetic(
        SPEC, seed=2, quant="int8", dtype=torch.float32, device="cpu"), SPEC)
    built = []
    real = tmodel.rope_rotation_matrix
    monkeypatch.setattr(tmodel, "rope_rotation_matrix",
                        lambda *a: built.append(1) or real(*a))
    for fused, want in ((True, 1), (False, 0)):
        monkeypatch.setattr(tattention, "MLA_FUSED", fused)
        built.clear()
        cache = tmodel.KVCache.create(SPEC, 1, MAX_LEN, torch.float32, "cpu")
        tmodel.forward(params, SPEC, torch.tensor([[1, 2, 3]]), cache,
                       compute_dtype=torch.float32)
        assert not built  # a prefill never builds it
        tmodel.forward(params, SPEC, torch.tensor([[4]]), cache,
                       compute_dtype=torch.float32)
        assert len(built) == want


@pytest.mark.parametrize("kind", ["int8", "fp8", "int4", "int4_g", "int4_gz",
                                  "int8_g", "mxfp4", "mxfp8"])
def test_synthetic_params_of_every_kind_generate(kind, no_w4a8):
    """init_params_synthetic accepts every kind, its codes are valid (no
    NaN byte, exponents near 127, zero points in [-8, 7]) and a Generator
    runs on them; routed experts stay on a kernel kind (int8_g has none)."""
    from ktransformers_tpu_torch.models.init import init_params_synthetic
    from ktransformers_tpu_torch.quant.formats import dequantize

    moe_kind = "int8" if kind == "int8_g" else kind
    params = init_params_synthetic(SPEC, seed=3, quant=kind,
                                   moe_quant=moe_kind, dtype=torch.float32,
                                   device="cpu")
    q = params["layers"][0]["attn"]["q_proj"]
    assert q.kind == kind
    w = dequantize(q, torch.float32)
    assert bool(torch.isfinite(w).all())
    assert 0.3 < float(w.std()) * SMALL["hidden_size"] ** 0.5 < 2.0
    if kind.startswith("mx"):
        assert q.scales.dtype == torch.uint8
        assert 100 < int(q.scales.min()) <= int(q.scales.max()) < 130
    if kind == "int4_gz":
        assert -8 <= float(q.zeros.min()) <= float(q.zeros.max()) <= 7
    gen = Generator(params, SPEC, max_len=MAX_LEN, **F32)
    out = gen.generate(_tokens()[0].tolist(), GenerateConfig(
        max_new_tokens=3, prefill_chunk=PROMPT_LEN))
    assert len(out[0]) == 3 and all(0 <= t < SMALL["vocab_size"]
                                    for t in out[0])


def test_int4_gz_needs_the_w4a8_switch_off():
    """With the repack on (the default) int4_gz weights no longer need
    KT_W4A8=0: the engine repacks them for the W4A8 kernels (their zero
    term), zero points kept, and generates on them."""
    from ktransformers_tpu_torch.models.init import init_params_synthetic

    params = init_params_synthetic(SPEC, seed=3, quant="int4_gz",
                                   dtype=torch.float32, device="cpu")
    gen = Generator(params, SPEC, max_len=MAX_LEN, **F32)
    qkv = gen.params["layers"][0]["attn"]["qkv_a"]
    assert qkv.kind == "int4_gz" and qkv.act_quant
    assert qkv.zeros is not None and qkv.data.dtype == torch.int8
    out = gen.generate(_tokens()[0].tolist(), GenerateConfig(
        max_new_tokens=3, prefill_chunk=PROMPT_LEN))
    assert len(out[0]) == 3 and all(0 <= t < SMALL["vocab_size"]
                                    for t in out[0])


# ------------------------------------------------------------- the engine

_PROMPT_RNG = np.random.default_rng(5)
PROMPTS = [_PROMPT_RNG.integers(0, 512, n).tolist() for n in (7, 17, 5)]
SCHED = dict(max_batch_size=4, prefill_chunk=8, page_size=8,
             max_pages_per_query=8)


def _serve(eng):
    qs = [eng.submit(p, max_new_tokens=7) for p in PROMPTS[:2]]
    eng.step()
    eng.step()
    qs.append(eng.submit(PROMPTS[2], max_new_tokens=7))
    for _ in range(3000):
        if all(q.state == "done" for q in qs):
            break
        eng.step()
    assert all(q.finish_reason == "length" for q in qs)
    return [list(q.output_ids) for q in qs]


def test_serve_engine_on_int8_matches_generator_and_jax_engine():
    """Continuous batching on int8 weights gives the single-user output
    (fused decode on and off), and the port's engine the JAX engine's, on
    the same prompts and submit order (the third prompt joins after two
    steps, so mixed steps run)."""
    from ktransformers_tpu.models import paged as jpaged
    from ktransformers_tpu.ops.pallas import paged_attention as jpa
    from ktransformers_tpu.serving.engine import ServeEngine as JEngine
    from ktransformers_tpu.serving.scheduler import SchedulerConfig as JCfg

    old = (jpaged._PAGED_MLA_DECODE, jpaged._PAGED_GQA_DECODE,
           jpaged._PAGED_MLA_PREFILL, jpaged._PAGED_GQA_PREFILL)
    interp = lambda fn: lambda *a, **kw: fn(*a, **kw, interpret=True)  # noqa: E731
    with jax_interpret_hooks() as calls:
        jpaged.set_pallas_paged_decode(interp(jpa.mla_paged_decode), old[1])
        jpaged.set_pallas_paged_prefill(interp(jpa.mla_paged_prefill), old[3])
        try:
            jspec, jparams = _jax_params("int8")
            ref = _serve(JEngine(jparams, jspec, JCfg(**SCHED), num_pages=64,
                                 cache_dtype=jnp.float32,
                                 compute_dtype=jnp.float32))
        finally:
            jpaged.set_pallas_paged_decode(old[0], old[1])
            jpaged.set_pallas_paged_prefill(old[2], old[3])
    assert calls.get("gather", 0) > 0 and calls.get("gmm", 0) > 0
    params = params_from_jax(jax.device_get(jparams), SPEC, "cpu")
    eng = ServeEngine(params, SPEC, SchedulerConfig(**SCHED), num_pages=64,
                      **F32)
    got = _serve(eng)
    assert eng.mixed_steps_fused >= 1
    assert got == ref
    for fused in (True, False):
        tattention.MLA_FUSED = fused
        try:
            gen = Generator(params, SPEC, max_len=96, **F32)
            single = [gen.generate(p, GenerateConfig(
                max_new_tokens=7, prefill_chunk=8))[0] for p in PROMPTS]
        finally:
            tattention.MLA_FUSED = True
        assert got == single, fused


def test_cpu_runs_count_no_launch():
    """The launch counters move only where a kernel launches: a CPU run
    of every new wrapper leaves them at zero."""
    from ktransformers_tpu_torch.models.init import init_params_synthetic
    from ktransformers_tpu_torch.ops.cuda import reset_launches

    reset_launches()
    params = init_params_synthetic(SPEC, seed=4, quant="int8",
                                   dtype=torch.float32, device="cpu")
    tattention.MLA_FUSED = False
    try:
        Generator(params, SPEC, max_len=MAX_LEN, **F32).generate(
            _tokens()[0].tolist(), GenerateConfig(max_new_tokens=2,
                                                  prefill_chunk=PROMPT_LEN))
    finally:
        tattention.MLA_FUSED = True
    assert set(LAUNCHES) >= {"quant_matmul", "gathered_quant_matmul",
                             "grouped_quant_matmul", "mla_decode_attention"}
    assert not any(LAUNCHES.values())
