"""Continuous batching with host-resident routed experts
(ktransformers_tpu_torch/offload/paged_engine.py): the HostOffloadServeEngine
against the port's resident ServeEngine and against the JAX package's
HostOffloadServeEngine, on weights the JAX package's init_params draws
(carried across by convert.params_from_jax), on the CPU.

Tolerances: against the resident engine (KT_W4A8=0 on both sides, float32
hops) the same greedy tokens; against the JAX engine the logits of a
prefill chunk and of a decode step within 1e-4 with float32 hops, and the
same greedy tokens with bf16 hops.
"""

import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ktransformers_tpu_torch.convert import params_from_jax
from ktransformers_tpu_torch.engine.sampler import SamplingConfig
from ktransformers_tpu_torch.models.paged import forward_paged
from ktransformers_tpu_torch.models.spec import spec_from_hf_config
from ktransformers_tpu_torch.offload import HostOffloadServeEngine
from ktransformers_tpu_torch.serving import SchedulerConfig, ServeEngine

from tests.test_torch_model import one_torch_thread  # noqa: F401 (a fixture)
from tests.test_torch_offload import (
    TINY_DS,
    TINY_QWEN3,
    _jax_host_moe,
    bf16_absorbed,
)

F32 = dict(cache_dtype=torch.float32, compute_dtype=torch.float32,
           device="cpu")


@pytest.fixture(scope="module", autouse=True)
def gxx():
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed: the host expert FFN cannot be "
                    "built")


@pytest.fixture(autouse=True)
def no_w4a8(monkeypatch):
    """KT_W4A8=0 on both packages: int4_g runs un-repacked everywhere."""
    monkeypatch.setenv("KT_W4A8", "0")


def _cfg():
    return SchedulerConfig(max_batch_size=2, prefill_chunk=8, page_size=8,
                           max_pages_per_query=8)


def _draw(cfg=TINY_DS):
    from ktransformers_tpu.models.init import init_params
    from ktransformers_tpu.models.spec import spec_from_hf_config as jspec

    js = jspec(dict(cfg))
    jp = jax.device_get(init_params(js, seed=0, quant="bf16",
                                    moe_quant="int4_g", group_size=32))
    return js, jp, spec_from_hf_config(dict(cfg))


def _engines(cfg=TINY_DS, transfer_dtype=None):
    _, jp, spec = _draw(cfg)
    resident = ServeEngine(params_from_jax(jp, spec, "cpu"), spec, _cfg(),
                           num_pages=48, **F32)
    offload = HostOffloadServeEngine(params_from_jax(jp, spec, "cpu"), spec,
                                     _cfg(), num_pages=48,
                                     transfer_dtype=transfer_dtype, **F32)
    return resident, offload


@pytest.mark.parametrize("cfg", [TINY_DS, TINY_QWEN3],
                         ids=["deepseek_v2", "qwen3_moe"])
def test_offload_serving_matches_resident(cfg):
    """Greedy generation through the scheduler: the offloaded engine (MLA
    or GQA pools) == the resident engine, token for token."""
    resident, offload = _engines(cfg)
    assert offload.decode_pipeline_depth == 1
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, 128, 12).tolist() for _ in range(2)]
    want = [resident.generate_sync(p, max_new_tokens=6) for p in prompts]
    got = [offload.generate_sync(p, max_new_tokens=6) for p in prompts]
    assert got == want


def test_offload_continuous_batching():
    """A query submitted mid-decode of another, and a third sharing the
    first one's prefix (a prefix-cache hit), keep the resident tokens;
    the mixed batch takes the fused mixed step (one host hop a layer for
    the decode rows and the chunk), and every page comes back."""
    resident, offload = _engines()
    rng = np.random.default_rng(5)
    p1 = rng.integers(0, 128, 10).tolist()
    p2 = rng.integers(0, 128, 7).tolist()
    p3 = p1[:8] + rng.integers(0, 128, 5).tolist()
    want = [resident.generate_sync(p1, max_new_tokens=8),
            resident.generate_sync(p2, max_new_tokens=5)]
    q1 = offload.submit(p1, max_new_tokens=8)
    while len(q1.output_ids) < 2:
        offload.step()
    q2 = offload.submit(p2, max_new_tokens=5)
    while not (q1.state == "done" and q2.state == "done"):
        if not offload.step():
            break
    assert [list(q1.output_ids), list(q2.output_ids)] == want
    assert offload.mixed_steps_fused >= 1
    q3 = offload.submit(p3, max_new_tokens=4)
    while q3.state != "done":
        offload.step()
    assert q3.matched_len == 8
    assert list(q3.output_ids) == resident.generate_sync(p3,
                                                         max_new_tokens=4)
    held = offload.prefix.stats()["nodes"]
    assert offload.alloc.free_count + held == 47


def test_offload_serving_sampling_params():
    """Penalized temperature sampling runs through the inherited sampler."""
    _, offload = _engines()
    p = np.random.default_rng(7).integers(0, 128, 8).tolist()
    out = offload.generate_sync(p, max_new_tokens=6, sampling=SamplingConfig(
        temperature=0.8, top_k=4, repetition_penalty=1.3))
    assert len(out) == 6 and all(0 <= t < 128 for t in out)


@pytest.mark.parametrize("transfer", [None, "bf16"])
def test_offload_engine_matches_jax(transfer):
    """The port's HostOffloadServeEngine against the JAX package's on the
    same weights (the JAX absorbed mats rounded to bf16, as the port's
    prepare_params stores them): with float32 hops the logits of a
    12-token chunk (bucket 16) and of the decode step after it, the
    engine's model step (forward_paged over its HostExperts), within 1e-4
    on fresh pools; with bf16 hops (the engines' default) the same greedy
    tokens."""
    from ktransformers_tpu.offload.paged_engine import (
        HostOffloadServeEngine as JEngine,
    )
    from ktransformers_tpu.serving.scheduler import (
        SchedulerConfig as JConfig,
    )

    _jax_host_moe()
    js, jp, spec = _draw()
    jcfg = JConfig(max_batch_size=2, prefill_chunk=8, page_size=8,
                   max_pages_per_query=8)
    jtd = None if transfer is None else jnp.bfloat16
    jeng = JEngine(bf16_absorbed(jp), js, jcfg, num_pages=48,
                   cache_dtype=jnp.float32, compute_dtype=jnp.float32,
                   transfer_dtype=jtd)
    eng = HostOffloadServeEngine(
        params_from_jax(jp, spec, "cpu"), spec, _cfg(), num_pages=48,
        transfer_dtype=None if transfer is None else torch.bfloat16, **F32)
    rng = np.random.default_rng(11)
    if transfer is not None:
        prompts = [rng.integers(0, 128, n).tolist() for n in (12, 9)]
        for p in prompts:
            assert eng.generate_sync(p, max_new_tokens=6) == \
                jeng.generate_sync(p, max_new_tokens=6)
        return
    tokens = np.zeros((1, 16), np.int32)
    tokens[0, :12] = rng.integers(0, 128, 12)
    table = np.arange(1, 9, dtype=np.int32)[None]
    jl = jeng._run_forward(jnp.asarray(tokens), jnp.asarray(table),
                           jnp.asarray([0], jnp.int32),
                           jnp.asarray([12], jnp.int32))

    def step(toks, pos, valid=None):
        logits, _ = forward_paged(
            eng.params, eng.spec, torch.from_numpy(toks).long(), eng.kv,
            torch.from_numpy(table), torch.tensor([pos], dtype=torch.int32),
            valid=valid, **eng._forward_args())
        return logits

    tl = step(tokens, 0, torch.tensor([12], dtype=torch.int32))
    nxt = np.asarray(jl)[:, 0].argmax(-1).astype(np.int32)
    jd = jeng._run_forward(jnp.asarray(nxt)[:, None], jnp.asarray(table),
                           jnp.asarray([12], jnp.int32), None)
    td = step(nxt[:, None], 12)
    for got, want in ((tl, jl), (td, jd)):
        want = np.asarray(want)
        err = np.abs(got.numpy() - want).max() / np.abs(want).max()
        assert err <= 1e-4, err


def test_offload_refusals():
    """A sparse retrieval the attention does not take raises (offloaded as
    resident; the sparse budget itself is served,
    tests/test_torch_sparse_attention.py), and a hybrid spec raises before
    any weight moves."""
    from tests.test_torch_offload import _refusal_cases

    _, jp, spec = _draw()
    with pytest.raises(ValueError, match="kvhead"):
        HostOffloadServeEngine(params_from_jax(jp, spec, "cpu"), spec,
                               _cfg(), sparse_budget=8,
                               sparse_retrieval="kvhead", **F32)
    cfg, what = _refusal_cases()["hybrid"]
    with pytest.raises(ValueError, match=what):
        HostOffloadServeEngine({"layers": []}, spec_from_hf_config(dict(cfg)),
                               _cfg(), **F32)
