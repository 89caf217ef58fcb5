"""The port's ServeEngine on the CPU: continuous batching against the
single-user Generator and the JAX engine, and the engine's scheduling
behaviour (prefix reuse on pages written in place, sampling and EOS,
decode progress under a long prefill, preemption under page exhaustion,
top-k and penalties, cancel, the request log, the stage timer, fused mixed
steps, pipeline depth, the three-tier prefix cache).

Split from tests/test_torch_serving.py (the paged forward against the JAX
package and against the contiguous one), whose fixtures and helpers these
tests use: ``both`` (the JAX params with the Pallas hooks in interpret
mode, carried across), ``synth`` (the port's own synthetic W4A8 params on
the 3-layer SMALL DeepSeek-V2 spec), ``dense`` (unquantized float32
weights) and the scheduler settings ``SCHED``. Engines that chunk alike
agree token for token; the tolerances are that module's.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ktransformers_tpu_torch.cache.tiers import HostDiskTier
from ktransformers_tpu_torch.engine.generate import GenerateConfig, Generator
from ktransformers_tpu_torch.engine.sampler import SamplingConfig
from ktransformers_tpu_torch.serving import SchedulerConfig, ServeEngine
from ktransformers_tpu_torch.utils.observability import (
    StageTimer,
    check_numerics,
)

from tests.test_torch_model import one_torch_thread  # noqa: F401
from tests.test_torch_serving import (  # noqa: F401 (fixtures)
    DENSE_SPEC,
    F32,
    PROMPTS,
    SCHED,
    SPEC,
    VOCAB,
    _engine,
    _run,
    both,
    dense,
    synth,
)


def test_serving_mixed_sampling_and_eos(synth):
    eng = _engine(synth)
    free = eng.generate_sync(list(range(6)), max_new_tokens=10)
    k, eos = next((i, t) for i, t in enumerate(free) if t not in free[:i])
    out = eng.generate_sync(list(range(6)), max_new_tokens=10,
                            eos_token_id=eos)
    assert out == free[: k + 1] and out[-1] == eos
    q = eng.submit(list(range(6)), max_new_tokens=5,
                   sampling=SamplingConfig(temperature=0.8, top_p=0.9))
    _run(eng, [q])
    assert len(q.output_ids) == 5
    assert all(0 <= t < VOCAB for t in q.output_ids)


def test_decode_not_blocked_by_long_prefill(synth):
    eng = _engine(synth, prefix=False, max_pages_per_query=16)
    qa = eng.submit(list(range(6)), max_new_tokens=30)
    while not qa.output_ids:
        eng.step()
    qb = eng.submit([i % 90 for i in range(80)], max_new_tokens=2)
    during = 0
    while qb.state in ("received", "prefill") and qa.state == "decode":
        before = len(qa.output_ids)
        eng.step()
        during += len(qa.output_ids) - before
    assert during >= 8, during
    _run(eng, [qa, qb])
    assert len(qa.output_ids) == 30 and len(qb.output_ids) == 2


def test_page_exhaustion_preempts_and_completes(synth):
    prompts = [list(range(10 + i, 20 + i)) for i in range(4)]
    eng = _engine(synth, num_pages=14, prefix=False, max_pages_per_query=16)
    qs = [eng.submit(p, max_new_tokens=25) for p in prompts]
    _run(eng, qs)
    assert all(len(q.output_ids) == 25 for q in qs)
    assert sum(q.preemptions for q in qs) >= 1  # pressure actually hit
    eng2 = _engine(synth, prefix=False, max_pages_per_query=16)
    for q, p in zip(qs, prompts):
        assert q.output_ids == eng2.generate_sync(p, max_new_tokens=25)
    assert eng.alloc.free_count == 13


def test_serving_honors_topk_and_penalties(synth):
    eng = _engine(synth, prefix=False)
    prompt = list(range(6))
    greedy = eng.generate_sync(prompt, max_new_tokens=8)
    topk1 = eng.generate_sync(
        prompt, max_new_tokens=8,
        sampling=SamplingConfig(temperature=5.0, top_k=1))
    assert topk1 == greedy
    long_greedy = eng.generate_sync(prompt, max_new_tokens=16)
    assert len(set(long_greedy)) < len(long_greedy)  # greedy repeats here
    pen = SamplingConfig(frequency_penalty=1e4)
    q = eng.submit(prompt, max_new_tokens=16, sampling=pen)
    _run(eng, [q])
    assert len(set(q.output_ids)) == len(q.output_ids), q.output_ids
    # mixed batch: the default query is unaffected by its neighbour
    qa = eng.submit(prompt, max_new_tokens=12)
    qb = eng.submit(prompt, max_new_tokens=12, sampling=pen)
    _run(eng, [qa, qb])
    assert qa.output_ids == long_greedy[:12]
    assert len(set(qb.output_ids)) == len(qb.output_ids)
    assert qb.output_ids == q.output_ids[:12]


@pytest.mark.parametrize("cache_dtype", [torch.float32, torch.bfloat16])
def test_three_tier_prefix_cache(synth, tmp_path, cache_dtype):
    """Evicted prefix pages spill to host / disk and are restored on the
    next matching query with identical output (bfloat16 pages travel as
    their bits)."""
    spill = HostDiskTier(max_host_bytes=1 << 14,
                         disk_dir=str(tmp_path / "kv"))
    eng = ServeEngine(synth, SPEC,
                      SchedulerConfig(**{**SCHED, "max_batch_size": 2}),
                      num_pages=16, spill_tier=spill,
                      **{**F32, "cache_dtype": cache_dtype})
    p1 = list(range(24))  # 3 pages
    out1 = eng.generate_sync(p1, max_new_tokens=4)
    for start in (100, 200, 300):
        eng.generate_sync(list(range(start, start + 24)), max_new_tokens=4)
        eng.prefix.trim(14)
    assert spill.stats["spilled"] >= 1
    out1b = eng.generate_sync(p1, max_new_tokens=4)
    assert out1b == out1
    assert spill.stats["host_hits"] + spill.stats["disk_hits"] >= 1
    assert spill.stats["disk_hits"] >= 1


def test_serve_engine_matches_generator_and_jax_engine(both):
    """The invariant: continuous batching gives the single-user output, and
    the port's engine the JAX engine's, on the same prompts and submit
    order (the third prompt joins after two steps, so mixed steps run)."""
    from ktransformers_tpu.serving.engine import ServeEngine as JEngine
    from ktransformers_tpu.serving.scheduler import SchedulerConfig as JCfg

    def serve(eng):
        qs = [eng.submit(p, max_new_tokens=7) for p in PROMPTS[:2]]
        eng.step()
        eng.step()
        qs.append(eng.submit(PROMPTS[2], max_new_tokens=7))
        _run(eng, qs)
        assert all(q.finish_reason == "length" for q in qs)
        return [list(q.output_ids) for q in qs]

    ref = serve(JEngine(both.jparams, both.jspec, JCfg(**SCHED), num_pages=64,
                        cache_dtype=jnp.float32, compute_dtype=jnp.float32))
    eng = ServeEngine(both.params, SPEC, SchedulerConfig(**SCHED),
                      num_pages=64, **F32)
    got = serve(eng)
    assert eng.mixed_steps_fused >= 1
    gen = Generator(both.params, SPEC, max_len=96, **F32)
    single = [gen.generate(p, GenerateConfig(max_new_tokens=7,
                                             prefill_chunk=8))[0]
              for p in PROMPTS]
    assert got == single
    assert got == ref


def test_serving_prefix_cache_reuse(synth):
    eng = _engine(synth)
    prompt = list(range(30))  # 3 full pages + tail
    out1 = eng.generate_sync(prompt, max_new_tokens=4)
    q2 = eng.submit(prompt, max_new_tokens=4)
    _run(eng, [q2])
    assert list(q2.output_ids) == out1
    assert q2.matched_len == 24  # 3 pages of 8 reused
    assert eng.prefix.hits >= 1


def test_shared_prefix_pages_stay_intact_under_in_place_writes(dense):
    """Two queries reuse the cached pages of a finished one at the same
    time, each continuing with its own suffix; the pools are written in
    place, so a write that strayed into a shared page would corrupt the
    other query. Outputs must equal the single-user ones (float32 weights:
    the engine chunks the prompt otherwise than the Generator)."""
    gen = Generator(dense, DENSE_SPEC, max_len=96, **F32)
    base = list(range(100, 124))  # 3 full pages
    pa, pb = base + [7, 8, 9], base + [300, 301]
    want = [gen.generate(p, GenerateConfig(max_new_tokens=6,
                                           prefill_chunk=8))[0]
            for p in (base + [5], pa, pb)]
    eng = _engine(dense, spec=DENSE_SPEC)
    first = eng.generate_sync(base + [5], max_new_tokens=6)
    qa = eng.submit(pa, max_new_tokens=6)
    qb = eng.submit(pb, max_new_tokens=6)
    _run(eng, [qa, qb])
    assert qa.matched_len == qb.matched_len == 24
    assert qa.pages == [] and eng.alloc.refcount(1) >= 1  # still cached
    assert [first, qa.output_ids, qb.output_ids] == want
    again = eng.generate_sync(base + [5], max_new_tokens=6)
    assert again == first


def test_cancel_mid_decode_frees_and_continues(synth):
    gen = Generator(synth, SPEC, max_len=96, **F32)
    p1, p2 = list(range(7)), list(range(20, 30))
    expected = gen.generate(p2, GenerateConfig(max_new_tokens=8))[0]
    eng = _engine(synth, max_batch_size=2)
    free0 = eng.alloc.free_count
    q1 = eng.submit(p1, max_new_tokens=32)
    q2 = eng.submit(p2, max_new_tokens=8)
    while len(q1.output_ids) < 3:
        eng.step()
    eng.cancel(q1)
    assert q1.state == "done" and q1.finish_reason == "cancelled"
    assert q1.slot is None and q1.pages == []
    _run(eng, [q2])
    assert not eng.step()
    assert list(q2.output_ids) == expected
    drained = []
    while not q1.out_queue.empty():
        drained.append(q1.out_queue.get_nowait())
    assert drained[-1] is None
    eng.prefix.trim(10**6)
    assert eng.alloc.free_count == free0


def test_request_log_export(synth, tmp_path, monkeypatch):
    log = tmp_path / "requests.jsonl"
    monkeypatch.setenv("KT_REQUEST_LOG", str(log))
    eng = _engine(synth, max_batch_size=2)
    eng.generate_sync(list(range(9)), max_new_tokens=4)
    eng.generate_sync(list(range(30, 36)), max_new_tokens=3)
    recs = [json.loads(line) for line in log.read_text().splitlines()]
    assert len(recs) == 2
    assert recs[0]["output_tokens"] == 4 and recs[1]["output_tokens"] == 3
    assert recs[0]["finish_reason"] == "length"
    assert recs[0]["ttft_s"] is not None
    m = eng.metrics()
    assert "p95_ttft_s" in m and "preemptions" in m
    assert m["queries_finished"] == 2 and m["engine_steps"] > 0
    eng.reset_metrics()
    assert eng.metrics()["queries_finished"] == 0


def test_stage_timer_and_numeric_guard(synth):
    eng = _engine(synth, num_pages=32, max_batch_size=2)
    eng.timer = StageTimer(enabled=True)
    eng.check_numerics = True
    eng.generate_sync(list(range(6)), max_new_tokens=4)
    rep = eng.timer.report()
    assert {"schedule", "dispatch", "readback"} <= set(rep)
    assert all(v["count"] > 0 for v in rep.values())
    with pytest.raises(FloatingPointError):
        check_numerics({"x": np.asarray([1.0, np.nan])}, "test")
    with pytest.raises(FloatingPointError, match=r"\['y'\]\[1\]"):
        check_numerics({"y": [torch.ones(2), torch.tensor([float("inf")])]})
    check_numerics({"ids": np.arange(3), "none": None})


def _staggered(params, n_late: int, **sched):
    """q1 decodes, then n_late queries arrive, so their prefill chunks ride
    along with q1's decode steps."""
    eng = _engine(params, num_pages=48, prefix=False, **sched)
    q1 = eng.submit(list(range(4, 14)), max_new_tokens=12)
    for _ in range(20):
        eng.step()
        if q1.state == "decode":
            break
    late = [list(range(20, 37)), list(range(40, 51))][:n_late]
    qs = [q1] + [eng.submit(p, max_new_tokens=6) for p in late]
    _run(eng, qs)
    return [list(q.output_ids) for q in qs], eng


@pytest.mark.parametrize("n_late", [1, 2])
def test_serving_fused_mixed_matches_unfused(synth, monkeypatch, n_late):
    sched = dict(max_batch_size=3, max_prefills_per_step=2)
    monkeypatch.setenv("KT_FUSED_MIXED", "1")
    fused, eng = _staggered(synth, n_late, **sched)
    assert eng.mixed_steps_fused >= 1
    monkeypatch.setenv("KT_FUSED_MIXED", "0")
    unfused, eng = _staggered(synth, n_late, **sched)
    assert eng.mixed_steps_fused == 0
    assert fused == unfused


def test_pipeline_depth_does_not_change_tokens(synth, monkeypatch):
    """With k steps in flight the device lengths run k ahead of the host's;
    a finished query decodes into its lookahead page and those tokens are
    dropped. Greedy output is the same at depth 1 and depth 3."""
    outs = []
    for depth in ("1", "3"):
        monkeypatch.setenv("KT_DECODE_PIPELINE", depth)
        eng = _engine(synth, prefix=False)
        assert eng.decode_pipeline_depth == int(depth)
        qs = [eng.submit(p, max_new_tokens=n)
              for p, n in zip(PROMPTS, (9, 17, 12))]
        _run(eng, qs)
        assert not eng.step() and not eng._inflight
        assert eng.alloc.free_count == 63
        outs.append([list(q.output_ids) for q in qs])
    assert outs[0] == outs[1]
    assert [len(o) for o in outs[0]] == [9, 17, 12]
