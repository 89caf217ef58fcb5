"""The compiled prefill and mixed steps (engine/cuda_graph.py): the
Generator's prefill chunks, the ServeEngine's prefill chunks and its fused
mixed step over static buffers, captured in CUDA graphs and replayed on
the card, run eagerly on the same buffers on the CPU; and moe_dispatch's
group sizes counted on the device.

CPU (one torch thread, the JAX forwards jitted by the JAX package):
- the Generator's prefill through its step buffers gives the JAX
  Generator's greedy tokens on the tiny float32 DeepSeek-V2-Lite (MLA),
  Mixtral (GQA) and Qwen3-Next (hybrid) models of
  tests/test_torch_graph_step.py, a 40-token prompt in chunks of 16 (two
  through the 16-token step, the tail of 8 eagerly on the same buffers),
  and prompts ending on every tail length keep that one step;
- the ServeEngine's tokens equal the JAX engine's and the single-user
  Generator's where two chunks of one bucket run in one step and where
  fused mixed steps run (MLA), and through the hybrid's prefill steps with
  their state slots; each query keeps its own logits;
- the static buffers keep their storage across chunks, steps and calls;
- under stubbed torch.cuda (no card here) a prefill step and a mixed step
  warm up, capture (the garbage collector off) and replay with their
  launch counts;
- moe_dispatch's group sizes equal torch.bincount's bit for bit, the
  masked id and empty experts included.

Card (marked ``cuda``, skipped here inside the ``cuda`` fixture; run them
with ``python -m pytest --noconftest -m cuda
tests/test_torch_graph_prefill.py`` on the card): a replayed prefill chunk
and a replayed mixed step equal their eager steps with equal launch
counts, and moe_forward at 256 tokens captures in a CUDA graph. This file
imports JAX only inside the CPU tests, so the card collects it.
"""

import gc

import numpy as np
import pytest
import torch

from ktransformers_tpu_torch.engine import cuda_graph
from ktransformers_tpu_torch.engine.generate import GenerateConfig, Generator
from ktransformers_tpu_torch.models.init import init_params_synthetic
from ktransformers_tpu_torch.models.spec import spec_from_hf_config
from ktransformers_tpu_torch.ops import cuda as kernels
from ktransformers_tpu_torch.ops.moe import moe_dispatch
from ktransformers_tpu_torch.serving import SchedulerConfig, ServeEngine

from test_torch_graph_step import (  # noqa: F401 (fixtures)
    CARD,
    GQA,
    MLA,
    _hybrid_cfg,
    _jax_pair,
    cuda,
    one_torch_thread,
    stub_cuda,
)

PROMPT, CHUNK, NEW = 40, 16, 8  # chunks of 16, 16 and 8 tokens
SCHED = dict(max_batch_size=4, prefill_chunk=16, page_size=8,
             max_pages_per_query=8, max_prefills_per_step=2)
F32 = dict(cache_dtype=torch.float32, compute_dtype=torch.float32,
           device="cpu")


@pytest.fixture(scope="module")
def pairs():
    """Each model's (JAX Generator, port Generator), made at first use."""
    made = {}

    def get(name):
        if name not in made:
            cfg = {"mla": MLA, "gqa": GQA}.get(name) or _hybrid_cfg()
            made[name] = _jax_pair(
                cfg, "init" if name == "hybrid" else "synthetic", batch=1)
        return made[name]

    return get


def _prompt(seed: int, n: int = PROMPT, vocab: int = 512) -> list:
    return np.random.default_rng(seed).integers(0, vocab, n).tolist()


@pytest.mark.parametrize("name", ["mla", "gqa", "hybrid"])
def test_chunked_prefill_matches_jax(pairs, name):
    """A 40-token prompt in chunks of 16: the port's prefill step of 16
    tokens (two chunks) and the tail of 8, run eagerly on the same
    buffers, give the JAX Generator's greedy tokens, twice."""
    jgen, gen = pairs(name)
    cfg = GenerateConfig(max_new_tokens=NEW, prefill_chunk=CHUNK)
    prompt = [_prompt(21)]
    want = jgen.generate(prompt, cfg)
    assert gen.generate(prompt, cfg) == want
    assert gen.generate(prompt, cfg) == want
    steps = {k[1]: s for k, s in gen._graphs._steps.items()
             if k[0] == "prefill"}
    assert list(steps) == [16] and steps[16].calls == 4
    assert not steps[16].capture
    assert sorted(gen.decode_state().chunks) == [16]


def test_prefill_buffers_keep_their_storage(pairs):
    """The chunk buffer, the logits buffer and the step cache (the
    hybrid's GatedDeltaNet states among its buffers): the same storage
    after every chunk (the eager tail's too) of two generate calls."""
    _, gen = pairs("hybrid")
    st = gen.decode_state()
    ptrs: dict = {}
    chunks = []
    orig = gen._prefill_state

    def watched(tokens):
        orig(tokens)
        chunks.append(tokens.shape[1])
        c = st.cache
        named = {"logits": st.logits, "lengths": c.lengths,
                 **{f"chunk{k}": t for k, t in st.chunks.items()},
                 **{f"a{i}": t for i, t in enumerate(c.bufs_a)},
                 **{f"b{i}": t for i, t in enumerate(c.bufs_b)}}
        for name, t in named.items():
            ptrs.setdefault(name, set()).add(t.data_ptr())

    gen._prefill_state = watched
    try:
        for seed in (22, 23):
            gen.generate([_prompt(seed)], GenerateConfig(
                max_new_tokens=2, prefill_chunk=CHUNK))
    finally:
        del gen._prefill_state
    assert chunks == [16, 16, 8] * 2
    assert {"chunk16", "a0", "b0"} <= set(ptrs)
    assert all(len(p) == 1 for p in ptrs.values())
    assert gen.decode_state().cache.lengths.tolist() == [PROMPT + 1]


def test_prefill_steps_stay_bounded(stub_cuda, monkeypatch):
    """Prompts ending on every tail length (17 to 63 tokens in chunks of
    16) with torch.cuda stubbed: the Generator keeps one prefill step,
    the chunk length's, captured once; every tail runs eagerly, so no
    graph (and no memory pool) is kept a length."""
    from ktransformers_tpu_torch.engine import generate

    monkeypatch.setattr(generate, "capture_allowed", lambda *a: True)
    spec = spec_from_hf_config(dict(MLA))
    params = init_params_synthetic(spec, seed=3, quant="bf16",
                                   dtype=torch.float32, device="cpu")
    gen = Generator(params, spec, max_len=96, **F32)
    tails = []
    orig = gen._prefill_state

    def watched(tokens):
        if tokens.shape[1] < CHUNK:
            tails.append(tokens.shape[1])
        orig(tokens)

    gen._prefill_state = watched
    cfg = GenerateConfig(prefill_chunk=CHUNK)
    for n in range(CHUNK + 1, 4 * CHUNK):
        gen.prime(torch.as_tensor([_prompt(n, n)]), cfg)
    prefill = [k for k in gen._graphs._steps if k[0] == "prefill"]
    assert [k[1] for k in prefill] == [CHUNK]
    assert gen._graphs.captured("prefill") == 1
    assert gen._graphs.captured() == 1  # prime calls no decode step
    assert sorted(set(tails)) == list(range(1, CHUNK))
    assert sorted(gen.decode_state().chunks) == [CHUNK]


def _engines(cfg: dict, draw: str):
    """(JAX engine, port engine) over the float32 weights of _jax_pair."""
    import jax.numpy as jnp

    from ktransformers_tpu.serving.engine import ServeEngine as JEngine
    from ktransformers_tpu.serving.scheduler import SchedulerConfig as JCfg

    jgen, gen = _jax_pair(cfg, draw, batch=1)
    jeng = JEngine(jgen.params, jgen.spec, JCfg(**SCHED), num_pages=64,
                   cache_dtype=jnp.float32, compute_dtype=jnp.float32)
    eng = ServeEngine(gen.params, gen.spec, SchedulerConfig(**SCHED),
                      num_pages=64, **F32)
    return jeng, eng, gen


def _serve(eng) -> list:
    """Two prompts of 20 and 25 tokens at once (no decode rows yet, so the
    chunk budget doubles to 32: both prompts whole, two prefill steps of
    bucket 32 in one engine step), then two more of 18 and 11 tokens while
    those decode (chunks of 16: one fused into a mixed step a step and the
    other dispatched beside it, or separate steps for a hybrid model)."""
    qs = [eng.submit(_prompt(30 + i, n), max_new_tokens=6)
          for i, n in enumerate((20, 25))]
    eng.step()
    eng.step()
    qs += [eng.submit(_prompt(40 + i, n), max_new_tokens=6)
           for i, n in enumerate((18, 11))]
    for _ in range(200):
        if all(q.state == "done" for q in qs):
            break
        eng.step()
    assert all(q.finish_reason == "length" for q in qs)
    return [list(q.output_ids) for q in qs]


@pytest.mark.parametrize("name", ["mla", "hybrid"])
def test_engine_steps_match_jax(name, monkeypatch):
    """The engine's prefill and mixed steps through their static buffers:
    its tokens equal the JAX engine's and the single-user Generator's. The
    first two queries' whole prompts share bucket 32 in one step; their
    first tokens differ, so each kept its own logits (a shared buffer
    would hand both the second chunk's)."""
    monkeypatch.setenv("KT_MIXED_MAX_CHUNKS", "1")
    cfg = MLA if name == "mla" else _hybrid_cfg()
    jeng, eng, gen = _engines(cfg, "init" if name == "hybrid" else
                              "synthetic")
    seen = {}
    dispatch = eng._dispatch_prefill

    def counted(q, chunk):
        seen.setdefault(eng.steps_executed, []).append(len(chunk))
        return dispatch(q, chunk)

    eng._dispatch_prefill = counted
    got = _serve(eng)
    assert got == _serve(jeng)
    single = [gen.generate([p], GenerateConfig(max_new_tokens=6,
                                               prefill_chunk=16))[0]
              for p in [_prompt(30, 20), _prompt(31, 25), _prompt(40, 18),
                        _prompt(41, 11)]]
    assert got == single
    assert seen[0] == [20, 25]
    assert got[0][0] != got[1][0]
    calls = {k[:3]: step.calls for k, step in eng._graphs._steps.items()
             if k[0] in ("prefill", "mixed")}
    assert calls[("prefill", 32, eng._hybrid)] == 2
    if name == "mla":
        # one chunk fused a step, the other dispatched beside it
        assert eng.mixed_steps_fused >= 2 and ("mixed", 16, 1) in calls
        assert seen[2] == [11]
    else:
        assert calls[("prefill", 16, True)] >= 3


def test_engine_buffers_keep_their_storage():
    """The prefill and mixed steps' buffers and the decode state: the same
    storage at every engine step of a run with mixed steps; the inputs
    packed into one buffer a step."""
    spec = spec_from_hf_config(dict(MLA))
    params = init_params_synthetic(spec, seed=3, quant="bf16",
                                   dtype=torch.float32, device="cpu")
    eng = ServeEngine(params, spec, SchedulerConfig(**SCHED), num_pages=64,
                      **F32)
    ptrs = {}
    seen = []

    def record():
        for key, bufs in eng._bufs.items():
            for name, t in bufs.items():
                ptrs.setdefault((key, name), set()).add(t.data_ptr())
        seen.append(sorted(k[0] for k in eng._bufs))

    qs = [eng.submit(_prompt(50 + i, n), max_new_tokens=5)
          for i, n in enumerate((20, 33))]
    while any(q.state != "done" for q in qs):
        eng.step()
        record()
        if len(qs) < 4 and eng.steps_executed % 2 == 0:
            qs.append(eng.submit(_prompt(60 + len(qs), 19),
                                 max_new_tokens=5))
        assert eng.steps_executed < 300
    assert eng.mixed_steps_fused >= 1
    assert {k[0] for k in eng._bufs} == {"prefill", "mixed"}
    assert all(len(p) == 1 for p in ptrs.values())
    # each step's inputs are views of its one packed upload buffer; a
    # model without GatedDeltaNet layers has no state slot
    for bufs in eng._bufs.values():
        base = bufs["packed"].untyped_storage().data_ptr()
        assert "slot" not in bufs
        assert all(bufs[k].untyped_storage().data_ptr() == base
                   for k in ("tokens", "table", "start", "valid"))


def test_prefill_and_mixed_steps_capture_and_count(stub_cuda, monkeypatch):
    """GraphStep's course for a prefill key and a mixed key with
    torch.cuda stubbed: WARMUP eager calls, a capture (the garbage
    collector off, whose collection could free a dead graph's pool inside
    it) whose counts are taken back out, then replays that run no body
    and add the counts of one call; the mixed step registers the sampling
    generator."""
    from ktransformers_tpu_torch.engine import generate
    from ktransformers_tpu_torch.serving import engine as engine_mod

    seen = stub_cuda
    for module in (generate, engine_mod):
        monkeypatch.setattr(module, "capture_allowed", lambda *a: True)
    spec = spec_from_hf_config(dict(MLA))
    params = init_params_synthetic(spec, seed=3, quant="bf16",
                                   dtype=torch.float32, device="cpu")
    gen = Generator(params, spec, max_len=96, **F32)
    eng = ServeEngine(params, spec, SchedulerConfig(**SCHED), num_pages=64,
                      **F32)
    forward = gen._forward

    collecting = []

    def counted(*a, **kw):
        seen.append("body")
        collecting.append(gc.isenabled())
        kernels.LAUNCHES["quant_matmul"] += 3
        return forward(*a, **kw)

    gen._forward = counted
    mixed_step = eng._mixed_step

    def counted_mixed(*a):
        seen.append("mixed body")
        kernels.ROUTED_LAUNCHES["quant_gemv_kernel"] += 2
        return mixed_step(*a)

    eng._mixed_step = counted_mixed
    kernels.reset_launches()
    try:
        step = gen.prefill_graph(CHUNK)
        lengths = gen.decode_state().cache.lengths
        for _ in range(cuda_graph.WARMUP + 3):
            step()
        assert seen == ["body"] * (cuda_graph.WARMUP + 1) + ["replay"] * 3
        assert step.graphed and step.pool_bytes == 0
        # the garbage collector is off inside the capture only
        assert collecting == [True] * cuda_graph.WARMUP + [False]
        assert gc.isenabled()
        # the replays (stubbed) ran no body: the cache advanced by the
        # warm-ups and the capture only
        assert lengths.tolist() == [CHUNK * (cuda_graph.WARMUP + 1)]
        calls = cuda_graph.WARMUP + 3
        assert kernels.LAUNCHES["quant_matmul"] == 3 * calls
        del seen[:]
        eng.submit(list(range(9)), max_new_tokens=4)
        eng._build_decode_state([])
        mixed, _ = eng._mixed_graph(1, 16)
        for _ in range(cuda_graph.WARMUP + 2):
            mixed()
        assert seen == ["mixed body"] * cuda_graph.WARMUP + [
            "register", "mixed body", "replay", "replay"]
        assert kernels.ROUTED_LAUNCHES["quant_gemv_kernel"] == 2 * (
            cuda_graph.WARMUP + 2)
        assert eng._graphs.captured("mixed") == 1
        assert eng._graphs.captured("prefill") == 0
        assert eng._graphs.pool_bytes() == {"mixed": 0}
        assert gen._graphs.captured("prefill") == 1
    finally:
        kernels.reset_launches()


@pytest.mark.parametrize("t, k, e, masked", [
    (256, 6, 64, 0.0), (257, 6, 64, 0.2), (40, 8, 128, 0.5), (9, 2, 8, 1.0),
    (300, 10, 512, 0.1)])
def test_dispatch_group_sizes_equal_bincount(t, k, e, masked):
    """Group sizes counted on the device, against torch.bincount: the same
    int32 bits, experts with no row at 0, the masked id E in no group;
    the stable sort order unchanged."""
    rng = np.random.default_rng(t + k + e)
    ids = rng.integers(0, e // 2 if e > 8 else e, (t, k))  # empty experts
    ids[rng.random((t, k)) < masked] = e
    idx = torch.as_tensor(ids, dtype=torch.int32)
    order, token, sizes = moe_dispatch(idx, e)
    flat = idx.reshape(-1).to(torch.int64)
    want = torch.bincount(flat, minlength=e + 1)[:e].to(torch.int32)
    assert sizes.dtype == torch.int32 and sizes.shape == (e,)
    assert torch.equal(sizes, want)
    assert torch.equal(order, torch.argsort(flat, stable=True))
    assert torch.equal(token, order // k)
    assert int(sizes.sum()) == int((flat < e).sum())


# ------------------------------------------------------------------ card

CARD_MOE = dict(CARD, first_k_dense_replace=1)  # a dense and an MoE layer


def _card_moe_gen():
    spec = spec_from_hf_config(dict(CARD_MOE))
    params = init_params_synthetic(spec, seed=1, quant="int8", device="cuda")
    return Generator(params, spec, max_len=1024, device="cuda")


@pytest.mark.cuda
def test_card_prefill_replay_equals_eager(cuda):
    """Prompts of 3 x 256 + 40 tokens: the graphed prefill (the 256 key
    captured at its third chunk) gives the eager loop's tokens, a replayed
    chunk the eager chunk's logits and launch counts."""
    from test_torch_graph_step import _eager_greedy

    gen = _card_moe_gen()
    cfg = GenerateConfig(max_new_tokens=8)
    prompt = np.random.default_rng(5).integers(
        0, CARD["vocab_size"], 3 * 256 + 40).tolist()
    got = gen.generate(prompt, cfg)[0]
    step = gen.prefill_graph(256)
    assert step.graphed and step.pool_bytes > 0
    assert got == _eager_greedy(gen, prompt, 8)
    chunk = torch.tensor([prompt[256:512]], device="cuda")
    cache = gen.new_cache()
    _, cache = gen.prefill(cache, torch.tensor([prompt[:256]],
                                               device="cuda"))
    kernels.reset_launches()
    eager, _ = gen.prefill(cache, chunk)
    want = {k: v for k, v in kernels.LAUNCHES.items() if v}
    st = gen.decode_state()
    st.cache.lengths.fill_(256)
    st.chunk(256).copy_(chunk)
    kernels.reset_launches()
    step()
    torch.cuda.synchronize()
    assert {k: v for k, v in kernels.LAUNCHES.items() if v} == want
    assert want.get("grouped_quant_matmul") == 2
    assert torch.equal(st.logits, eager)


@pytest.mark.cuda
def test_card_mixed_replay_equals_eager(cuda):
    """Three decode rows and a late 1,100-token prompt (chunks of 256
    fused into mixed steps, the (256, 1) key captured): the graphed
    engine's tokens equal the eager engine's, and a replayed mixed step
    counts an eager one's launches."""
    gen = _card_moe_gen()

    def run(graphs: bool):
        eng = ServeEngine(gen.params, gen.spec, SchedulerConfig(
            max_batch_size=4, page_size=64, max_pages_per_query=32),
            num_pages=128, enable_prefix_cache=False, device="cuda")
        eng.graph_steps = graphs
        rng = np.random.default_rng(6)
        qs = [eng.submit(rng.integers(0, CARD["vocab_size"], 40).tolist(),
                         max_new_tokens=40) for _ in range(3)]
        while any(q.state != "decode" for q in qs):
            eng.step()
        qs.append(eng.submit(rng.integers(0, CARD["vocab_size"],
                                          1100).tolist(), max_new_tokens=4))
        launches = []
        while any(q.state != "done" for q in qs):
            fused = eng.mixed_steps_fused
            kernels.reset_launches()
            eng.step()
            torch.cuda.synchronize()
            if eng.mixed_steps_fused > fused:
                launches.append({k: v for k, v in kernels.LAUNCHES.items()
                                 if v})
        return [list(q.output_ids) for q in qs], eng, launches

    graphed, eng, g_launches = run(True)
    assert eng._graphs.captured("mixed") >= 1
    eager, _, e_launches = run(False)
    assert graphed == eager
    assert g_launches[:4] == e_launches[:4]


@pytest.mark.cuda
def test_card_moe_forward_captures(cuda):
    """moe_forward at 256 tokens (the sorted path, its group sizes counted
    on the device) captures in a torch.cuda.graph, and a replay gives the
    eager call's output."""
    from ktransformers_tpu_torch.ops.moe import moe_forward

    gen = _card_moe_gen()
    lp = next(lp for lp in gen.params["layers"] if "moe" in lp)
    experts, e = lp["moe"]["experts"], lp["moe"]["experts"].num_experts
    torch.manual_seed(0)
    x = torch.randn(256, CARD["hidden_size"], device="cuda",
                    dtype=torch.bfloat16)
    idx = torch.randint(0, e, (256, 6), device="cuda", dtype=torch.int32)
    w = torch.rand(256, 6, device="cuda")
    want = moe_forward(x, experts, idx, w)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        moe_forward(x, experts, idx, w)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="thread_local"):
        out = moe_forward(x, experts, idx, w)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, want)
