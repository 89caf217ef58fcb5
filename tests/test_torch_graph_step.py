"""The compiled decode step (engine/cuda_graph.py): the Generator's and the
ServeEngine's decode steps over static buffers, captured in CUDA graphs
and replayed on the card, run eagerly on the same buffers on the CPU.

CPU (one torch thread, the JAX forwards jitted by the JAX Generator):
- the pipelined Generator's greedy tokens equal the JAX package's
  Generator.generate on three tiny float32 models, the DeepSeek-V2-Lite
  shape (MLA, a dense and an MoE layer), the Mixtral shape (GQA, MoE) and
  the Qwen3-Next shape (3 GatedDeltaNet layers and a gated full
  attention): batch 2 with an EOS that ends the rows at different steps,
  at pipeline depths 1, 3 and 24, ``max_new_tokens`` 1 and 2, and
  penalized sampling. Both sides compute in float32 and run no Pallas
  kernel, so only the order of float32 sums differs and greedy tokens
  agree exactly;
- the step cache's buffers, its lengths, the GatedDeltaNet states and the
  step tokens keep their storage across steps and across two generate
  calls; ``on_token`` gets one CPU tensor [B] a step, in order;
- the ServeEngine's decode state buffers keep their storage across changes
  of the batch's composition, its tokens equal the single-user
  Generator's;
- the eager rules: no capture on the CPU, over experts in host memory
  or under a parallel context; ``scratch`` keeps every set it handed out.

Card (marked ``cuda``, skipped here inside the ``cuda`` fixture; run them
with ``python -m pytest --noconftest -m cuda tests/test_torch_graph_step.py``
on the card): graph replays equal the eager decode_step loop token for
token on int8 weights, launch counts per replay equal an eager step's, a
sampled run repeats under one seed, a replay after every scratch set grew
equals the eager tokens, the ServeEngine's graphed and eager runs give the
same tokens. This file imports JAX only inside the CPU tests' fixtures, so
the card, which has no JAX, collects it.
"""

import gc
import weakref

import numpy as np
import pytest
import torch

from ktransformers_tpu_torch.engine import cuda_graph
from ktransformers_tpu_torch.engine.generate import GenerateConfig, Generator
from ktransformers_tpu_torch.engine.sampler import SamplingConfig
from ktransformers_tpu_torch.models.spec import (
    DEEPSEEK_V2_LITE,
    MIXTRAL_8X7B,
    spec_from_hf_config,
)
from ktransformers_tpu_torch.ops.cuda import w4a8_matmul
from ktransformers_tpu_torch.serving import SchedulerConfig, ServeEngine

PROMPT_LEN, NEW_TOKENS, MAX_LEN = 12, 10, 48
PENALTIES = dict(repetition_penalty=1.3, presence_penalty=0.5,
                 frequency_penalty=0.25)
MLA = dict(
    DEEPSEEK_V2_LITE, vocab_size=512, hidden_size=256,
    intermediate_size=512, moe_intermediate_size=128, num_hidden_layers=2,
    first_k_dense_replace=1, num_attention_heads=4, num_key_value_heads=4,
    n_routed_experts=8, num_experts_per_tok=3, n_shared_experts=1,
    kv_lora_rank=64, qk_rope_head_dim=16, qk_nope_head_dim=32,
    v_head_dim=32)
GQA = dict(
    MIXTRAL_8X7B, vocab_size=512, hidden_size=256, intermediate_size=512,
    num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
    num_local_experts=8, max_position_embeddings=256)


def _hybrid_cfg():
    from tests.test_torch_qwen3_next import TINY

    return dict(TINY)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch thread, as tests/test_torch_model.py's fixture: the suite
    runs JAX beside these tests."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jax_pair(cfg: dict, draw: str, batch: int = 2):
    """(JAX Generator, port Generator) over the same float32 weights,
    drawn in the JAX package (``draw``: its init_params_synthetic, or
    init_params, which the hybrid spec needs) and carried across."""
    import jax
    import jax.numpy as jnp

    from ktransformers_tpu.engine.generate import Generator as JGenerator
    from ktransformers_tpu.models import init as jinit
    from ktransformers_tpu.models.spec import spec_from_hf_config as jspec_of
    from ktransformers_tpu.utils.device_prep import prepare_params

    from ktransformers_tpu_torch.convert import params_from_jax

    jspec = jspec_of(dict(cfg))
    if draw == "synthetic":
        raw = jinit.init_params_synthetic(jspec, seed=5, quant="bf16",
                                          dtype=jnp.float32)
    else:
        raw = jinit.init_params(jspec, seed=5, quant="f32", moe_quant="f32")
    jparams = prepare_params(raw, True, jspec)
    jgen = JGenerator(jparams, jspec, max_len=MAX_LEN, batch=batch,
                      cache_dtype=jnp.float32, compute_dtype=jnp.float32)
    spec = spec_from_hf_config(dict(cfg))
    gen = Generator(params_from_jax(jax.device_get(jgen.params), spec, "cpu"),
                    spec, max_len=MAX_LEN, batch=batch,
                    cache_dtype=torch.float32, compute_dtype=torch.float32,
                    device="cpu")
    return jgen, gen


MODELS = ("mla", "gqa", "hybrid")


@pytest.fixture(scope="module")
def pairs():
    """Each model's (JAX Generator, port Generator, prompts [2, S]), made
    at first use."""
    made = {}

    def get(name):
        if name not in made:
            cfg = {"mla": MLA, "gqa": GQA}.get(name) or _hybrid_cfg()
            jgen, gen = _jax_pair(
                cfg, "init" if name == "hybrid" else "synthetic")
            prompts = np.random.default_rng(11).integers(
                0, cfg["vocab_size"], (2, PROMPT_LEN)).tolist()
            made[name] = (jgen, gen, prompts)
        return made[name]

    return get


def _eos_case(gen: Generator) -> tuple:
    """(prompts [2, S], eos): the first of the seeded prompt pairs whose
    greedy rows share a token first generated at different steps in each
    row, that token as EOS, so it ends the two rows apart."""
    for seed in range(100, 140):
        prompts = np.random.default_rng(seed).integers(
            0, gen.spec.vocab_size, (2, PROMPT_LEN)).tolist()
        rows = gen.generate(prompts, GenerateConfig(
            max_new_tokens=NEW_TOKENS, prefill_chunk=PROMPT_LEN))
        for t in rows[0][1:]:
            if t in rows[1][1:] and rows[0].index(t) != rows[1].index(t):
                return prompts, t
    raise AssertionError("no seeded prompt pair shares a token")


@pytest.mark.parametrize("name", MODELS)
def test_greedy_batch_eos_matches_jax(pairs, name, monkeypatch):
    """Batch 2, an EOS the rows reach at different steps: the port's
    tokens equal the JAX Generator's at pipeline depths 1, 3 and 24, each
    row ending at its EOS."""
    jgen, gen, _ = pairs(name)
    prompts, eos = _eos_case(gen)
    cfg = GenerateConfig(max_new_tokens=NEW_TOKENS,
                         prefill_chunk=PROMPT_LEN, eos_token_id=eos)
    want = jgen.generate(prompts, cfg)
    assert len(want[0]) != len(want[1])
    assert all(row[-1] == eos for row in want)
    for depth in ("1", "3", "24"):
        monkeypatch.setenv("KT_GENERATE_PIPELINE", depth)
        assert gen.generate(prompts, cfg) == want, depth


@pytest.mark.parametrize("n", [1, 2])
@pytest.mark.parametrize("name", MODELS)
def test_short_generations_match_jax(pairs, name, n):
    jgen, gen, prompts = pairs(name)
    cfg = GenerateConfig(max_new_tokens=n, prefill_chunk=PROMPT_LEN)
    got = gen.generate(prompts, cfg)
    assert got == jgen.generate(prompts, cfg)
    assert [len(row) for row in got] == [n, n]


@pytest.mark.parametrize("name", MODELS)
def test_penalized_greedy_matches_jax(pairs, name):
    """Repetition, presence and frequency penalties: the counts and the
    prompt mask in the step's static buffers."""
    jgen, gen, prompts = pairs(name)
    cfg = GenerateConfig(max_new_tokens=NEW_TOKENS, prefill_chunk=PROMPT_LEN,
                         sampling=SamplingConfig(**PENALTIES))
    assert gen.generate(prompts, cfg) == jgen.generate(prompts, cfg)


def _storage(gen: Generator) -> list:
    st = gen.decode_state()
    c = st.cache
    return [t.data_ptr() for t in
            [c.lengths, st.tokens, *c.bufs_a, *c.bufs_b]]


@pytest.mark.parametrize("name", ["mla", "hybrid"])
def test_step_buffers_keep_their_storage(pairs, name):
    """The step cache (the hybrid's GatedDeltaNet conv tails and recurrent
    states among its buffers), its lengths and the step tokens: the same
    storage at every step of two generate calls, the lengths at prompt +
    steps after each."""
    _, gen, prompts = pairs(name)
    cfg = GenerateConfig(max_new_tokens=6, prefill_chunk=5)
    seen = []
    for _ in range(2):
        gen.generate(prompts, cfg, on_token=lambda tok: seen.append(
            _storage(gen)))
        lengths = gen.decode_state().cache.lengths
        assert lengths.tolist() == [PROMPT_LEN + 5] * 2
    assert len(seen) == 12
    assert all(s == seen[0] for s in seen)
    if name == "hybrid":
        kinds = [gen.spec.layer_kind(i) for i in range(gen.spec.num_layers)]
        assert "linear" in kinds


def test_on_token_gets_host_tokens_in_order(pairs):
    """One call a step, in order, each a CPU int64 tensor [B] holding that
    step's tokens of both rows (rows past their EOS too)."""
    _, gen, prompts = pairs("mla")
    got = []
    out = gen.generate(prompts, GenerateConfig(
        max_new_tokens=NEW_TOKENS, prefill_chunk=PROMPT_LEN),
        on_token=lambda tok: got.append(tok.clone()))
    assert len(got) == NEW_TOKENS
    assert all(t.device.type == "cpu" and t.dtype == torch.int64
               and t.shape == (2,) for t in got)
    assert torch.stack(got, 1).tolist() == out


def test_engine_decode_state_keeps_storage():
    """Queries joining and finishing change the decode batch's composition
    several times: the decode state's buffers keep their storage, and each
    query's tokens equal the single-user Generator's."""
    spec = spec_from_hf_config(dict(MLA))
    from ktransformers_tpu_torch.models.init import init_params_synthetic

    params = init_params_synthetic(spec, seed=3, quant="bf16",
                                   dtype=torch.float32, device="cpu")
    f32 = dict(cache_dtype=torch.float32, compute_dtype=torch.float32,
               device="cpu")
    eng = ServeEngine(params, spec, SchedulerConfig(
        max_batch_size=3, prefill_chunk=16, page_size=8,
        max_pages_per_query=8), num_pages=64, **f32)
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, MLA["vocab_size"], n).tolist()
               for n in (9, 17, 5, 12)]
    news = (6, 3, 8, 4)
    qs, ptrs, step = [], set(), 0
    while len(qs) < 4 or any(q.state != "done" for q in qs):
        if step % 3 == 0 and len(qs) < 4:
            i = len(qs)
            qs.append(eng.submit(prompts[i], max_new_tokens=news[i]))
        eng.step()
        step += 1
        if eng._dstate is not None:
            ptrs.add(tuple((k, t.data_ptr())
                           for k, t in sorted(eng._dstate.items())))
        assert step < 500
    assert len(ptrs) == 1
    gen = Generator(params, spec, max_len=64, **f32)
    for q, p, n in zip(qs, prompts, news):
        assert list(q.output_ids) == gen.generate(
            [p], GenerateConfig(max_new_tokens=n, prefill_chunk=16))[0]


def test_capture_rules():
    """Captured only on the card, over experts on the device, with no
    parallel context, where the owner allows it; otherwise eager."""
    from ktransformers_tpu_torch.models.init import init_params_synthetic
    from ktransformers_tpu_torch.offload import offload_moe_weights
    from ktransformers_tpu_torch.offload.host_engine import (
        HostExperts,
        HostOffloadGenerator,
    )
    from ktransformers_tpu_torch.offload.paged_engine import (
        HostOffloadServeEngine,
    )
    from ktransformers_tpu_torch.parallel.context import parallel_context
    from ktransformers_tpu_torch.parallel.mesh import make_mesh

    spec = spec_from_hf_config(dict(MLA))
    params = init_params_synthetic(spec, seed=3, quant="bf16",
                                   dtype=torch.float32, device="cpu")
    card = torch.device("cuda")
    assert cuda_graph.capture_allowed(card, params)
    assert not cuda_graph.capture_allowed("cpu", params)
    assert not cuda_graph.capture_allowed(card, params, enabled=False)
    with parallel_context(make_mesh(device="cpu")):
        assert not cuda_graph.capture_allowed(card, params)
    assert cuda_graph.capture_allowed(card, params)
    moe_li = next(i for i, lp in enumerate(params["layers"]) if "moe" in lp)
    for host in (offload_moe_weights(params["layers"][moe_li]["moe"]
                                     ["experts"]),
                 HostExperts.__new__(HostExperts)):
        layers = list(params["layers"])
        layers[moe_li] = {**layers[moe_li], "moe": {
            **layers[moe_li]["moe"], "experts": host}}
        assert not cuda_graph.capture_allowed(card, {**params,
                                                     "layers": layers})
    # the offload classes hold HostExperts in their MoE layers
    assert issubclass(HostOffloadGenerator, Generator)
    assert issubclass(HostOffloadServeEngine, ServeEngine)


def test_cpu_steps_run_eagerly(pairs):
    """The CPU runs every step eagerly on the static buffers, past the
    warm-up count, under a parallel context too."""
    from ktransformers_tpu_torch.parallel.context import parallel_context
    from ktransformers_tpu_torch.parallel.mesh import make_mesh

    _, gen, prompts = pairs("mla")
    step = gen.decode_graph(SamplingConfig())
    assert not step.capture
    with parallel_context(make_mesh(device="cpu")):
        assert not gen.decode_graph(SamplingConfig()).capture
    gen.generate(prompts, GenerateConfig(max_new_tokens=5,
                                         prefill_chunk=PROMPT_LEN))
    assert step.calls > cuda_graph.WARMUP and not step.graphed


def test_rebound_params_drop_the_steps(pairs):
    """A step captured the parameter tensors it read: the Generator's new
    tree and the engine's expert re-placement each drop the steps."""
    from ktransformers_tpu_torch.models.init import init_params_synthetic

    _, gen, _ = pairs("gqa")
    step = gen.decode_graph(SamplingConfig())
    params = gen.params
    gen.params = dict(params)
    try:
        assert gen.decode_graph(SamplingConfig()) is not step
    finally:
        gen.params = params
    spec = spec_from_hf_config(dict(MLA))
    eng = ServeEngine(init_params_synthetic(
        spec, seed=3, quant="bf16", dtype=torch.float32, device="cpu"),
        spec, SchedulerConfig(max_batch_size=2, page_size=8,
                              max_pages_per_query=8),
        num_pages=32, collect_routing=True, cache_dtype=torch.float32,
        compute_dtype=torch.float32, device="cpu")
    out = eng.generate_sync(list(range(9)), max_new_tokens=4)
    step = eng._decode_graph(False)
    eng.apply_expert_rebalance(ep_size=2)
    assert eng._decode_graph(False) is not step
    assert eng.generate_sync(list(range(9)), max_new_tokens=4) == out


# public callables whose ``device`` does not default to the card: the
# readers that decode a file's blocks into host memory (the build that
# takes them places them, by default on the card), and the meshes, whose
# None is the card (parallel/mesh.card_device, which raises without one)
HOST_READERS = {
    "ktransformers_tpu_torch.loader.providers.GGUFProvider.__init__": "cpu",
    "ktransformers_tpu_torch.quant.gguf_repack.repack_ggml_exact": "cpu",
    "ktransformers_tpu_torch.parallel.distributed.init_multihost": None,
    "ktransformers_tpu_torch.parallel.mesh.make_mesh": None,
    "ktransformers_tpu_torch.parallel.pp.make_pp_mesh": None,
}


def test_entry_points_default_to_the_card():
    """Every public function, class and method of the port that takes a
    ``device`` runs on the card unless the caller asks for the CPU (the
    MTP heads' init_mtp_synthetic and mtp_params_from_provider defaulted
    to the CPU until this test)."""
    import importlib
    import inspect
    import pkgutil

    import ktransformers_tpu_torch as pkg

    found, seen = {}, 0
    for info in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
        if info.name.endswith("__main__"):
            continue
        mod = importlib.import_module(info.name)
        for name, obj in vars(mod).items():
            if name.startswith("_") or getattr(obj, "__module__",
                                               None) != mod.__name__:
                continue
            fns = [(name, obj)] if inspect.isfunction(obj) else []
            if inspect.isclass(obj):
                fns = [(f"{name}.__init__", obj.__init__)] + [
                    (f"{name}.{k}", v) for k, v in vars(obj).items()
                    if inspect.isfunction(v) and not k.startswith("_")]
            for fname, fn in fns:
                p = inspect.signature(fn).parameters.get("device")
                if p is None or p.default is inspect.Parameter.empty:
                    continue
                seen += 1
                if p.default != "cuda":
                    found[f"{mod.__name__}.{fname}"] = p.default
    assert seen > 20
    assert found == HOST_READERS


@pytest.fixture
def stub_cuda(monkeypatch):
    """torch.cuda's streams and graphs stubbed (no card here): the list
    each graph's registrations and replays are appended to."""
    import contextlib

    seen = []

    class Graph:
        def register_generator_state(self, gen):
            seen.append("register")

        def replay(self):
            seen.append("replay")

    class Stream:
        def __init__(self, *a):
            pass

        def wait_stream(self, other):
            pass

    monkeypatch.setattr(torch.cuda, "CUDAGraph", Graph)
    monkeypatch.setattr(torch.cuda, "graph",
                        lambda g, **kw: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "Stream", Stream)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda *a: Stream())
    monkeypatch.setattr(torch.cuda, "stream",
                        lambda s: contextlib.nullcontext())
    return seen


def test_graph_step_warms_up_captures_and_counts(stub_cuda):
    """GraphStep's course with torch.cuda stubbed: WARMUP eager calls, then
    a capture, whose own wrapper counts are taken back out, and replays,
    each adding the counts one call of the body made; the generators
    registered before the capture."""
    from ktransformers_tpu_torch.ops import cuda as kernels

    seen = stub_cuda

    def body():
        seen.append("body")
        kernels.LAUNCHES["quant_matmul"] += 3
        kernels.ROUTED_LAUNCHES["quant_gemv_kernel"] += 2

    kernels.reset_launches()
    try:
        step = cuda_graph.GraphStep(body, "cpu", True, [object()])
        for _ in range(cuda_graph.WARMUP + 3):
            step()
        assert seen == ["body"] * cuda_graph.WARMUP + [
            "register", "body"] + ["replay"] * 3
        assert step.graphed
        # every call counted once: the warm-ups, then a replay a call
        calls = cuda_graph.WARMUP + 3
        assert kernels.LAUNCHES["quant_matmul"] == 3 * calls
        assert kernels.ROUTED_LAUNCHES["quant_gemv_kernel"] == 2 * calls
    finally:
        kernels.reset_launches()


def test_captured_step_holds_its_scratch_sets(stub_cuda):
    """A grown scratch set replaces the smaller one for later calls; a step
    captured over the smaller one keeps it alive (its replays write into
    it) until the step goes, and an eager step holds none."""
    what = "test_graph_step"

    def body():
        w4a8_matmul.scratch("cpu", 64, 4, what)

    step = cuda_graph.GraphStep(body, "cpu", True)
    eager = cuda_graph.GraphStep(body, "cpu", False)
    for _ in range(cuda_graph.WARMUP + 1):
        step()
        eager()
    assert step.graphed and not eager.graphed and eager.scratch == ()
    first = w4a8_matmul._SCRATCH[("cpu", what)]
    ref = weakref.ref(first[0])
    assert w4a8_matmul.scratch("cpu", 32, 2, what) is first
    grown = w4a8_matmul.scratch("cpu", 256, 8, what)
    assert grown is not first and grown[0].numel() == 256
    assert not grown[1].any()
    assert w4a8_matmul.scratch("cpu", 64, 4, what) is grown
    del first
    gc.collect()
    assert ref() is not None
    assert any(s[0] is ref() for s in step.scratch)
    del step
    gc.collect()
    assert ref() is None
    del w4a8_matmul._SCRATCH[("cpu", what)]


# ------------------------------------------------------------------ card

CARD = dict(
    DEEPSEEK_V2_LITE, vocab_size=1024, hidden_size=512,
    intermediate_size=1024, num_hidden_layers=2, first_k_dense_replace=2,
    num_attention_heads=16, num_key_value_heads=16)
CARD_PROMPT, CARD_NEW = 40, 12


@pytest.fixture
def cuda():
    """The card, or a skip: a CUDA graph needs a CUDA device."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _card_gen(quant: str = "int8"):
    from ktransformers_tpu_torch.models.init import init_params_synthetic

    spec = spec_from_hf_config(dict(CARD))
    params = init_params_synthetic(spec, seed=1, quant=quant, device="cuda")
    return Generator(params, spec, max_len=128, device="cuda")


def _card_prompt(seed: int = 2) -> list:
    return np.random.default_rng(seed).integers(
        0, CARD["vocab_size"], CARD_PROMPT).tolist()


def _eager_greedy(gen: Generator, prompt: list, n: int) -> list:
    """The eager decode_step loop on a cache of its own."""
    cache = gen.new_cache()
    last, cache = gen.prefill(cache, torch.tensor([prompt], device="cuda"))
    tok = last.argmax(-1)
    out = [int(tok[0])]
    while len(out) < n:
        tok, cache = gen.decode_step(tok, cache)
        out.append(int(tok[0]))
    return out


@pytest.mark.cuda
def test_card_replay_equals_eager(cuda):
    from ktransformers_tpu_torch.ops.cuda import LAUNCHES, reset_launches

    gen = _card_gen()
    prompt = _card_prompt()
    want = _eager_greedy(gen, prompt, CARD_NEW)
    cfg = GenerateConfig(max_new_tokens=CARD_NEW)
    assert gen.generate(prompt, cfg)[0] == want
    step = gen.decode_graph(cfg.sampling)
    assert step.graphed
    assert gen.generate(prompt, cfg)[0] == want
    # one replay counts what one eager step launches
    cache = gen.new_cache()
    last, cache = gen.prefill(cache, torch.tensor([prompt], device="cuda"))
    reset_launches()
    gen.decode_step(last.argmax(-1), cache)
    eager = {k: v for k, v in LAUNCHES.items() if v}
    reset_launches()
    step()
    torch.cuda.synchronize()
    assert {k: v for k, v in LAUNCHES.items() if v} == eager
    assert eager.get("mla_decode_fused") == CARD["num_hidden_layers"]


@pytest.mark.cuda
def test_card_sampled_run_repeats(cuda):
    gen = _card_gen()
    cfg = GenerateConfig(max_new_tokens=CARD_NEW, seed=9, sampling=
                         SamplingConfig(temperature=0.8, top_p=0.9))
    first = gen.generate(_card_prompt(), cfg)
    assert gen.decode_graph(cfg.sampling).graphed
    assert gen.generate(_card_prompt(), cfg) == first


@pytest.mark.cuda
def test_card_replay_after_scratch_grew(cuda):
    """Every scratch set replaced by a larger one after the capture: the
    graph replays into the sets it holds and its tokens stay the eager
    loop's."""
    gen = _card_gen()
    prompt = _card_prompt(3)
    want = _eager_greedy(gen, prompt, CARD_NEW)
    cfg = GenerateConfig(max_new_tokens=CARD_NEW)
    assert gen.generate(prompt, cfg)[0] == want
    sets = dict(w4a8_matmul._SCRATCH)
    assert sets
    for (dev, what), (part, cnt) in sets.items():
        w4a8_matmul.scratch(dev, 4 * part.numel(), 4 * cnt.numel(), what)
    sizes = [(part.numel(), cnt.numel()) for part, cnt in sets.values()]
    del sets, part, cnt
    # what a stale graph would read where a freed set lay: NaN partials,
    # counters that are not zero
    junk = [(torch.full((n,), float("nan"), device="cuda"),
             torch.full((c,), 7, dtype=torch.int32, device="cuda"))
            for n, c in sizes]
    assert gen.generate(prompt, cfg)[0] == want
    del junk


@pytest.mark.cuda
def test_card_engine_graphed_equals_eager(cuda):
    gen = _card_gen()
    prompts = [_card_prompt(s) for s in range(4)]

    def run(graphs: bool):
        eng = ServeEngine(gen.params, gen.spec, SchedulerConfig(
            max_batch_size=4, page_size=16, max_pages_per_query=8),
            num_pages=64, device="cuda")
        eng.graph_steps = graphs
        qs = [eng.submit(p, max_new_tokens=CARD_NEW) for p in prompts]
        while any(q.state != "done" for q in qs):
            eng.step()
        return [list(q.output_ids) for q in qs], eng

    graphed, eng = run(True)
    assert eng._decode_graph(False).graphed
    eager, _ = run(False)
    assert graphed == eager


@pytest.mark.cuda
def test_card_parallel_context_runs_eagerly(cuda):
    """Under a parallel context the card's step is not captured, and its
    tokens are the graphed step's."""
    from ktransformers_tpu_torch.parallel.context import parallel_context
    from ktransformers_tpu_torch.parallel.mesh import make_mesh

    gen = _card_gen()
    cfg = GenerateConfig(max_new_tokens=CARD_NEW)
    want = gen.generate(_card_prompt(), cfg)
    with parallel_context(make_mesh(device="cuda")):
        assert gen.generate(_card_prompt(), cfg) == want
        step = gen.decode_graph(cfg.sampling)
    assert not step.capture and not step.graphed
    assert step.calls == CARD_NEW - 1


@pytest.mark.cuda
def test_card_draw_is_multinomials(cuda):
    """The sampler's draw gives torch.multinomial's one-sample draws from
    the same generator state (its path, without the host-side checks)."""
    from ktransformers_tpu_torch.engine.sampler import _draw

    scaled = torch.randn(8, 4096, device="cuda") * 3
    g1 = torch.Generator(device="cuda").manual_seed(5)
    g2 = torch.Generator(device="cuda").manual_seed(5)
    want = torch.multinomial(torch.softmax(scaled, -1), 1, generator=g1)
    assert torch.equal(_draw(scaled, g2), want[:, 0])
