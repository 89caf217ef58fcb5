"""Model steps captured in CUDA graphs and replayed: the port's
counterpart of the JAX package's ``jax.jit(step, donate_argnums=...)``
(ktransformers_tpu/engine/generate.py:88, :158, :192 and
ktransformers_tpu/serving/engine.py:186-211, :219-237, :301-336): the
Generator's prefill chunks and decode step, the ServeEngine's prefill
chunks, decode step and fused mixed step.

A ``GraphStep`` runs a step body that reads and writes STATIC buffers only:
tensors allocated once, outside the step, whose storage never changes (the
KV cache or pools, the step's input and output tokens, lengths, sampling
state). The caller writes a step's inputs into them before a call and
reads its outputs from them after. Where the body's code rebinds a tensor
instead of writing into it (forward() advances ``cache.lengths`` out of
place), the body copies the new tensor back into its static buffer before
it ends, so a replay finds everything where the capture saw it.

On ``cuda``, where ``capture_allowed`` says so, the first ``WARMUP`` calls
run the body eagerly on a side stream: they build the kernels
(ops/cuda/_build.lib), set their shared-memory attributes and size every
scratch buffer and tile map the wrappers keep. The next call captures one
call of the body in a ``torch.cuda.CUDAGraph`` (``thread_local`` capture
errors: the ServeEngine captures from its own thread; Python's garbage
collector off, as a collection there could free a dead owner's graphs,
whose cudaFree invalidates a capture) and replays it; every later call
replays. Warm-up calls are real steps: their results are the
step's results. A capture or replay error propagates; nothing retries
eagerly. Elsewhere (the CPU, or a path eager by rule) every call runs the
body eagerly on the same buffers, so the CPU tests exercise the buffer
contract.

A sampling torch.Generator the body draws from is registered with the
graph (``CUDAGraph.register_generator_state``), so each replay draws anew
from its current seed and offset; reseeding it (``manual_seed``) between
replays restarts the draws as it does for eager calls.

Each captured graph keeps a private memory pool for the tensors its
captured call allocated (``pool_bytes``: what the capture added to the
device's reserved memory); no pool is shared, so replays may come in any
order. An owner's steps are bounded: every key starts with its kind
("prefill", "mixed", "decode") and holds only values of a bounded set
(the Generator captures the prefill chunk of its configured length
only, and runs a shorter tail eagerly).

With ``DEBUG_GRAPHS`` set before a capture, the graph keeps its node list
(``CUDAGraph(keep_graph=True)``) and ``GraphStep.dump`` writes it as
Graphviz DOT: the kernels a replay launches, by name (chip_smoke.py holds
them against the eager step's profiled kernels).

The graph replays into the scratch sets of the split kernels
(ops/cuda/w4a8_matmul.scratch) that its capture saw; a wider eager call
later replaces a set with a larger one, so the step holds every set that
was live at its capture, and frees them with the graph.

Launch accounting: ops/cuda's LAUNCHES and ROUTED_LAUNCHES count wrapper
calls, and a replay calls no wrapper. A capture records what its call of
the body added to each count (and takes it back out: a capture launches
nothing), and every replay adds it again, so the counts stay those of the
kernels launched, per step.
"""

from __future__ import annotations

import gc

import torch

from ktransformers_tpu_torch.ops import cuda as kernels
from ktransformers_tpu_torch.ops.cuda.w4a8_matmul import scratch_sets
from ktransformers_tpu_torch.ops.moe import MoEWeights
from ktransformers_tpu_torch.parallel.context import get_parallel_context

# eager calls of a step before its capture
WARMUP = 2
# captures keep their graphs' node lists for GraphStep.dump
DEBUG_GRAPHS = False


def host_experts(params) -> bool:
    """Whether a layer of ``params`` keeps its routed experts in host
    memory (offload/: HostExperts computes them on the host,
    OffloadedMoEWeights streams them to the card): either waits on the
    CPU inside the step."""
    return any(not isinstance(lp["moe"]["experts"], MoEWeights)
               for lp in params["layers"] if "moe" in lp)


def capture_allowed(device, params, enabled: bool = True) -> bool:
    """Whether a step on ``device`` over ``params`` is captured: on the
    card only, where the owner allows it (``enabled``: the ServeEngine's
    ``graph_steps``), never over experts in host memory (host_experts:
    HostOffloadGenerator, HostOffloadServeEngine, streamed experts) and
    never while a parallel context is set (its gloo collectives and host
    copies run on the CPU between launches). A CUDA graph cannot hold a
    wait on the CPU; these steps run eagerly."""
    return (torch.device(device).type == "cuda" and enabled
            and get_parallel_context() is None
            and not host_experts(params))


_COUNTS = (kernels.LAUNCHES, kernels.ROUTED_LAUNCHES)


def _reserved(device: torch.device) -> int:
    """Bytes the caching allocator holds on ``device`` (0 off the card)."""
    return torch.cuda.memory_reserved(device) if device.type == "cuda" else 0


def _add(diffs: list, sign: int = 1) -> None:
    """Add ``sign`` times each count of ``diffs`` (one dict a table of
    _COUNTS) to the launch counts."""
    for table, diff in zip(_COUNTS, diffs):
        for name, n in diff.items():
            table[name] += sign * n


class GraphStep:
    """One step body over static buffers: captured and replayed on the
    card where ``capture`` (capture_allowed) says so, else run eagerly at
    every call. ``generators``: the torch.Generators the body draws
    from."""

    def __init__(self, body, device, capture: bool, generators=()):
        self.body = body
        self.device = torch.device(device)
        self.capture = capture
        self.generators = tuple(generators)
        self.calls = 0
        self.graph = None
        # what one call of the body adds to each table of _COUNTS
        self.launches: list = [{}, {}]
        # the split kernels' scratch sets the capture saw: a replay writes
        # into them, so they live as long as the graph (w4a8_matmul.scratch
        # replaces a set that a wider call outgrows)
        self.scratch: tuple = ()
        # device memory the capture reserved for the graph's private pool
        self.pool_bytes = 0

    @property
    def graphed(self) -> bool:
        return self.graph is not None

    def __call__(self) -> None:
        if not self.capture:
            self.body()
        elif self.graph is not None:
            self._replay()
        elif self.calls < WARMUP:
            self._warmup()
        else:
            self._capture()
            self._replay()
        self.calls += 1

    def _warmup(self) -> None:
        main = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            self.body()
        main.wait_stream(side)

    def _capture(self) -> None:
        if DEBUG_GRAPHS:
            # the node list is kept (keep_graph) and the graph instantiated
            # after the capture, as without it
            graph = torch.cuda.CUDAGraph(keep_graph=True)
            graph.enable_debug_mode()
        else:
            graph = torch.cuda.CUDAGraph()
        if self.generators and not hasattr(graph, "register_generator_state"):
            raise RuntimeError(
                "a sampled step needs torch.cuda.CUDAGraph."
                "register_generator_state, which this PyTorch "
                f"({torch.__version__}) lacks")
        for gen in self.generators:
            graph.register_generator_state(gen)
        before = [dict(table) for table in _COUNTS]
        sets = scratch_sets()
        # no garbage collection inside the capture (entering it collects
        # first): collecting a dead owner's graphs frees their pools, and
        # that cudaFree invalidates the capture
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph, capture_error_mode="thread_local"):
                # read inside: entering the capture empties the
                # allocator's cache first
                reserved = _reserved(self.device)
                self.body()
        finally:
            if collecting:
                gc.enable()
        if DEBUG_GRAPHS:
            graph.instantiate()
        self.pool_bytes = _reserved(self.device) - reserved
        self.scratch = sets + scratch_sets()
        self.launches = [{k: n - old[k] for k, n in table.items()
                          if n != old[k]}
                         for table, old in zip(_COUNTS, before)]
        _add(self.launches, -1)
        self.graph = graph

    def _replay(self) -> None:
        self.graph.replay()
        _add(self.launches)

    def dump(self, path: str) -> None:
        """Write the captured graph's nodes to ``path`` as Graphviz DOT
        (cudaGraphDebugDotPrint): every kernel a replay launches, by name.
        Needs DEBUG_GRAPHS set at the capture."""
        self.graph.debug_dump(path)


class StepGraphs:
    """GraphSteps by key, for one owner's parameters: a step captured the
    parameter tensors it read, so rebinding the owner's parameters (expert
    re-placement, a new tree) drops every step at the next lookup."""

    def __init__(self):
        self._steps: dict = {}
        self._params = None

    def get(self, params, key, make) -> GraphStep:
        if params is not self._params:
            self._steps.clear()
            self._params = params
        if key not in self._steps:
            self._steps[key] = make()
        return self._steps[key]

    def captured(self, kind: str | None = None) -> int:
        """How many of the steps hold a captured graph; with ``kind``
        (a key's first item: "prefill", "mixed", "decode") only those."""
        return sum(step.graphed for key, step in self._steps.items()
                   if kind is None or key[0] == kind)

    def pool_bytes(self) -> dict:
        """The captured steps' pool bytes summed by kind (a key's first
        item)."""
        out: dict = {}
        for key, step in self._steps.items():
            if step.graphed:
                out[key[0]] = out.get(key[0], 0) + step.pool_bytes
        return out


def readback(*tensors):
    """Start copying ``tensors`` to the host: (host copies, event or None).
    On the card each copy is asynchronous into pinned memory and the event
    is recorded after the last; read the copies after event.synchronize().
    On the CPU they are plain copies."""
    if tensors[0].device.type != "cuda":
        return tuple(t.clone() for t in tensors), None
    hosts = []
    for t in tensors:
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t, non_blocking=True)
        hosts.append(host)
    event = torch.cuda.Event()
    event.record(torch.cuda.current_stream(tensors[0].device))
    return tuple(hosts), event
