"""Bigger-than-card serving: attention, norms, router and shared experts on
the card, the routed experts' FFN on the host in C++ (counterpart of
ktransformers_tpu/offload/host_engine.py).

``split_params_for_offload`` moves each MoE layer's routed experts to host
RAM (offload/host_moe.py: HostMoELayer, the int4_g codes re-laid-out for
csrc/host_moe.cpp) and leaves the rest of the tree for the card. Call it on
params that utils/device_prep.prepare_params has not repacked for W4A8,
or on repacked ones: the packer reads the group-split codes either way
(quant/formats.raw_int4_data).

``offload_params`` then puts a ``HostExperts`` in the place of each MoE
layer's MoEWeights. ops/moe.py:moe_forward hands it the layer's routed
rows, so the resident layer loop (models/model.py:forward, and
models/paged.py:forward_paged and forward_paged_mixed behind the
ServeEngine) runs unchanged with the host hop inside it. A hop
1. copies the activations, expert ids and combine weights into pinned host
   buffers with non_blocking=True and records an event;
2. waits on that event only (never on the whole device);
3. runs the C++ expert FFN (ctypes releases the GIL for it);
4. copies the output back to the card with non_blocking=True.
The layer then adds its shared expert as the resident path does, after the
hop in stream order. The staging buffers are shared by every layer of one
model: the hops run one after another on one stream, and a buffer is
rewritten only after the host has waited on an event recorded behind the
copy that last read it.

The hop's activations cross in their compute dtype (``transfer_dtype=None``:
float32 end to end under float32 compute, the tests' setting) or in
bfloat16, which rounds x, the combine weights and the expert output to bf16
as the JAX package's pack_activations / run_host_moe do. Expert ids cross as
int32 either way (the JAX package splits them into two bf16 digits; both
are exact). Padding rows (a bucketed chunk's tail, an inactive decode slot)
reach the host like any other row, as they reach the card's experts on the
resident path.

``HostOffloadGenerator`` is the resident Generator over such a tree, with
the JAX package's forward_chunk / generate API. Its microbatches
(``forward_chunk_pipelined``, ``generate(..., microbatches=)``) run one
after another: the JAX package overlaps one microbatch's host FFN with the
others' device segments, which here waits on a measurement that the
overlap gains time (ROADMAP Queue 1 item 10).

Supported specs, as in the JAX package: an optional dense prefix, then
MoE on every layer (DeepSeek V2 / V3, Kimi, Qwen2 / Qwen3-MoE, Mixtral,
GLM4-MoE). The JAX segments call _gqa_attention with neither window nor
rope switch and route from the post-attention norm, so they compute
SmallThinker (windows, NoPE layers, the early router) and Qwen3-Next
(linear-attention layers) wrongly and leave the port no reference there;
the port raises ValueError for each of those, for experts with LoRA
factors and for every activation the C++ does not compute
(host_moe.activation_code).
"""

from __future__ import annotations

import torch

from ktransformers_tpu_torch.engine.generate import Generator
from ktransformers_tpu_torch.engine.sampler import SamplingConfig, sample
from ktransformers_tpu_torch.models.model import KVCache
from ktransformers_tpu_torch.models.spec import ModelSpec
from ktransformers_tpu_torch.offload.host_moe import (
    HostMoELayer,
    activation_code,
)
from ktransformers_tpu_torch.ops.activations import ActivationConfig
from ktransformers_tpu_torch.ops.moe import MoEWeights
from ktransformers_tpu_torch.utils.device_prep import params_to

HOP_RANGE = "offload::host_moe"  # profiler range of a host hop


def check_offload_spec(spec: ModelSpec) -> None:
    """Raise ValueError, naming what, for a spec that the JAX package's
    offloaded segments compute wrongly (no reference to hold the port to)
    or that the C++ cannot compute: no MoE, hybrid linear-attention
    layers, sliding windows, NoPE layers, the early router, an activation
    the C++ does not compute."""
    bad = []
    if spec.moe is None:
        bad.append("a model without MoE layers")
    if spec.hybrid:
        bad.append("hybrid linear-attention layers")
    n = spec.num_layers
    if any(spec.layer_window(li) for li in range(n)):
        bad.append("sliding-window layers")
    if not all(spec.layer_uses_rope(li) for li in range(n)):
        bad.append("NoPE layers")
    if spec.moe is not None and spec.moe.early_router:
        bad.append("the early router")
    if bad:
        raise ValueError(f"host offload does not support {', '.join(bad)} "
                         f"({spec.model_type})")
    activation_code(spec.activation)


def moe_tail_start(spec: ModelSpec) -> int:
    """The first MoE layer, where every later layer is MoE too (the one
    layout the offloaded segments take); raises ValueError otherwise."""
    n = spec.num_layers
    lis = [li for li in range(n) if spec.moe.is_moe_layer(li)]
    if not lis or lis != list(range(lis[0], n)):
        raise ValueError("host offload supports a dense prefix followed by "
                         f"MoE layers only, not MoE at {lis}")
    return lis[0]


def check_host_layers(spec: ModelSpec, host_layers: dict) -> None:
    """Raise ValueError unless ``host_layers`` holds exactly the MoE layers
    of a supported spec."""
    check_offload_spec(spec)
    first = moe_tail_start(spec)
    if sorted(host_layers) != list(range(first, spec.num_layers)):
        raise ValueError(f"host layers {sorted(host_layers)} are not the "
                         f"MoE layers {first}..{spec.num_layers - 1}")


def split_params_for_offload(params, spec: ModelSpec):
    """(device params, {layer: HostMoELayer}): each MoE layer's routed
    experts go to host RAM; the device tree keeps router, shared expert,
    norms and attention (the same tensors, where they lie). The host FFN
    runs on torch.get_num_threads() OpenMP threads (HostMoELayer)."""
    check_offload_spec(spec)
    first = moe_tail_start(spec)
    host, layers = {}, []
    for li, lp in enumerate(params["layers"]):
        if li < first:
            layers.append(lp)
            continue
        moe = dict(lp["moe"])
        w = moe.pop("experts")
        if not isinstance(w, MoEWeights):
            raise ValueError(f"layer {li}: experts already offloaded "
                             f"({type(w).__name__})")
        if w.lora is not None:
            raise ValueError(f"layer {li}: experts with LoRA factors are "
                             "not offloaded")
        if w.logical_to_physical is not None or w.expert_mask is not None \
                or w.n_shared_fused:
            raise ValueError(f"layer {li}: an expert map, mask or fused "
                             "shared experts are not offloaded to the host "
                             "FFN")
        host[li] = HostMoELayer.from_qtensors(w.gate_up, w.down,
                                              spec.activation)
        layers.append({**lp, "moe": moe})
    return {**params, "layers": layers}, host


class HopStaging:
    """The pinned host buffers of one model's hops, by row count and
    activation dtype, shared by its layers; plain CPU tensors when the
    activations lie on the CPU."""

    def __init__(self, transfer_dtype=None):
        self.transfer_dtype = transfer_dtype
        self._bufs: dict = {}

    def get(self, rows: int, hidden: int, k: int, x: torch.Tensor) -> dict:
        key = (rows, hidden, k, x.dtype, x.device.type)
        if key not in self._bufs:
            pin = x.device.type == "cuda"
            td = self.transfer_dtype

            def buf(cols, dt):
                return torch.empty(rows, cols, dtype=dt, pin_memory=pin)

            self._bufs[key] = dict(
                x=buf(hidden, x.dtype if td is None else td),
                ids=buf(k, torch.int32),
                w=buf(k, torch.float32 if td is None else td),
                y=buf(hidden, torch.float32),
                y_t=None if td is None else buf(hidden, td))
        return self._bufs[key]


class HostExperts:
    """One MoE layer's routed experts in host RAM, in the place of its
    MoEWeights: ops/moe.py:moe_forward hands it the routed rows and it
    runs the host hop (see the module docstring). Not a dataclass, so the
    params tree walkers (params_to, prepare_params) leave it as it is."""

    def __init__(self, layer: HostMoELayer, staging: HopStaging):
        self.layer = layer
        self.staging = staging

    def forward(self, x: torch.Tensor, topk_idx: torch.Tensor,
                topk_weights: torch.Tensor,
                act: ActivationConfig = ActivationConfig()) -> torch.Tensor:
        """x [T, d]; topk_idx [T, k]; topk_weights [T, k] float32 -> the
        combined expert output [T, d] in x's dtype, on x's device."""
        t, k = topk_idx.shape
        td = self.staging.transfer_dtype
        b = self.staging.get(t, x.shape[1], k, x)
        with torch.profiler.record_function(HOP_RANGE):
            b["x"].copy_(x if td is None else x.to(td), non_blocking=True)
            b["ids"].copy_(topk_idx.to(torch.int32), non_blocking=True)
            b["w"].copy_(topk_weights.to(b["w"].dtype), non_blocking=True)
            if x.device.type == "cuda":
                ev = torch.cuda.Event()
                ev.record(torch.cuda.current_stream(x.device))
                ev.synchronize()
            self.layer.forward(b["x"].float(), b["ids"], b["w"].float(),
                               out=b["y"])
            y = b["y"]
            if b["y_t"] is not None:
                b["y_t"].copy_(y)
                y = b["y_t"]
            return y.to(x.device, non_blocking=True, copy=True).to(x.dtype)


def offload_params(params, spec: ModelSpec, host_layers: dict | None = None,
                   transfer_dtype=None):
    """(params, host_layers): the tree with a HostExperts on each MoE
    layer (one HopStaging for all), splitting the experts off first when
    ``host_layers`` is None. The caller's dicts are not changed, so one
    host_layers can serve several engines."""
    if host_layers is None:
        params, host_layers = split_params_for_offload(params, spec)
    check_host_layers(spec, host_layers)
    staging = HopStaging(transfer_dtype)
    layers = [{**lp, "moe": {**lp["moe"], "experts": HostExperts(
        host_layers[li], staging)}} if li in host_layers else lp
        for li, lp in enumerate(params["layers"])]
    return {**params, "layers": layers}, host_layers


class HostOffloadGenerator(Generator):
    """Batch generation with host-resident routed experts on one device
    (``cuda`` unless told otherwise): the resident Generator over the tree
    of offload_params."""

    def __init__(self, params, spec: ModelSpec, host_layers: dict | None = None,
                 max_len: int = 2048, batch: int = 8,
                 cache_dtype=torch.bfloat16, compute_dtype=torch.bfloat16,
                 transfer_dtype=None, device="cuda"):
        params, self.host = offload_params(params, spec, host_layers,
                                           transfer_dtype)
        super().__init__(params, spec, max_len, batch, cache_dtype,
                         compute_dtype, device)
        self.params = params_to(self.params, self.device)
        self.transfer_dtype = transfer_dtype

    def new_cache(self, batch: int | None = None) -> KVCache:
        return KVCache.create(self.spec, batch or self.batch, self.max_len,
                              self.cache_dtype, self.device)

    @torch.no_grad()
    def forward_chunk(self, tokens: torch.Tensor, cache: KVCache,
                      temperature: float = 0.0,
                      generator: torch.Generator | None = None):
        """The whole layer stack over S new tokens [B, S]: (next token [B],
        last logits [B, V] float32, cache); the cache is written in place
        and advances by S."""
        logits, cache = self._forward(tokens.to(self.device), cache, True)
        logits = logits[:, -1].to(torch.float32)
        return (sample(logits, generator,
                       SamplingConfig(temperature=temperature)),
                logits, cache)

    def forward_chunk_pipelined(self, tokens_list: list, caches: list,
                                temperature: float = 0.0,
                                generator: torch.Generator | None = None
                                ) -> list:
        """forward_chunk over several microbatches, one after another:
        [(tok, logits, cache)]."""
        return [self.forward_chunk(t, c, temperature, generator)
                for t, c in zip(tokens_list, caches)]

    def generate(self, prompts: list, max_new_tokens: int = 32,
                 prefill_chunk: int = 256, temperature: float = 0.0,
                 seed: int = 0, microbatches: int = 1) -> list:
        """Generation for up to ``batch`` prompts of any lengths (the JAX
        package's rule): the batch prefills together up to the shortest
        prompt, then rows with prompt left are fed their own next prompt
        token (teacher forcing) while the others decode, so under greedy
        each row's output is its own single-prompt run's. ``microbatches``
        > 1 splits the batch for forward_chunk_pipelined."""
        n, m = len(prompts), microbatches
        if not 0 < n <= self.batch or self.batch % m:
            raise ValueError(f"{n} prompts, batch {self.batch}, "
                             f"{m} microbatches")
        rows = list(prompts) + [prompts[0]] * (self.batch - n)
        lens = torch.tensor([len(p) for p in rows])
        if int(lens.max()) + max_new_tokens > self.max_len:
            raise ValueError("prompt + max_new_tokens exceeds max_len")
        toks = torch.zeros(self.batch, int(lens.max()), dtype=torch.int64)
        for i, p in enumerate(rows):
            toks[i, :len(p)] = torch.as_tensor(p)
        bs = self.batch // m
        caches = [self.new_cache(bs) for _ in range(m)]
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)

        def run(chunk):
            outs = self.forward_chunk_pipelined(
                list(chunk.split(bs)), caches, temperature, gen)
            return torch.cat([o[0] for o in outs]).cpu()

        min_len = int(lens.min())
        for lo in range(0, min_len, prefill_chunk):
            cur = run(toks[:, lo:min(lo + prefill_chunk, min_len)])
        out = [[] for _ in range(n)]
        cache_len = min_len
        while True:
            forced = cache_len < lens
            for i in range(n):
                if not forced[i] and len(out[i]) < max_new_tokens:
                    out[i].append(int(cur[i]))
            if all(len(o) >= max_new_tokens for o in out):
                return out
            col = toks[:, min(cache_len, toks.shape[1] - 1)]
            cur = run(torch.where(forced, col, cur)[:, None])
            cache_len += 1
