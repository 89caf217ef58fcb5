"""ServeEngine: executes scheduler batches as fixed-shape model steps
(counterpart of ktransformers_tpu/serving/engine.py).

scheduler (serving/scheduler.py) -> paged model step (models/paged.py) ->
sampler (engine/sampler.py); the KV pools are updated in place. The shapes
stay fixed: the decode batch always has ``max_batch_size`` rows indexed by
the query's slot (inactive rows carry a zero page table and write to the
trash page 0), and prefill chunks are padded to power-of-two buckets with
``valid`` marking the live tokens. That keeps MoE routing by row count
equal to the JAX package's; the padded rows are real work on the card.

Every model step is captured in a CUDA graph and replayed
(engine/cuda_graph.py; the JAX package jits each, its serving/engine.py:
186-211, 219-237 and 301-336), over static buffers:
- the decode-only step: its state lives in fixed buffers of
  ``max_batch_size`` rows (``_dstate``: tokens, lengths, page tables,
  sampling parameters, the active mask and, with collect_routing, the
  routed ids), which a change of the batch's composition refills in place,
  and the step writes its next tokens and lengths into the same buffers;
- a prefill chunk, one step a power-of-two bucket: the chunk's tokens
  [1, bucket], its page table [1, max_pages_per_query], start position,
  ``valid`` count and (hybrid) state slot, each [1], and the last valid
  row's logits [1, V];
- the fused mixed step, one a (bucket, number of chunks C), as the JAX
  package compiles one: ``_dstate`` and the chunks' tokens [C, bucket],
  page tables, start positions and ``valid`` counts, and their logits
  [C, V].
A chunk step's inputs are int32 views of one packed buffer, uploaded from
the host with one copy a dispatch (``_fill``).
The steps are keyed by every Python-level branch they take (penalized or
not, hybrid ``valid`` and slots, the sparse arguments, collect_routing);
the sampling generator is registered with the steps that sample. A step
writes its logits into its own buffer, which its next replay overwrites:
``step()`` dispatches every chunk of a plan (two may share a bucket)
before it reads any logits, so each dispatch copies its logits out first.
A hybrid slot's state is zeroed eagerly before its first chunk's step. On
the CPU, and where capture_allowed refuses (``graph_steps`` False,
experts in host memory, a parallel context), every step runs its body
eagerly on the same buffers.

Decode-only steps are PIPELINED: a step consumes device-resident tokens and
lengths and returns the next ones, so step N+1 is enqueued before step N's
tokens reach the host. The readback is a non-blocking copy into pinned host
memory plus a CUDA event, resolved up to ``decode_pipeline_depth`` steps
later (a plain copy on the CPU). The scheduler sees tokens that many steps
late; a finished query decodes a few extra tokens into its lookahead page,
and they are dropped.

Sampling draws come from one torch.Generator on the engine's device, seeded
in the constructor: sampled tokens differ from the JAX package's, greedy
tokens do not.

Both attention kinds of the port serve: MLA pools (ckv / k_pe) and GQA
pools (k / v per KV head); pool creation, trash-page writes, prefix reuse
and the spill tiers read pages by id and do not care which. A hybrid
model's GatedDeltaNet layers (qwen3-next) keep O(1) state per slot
instead of pages: a state cannot be rebuilt from pages, so prefix reuse is
off and spilling refused for such a model, a slot's state is zeroed before
its query's first prefill chunk, the decode batch's inactive rows leave
theirs untouched (``valid``) and decode and prefill run as separate steps.

Sparse long-context decode (``sparse_budget``, ``sparse_anchor``,
``sparse_retrieval``; ops/sparse_attention.py): the pools keep page
summaries, which every step updates; decode rows attend the top pages of
their anchor scores, in the decode-only step and in the fused mixed step
alike. Pages the allocator hands out are collected and their summaries
reset before the next step's launches, so a recycled page never carries
its previous occupant's extremes into a bound.

Routing statistics (``collect_routing``): each decode-only step also
writes its MoE layers' routed ids into the decode state, copied to the host
with its tokens, and when they are read back the active rows' ids are
counted in ``stats`` (utils/expert_placement.py
ExpertStatsCollector), as the JAX package's engine counts them (its
serving/engine.py:50, 146-157, 567-571; prefill chunks are not counted, and
the fused mixed step, which returns no ids, is off).
``apply_expert_rebalance(ep_size)`` drains the pipeline and stores every
MoE layer's experts in the frequency-balanced order for ep_size ranks
(balanced_logical_to_physical, reorder_expert_weights), then drops the
captured graphs, which read the old experts; the outputs do not change.
As in the JAX package, the engine never re-places on its own.
"""

from __future__ import annotations

import json
import math
import os
import threading
import time

import numpy as np
import torch

from ktransformers_tpu_torch.cache.paged import PagedKVCache, PageAllocator
from ktransformers_tpu_torch.cache.prefix import PrefixCache
from ktransformers_tpu_torch.engine.cuda_graph import (
    GraphStep,
    StepGraphs,
    capture_allowed,
    readback,
)
from ktransformers_tpu_torch.engine.local_chat import prompt_ids_error
from ktransformers_tpu_torch.engine.sampler import sample, sample_batched
from ktransformers_tpu_torch.models.paged import (
    forward_paged,
    forward_paged_mixed,
    sparse_args,
)
from ktransformers_tpu_torch.models.spec import ModelSpec
from ktransformers_tpu_torch.ops.moe import MoEWeights
from ktransformers_tpu_torch.ops.rope import precompute_rope_tables
from ktransformers_tpu_torch.serving.scheduler import (
    DECODE,
    DONE,
    Query,
    Scheduler,
    SchedulerConfig,
)
from ktransformers_tpu_torch.utils.device_prep import (
    params_to,
    prepare_params,
)
from ktransformers_tpu_torch.utils.expert_placement import (
    ExpertStatsCollector,
    balanced_logical_to_physical,
    reorder_expert_weights,
)
from ktransformers_tpu_torch.utils.observability import (
    StageTimer,
    check_numerics,
)


def _page_to_numpy(t: torch.Tensor) -> np.ndarray:
    """A host copy of one page's rows (bfloat16 as its int16 bits). Always
    a copy: the pools are written in place, on the CPU too."""
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.to("cpu", copy=True).numpy()


# the inputs of a prefill or mixed step, in their packed buffer's order
_CHUNK_INPUTS = ("tokens", "table", "start", "valid", "slot")


class ServeEngine:
    # model steps captured in CUDA graphs where capture_allowed says so
    # (False: every step eager, as a comparison on the card wants)
    graph_steps = True

    def __init__(self, params, spec: ModelSpec,
                 cfg: SchedulerConfig = SchedulerConfig(),
                 num_pages: int = 512, cache_dtype=torch.bfloat16,
                 compute_dtype=torch.bfloat16,
                 enable_prefix_cache: bool = True,
                 spill_tier=None,  # cache/tiers.py HostDiskTier
                 collect_routing: bool = False,
                 sparse_budget: int | None = None,
                 sparse_anchor: str = "quest",
                 sparse_retrieval: str = "layer", device="cuda"):
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.device = torch.device(device)
        # parameters already on the engine's device are used as they are
        # (one tree can serve a Generator and an engine); others are copied
        self.params = params_to(prepare_params(params, spec), self.device)
        self.spec = spec
        self.cfg = cfg
        self._hybrid = spec.hybrid
        if self._hybrid:
            if spill_tier is not None:
                raise ValueError("a hybrid model's linear-attention state "
                                 "cannot spill")
            enable_prefix_cache = False
        self.kv = PagedKVCache.create(spec, num_pages, cfg.page_size,
                                      dtype=cache_dtype, device=self.device,
                                      linear_slots=cfg.max_batch_size,
                                      summaries=sparse_budget is not None,
                                      anchor=sparse_anchor)
        # raises for kinds the attention does not take
        sparse_args(self.kv, spec, sparse_budget, sparse_anchor,
                    sparse_retrieval)
        self.sparse_budget = sparse_budget
        self.sparse_anchor = sparse_anchor
        self.sparse_retrieval = sparse_retrieval
        # pages handed out since the last step, whose summaries are reset
        # before the next launch
        self._stale_summary_pages: list[int] = []
        # page 0 = trash page for padding-row writes (see PageAllocator)
        self.alloc = PageAllocator(
            num_pages, reserved=1,
            on_alloc=(self._stale_summary_pages.extend
                      if sparse_budget is not None else None))
        self.prefix = (
            PrefixCache(
                self.alloc, cfg.page_size, spill=spill_tier,
                read_page=self._read_page if spill_tier else None,
                write_page=self._write_page if spill_tier else None,
            )
            if enable_prefix_cache else None
        )
        # per-query export: one JSON line per finished query, appended to
        # the file KT_REQUEST_LOG names
        self._request_log_path = os.environ.get("KT_REQUEST_LOG")
        self.scheduler = Scheduler(
            cfg, self.alloc, self.prefix,
            on_finish=self._log_request if self._request_log_path else None,
        )
        self.compute_dtype = compute_dtype
        self.rope_tables = precompute_rope_tables(spec.rope, self.device)
        # per-slot device-side sampling state (lazy; only allocated once a
        # query with repetition / presence / frequency penalties joins)
        self._counts = None  # [max_batch, V] int32 generated-token counts
        self._pmask = None  # [max_batch, V] bool prompt occurrence
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(0)
        # decode pipeline: device-resident batch state + in-flight steps
        # whose tokens have not been read back yet (see step())
        self._dstate = None
        self._decode_sig = None
        self._inflight = []
        self._graphs = StepGraphs()
        # the prefill and mixed steps' static buffers by (kind, shape)
        self._bufs: dict = {}
        # most unresolved decode steps in flight before a blocking resolve
        # of the oldest (see step())
        self.decode_pipeline_depth = int(
            os.environ.get("KT_DECODE_PIPELINE", "3"))
        # how many prefill chunks ride the fused mixed step (each extra
        # chunk shares the same weights pass)
        self._mixed_max_chunks = max(
            1, int(os.environ.get("KT_MIXED_MAX_CHUNKS", "2")))
        # per-stage host profile of the serving loop (enable with
        # KT_FORWARD_TIME_PROFILE=1; engine.timer.report())
        self.timer = StageTimer()
        self.check_numerics = os.environ.get("KT_CHECK_NUMERICS", "0") == "1"
        self._lock = threading.Lock()
        self._running = False
        self._thread = None
        self.steps_executed = 0
        self.mixed_steps_fused = 0
        self.collect_routing = collect_routing
        self.stats = None
        if collect_routing and spec.moe is not None:
            n_moe = sum(1 for li in range(spec.num_layers)
                        if spec.moe.is_moe_layer(li))
            self.stats = ExpertStatsCollector(n_moe, spec.moe.num_experts)

    # -- page spill callbacks -----------------------------------------------

    def _read_page(self, pid: int) -> dict:
        """Copy one page's KV (all layers) to host numpy."""
        out = {}
        for li in range(len(self.kv.bufs_a)):
            out[f"a{li}"] = _page_to_numpy(self.kv.bufs_a[li][pid])
            out[f"b{li}"] = _page_to_numpy(self.kv.bufs_b[li][pid])
        return out

    def _write_page(self, pid: int, payload: dict) -> None:
        """Upload a spilled page back into the device pool, in place."""
        for key, bufs in (("a", self.kv.bufs_a), ("b", self.kv.bufs_b)):
            for li, buf in enumerate(bufs):
                page = torch.from_numpy(np.ascontiguousarray(
                    payload[f"{key}{li}"]))
                if buf.dtype == torch.bfloat16:
                    page = page.view(torch.bfloat16)
                buf[pid] = page.to(self.device)

    # -- model steps --------------------------------------------------------

    def _bucket(self, n: int) -> int:
        """Chunk lengths are padded to a power of two (at least 16); the
        remainder is padding whose KV writes go to the trash page."""
        b = 16
        while b < n:
            b *= 2
        return b

    def _forward_args(self) -> dict:
        args = dict(rope_tables=self.rope_tables,
                    compute_dtype=self.compute_dtype)
        if self.sparse_budget is not None:
            args.update(sparse_budget=self.sparse_budget,
                        sparse_anchor=self.sparse_anchor,
                        sparse_retrieval=self.sparse_retrieval)
        return args

    def _reset_stale_summaries(self) -> None:
        """Clear the summaries of the pages allocated since the last call
        (recycled pages carry the previous occupant's keys' extremes)."""
        if self._stale_summary_pages:
            self.kv.reset_page_summaries(self._stale_summary_pages)
            self._stale_summary_pages.clear()

    def _sample_decode(self, logits, st, penalized: bool):
        """Next tokens and lengths of the decode batch from its logits
        [B, V], written into st["tokens"] / st["lengths"]. 'basic' samples
        with per-row temperature / top-k / top-p; 'penalized' also applies
        the per-slot generated-token counts and prompt mask, and counts the
        new tokens of the active rows."""
        active = st["active"].to(torch.int32)
        if penalized:
            toks = sample_batched(
                logits, self._gen, st["temps"], top_ks=st["top_ks"],
                top_ps=st["top_ps"], rep_pens=st["reps"],
                pres_pens=st["press"], freq_pens=st["freqs"],
                token_counts=self._counts, prompt_mask=self._pmask)
            rows = torch.arange(toks.shape[0], device=toks.device)
            self._counts[rows, toks] += active
        else:
            toks = sample_batched(logits, self._gen, st["temps"],
                                  top_ks=st["top_ks"], top_ps=st["top_ps"])
        st["tokens"].copy_(toks)
        st["lengths"].add_(active)

    @torch.no_grad()
    def _decode_step(self, st, penalized: bool):
        """One token for every row of the fixed decode batch. Chainable: it
        consumes st["tokens"] / st["lengths"] on the device and writes the
        next ones into the same buffers, so the following step needs no
        host round trip (and a CUDA graph of it finds them there)."""
        # a hybrid model's inactive rows must not advance their slot's
        # linear-attention state
        out = forward_paged(
            self.params, self.spec, st["tokens"][:, None], self.kv,
            st["tables"], st["lengths"], logits_last_only=True,
            valid=st["active"].to(torch.int32) if self._hybrid else None,
            collect_routing=self.stats is not None, **self._forward_args())
        self._sample_decode(out[0][:, -1], st, penalized)
        if self.stats is not None:
            # the routed ids [n_moe, B, k] of this step, for the statistics
            st["routing"].copy_(out[2])

    def _decode_graph(self, penalized: bool) -> GraphStep:
        """The decode-only step over the decode state's buffers, keyed by
        every Python-level branch it takes."""
        capture = capture_allowed(self.device, self.params, self.graph_steps)
        key = ("decode", penalized, self._hybrid, self.stats is not None,
               self.sparse_budget, self.sparse_anchor, self.sparse_retrieval,
               capture)
        return self._graphs.get(self.params, key, lambda: GraphStep(
            lambda: self._decode_step(self._dstate, penalized), self.device,
            capture, (self._gen,)))

    @torch.no_grad()
    def _mixed_step(self, st, b) -> None:
        """ONE model pass for the decode batch plus up to
        KT_MIXED_MAX_CHUNKS prefill chunks (distinct queries, in the chunk
        buffers ``b``), which share every dense / MoE weights pass: the
        decode rows' next tokens sampled into ``st``, the chunks' last
        logits written into b["logits"] [C, V]."""
        dec_logits, pre_logits, _ = forward_paged_mixed(
            self.params, self.spec, st["tokens"], b["tokens"], self.kv,
            st["tables"], st["lengths"], b["table"], b["start"], b["valid"],
            **self._forward_args())
        self._sample_decode(dec_logits, st, False)
        b["logits"].copy_(pre_logits)

    def _chunk_buffers(self, kind: str, c: int, bucket: int) -> dict:
        """The static inputs of ``c`` chunks padded to ``bucket`` tokens:
        int32 views (_CHUNK_INPUTS: tokens, page tables, start positions,
        valid counts and, hybrid only, state slots) of one packed buffer
        (``packed``), and their logits [c, V]; made at first use."""
        key = (kind, c, bucket)
        if key not in self._bufs:
            shapes = dict(tokens=(c, bucket),
                          table=(c, self.cfg.max_pages_per_query),
                          start=(c,), valid=(c,), slot=(c,))
            if not self._hybrid:
                del shapes["slot"]
            packed = torch.zeros(sum(math.prod(v) for v in shapes.values()),
                                 dtype=torch.int32, device=self.device)
            bufs, at = dict(packed=packed), 0
            for name, shape in shapes.items():
                bufs[name] = packed[at : at + math.prod(shape)].view(shape)
                at += math.prod(shape)
            bufs["logits"] = torch.zeros((c, self.spec.vocab_size),
                                         dtype=self.compute_dtype,
                                         device=self.device)
            self._bufs[key] = bufs
        return self._bufs[key]

    def _fill(self, bufs: dict, **arrays) -> None:
        """Pack the host arrays of bufs' inputs (_CHUNK_INPUTS, in order;
        ``slot`` is dropped where bufs has none) into one int32 array and
        upload it with one copy."""
        host = np.concatenate([
            np.asarray(arrays[name], np.int32).reshape(-1)
            for name in _CHUNK_INPUTS if name in bufs])
        bufs["packed"].copy_(torch.from_numpy(host))

    def _prefill_graph(self, bucket: int):
        """The prefill step of one chunk padded to ``bucket`` tokens, keyed
        by every Python-level branch forward_paged takes: (step, its
        _chunk_buffers)."""
        b = self._chunk_buffers("prefill", 1, bucket)
        capture = capture_allowed(self.device, self.params, self.graph_steps)
        key = ("prefill", bucket, self._hybrid, self.sparse_budget,
               self.sparse_anchor, self.sparse_retrieval, capture)

        def body():
            logits, _ = forward_paged(
                self.params, self.spec, b["tokens"], self.kv, b["table"],
                b["start"], logits_last_only=True, valid=b["valid"],
                slots=b.get("slot"),
                **self._forward_args())
            b["logits"].copy_(logits[:, -1])

        return self._graphs.get(self.params, key, lambda: GraphStep(
            body, self.device, capture)), b

    def _mixed_graph(self, c: int, bucket: int):
        """The fused mixed step of the decode batch and ``c`` chunks padded
        to ``bucket`` tokens: (step, its _chunk_buffers); the step samples
        the decode rows into _dstate and writes the chunks' logits."""
        b = self._chunk_buffers("mixed", c, bucket)
        capture = capture_allowed(self.device, self.params, self.graph_steps)
        key = ("mixed", bucket, c, self.sparse_budget, self.sparse_anchor,
               self.sparse_retrieval, capture)
        return self._graphs.get(self.params, key, lambda: GraphStep(
            lambda: self._mixed_step(self._dstate, b), self.device, capture,
            (self._gen,))), b

    def _can_fuse_mixed(self, qs: list[Query]) -> bool:
        return (os.environ.get("KT_FUSED_MIXED", "1") != "0"
                and not self._hybrid
                and self.stats is None
                and not any(q.sampling.needs_counts for q in qs))

    def _reset_linear_state(self, slot: int) -> None:
        """Zero a slot's GatedDeltaNet states before its query's first
        prefill chunk: unlike pages, they are reused by slot index."""
        for li in self.kv.linear_layers:
            self.kv.bufs_a[li][slot] = 0
            self.kv.bufs_b[li][slot] = 0

    # -- execution ----------------------------------------------------------

    def _pad_table(self, pages: list[int]) -> np.ndarray:
        pt = np.zeros(self.cfg.max_pages_per_query, np.int32)
        pt[: len(pages)] = pages
        return pt

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device)

    def _prompt_mask(self, q: Query) -> np.ndarray:
        pm = np.zeros((self.spec.vocab_size,), bool)
        pm[np.asarray(q.prompt, np.int64)] = True
        return pm

    def _init_slot_state(self, q: Query) -> None:
        """(Re)build the query's per-slot device sampling state, generated
        token counts + prompt mask, from host bookkeeping (fresh queries
        after their first token; preempted queries on resume)."""
        v = self.spec.vocab_size
        b = self.cfg.max_batch_size
        if self._counts is None:
            self._counts = torch.zeros((b, v), dtype=torch.int32,
                                       device=self.device)
            self._pmask = torch.zeros((b, v), dtype=torch.bool,
                                      device=self.device)
        row = np.zeros((v,), np.int32)
        for t in q.output_ids:
            row[t] += 1
        self._counts[q.slot] = self._to_device(row)
        self._pmask[q.slot] = self._to_device(self._prompt_mask(q))

    def _first_token(self, q: Query, logits) -> int:
        """Sample the first generated token from the last prefill logits
        [1, V], honoring the query's full sampling config."""
        sc = q.sampling
        counts = pmask = None
        if sc.needs_counts:
            pmask = self._to_device(self._prompt_mask(q))[None]
            counts = torch.zeros((1, logits.shape[-1]), dtype=torch.int32,
                                 device=self.device)
        return int(sample(logits, self._gen, sc, token_counts=counts,
                          prompt_mask=pmask)[0])

    def _dispatch_prefill(self, q: Query, chunk: list[int]):
        """Enqueue one bucketed prefill chunk through its bucket's step;
        returns a copy of its logits ([1, 1, V], taken at the last VALID
        position): the next chunk of the bucket overwrites the step's."""
        if self._hybrid and q.prefill_pos == 0:
            self._reset_linear_state(q.slot)
        bucket = self._bucket(len(chunk))
        step, b = self._prefill_graph(bucket)
        tokens = np.zeros((1, bucket), np.int32)
        tokens[0, : len(chunk)] = chunk
        self._fill(b, tokens=tokens, table=self._pad_table(q.pages)[None],
                   start=np.asarray([q.prefill_pos], np.int32),
                   valid=np.asarray([len(chunk)], np.int32),
                   slot=np.asarray([q.slot], np.int32))
        step()
        return b["logits"][:, None].clone()

    def _finish_prefill(self, q: Query, chunk: list[int], logits) -> None:
        self.scheduler.prefill_done_chunk(q, len(chunk))
        if q.state != DECODE:
            return
        if not q.resumed:
            # first generated token comes from the last prefill logits;
            # resumed (preempted) queries already hold their last token
            self.scheduler.push_token(q, self._first_token(q, logits[:, -1]))
        if q.state == DECODE and q.sampling.needs_counts:
            self._init_slot_state(q)

    def _ensure_decode_pages(self, qs: list[Query]) -> list[Query]:
        """Guarantee every decoding query a page for its next token,
        preempting the newest queries under page exhaustion instead of
        raising (FCFS order is preserved: the oldest query always
        survives)."""
        qs = list(qs)
        # lookahead: with k steps in flight the device length runs k ahead
        # of host total_len, so the next step writes KV at up to
        # total_len + k; keep the +1 margin on top
        ahead = 1 + len(self._inflight) + 1
        while qs:
            failed = None
            for q in qs:
                if not self.scheduler._ensure_pages(q, q.total_len + ahead):
                    failed = q
                    break
            if failed is None:
                return qs
            victim = max(qs, key=lambda q: q.id)
            self.scheduler.preempt(victim)
            qs.remove(victim)
        return qs

    def _decode_signature(self, qs: list[Query], penalized: bool):
        """Device decode state stays valid while the batch composition,
        sampling configs, and page tables are unchanged."""
        return (
            penalized,
            tuple((q.id, q.slot, len(q.pages), q.sampling) for q in qs),
        )

    def _build_decode_state(self, qs: list[Query]) -> None:
        """Host -> device upload of the full decode-batch state, packed
        into two transfers (one int32, one float32), copied into the fixed
        buffers of ``_dstate`` (made at the first call)."""
        b = self.cfg.max_batch_size  # fixed shape
        pmax = self.cfg.max_pages_per_query
        ints = np.zeros((3 + pmax, b), np.int32)  # tokens/lengths/top_k/table
        fpack = np.zeros((6, b), np.float32)  # temps/top_p/rep/pres/freq/act
        fpack[1] = 1.0
        fpack[2] = 1.0
        for q in qs:
            # rows indexed by the query's stable slot: the token being
            # decoded is the last generated one; its KV gets written at
            # position total_len - 1
            i = q.slot
            sc = q.sampling
            ints[0, i] = q.last_token
            ints[1, i] = q.total_len - 1
            ints[2, i] = sc.top_k
            ints[3:, i] = self._pad_table(q.pages)
            fpack[:, i] = (sc.temperature, sc.top_p, sc.repetition_penalty,
                           sc.presence_penalty, sc.frequency_penalty, 1.0)
        ints_d = self._to_device(ints)
        f_d = self._to_device(fpack)
        new = dict(
            tokens=ints_d[0], lengths=ints_d[1], top_ks=ints_d[2],
            tables=ints_d[3:].T,
            temps=f_d[0], top_ps=f_d[1], reps=f_d[2], press=f_d[3],
            freqs=f_d[4], active=f_d[5],
        )
        if self._dstate is None:
            self._dstate = {
                k: torch.empty(v.shape, device=self.device,
                               dtype=torch.int64 if k == "tokens"
                               else v.dtype)
                for k, v in new.items()}
            if self.stats is not None:
                self._dstate["routing"] = torch.zeros(
                    (self.stats.counts.shape[0], b, self.spec.moe.top_k),
                    dtype=torch.int32, device=self.device)
        for k, v in new.items():
            self._dstate[k].copy_(v)

    def _dispatch_decode(self, qs: list[Query]):
        """Enqueue one decode step from device-resident state and queue
        its tokens for a later (overlapped) readback."""
        penalized = any(q.sampling.needs_counts for q in qs)
        sig = self._decode_signature(qs, penalized)
        if sig != self._decode_sig:
            self._drain_decode()
            # the drain delivers pending tokens, which may FINISH (or
            # preempt) members of qs; dispatching for them afterwards
            # would snapshot a freed slot and waste a step
            qs = [q for q in qs if q.state == DECODE]
            if not qs:
                self._decode_sig = None
                return
            penalized = any(q.sampling.needs_counts for q in qs)
            self._build_decode_state(qs)
            self._decode_sig = self._decode_signature(qs, penalized)
        self._decode_graph(penalized)()
        st = self._dstate
        # the next step overwrites the buffers: their tokens (and routed
        # ids) go to the host now
        hosts, event = readback(st["tokens"], *(
            [st["routing"]] if self.stats is not None else []))
        # snapshot slots: a query preempted / finished while in flight has
        # its slot freed (possibly reused only after the drain that any
        # composition change forces)
        self._inflight.append(([(q, q.slot) for q in qs], hosts[0], event,
                               *hosts[1:]))

    def _drain_decode(self) -> None:
        while self._inflight:
            self._resolve_decode(*self._inflight.pop(0))

    def _resolve_decode(self, qs_slots, host_toks, event=None,
                        routing=None) -> None:
        if event is not None:
            event.synchronize()
        toks_np = host_toks.numpy()
        if self.check_numerics:
            check_numerics(toks_np, "decode tokens")
        if routing is not None:
            # [n_moe, B, k] logical ids; the rows active at dispatch
            r = routing.numpy()
            slots = [s for _, s in qs_slots]
            for li in range(r.shape[0]):
                self.stats.record(li, r[li, slots])
        for q, slot in qs_slots:
            # skip queries that finished or were preempted while this step
            # was in flight
            if q.state != DECODE or q.slot != slot:
                continue
            self.scheduler.push_token(q, int(toks_np[slot]))

    def _dispatch_mixed(self, decode_qs: list[Query], fused) -> list:
        """Run the decode batch and the chunks of ``fused`` as one model
        pass; returns [(query, chunk, logits [1, 1, V])]."""
        sig = self._decode_signature(decode_qs, False)
        if sig != self._decode_sig:
            self._build_decode_state(decode_qs)
            self._decode_sig = sig
        c = len(fused)
        bucket = self._bucket(max(len(ch) for _, ch in fused))
        step, b = self._mixed_graph(c, bucket)
        pt = np.zeros((c, bucket), np.int32)
        tables = np.zeros((c, self.cfg.max_pages_per_query), np.int32)
        poss = np.zeros((c,), np.int32)
        valids = np.zeros((c,), np.int32)
        for i, (q, ch) in enumerate(fused):
            pt[i, : len(ch)] = ch
            tables[i] = self._pad_table(q.pages)
            poss[i] = q.prefill_pos
            valids[i] = len(ch)
        self._fill(b, tokens=pt, table=tables, start=poss, valid=valids)
        step()
        self.mixed_steps_fused += 1
        # the next replay overwrites the step's logits
        pre_logits = b["logits"].clone()
        (host,), event = readback(self._dstate["tokens"])
        self._resolve_decode([(q, q.slot) for q in decode_qs], host, event)
        return [(q, ch, pre_logits[i : i + 1, None])
                for i, (q, ch) in enumerate(fused)]

    def step(self) -> bool:
        """Run one scheduler batch (decode batch + at most
        max_prefills_per_step prefill chunks); returns False when idle."""
        self.timer.stage("schedule")
        plan = self.scheduler.next_batch()
        if plan is None:
            self._drain_decode()  # deliver tail tokens before going idle
            self.timer.end()
            return False
        decode_qs = (
            self._ensure_decode_pages(plan.decode) if plan.decode else []
        )
        # after every allocation of this step, before its first launch
        self._reset_stale_summaries()
        self.timer.stage("dispatch")
        pending = []
        fuse = bool(decode_qs and plan.prefills
                    and self._can_fuse_mixed(decode_qs))
        if fuse:
            # flush the pipeline first: its tokens may finish members of
            # the batch
            self._drain_decode()
            decode_qs = [q for q in decode_qs if q.state == DECODE]
            fuse = bool(decode_qs)
        if fuse:
            n = self._mixed_max_chunks
            pending = self._dispatch_mixed(decode_qs, plan.prefills[:n])
            for q, chunk in plan.prefills[n:]:
                pending.append((q, chunk, self._dispatch_prefill(q, chunk)))
            self.timer.stage("readback")
        else:
            # enqueue everything (decode first: its tokens resolve first)
            # before reading anything back: prefill chunks execute behind
            # the decode step on the device while the host already
            # collects tokens
            if decode_qs:
                self._dispatch_decode(decode_qs)
            for q, chunk in plan.prefills:
                pending.append((q, chunk, self._dispatch_prefill(q, chunk)))
            self.timer.stage("readback")
            if pending:
                # mixed step: prefill completions change the batch
                # composition, so flush the decode pipeline now
                self._drain_decode()
            elif len(self._inflight) >= self.decode_pipeline_depth:
                # blocking resolve of the oldest step; the younger ones
                # keep the device busy meanwhile
                self._resolve_decode(*self._inflight.pop(0))
        self.timer.stage("bookkeeping")
        for q, chunk, logits in pending:
            self._finish_prefill(q, chunk, logits)
        self.timer.end()
        self.steps_executed += 1
        return True

    def apply_expert_rebalance(self, ep_size: int = 1) -> None:
        """Store each MoE layer's experts in the order that balances the
        counted routing over ``ep_size`` ranks (stop the world: the decode
        pipeline is drained first and its state rebuilt after). The
        outputs do not change: the map sends each logical id to its new
        slot (JAX serving/engine.py:581-611)."""
        if self.stats is None:
            raise ValueError("apply_expert_rebalance needs collect_routing")
        self._drain_decode()
        freqs = self.stats.frequencies
        layers, li_moe = [], 0
        for li, lp in enumerate(self.params["layers"]):
            if "moe" not in lp:
                layers.append(lp)
                continue
            w = lp["moe"]["experts"]
            if not isinstance(w, MoEWeights):
                raise ValueError(f"layer {li}: experts in host memory are "
                                 "not re-placed")
            l2p = balanced_logical_to_physical(freqs[li_moe], ep_size)
            layers.append({**lp, "moe": {
                **lp["moe"], "experts": reorder_expert_weights(w, l2p)}})
            li_moe += 1
        # a new tree: the graphs captured over the old experts are dropped
        # at the next step (StepGraphs), and the decode state is refilled
        self.params = {**self.params, "layers": layers}
        self._decode_sig = None

    # -- public API ---------------------------------------------------------

    def admission_error(self, prompt, max_new_tokens: int) -> str | None:
        """Why a query cannot run here, or None: an empty prompt, an id
        outside the vocabulary, or more tokens (with the decode pipeline's
        lookahead) than a page table, the page pool or the rope tables
        hold. Past the page table the step fails, past the pool the query
        waits for ever."""
        if not prompt:
            return "empty prompt"
        err = prompt_ids_error(prompt, self.spec.vocab_size)
        if err:
            return err
        pool = self.alloc.num_pages - self.alloc.reserved
        room = min(min(self.cfg.max_pages_per_query, pool)
                   * self.cfg.page_size, self.spec.rope.max_position) \
            - self.decode_pipeline_depth - 2
        if len(prompt) + max_new_tokens > room:
            return (f"prompt of {len(prompt)} tokens plus max_tokens "
                    f"{max_new_tokens} exceeds the {room} tokens a query may "
                    "hold")
        return None

    def submit(self, prompt, **kw) -> Query:
        with self._lock:
            return self.scheduler.add_query(list(prompt), **kw)

    def cancel(self, q: Query) -> None:
        """Abort a query (client disconnect). An in-flight pipelined step
        that still references it resolves harmlessly: _resolve_decode
        skips queries that are not decoding."""
        with self._lock:
            self.scheduler.cancel(q)

    def _log_request(self, q: Query) -> None:
        rec = {
            "id": q.id,
            "prompt_tokens": len(q.prompt),
            "output_tokens": len(q.output_ids),
            "matched_prefix_tokens": q.matched_len,
            "ttft_s": round(q.ttft, 4) if q.ttft is not None else None,
            "tbt_s": round(q.tbt, 5) if q.tbt is not None else None,
            "finish_reason": q.finish_reason,
            "preemptions": q.preemptions,
            "wall_s": round((q.finished_at or 0) - q.created, 3),
            "ts": time.time(),
        }
        with open(self._request_log_path, "a") as f:
            f.write(json.dumps(rec) + "\n")

    def generate_sync(self, prompt, **kw) -> list[int]:
        """Blocking single-query helper."""
        q = self.submit(prompt, **kw)
        while q.state != DONE:
            with self._lock:
                if not self.step():
                    time.sleep(0.001)
        return list(q.output_ids)

    def run_forever(self, poll_s: float = 0.002) -> None:
        self._running = True
        while self._running:
            with self._lock:
                busy = self.step()
            if not busy:
                time.sleep(poll_s)

    def start(self) -> None:
        self._thread = threading.Thread(target=self.run_forever, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._running = False
        if self._thread:
            self._thread.join(timeout=5)

    def metrics(self) -> dict:
        m = self.scheduler.metrics()
        m["engine_steps"] = self.steps_executed
        m["mixed_steps_fused"] = self.mixed_steps_fused
        return m

    def reset_metrics(self) -> None:
        """Forget finished-query stats (e.g. after a warm-up wave)."""
        self.scheduler.finished.clear()
        self.steps_executed = 0
        self.mixed_steps_fused = 0
        self.timer.totals.clear()
        self.timer.counts.clear()
