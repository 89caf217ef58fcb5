"""Generator: prefill chunks and one-token decode steps captured in CUDA
graphs (counterpart of ktransformers_tpu/engine/generate.py:Generator,
single user).

``generate`` runs its steps through GraphSteps (engine/cuda_graph.py), the
JAX package's jitted steps with the cache donated, over the Generator's
static buffers (``decode_state()``: the step cache, its input / output
tokens, the penalty counts and prompt mask, a token buffer [B, n] of the
chunk length n and the last logits [B, V]), each captured once per key and
replayed:
- the prefill chunk of n = cfg.prefill_chunk tokens (its
  ``_prefill_step_fn(n)``): forward() of ``chunk(n)`` into the step cache,
  the chunk's last logits written into ``logits``. A shorter tail chunk
  runs the same body eagerly: the contiguous cache's forward has no
  ``valid`` argument, so a tail is not padded, and a step a tail length
  (the JAX package jits one a ``q_len``) would keep a graph and its memory
  pool for every length a prompt ever ended on;
- the decode step (its ``_decode_step`` / ``_decode_step_penalized``):
  forward() + sampling (+ the penalties' counts).
The keys hold the step's kind, what selects the body (the chunk length,
the SamplingConfig) and every module attribute forward() reads at call
time (ops.attention.MLA_FUSED, BLOCKWISE_KV_THRESHOLD). Each ``generate`` resets
the step cache in place and reseeds the sampling generator, which the
decode graphs have registered; the first token is sampled eagerly from
``logits``.

The loop is the JAX package's depth-D software pipeline (its
generate.py:283-360): up to ``KT_GENERATE_PIPELINE`` (default 24) steps in
flight, each step's tokens copied to pinned host memory as it is
dispatched, the oldest resolved on the host, where EOS ends a row; EOS is
seen D - 1 steps late and the extra steps' tokens are dropped.
``on_token`` receives each step's tokens as a CPU tensor [B] (the JAX loop
passes numpy), in bunches as the pipeline resolves them.

``prefill``, ``decode_step`` and ``_forward`` stay eager and public:
speculation (engine/speculative.py, draft_spec.py, mtp.py) and the checks
drive them on caches of their own. On the CPU, and on the card where
capture_allowed refuses (experts in host memory, a parallel context),
every step body runs eagerly on the same buffers.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from ktransformers_tpu_torch.engine.cuda_graph import (
    GraphStep,
    StepGraphs,
    capture_allowed,
    readback,
)
from ktransformers_tpu_torch.engine.sampler import SamplingConfig, sample
from ktransformers_tpu_torch.models.model import KVCache, forward
from ktransformers_tpu_torch.ops import attention
from ktransformers_tpu_torch.models.spec import ModelSpec
from ktransformers_tpu_torch.ops.rope import precompute_rope_tables
from ktransformers_tpu_torch.utils.device_prep import prepare_params


@dataclasses.dataclass(frozen=True)
class GenerateConfig:
    max_new_tokens: int = 128
    prefill_chunk: int = 256
    sampling: SamplingConfig = SamplingConfig()
    eos_token_id: int | None = None
    seed: int = 0


def _count(counts: torch.Tensor, tok: torch.Tensor) -> None:
    """counts[b, tok[b]] += 1 for every row, in place on the device."""
    counts.scatter_add_(1, tok[:, None], torch.ones_like(counts[:, :1]))


def _view(cache: KVCache) -> KVCache:
    """A KVCache over the same tensors, whose rebinds leave ``cache``
    alone (forward() rebinds lengths and a linear layer's states)."""
    return KVCache(cache.lengths, list(cache.bufs_a), list(cache.bufs_b))


def _commit(static: KVCache, cache: KVCache) -> None:
    """Copy every tensor forward() rebound in ``cache`` (a _view of
    ``static``) back into static's buffer: the new lengths, GatedDeltaNet's
    new conv tails and recurrent states."""
    if cache.lengths is not static.lengths:
        static.lengths.copy_(cache.lengths)
    for bufs, new in ((static.bufs_a, cache.bufs_a),
                      (static.bufs_b, cache.bufs_b)):
        for buf, t in zip(bufs, new):
            if t is not buf:
                buf.copy_(t)


@dataclasses.dataclass
class DecodeState:
    """The steps' static buffers: the step cache, the tokens [B] int64
    (each decode step's input, then its output), the last logits [B, V]
    of the latest prefill chunk, a token buffer [B, n] int64 for each
    chunk length n (``chunk``) and, once penalized sampling ran, the
    generated-token counts [B, V] int32 and the prompt mask [B, V] bool."""

    cache: KVCache
    tokens: torch.Tensor
    logits: torch.Tensor
    chunks: dict = dataclasses.field(default_factory=dict)
    counts: torch.Tensor | None = None
    prompt_mask: torch.Tensor | None = None

    def chunk(self, n: int) -> torch.Tensor:
        """The token buffer of an n-token prefill chunk (made at first
        use)."""
        if n not in self.chunks:
            self.chunks[n] = torch.zeros((self.tokens.shape[0], n),
                                         dtype=torch.int64,
                                         device=self.tokens.device)
        return self.chunks[n]


class Generator:
    """Holds prepared params and the rope tables for one (spec, batch,
    max_len) on one device (``cuda`` unless told otherwise), and the
    steps' static buffers and graphs."""

    def __init__(self, params, spec: ModelSpec, max_len: int = 2048,
                 batch: int = 1, cache_dtype=torch.bfloat16,
                 compute_dtype=torch.bfloat16, device="cuda"):
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.device = torch.device(device)
        self.params = prepare_params(params, spec)
        self.spec = spec
        self.max_len = max_len
        self.batch = batch
        self.cache_dtype = cache_dtype
        self.compute_dtype = compute_dtype
        self.rope_tables = precompute_rope_tables(spec.rope, self.device)
        # the draws of generate's sampling, reseeded by each call
        self.sampler = torch.Generator(device=self.device)
        self._state: DecodeState | None = None
        self._graphs = StepGraphs()

    def new_cache(self) -> KVCache:
        return KVCache.create(self.spec, self.batch, self.max_len,
                              self.cache_dtype, self.device)

    @torch.no_grad()
    def _forward(self, tokens, cache, logits_last_only=False,
                 return_hidden=False):
        """forward() over this Generator's params, rope tables and compute
        dtype: (logits, cache), plus the hidden states with
        return_hidden."""
        return forward(self.params, self.spec, tokens, cache,
                       rope_tables=self.rope_tables,
                       compute_dtype=self.compute_dtype,
                       logits_last_only=logits_last_only,
                       return_hidden=return_hidden)

    def prefill(self, cache: KVCache, tokens: torch.Tensor,
                chunk: int = 256):
        """Chunked prefill of tokens [B, S]: (last logits [B, V], cache)."""
        s = tokens.shape[1]
        logits = None
        for i in range(0, s, chunk):
            logits, cache = self._forward(tokens[:, i : i + chunk], cache,
                                          logits_last_only=True)
        return logits[:, -1], cache

    def decode_step(self, tok: torch.Tensor, cache: KVCache,
                    sampling: SamplingConfig = SamplingConfig(),
                    generator: torch.Generator | None = None,
                    counts: torch.Tensor | None = None,
                    prompt_mask: torch.Tensor | None = None):
        """One token per sequence: tok [B] -> (next [B], cache).

        With ``counts`` (int32 [B, V], the generated tokens' occurrences)
        and ``prompt_mask`` (bool [B, V]) the penalties of ``sampling``
        apply, and the sampled token is counted into ``counts`` in place
        (the JAX package's _decode_step_penalized returns new counts)."""
        logits, cache = self._forward(tok[:, None], cache)
        nxt = sample(logits[:, -1], generator, sampling, counts, prompt_mask)
        if counts is not None:
            _count(counts, nxt)
        return nxt, cache

    def decode_state(self) -> DecodeState:
        """The steps' static buffers (made at first use)."""
        if self._state is None:
            self._state = DecodeState(
                self.new_cache(),
                torch.zeros(self.batch, dtype=torch.int64,
                            device=self.device),
                torch.zeros((self.batch, self.spec.vocab_size),
                            dtype=self.compute_dtype, device=self.device))
        return self._state

    def _prefill_state(self, tokens: torch.Tensor) -> None:
        """The prefill body: tokens [B, n] into the step cache, their last
        logits into decode_state().logits."""
        st = self.decode_state()
        cache = _view(st.cache)
        logits, cache = self._forward(tokens, cache, logits_last_only=True)
        st.logits.copy_(logits[:, -1])
        _commit(st.cache, cache)

    def prefill_graph(self, n: int) -> GraphStep:
        """The prefill step of an n-token chunk: each call feeds
        decode_state().chunk(n) into the step cache and writes the chunk's
        last logits into decode_state().logits."""
        tokens = self.decode_state().chunk(n)
        capture = capture_allowed(self.device, self.params)
        key = ("prefill", n, attention.MLA_FUSED,
               attention.BLOCKWISE_KV_THRESHOLD, capture)
        return self._graphs.get(self.params, key, lambda: GraphStep(
            lambda: self._prefill_state(tokens), self.device, capture))

    def decode_graph(self, sampling: SamplingConfig) -> GraphStep:
        """The decode step for ``sampling``: each call writes the next
        tokens of decode_state().tokens into it and advances its cache
        (penalized sampling: counts them too)."""
        st = self.decode_state()
        capture = capture_allowed(self.device, self.params)
        # sampling decides the penalties' branch; the attention module's
        # switches are read by forward() at call time
        key = ("decode", sampling, attention.MLA_FUSED,
               attention.BLOCKWISE_KV_THRESHOLD, capture)

        def body():
            cache = _view(st.cache)
            pen = sampling.needs_counts
            nxt, cache = self.decode_step(
                st.tokens, cache, sampling, self.sampler,
                st.counts if pen else None, st.prompt_mask if pen else None)
            st.tokens.copy_(nxt)
            _commit(st.cache, cache)

        gens = (self.sampler,) if sampling.temperature > 0 else ()
        return self._graphs.get(
            self.params, key,
            lambda: GraphStep(body, self.device, capture, gens))

    def prime(self, prompt: torch.Tensor,
              cfg: GenerateConfig = GenerateConfig()) -> GraphStep:
        """Start a generation of prompt [B, S] on the device: reset the
        step cache in place, reseed the sampler, prefill in chunks of
        cfg.prefill_chunk through prefill_graph (a shorter tail eagerly),
        sample the first tokens into decode_state().tokens; returns
        decode_graph(cfg.sampling)."""
        st = self.decode_state()
        st.cache.lengths.zero_()
        for buf in st.cache.bufs_a + st.cache.bufs_b:
            buf.zero_()
        self.sampler.manual_seed(cfg.seed)
        n = cfg.prefill_chunk
        for i in range(0, prompt.shape[1], n):
            piece = prompt[:, i : i + n]
            if piece.shape[1] < n:
                self._prefill_state(piece)
            else:
                st.chunk(n).copy_(piece)
                self.prefill_graph(n)()
        last = st.logits
        counts = prompt_mask = None
        if cfg.sampling.needs_counts:
            # penalties: the generated tokens' counts and the prompt's
            # tokens, both on the device (the JAX Generator's layout)
            if st.counts is None:
                shape = (self.batch, last.shape[-1])
                st.counts = torch.zeros(shape, dtype=torch.int32,
                                        device=self.device)
                st.prompt_mask = torch.zeros(shape, dtype=torch.bool,
                                             device=self.device)
            counts, prompt_mask = st.counts, st.prompt_mask
            counts.zero_()
            prompt_mask.zero_()
            prompt_mask.scatter_(1, prompt, True)
        tok = sample(last, self.sampler, cfg.sampling, counts, prompt_mask)
        if counts is not None:
            _count(counts, tok)
        st.tokens.copy_(tok)
        return self.decode_graph(cfg.sampling)

    def generate(self, prompt_ids, cfg: GenerateConfig = GenerateConfig(),
                 on_token=None) -> list[list[int]]:
        """Generate for a batch of equal-length prompts (token-id lists or
        a [B, S] tensor); returns the generated ids per sequence, each row
        ending at its first eos_token_id. ``on_token`` gets each step's
        tokens, a CPU tensor [B], once the pipeline resolves them."""
        prompt = torch.as_tensor(prompt_ids, dtype=torch.int64)
        if prompt.dim() == 1:
            prompt = prompt[None]
        b, s = prompt.shape
        if b != self.batch:
            raise ValueError(f"batch {b} != Generator batch {self.batch}")
        if s + cfg.max_new_tokens > self.max_len:
            raise ValueError("prompt + max_new_tokens exceeds max_len")
        step = self.prime(prompt.to(self.device), cfg)
        tokens = self.decode_state().tokens
        depth = max(1, int(os.environ.get("KT_GENERATE_PIPELINE", "24")))
        n = cfg.max_new_tokens
        out = [[] for _ in range(b)]
        finished = np.zeros(b, bool)
        # steps in flight: (host tokens, event), oldest first
        pending = [readback(tokens)]
        dispatched, resolved = 1, 0
        while resolved < n:
            while dispatched < n and not finished.all() \
                    and len(pending) < depth:
                step()
                pending.append(readback(tokens))
                dispatched += 1
            (host,), event = pending.pop(0)
            if event is not None:
                event.synchronize()
            resolved += 1
            for bi, t in enumerate(host.tolist()):
                if not finished[bi]:
                    out[bi].append(t)
                    finished[bi] = t == cfg.eos_token_id
            if on_token is not None:
                on_token(host)
            if finished.all():
                break
        return out
