"""Generator: chunked prefill + one-token decode steps (counterpart of
ktransformers_tpu/engine/generate.py:Generator, single user).

PyTorch runs eagerly, so a decode step is forward() + sample() launched
straight from Python; capturing it in a CUDA graph is later work.
"""

from __future__ import annotations

import dataclasses

import torch

from ktransformers_tpu_torch.engine.sampler import SamplingConfig, sample
from ktransformers_tpu_torch.models.model import KVCache, forward
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


class Generator:
    """Holds prepared params and the rope tables for one (spec, batch,
    max_len) on one device (``cuda`` unless told otherwise)."""

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

    def generate(self, prompt_ids, cfg: GenerateConfig = GenerateConfig(),
                 on_token=None) -> list[list[int]]:
        """Generate for a batch of equal-length prompts (token-id lists or
        a [B, S] tensor); returns the generated ids per sequence."""
        prompt = torch.as_tensor(prompt_ids, dtype=torch.int64)
        if prompt.dim() == 1:
            prompt = prompt[None]
        b, s = prompt.shape
        if b != self.batch:
            raise ValueError(f"batch {b} != Generator batch {self.batch}")
        if s + cfg.max_new_tokens > self.max_len:
            raise ValueError("prompt + max_new_tokens exceeds max_len")
        prompt = prompt.to(self.device)
        gen = torch.Generator(device=self.device)
        gen.manual_seed(cfg.seed)
        cache = self.new_cache()
        last, cache = self.prefill(cache, prompt, cfg.prefill_chunk)
        counts = prompt_mask = None
        if cfg.sampling.needs_counts:
            # penalties: the generated tokens' counts and the prompt's
            # tokens, both on the device (the JAX Generator's layout)
            v = last.shape[-1]
            counts = torch.zeros(b, v, dtype=torch.int32, device=self.device)
            prompt_mask = torch.zeros(b, v, dtype=torch.bool,
                                      device=self.device)
            prompt_mask.scatter_(1, prompt, True)
        tok = sample(last, gen, cfg.sampling, counts, prompt_mask)
        if counts is not None:
            _count(counts, tok)
        toks = [tok]
        if on_token is not None:
            on_token(tok)
        finished = torch.zeros(b, dtype=torch.bool)
        while len(toks) < cfg.max_new_tokens:
            if cfg.eos_token_id is not None:
                finished |= (tok == cfg.eos_token_id).cpu()
                if bool(finished.all()):
                    break
            tok, cache = self.decode_step(tok, cache, cfg.sampling, gen,
                                          counts, prompt_mask)
            toks.append(tok)
            if on_token is not None:
                on_token(tok)
        out = torch.stack(toks, dim=1).cpu().tolist()
        if cfg.eos_token_id is not None:
            for row in out:
                if cfg.eos_token_id in row:
                    del row[row.index(cfg.eos_token_id) + 1 :]
        return out
