"""Token sampling (counterpart of ktransformers_tpu/engine/sampler.py:sample):
greedy, temperature, top-k, top-p, with an explicit torch.Generator.
Penalties are not ported."""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class SamplingConfig:
    temperature: float = 0.0  # 0 => greedy
    top_k: int = 0  # 0 => disabled
    top_p: float = 1.0  # 1 => disabled


def _top_k_filter(logits: torch.Tensor, k: int) -> torch.Tensor:
    kth = torch.topk(logits, k, dim=-1).values[..., -1:]
    return logits.masked_fill(logits < kth, float("-inf"))


def _top_p_filter(logits: torch.Tensor, p: float) -> torch.Tensor:
    """Keep the smallest prefix with cumulative probability > p (the top
    token always stays)."""
    sorted_logits = torch.sort(logits, dim=-1, descending=True).values
    probs = torch.softmax(sorted_logits, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    cutoff = torch.where(cum - probs > p, torch.full_like(sorted_logits,
                                                          float("inf")),
                         sorted_logits).amin(dim=-1, keepdim=True)
    return logits.masked_fill(logits < cutoff, float("-inf"))


def sample(logits: torch.Tensor, generator: torch.Generator | None,
           cfg: SamplingConfig) -> torch.Tensor:
    """Token ids [B] int64 from logits [B, V]."""
    logits = logits.to(torch.float32)
    if cfg.temperature <= 0.0:
        return torch.argmax(logits, dim=-1)
    logits = logits / cfg.temperature
    if cfg.top_k > 0:
        logits = _top_k_filter(logits, cfg.top_k)
    if cfg.top_p < 1.0:
        logits = _top_p_filter(logits, cfg.top_p)
    probs = torch.softmax(logits, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]
