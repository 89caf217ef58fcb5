"""Token sampling (counterpart of ktransformers_tpu/engine/sampler.py):
greedy, temperature, top-k, top-p and repetition / presence / frequency
penalties, with an explicit torch.Generator.

``sample`` takes one SamplingConfig for the whole batch (the single-user
Generator and the first token of a served query); ``sample_batched`` takes
per-row parameter vectors so one decode step serves a mixed batch. Penalty
semantics: the repetition penalty (HF rule) considers the FULL context
(prompt + generated), presence / frequency penalties the generated tokens
only; hence ``token_counts`` (generated occurrences, [B, V]) and
``prompt_mask`` ([B, V] bool, tokens present in the prompt). A draw uses
torch's generator, so sampled tokens differ from the JAX package's; greedy
tokens and the filtered logits do not.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class SamplingConfig:
    temperature: float = 0.0  # 0 => greedy
    top_k: int = 0  # 0 => disabled
    top_p: float = 1.0  # 1 => disabled
    repetition_penalty: float = 1.0
    presence_penalty: float = 0.0  # OpenAI-style additive penalties
    frequency_penalty: float = 0.0

    @property
    def needs_counts(self) -> bool:
        return (self.repetition_penalty != 1.0
                or self.presence_penalty != 0.0
                or self.frequency_penalty != 0.0)


def _column(v, like: torch.Tensor) -> torch.Tensor:
    """A scalar or a [B] vector as a float32 [B or 1, 1] column on like's
    device (a scalar filled there: no host copy, which a captured decode
    step cannot hold)."""
    if isinstance(v, torch.Tensor):
        return v.to(like.device, torch.float32).reshape(-1, 1)
    return torch.full((1, 1), v, dtype=torch.float32, device=like.device)


def apply_repetition_penalty(logits: torch.Tensor, seen_mask: torch.Tensor,
                             penalty) -> torch.Tensor:
    """seen_mask [B, V] bool / number, nonzero where the token appeared in
    the context. Positive logits are divided by the penalty, negative ones
    multiplied (HF rule). ``penalty`` is a scalar or a [B] vector."""
    pen = _column(penalty, logits)
    out = torch.where(logits > 0, logits / pen, logits * pen)
    return torch.where(seen_mask > 0, out, logits)


def apply_presence_frequency_penalties(logits: torch.Tensor,
                                       token_counts: torch.Tensor,
                                       presence_penalty,
                                       frequency_penalty) -> torch.Tensor:
    """OpenAI-style additive penalties over the generated-token counts
    [B, V]; scalars or [B] vectors."""
    p = _column(presence_penalty, logits)
    f = _column(frequency_penalty, logits)
    counts = token_counts.to(torch.float32)
    return logits - p * (counts > 0).to(torch.float32) - f * counts


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


def _draw(scaled: torch.Tensor, generator) -> torch.Tensor:
    """One draw a row from softmax(scaled): torch.multinomial's own
    one-sample path (argmax of p / q, q ~ Exp(1) from ``generator``), the
    same draws, without its checks of p, which read the device's values
    back to the host: a captured decode step cannot. So invalid
    probabilities are no longer rejected, on every path and device: a row
    of NaN (or negative) values gives a token instead of raising."""
    probs = torch.softmax(scaled, dim=-1)
    q = torch.empty_like(probs).exponential_(1, generator=generator)
    return torch.argmax(probs / q, dim=-1)


def sample(logits: torch.Tensor, generator: torch.Generator | None,
           cfg: SamplingConfig, token_counts: torch.Tensor | None = None,
           prompt_mask: torch.Tensor | None = None) -> torch.Tensor:
    """Token ids [B] int64 from logits [B, V], one config for the batch.
    Penalties apply only when token_counts [B, V] is given."""
    logits = logits.to(torch.float32)
    if token_counts is not None:
        if cfg.repetition_penalty != 1.0:
            seen = token_counts > 0
            if prompt_mask is not None:
                seen = seen | prompt_mask
            logits = apply_repetition_penalty(logits, seen,
                                              cfg.repetition_penalty)
        if cfg.presence_penalty or cfg.frequency_penalty:
            logits = apply_presence_frequency_penalties(
                logits, token_counts, cfg.presence_penalty,
                cfg.frequency_penalty)
    if cfg.temperature <= 0.0:
        return torch.argmax(logits, dim=-1)
    logits = logits / cfg.temperature
    if cfg.top_k > 0:
        logits = _top_k_filter(logits, cfg.top_k)
    if cfg.top_p < 1.0:
        logits = _top_p_filter(logits, cfg.top_p)
    return _draw(logits, generator)


def filter_batched(logits: torch.Tensor, temps: torch.Tensor,
                   top_ks: torch.Tensor | None = None,
                   top_ps: torch.Tensor | None = None,
                   rep_pens: torch.Tensor | None = None,
                   pres_pens: torch.Tensor | None = None,
                   freq_pens: torch.Tensor | None = None,
                   token_counts: torch.Tensor | None = None,
                   prompt_mask: torch.Tensor | None = None):
    """The deterministic part of sample_batched: (greedy ids [B] of the
    penalized logits, temperature-scaled logits [B, V] with everything
    outside each row's top-k / top-p set at -inf)."""
    logits = logits.to(torch.float32)
    if token_counts is not None:
        if rep_pens is not None:
            seen = token_counts > 0
            if prompt_mask is not None:
                seen = seen | prompt_mask
            logits = apply_repetition_penalty(logits, seen, rep_pens)
        if pres_pens is not None or freq_pens is not None:
            logits = apply_presence_frequency_penalties(
                logits, token_counts,
                0.0 if pres_pens is None else pres_pens,
                0.0 if freq_pens is None else freq_pens)
    greedy = torch.argmax(logits, dim=-1)
    scaled = logits / torch.clamp(temps.to(torch.float32), min=1e-6)[:, None]
    if top_ks is not None or top_ps is not None:
        # one descending sort serves both filters: top-k masks ranks >= k
        # before the top-p cumulative cutoff is taken over the remainder
        v = scaled.shape[-1]
        neg_inf = torch.full((), float("-inf"), device=scaled.device)
        sorted_desc = torch.sort(scaled, dim=-1, descending=True).values
        if top_ks is not None:
            k = torch.where(top_ks > 0, top_ks, torch.full_like(top_ks, v))
            k = torch.clamp(k, 1, v)
            rank = torch.arange(v, device=scaled.device)[None, :]
            sorted_desc = torch.where(rank < k[:, None], sorted_desc, neg_inf)
        if top_ps is not None:
            probs = torch.softmax(sorted_desc, dim=-1)
            cum = torch.cumsum(probs, dim=-1)
            sorted_desc = torch.where(cum - probs > _column(top_ps, scaled),
                                      neg_inf, sorted_desc)
        # each row's smallest surviving logit is its threshold
        cutoff = torch.where(torch.isfinite(sorted_desc), sorted_desc,
                             -neg_inf).amin(dim=-1, keepdim=True)
        scaled = torch.where(scaled < cutoff, neg_inf, scaled)
    return greedy, scaled


def sample_batched(logits: torch.Tensor, generator: torch.Generator | None,
                   temps: torch.Tensor, **filters) -> torch.Tensor:
    """Per-row sampling for mixed serving batches: token ids [B] int64.
    temps [B] float32, rows <= 0 are greedy; ``filters`` are the per-row
    vectors of filter_batched (top_ks int, <= 0 disabled; top_ps, 1.0
    disabled; rep_pens / pres_pens / freq_pens with token_counts and
    prompt_mask)."""
    greedy, scaled = filter_batched(logits, temps, **filters)
    return torch.where(temps > 0, _draw(scaled, generator), greedy)
