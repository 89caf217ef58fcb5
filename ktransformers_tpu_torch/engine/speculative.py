"""Speculative decoding with a draft model, greedy and exact (counterpart of
ktransformers_tpu/engine/speculative.py).

Round structure (k draft tokens a round): the target cache holds positions
[0, L) and t0 is the last emitted token.
  1. the draft decodes d1..dk one token at a time from its own cache;
  2. the target runs one (k+1)-token step on [t0, d1, .., dk]: its logits
     at input i give the greedy g1..g(k+1);
  3. d1..dj are accepted while d_i == g_i, and g_(j+1) is emitted as the
     correction (or the bonus token when all k were accepted);
  4. both caches' lengths are rewound to the accepted frontier.

The port's caches are updated in place (models/model.py), so a rewind only
sets ``lengths``: the rows a rejected verify wrote stay behind it, where the
causal mask hides them (``_attn_mask``) and the decode kernels never read
them, until the next round writes over them.

Capacity: the last verify step writes up to k - 1 rows past prompt +
max_new_tokens. The JAX package's cache write clamps its start there and
overwrites valid rows without a word; the port's write would index past
the buffer. So every speculation entry point checks each cache's max_len
before its first step (``check_capacity``) and raises a ValueError naming
the length it needs.
"""

from __future__ import annotations

import dataclasses

import torch

from ktransformers_tpu_torch.engine.generate import GenerateConfig, Generator


@dataclasses.dataclass
class SpecStats:
    rounds: int = 0
    drafted: int = 0
    accepted: int = 0

    @property
    def acceptance_rate(self) -> float:
        return self.accepted / max(self.drafted, 1)


def _set_len(cache, value: int):
    """Rewind (or advance) every sequence of ``cache`` to ``value`` cached
    tokens: a new lengths tensor, the buffers as they are. Returns the
    cache."""
    cache.lengths = torch.full_like(cache.lengths, value)
    return cache


def check_greedy(cfg: GenerateConfig) -> None:
    if cfg.sampling.temperature > 0:
        raise ValueError("speculative decoding is greedy only: "
                         f"temperature {cfg.sampling.temperature} > 0")


def check_capacity(gen: Generator, need: int, what: str, k: int) -> None:
    """Raise unless ``gen``'s caches hold ``need`` positions, the most this
    speculation run can write (the rows of a last verify or draft step
    past prompt + max_new_tokens included)."""
    if gen.max_len < need:
        raise ValueError(
            f"{what}: speculation with k={k} writes up to cache position "
            f"{need - 1}, past max_len {gen.max_len}; build it with "
            f"max_len >= {need}")


def _prompt(prompt_ids, device) -> torch.Tensor:
    return torch.as_tensor(list(prompt_ids), dtype=torch.int64,
                           device=device)[None]


def _finished(out: list, cfg: GenerateConfig) -> bool:
    return len(out) >= cfg.max_new_tokens or (
        cfg.eos_token_id is not None and out[-1] == cfg.eos_token_id)


def _accept(drafted: list, greedy: list, k: int) -> int:
    """Leading drafts equal to the target's greedy tokens."""
    accepted = 0
    while accepted < k and drafted[accepted] == greedy[accepted]:
        accepted += 1
    return accepted


def speculative_generate(
    target: Generator,
    draft: Generator,
    prompt_ids: list[int],
    cfg: GenerateConfig = GenerateConfig(),
    k: int = 4,
) -> tuple[list[int], SpecStats]:
    """Greedy speculative generation; returns (tokens, stats). The tokens
    equal target.generate(...)'s with greedy sampling."""
    check_greedy(cfg)
    p = len(prompt_ids)
    # the last round starts with max_new_tokens - 1 tokens out: its verify
    # writes k + 1 rows from P + n - 2, its drafts k rows from P + n - 1
    need = p + cfg.max_new_tokens + k - 1
    check_capacity(target, need, "target", k)
    check_capacity(draft, need, "draft", k)
    prompt = _prompt(prompt_ids, target.device)

    t_cache = target.new_cache()
    t_logits, t_cache = target.prefill(t_cache, prompt, cfg.prefill_chunk)
    d_cache = draft.new_cache()
    _, d_cache = draft.prefill(d_cache, prompt.to(draft.device),
                               cfg.prefill_chunk)

    out = [int(t_logits[0].argmax())]
    stats = SpecStats()
    t_frontier = p  # tokens whose KV is valid in the target cache
    d_frontier = p  # the same for the draft cache

    def step(gen, toks, cache):
        return gen._forward(torch.tensor([toks], dtype=torch.int64,
                                         device=gen.device), cache)

    while not _finished(out, cfg):
        all_tokens = list(prompt_ids) + out
        # draft: consume its unprocessed tail, then emit k guesses
        d_cache = _set_len(d_cache, d_frontier)
        dl = None
        for tok in all_tokens[d_frontier:]:
            dl, d_cache = step(draft, [tok], d_cache)
        d_frontier = len(all_tokens)
        drafted = []
        for _ in range(k):
            cur = int(dl[0, -1].argmax())
            drafted.append(cur)
            dl, d_cache = step(draft, [cur], d_cache)
        d_frontier += k  # provisional; rewound below

        # verify: one (k+1)-token target step over [last, d1..dk]
        t_cache = _set_len(t_cache, t_frontier)
        tl, t_cache = step(target, all_tokens[t_frontier:] + drafted,
                           t_cache)
        greedy = tl[0].argmax(-1).tolist()  # [k+1]

        accepted = _accept(drafted, greedy, k)
        stats.rounds += 1
        stats.drafted += k
        stats.accepted += accepted
        for tok in drafted[:accepted] + [greedy[accepted]]:
            out.append(tok)
            if _finished(out, cfg):
                break
        t_frontier += accepted + 1
        d_frontier = min(d_frontier, t_frontier)

    return out[: cfg.max_new_tokens], stats
