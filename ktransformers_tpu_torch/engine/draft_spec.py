"""Separate-draft-model speculative decoding (counterpart of
ktransformers_tpu/engine/draft_spec.py).

A small model with the target's vocabulary proposes k tokens; the target
verifies them in one (k+1)-token step. The verify rule is
engine/mtp.mtp_generate's; the drafter is a second Generator (its own
weights and KV cache). Greedy and exact: the tokens equal the target's own
greedy continuation whatever the draft proposes; bad drafts only cost
speed.
"""

from __future__ import annotations

import torch

from ktransformers_tpu_torch.engine.generate import GenerateConfig, Generator
from ktransformers_tpu_torch.engine.speculative import (
    SpecStats,
    _accept,
    _finished,
    _prompt,
    _set_len,
    check_capacity,
    check_greedy,
)


def draft_generate(
    target: Generator,
    draft: Generator,
    prompt_ids: list[int],
    cfg: GenerateConfig = GenerateConfig(),
    k: int = 3,
) -> tuple[list[int], SpecStats]:
    """Greedy speculative generation with a separate draft model.

    A round: catch the draft cache up to the committed tokens, draft k
    greedy tokens (the catch-up step gives the first, k - 1 one-token
    steps the rest), verify with ONE (k+1)-token target step, accept the
    matching prefix and the target's next token."""
    check_greedy(cfg)
    if target.spec.vocab_size != draft.spec.vocab_size:
        raise ValueError(
            f"draft vocabulary {draft.spec.vocab_size} != target vocabulary "
            f"{target.spec.vocab_size}: the draft must share the tokenizer")
    p = len(prompt_ids)
    n = cfg.max_new_tokens
    # the last round starts with n - 1 tokens out: the verify writes k + 1
    # rows from P + n - 2, the draft k rows from P + n - 2
    check_capacity(target, p + n + k - 1, "target", k)
    check_capacity(draft, p + n + k - 2, "draft", k)

    def step(gen, toks, cache):
        return gen._forward(torch.tensor([toks], dtype=torch.int64,
                                         device=gen.device), cache)

    # prompt prefill, in the chunks Generator.generate takes
    t_cache = target.new_cache()
    tl, t_cache = target.prefill(t_cache, _prompt(prompt_ids, target.device),
                                 cfg.prefill_chunk)
    out = [int(tl[0].argmax())]
    t_frontier = p
    d_cache = draft.new_cache()
    _, d_cache = draft.prefill(d_cache, _prompt(prompt_ids, draft.device),
                               cfg.prefill_chunk)
    d_frontier = p

    stats = SpecStats()
    while not _finished(out, cfg):
        all_tokens = list(prompt_ids) + out
        length = len(all_tokens)

        # catch-up + first draft: the committed tokens the draft has not
        # consumed (its cache holds a valid prefix after the rewind)
        d_cache = _set_len(d_cache, d_frontier)
        dl, d_cache = step(draft, all_tokens[d_frontier:], d_cache)
        drafted = [int(dl[0, -1].argmax())]
        d_frontier = length
        while len(drafted) < k:
            dl, d_cache = step(draft, [drafted[-1]], d_cache)
            drafted.append(int(dl[0, -1].argmax()))
            d_frontier += 1

        # verify: one target step over [unconsumed committed] + drafted
        t_cache = _set_len(t_cache, t_frontier)
        inp = all_tokens[t_frontier:] + drafted
        tl, t_cache = step(target, inp, t_cache)
        # the target's continuations of [last committed, drafted[:k]]
        g = tl[0].argmax(-1).tolist()[-(k + 1):]

        accepted = _accept(drafted, g, k)
        stats.rounds += 1
        stats.drafted += k
        stats.accepted += accepted
        for tok in drafted[:accepted] + [g[accepted]]:
            out.append(tok)
            if _finished(out, cfg):
                break
        t_frontier += len(inp) - k + accepted
        # the draft cache holds committed[:L] + drafted[:k-1]; the first
        # `accepted` drafts are committed now, the rest are stale
        d_frontier = min(d_frontier, length + accepted)

    return out[: cfg.max_new_tokens], stats
