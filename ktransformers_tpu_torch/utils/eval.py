"""Evaluation: perplexity and a multiple-choice harness over HTTP
(counterpart of ktransformers_tpu/utils/eval.py).

``perplexity`` runs teacher-forced chunked prefill over the port's KVCache
on ``device``; ``mmlu_eval_http`` asks any OpenAI-compatible endpoint (the
port's server too) a JSON dataset of {question, choices, answer} with
urllib.
"""

from __future__ import annotations

import json
import math

import torch

from ktransformers_tpu_torch.models.model import KVCache, forward
from ktransformers_tpu_torch.models.spec import ModelSpec
from ktransformers_tpu_torch.ops.rope import precompute_rope_tables
from ktransformers_tpu_torch.utils.device_prep import prepare_params


@torch.no_grad()
def perplexity(params, spec: ModelSpec, token_ids: list[int],
               chunk: int = 512, compute_dtype=torch.bfloat16,
               return_nll: bool = False, device="cuda") -> float:
    """exp(mean NLL) of each token given the ones before it (the mean NLL
    itself with ``return_nll``); the cache carries the context across
    chunks. ``params`` are prepared in place."""
    ids = torch.as_tensor(list(token_ids), dtype=torch.int64)
    n = len(ids)
    if n < 2:
        raise ValueError("perplexity needs at least two tokens")
    params = prepare_params(params, spec)
    dev = torch.device(device)
    rope = precompute_rope_tables(spec.rope, dev)
    cache = KVCache.create(spec, 1, n, dtype=compute_dtype, device=dev)
    total_nll, total_tok, pos = 0.0, 0, 0
    while pos + 1 < n:
        end = min(pos + chunk, n - 1)
        inputs = ids[pos:end][None].to(dev)  # predicts ids[pos + 1 .. end]
        logits, cache = forward(params, spec, inputs, cache,
                                rope_tables=rope, compute_dtype=compute_dtype)
        logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
        targets = ids[pos + 1 : end + 1][None].to(dev)
        nll = -torch.gather(logp, -1, targets[..., None])
        total_nll += float(nll.sum())
        total_tok += end - pos
        pos = end
    mean_nll = total_nll / max(total_tok, 1)
    if return_nll:
        return mean_nll
    try:
        return math.exp(mean_nll)
    except OverflowError:  # random weights can overflow exp
        return float("inf")


def mmlu_eval_http(endpoint: str, dataset_path: str,
                   model: str = "ktransformers-tpu",
                   limit: int | None = None, timeout: float = 300.0) -> dict:
    """Accuracy on a JSON list of {"question", "choices", "answer": int},
    asking ``endpoint``'s /v1/completions for one letter at temperature 0."""
    import urllib.request

    with open(dataset_path) as f:
        data = json.load(f)
    if limit:
        data = data[:limit]
    letters = "ABCDEFGH"
    correct = 0
    for item in data:
        prompt = item["question"] + "\n" + "\n".join(
            f"{letters[i]}. {c}" for i, c in enumerate(item["choices"])
        ) + "\nAnswer with a single letter.\nAnswer:"
        req = urllib.request.Request(
            endpoint.rstrip("/") + "/v1/completions",
            data=json.dumps({"model": model, "prompt": prompt,
                             "max_tokens": 2, "temperature": 0}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            text = json.load(resp)["choices"][0]["text"].strip().upper()
        pred = next((i for i, c in enumerate(letters) if text.startswith(c)),
                    -1)
        correct += int(pred == item["answer"])
    return {"accuracy": correct / max(len(data), 1), "n": len(data)}
