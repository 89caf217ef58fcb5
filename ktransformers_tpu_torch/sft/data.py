"""SFT dataset: JSON instruction data -> padded (input_ids, labels)
batches (counterpart of ktransformers_tpu/sft/data.py, plain Python and
numpy). Record shapes:
- {"messages": [{role, content}, ...]} (the last turn the assistant's)
- {"instruction": ..., "input": ..., "output": ...} (alpaca style)
- {"prompt": ..., "response": ...}
Prompt tokens are masked with IGNORE_INDEX; only response tokens train.
"""

from __future__ import annotations

import json

import numpy as np

from ktransformers_tpu_torch.sft.train import IGNORE_INDEX


def _to_prompt_response(rec: dict, tokenizer) -> tuple[str, str]:
    if "messages" in rec:
        msgs = rec["messages"]
        if not msgs or msgs[-1]["role"] != "assistant":
            raise ValueError("the last turn must be the assistant's")
        if hasattr(tokenizer, "apply_chat_template"):
            prompt = tokenizer.apply_chat_template(
                msgs[:-1], tokenize=False, add_generation_prompt=True)
        else:
            prompt = "\n".join(f"{m['role']}: {m['content']}"
                               for m in msgs[:-1])
        return prompt, msgs[-1]["content"]
    if "instruction" in rec:
        prompt = rec["instruction"]
        if rec.get("input"):
            prompt += "\n" + rec["input"]
        return prompt, rec.get("output", "")
    return rec["prompt"], rec.get("response", "")


def load_sft_dataset(path: str, tokenizer, seq_len: int = 512,
                     batch_size: int = 4, eos_token_id: int | None = None):
    """Yields (input_ids [B, seq_len], labels [B, seq_len]) int32 batches;
    a last partial batch is dropped."""
    with open(path) as f:
        data = json.load(f)
    eos = eos_token_id
    if eos is None:
        eos = getattr(tokenizer, "eos_token_id", None)

    examples = []
    for rec in data:
        prompt, response = _to_prompt_response(rec, tokenizer)
        p_ids = list(tokenizer.encode(prompt))
        r_ids = list(tokenizer.encode(response))
        if eos is not None:
            r_ids = r_ids + [eos]
        ids = (p_ids + r_ids)[:seq_len]
        labels = ([IGNORE_INDEX] * len(p_ids) + r_ids)[:seq_len]
        pad = seq_len - len(ids)
        examples.append((ids + [0] * pad, labels + [IGNORE_INDEX] * pad))

    for i in range(0, len(examples) - batch_size + 1, batch_size):
        chunk = examples[i : i + batch_size]
        yield (np.asarray([c[0] for c in chunk], np.int32),
               np.asarray([c[1] for c in chunk], np.int32))
