"""Model loading front door and interactive chat (counterpart of
ktransformers_tpu/engine/local_chat.py).

``load_model`` detects the source (an HF safetensors directory, plain or
GPTQ / AWQ; a GGUF file or shard directory; a packed directory that
models/checkpoint.py wrote), builds the spec, applies a placement spec and
returns (spec, params) on ``device`` (``cuda`` unless told otherwise).
``chat_loop`` runs a single-user Generator behind a prompt on stdin.

Unlike the JAX package's chat loop, ``chat_loop`` renders the chat template
to text and then encodes it (a template that returns a string, as the
fallback tokenizer's does, would otherwise feed its characters as token
ids), and prompt ids at or past the model's vocabulary raise instead of
being clamped by the embedding gather.
"""

from __future__ import annotations

import json
import os
import shutil
import sys
import time

from ktransformers_tpu_torch.engine.generate import GenerateConfig, Generator
from ktransformers_tpu_torch.engine.sampler import SamplingConfig
from ktransformers_tpu_torch.models.loading import build_params
from ktransformers_tpu_torch.models.spec import (
    ModelSpec,
    spec_from_gguf_fields,
    spec_from_hf_config,
)
from ktransformers_tpu_torch.utils.device_prep import params_to


def detect_source(path: str) -> str:
    """'packed' | 'hf' | 'gguf'"""
    if os.path.isdir(path):
        if any(os.path.exists(os.path.join(path, m))
               for m in ("manifest.json", "stream_manifest.json")):
            return "packed"
        if os.path.exists(os.path.join(path, "config.json")):
            return "hf"
        if any(f.endswith(".gguf") for f in os.listdir(path)):
            return "gguf"
    if path.endswith(".gguf"):
        return "gguf"
    raise ValueError(f"cannot detect model format at {path}")


def load_spec(path: str, config_path: str | None = None) -> ModelSpec:
    """The spec from config.json (an HF or packed directory, or
    ``config_path``), else from a GGUF file's metadata."""
    src = detect_source(path)
    if config_path is None:
        if src in ("hf", "packed"):
            config_path = os.path.join(path, "config.json")
        else:
            from ktransformers_tpu_torch.loader.gguf import GGUFDir

            gd = GGUFDir(path)
            try:
                return spec_from_gguf_fields(gd.fields)
            finally:
                gd.close()
    with open(config_path) as f:
        return spec_from_hf_config(json.load(f))


def resolve_spec_provider(path: str, config_path: str | None = None):
    """(spec, provider, exact) for a source that is not packed: a GPTQ /
    AWQ directory and a GGUF source hand their codes over exactly."""
    src = detect_source(path)
    if src == "packed":
        raise ValueError(f"{path} is already a packed directory")
    spec = load_spec(path, config_path)
    if src == "hf":
        from ktransformers_tpu_torch.loader.gptq import (
            QuantizedSafetensorsProvider,
            detect_quant_method,
        )
        from ktransformers_tpu_torch.loader.providers import (
            SafetensorsProvider,
        )

        provider = SafetensorsProvider(path)
        method = detect_quant_method(path) if os.path.isdir(path) else None
        if method is None:
            return spec, provider, False
        return spec, QuantizedSafetensorsProvider(provider, method), True
    from ktransformers_tpu_torch.loader.providers import GGUFProvider

    return spec, GGUFProvider(path), True


def load_model(path: str, quant: str = "int8", moe_quant: str = "int4_g",
               config_path: str | None = None, placement=None,
               save_packed: str | None = None, progress=None,
               exact_gguf: bool = True, device="cuda"):
    """(spec, params) on ``device``. ``save_packed`` also writes the built
    params as a packed directory (with config.json) that the next start,
    in either package, loads without converting. A packed source is a
    save_params directory or a stream_convert one."""
    src = detect_source(path)
    if src == "packed":
        from ktransformers_tpu_torch.models import checkpoint

        spec = load_spec(path, config_path)
        if os.path.exists(os.path.join(path, "stream_manifest.json")):
            return spec, checkpoint.stream_load(path, spec, device)
        return spec, checkpoint.load_params(path, spec, device)
    spec, provider, exact = resolve_spec_provider(path, config_path)
    params = build_params(
        provider, spec, quant=quant, moe_quant=moe_quant,
        placement=placement, progress=progress,
        exact_gguf=exact and (src == "hf" or exact_gguf),
        device="cpu" if save_packed else device)
    if save_packed:
        from ktransformers_tpu_torch.models.checkpoint import save_params

        save_params(params, save_packed)
        if config_path or src == "hf":
            shutil.copy(config_path or os.path.join(path, "config.json"),
                        os.path.join(save_packed, "config.json"))
        params = params_to(params, device)
    return spec, params


def load_tokenizer(path: str, tokenizer_path: str | None = None):
    """transformers' AutoTokenizer where it loads one, else the server's
    SimpleTokenizer (said on stderr); ``tokenizer_path`` "ids" gives the
    server's IdTokenizer (token ids as text)."""
    if tokenizer_path == "ids":
        from ktransformers_tpu_torch.serving.server import IdTokenizer

        return IdTokenizer()
    tp = tokenizer_path or path
    try:
        from transformers import AutoTokenizer

        return AutoTokenizer.from_pretrained(tp, trust_remote_code=True)
    except Exception as e:  # no transformers, or no tokenizer files
        from ktransformers_tpu_torch.serving.server import SimpleTokenizer

        print(f"load_tokenizer: no tokenizer at {tp} ({type(e).__name__}: "
              f"{e}); using SimpleTokenizer (codepoints)", file=sys.stderr)
        return SimpleTokenizer()


def prompt_ids_error(ids, vocab_size: int) -> str | None:
    """Why a prompt cannot go to the model (an id outside [0, vocab)), or
    None."""
    bad = [int(t) for t in ids if not 0 <= int(t) < vocab_size]
    if bad:
        return (f"prompt token ids {bad[:8]} lie outside the model's "
                f"vocabulary of {vocab_size}")
    return None


def render_prompt(tokenizer, messages) -> list[int]:
    """The chat template rendered to text, then encoded; a tokenizer
    without a template encodes the last message."""
    if hasattr(tokenizer, "apply_chat_template"):
        try:
            text = tokenizer.apply_chat_template(
                messages, tokenize=False, add_generation_prompt=True)
            return list(tokenizer.encode(text))
        except Exception:
            pass
    return list(tokenizer.encode(messages[-1]["content"]))


def chat_loop(spec, params, tokenizer, max_len: int = 4096,
              max_new_tokens: int = 512, temperature: float = 0.6,
              top_p: float = 0.95, draft=None, device="cuda"):
    """Interactive loop on stdin / stdout until an empty line or EOF. With
    ``draft`` (a Generator sharing the vocabulary) greedy turns run
    draft-model speculation (engine/draft_spec.draft_generate), whose
    tokens are the greedy ones."""
    gen = Generator(params, spec, max_len=max_len, batch=1, device=device)
    history = []
    print("ktransformers-tpu chat — empty line to exit", flush=True)
    while True:
        try:
            user = input("you> ").strip()
        except EOFError:
            break
        if not user:
            break
        history.append({"role": "user", "content": user})
        ids = render_prompt(tokenizer, history)
        err = prompt_ids_error(ids, spec.vocab_size)
        if err:
            raise ValueError(err)
        t0 = time.perf_counter()
        pieces = []

        def on_token(tok):
            text = tokenizer.decode([int(tok[0])])
            pieces.append(text)
            print(text, end="", flush=True)

        cfg = GenerateConfig(
            max_new_tokens=max_new_tokens,
            sampling=SamplingConfig(temperature=temperature, top_p=top_p),
            eos_token_id=getattr(tokenizer, "eos_token_id", None))
        if draft is not None and temperature <= 0:
            from ktransformers_tpu_torch.engine.draft_spec import (
                draft_generate,
            )

            out, _ = draft_generate(gen, draft, list(ids), cfg)
            for t in out:
                on_token([t])
        else:
            out = gen.generate([ids], cfg, on_token=on_token)[0]
        dt = time.perf_counter() - t0
        print(f"\n[{len(out)} tokens, {len(out) / dt:.1f} tok/s]",
              file=sys.stderr)
        history.append({"role": "assistant", "content": "".join(pieces)})
