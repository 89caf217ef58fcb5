"""Command line of the PyTorch port (counterpart of
ktransformers_tpu/cli/main.py, the same commands and options, on argparse):

    python -m ktransformers_tpu_torch.cli <command> ...

chat, serve, convert, doctor, sft, models list / show, placements, quant,
tune, eval-ppl, eval-mc; bench raises (the port's benchmark is ROADMAP
Queue 1 item 2). Commands that run a model take ``--device`` (``cuda``
unless told otherwise). ``main(argv)`` returns the exit code.
"""

from __future__ import annotations

import argparse
import json
import os
import sys


class CliError(Exception):
    """A usage error: printed as "Error: ..." with exit code 1."""


def _model_options(p: argparse.ArgumentParser, device: bool = True) -> None:
    p.add_argument("--quant", default="int8",
                   help="kind of the dense / attention weights (int8)")
    p.add_argument("--moe-quant", default="int4_g",
                   help="kind of the routed experts (int4_g)")
    p.add_argument("--config", dest="config_path", default=None,
                   help="HF config.json (a GGUF file without metadata)")
    p.add_argument("--placement", dest="placement_yaml", default=None,
                   help="placement rules: a library name (see "
                   "`placements`), a JSON file or a YAML file")
    p.add_argument("--tokenizer", dest="tokenizer_path", default=None,
                   help='tokenizer directory, or "ids" for token ids as '
                   "text (whitespace-separated integers)")
    if device:
        p.add_argument("--device", default="cuda",
                       help="torch device (cuda)")


def _load(a, save_packed: str | None = None, device: str | None = None):
    from ktransformers_tpu_torch.engine.local_chat import load_model

    placement = None
    if a.placement_yaml:
        from ktransformers_tpu_torch.placement.library import load_placement

        placement = load_placement(a.placement_yaml)
    return load_model(
        a.model_path, quant=a.quant, moe_quant=a.moe_quant,
        config_path=a.config_path, placement=placement,
        save_packed=save_packed, device=device or a.device,
        progress=lambda msg: print(f"\r{msg}", end="", file=sys.stderr))


# -- commands ------------------------------------------------------------------


def cmd_chat(a) -> None:
    from ktransformers_tpu_torch.engine.local_chat import (
        chat_loop,
        load_tokenizer,
    )

    spec, params = _load(a)
    tok = load_tokenizer(a.model_path, a.tokenizer_path)
    draft = None
    if a.speculative_model:
        # the draft model takes the target's kinds; greedy turns then run
        # draft-model speculation (engine/draft_spec.py)
        from ktransformers_tpu_torch.engine.generate import Generator

        d_spec, d_params = _load(argparse.Namespace(
            **{**vars(a), "model_path": a.speculative_model,
               "config_path": None, "placement_yaml": None}))
        draft = Generator(d_params, d_spec, max_len=a.max_len, batch=1,
                          device=a.device)
    try:
        chat_loop(spec, params, tok, max_len=a.max_len,
                  max_new_tokens=a.max_new_tokens,
                  temperature=a.temperature, top_p=a.top_p, draft=draft,
                  device=a.device)
    except ValueError as e:  # a prompt past the vocabulary
        raise CliError(str(e)) from e


def build_engine(sc, device: str):
    """(engine, tokenizer) for a ServerConfig: the model loaded, the
    ServeEngine (HostOffloadServeEngine with ``offload``) built on it."""
    from ktransformers_tpu_torch.engine.local_chat import (
        load_model,
        load_tokenizer,
    )
    from ktransformers_tpu_torch.serving.engine import ServeEngine

    placement = None
    if sc.placement_yaml:
        from ktransformers_tpu_torch.placement.library import load_placement

        placement = load_placement(sc.placement_yaml)
    spec, params = load_model(sc.model_path, quant=sc.quant,
                              moe_quant=sc.moe_quant,
                              config_path=sc.config_path,
                              placement=placement, device=device)
    engine_cls = ServeEngine
    if sc.offload:
        from ktransformers_tpu_torch.offload.paged_engine import (
            HostOffloadServeEngine,
        )

        engine_cls = HostOffloadServeEngine
    engine = engine_cls(params, spec, sc.scheduler_config(),
                        num_pages=sc.num_pages,
                        enable_prefix_cache=sc.enable_prefix_cache,
                        sparse_budget=sc.sparse_budget,
                        sparse_anchor=sc.sparse_anchor or "quest",
                        sparse_retrieval=sc.sparse_retrieval or "layer",
                        collect_routing=sc.collect_routing,
                        device=device)
    if not sc.offload:  # the offloaded engine keeps its depth of 1
        engine.decode_pipeline_depth = sc.decode_pipeline_depth
    return engine, load_tokenizer(sc.model_path, sc.tokenizer_path)


def cmd_serve(a) -> None:
    from ktransformers_tpu_torch.serving import server
    from ktransformers_tpu_torch.serving.config import ServerConfig

    overrides = dict(
        model_path=a.model_path, config_path=a.config_path,
        tokenizer_path=a.tokenizer_path, placement_yaml=a.placement_yaml,
        host=a.host, port=a.port, api_key=a.api_key,
        model_name=a.model_name, max_batch_size=a.max_batch_size,
        prefill_chunk=a.prefill_chunk, num_pages=a.num_pages,
        page_size=a.page_size, max_pages_per_query=a.max_pages_per_query,
        sparse_budget=a.sparse_budget, sparse_anchor=a.sparse_anchor,
        sparse_retrieval=a.sparse_retrieval, offload=a.offload,
        mount_web=a.mount_web)
    # the kinds have defaults: they override a config file only when given
    if a.config_file:
        sc = ServerConfig.from_file(a.config_file, **overrides)
        if a.quant != "int8" or sc.quant is None:
            sc.quant = a.quant
        if a.moe_quant != "int4_g" or sc.moe_quant is None:
            sc.moe_quant = a.moe_quant
    else:
        sc = ServerConfig(**{k: v for k, v in overrides.items()
                             if v is not None},
                          quant=a.quant, moe_quant=a.moe_quant)
    if not sc.model_path:
        raise CliError("model path required (argument or config-file "
                       "model_path)")
    engine, tok = build_engine(sc, a.device)
    server.serve(engine, tok, host=sc.host, port=sc.port,
                 model_name=sc.model_name, api_key=sc.api_key,
                 mount_web=sc.mount_web)


def cmd_convert(a) -> None:
    if a.stream:
        import shutil

        from ktransformers_tpu_torch.engine.local_chat import (
            resolve_spec_provider,
        )
        from ktransformers_tpu_torch.models.checkpoint import stream_convert

        spec, provider, exact = resolve_spec_provider(a.model_path,
                                                      a.config_path)
        stream_convert(provider, spec, a.out_dir, quant=a.quant,
                       moe_quant=a.moe_quant, exact_gguf=exact,
                       progress=lambda m: print(f"  converted {m}",
                                                flush=True))
        cfg = a.config_path or os.path.join(a.model_path, "config.json")
        if os.path.exists(cfg):
            shutil.copy(cfg, os.path.join(a.out_dir, "config.json"))
        print(f"\nstream-packed params written to {a.out_dir}")
        return
    _load(a, save_packed=a.out_dir, device="cpu")
    print(f"\npacked params written to {a.out_dir}")


def cmd_bench(a) -> None:
    raise NotImplementedError(
        "bench: bench.py drives the JAX package; the port's benchmark is "
        "ROADMAP Queue 1 item 2, not written yet")


def _power_limit() -> str | None:
    import shutil
    import subprocess

    smi = shutil.which("nvidia-smi")
    if smi is None:
        return None
    out = subprocess.run(
        [smi, "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=30)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else None


def _versions(names) -> dict:
    from importlib import metadata

    out = {}
    for name in names:
        try:
            out[name] = metadata.version(name)
        except metadata.PackageNotFoundError:
            out[name] = None
    return out


def cmd_doctor(a) -> None:
    import torch

    import ktransformers_tpu_torch
    from ktransformers_tpu_torch.ops.cuda import _build
    from ktransformers_tpu_torch.ops.cuda.quant_matmul import (
        quant_matmul,
        quant_matmul_ref,
    )
    from ktransformers_tpu_torch.quant.formats import quantize

    dev = torch.device(a.device)
    info = {
        "ktransformers_tpu_torch": ktransformers_tpu_torch.__version__,
        "python": sys.version.split()[0],
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "cuda_available": torch.cuda.is_available(),
        "device": str(dev),
        # installed or not (none is needed: the port's front door runs on
        # the standard library, numpy and torch)
        "optional_packages": _versions(("aiohttp", "click", "PyYAML",
                                        "safetensors", "transformers",
                                        "jax")),
    }
    if dev.type == "cuda":
        info["device_name"] = torch.cuda.get_device_name(dev)
        info["device_count"] = torch.cuda.device_count()
        info["name_power_limit"] = _power_limit()
        libs = {}
        try:
            _build.build_all()
        except Exception as e:
            info["kernel_build"] = f"error: {e}"
        for name in _build.SOURCES:
            try:
                _build.lib(name)
                libs[name] = "ok"
            except Exception as e:
                libs[name] = f"error: {e}"
        info["kernel_libraries"] = libs
    else:
        info["kernel_libraries"] = "not loaded: the CPU runs the plain versions"
    try:
        # one quant_matmul kernel launch (the plain version on the CPU)
        # held against the plain version on the same operands
        g = torch.Generator().manual_seed(0)
        x = torch.randn(4, 256, generator=g).to(torch.bfloat16).to(dev)
        w = quantize(torch.randn(256, 256, generator=g) * 0.05,
                     "int8").to(dev)
        y = quant_matmul(x, w).float()
        ref = quant_matmul_ref(x, w).float()
        err = float((y - ref).abs().max())
        tol = 2e-2 * float(ref.abs().max()) + 1e-3
        info["kernel_smoke"] = {"kernel": "quant_matmul",
                                "max_abs_err": err, "tolerance": tol}
        info["matmul_smoke"] = "ok" if err <= tol else (
            f"error: quant_matmul off its plain version by {err}")
    except Exception as e:
        info["matmul_smoke"] = f"error: {e}"
    print(json.dumps(info, indent=2))


def cmd_sft(a) -> None:
    from ktransformers_tpu_torch.engine.local_chat import load_tokenizer
    from ktransformers_tpu_torch.sft.data import load_sft_dataset
    from ktransformers_tpu_torch.sft.lora import (
        LoRAConfig,
        init_lora,
        save_lora,
    )
    from ktransformers_tpu_torch.sft.train import TrainConfig, Trainer

    spec, params = _load(a)
    tok = load_tokenizer(a.model_path, a.tokenizer_path)
    pl = init_lora(params, spec, LoRAConfig(rank=a.rank, alpha=a.alpha))
    trainer = Trainer(pl, spec, TrainConfig(learning_rate=a.lr,
                                            seq_len=a.seq_len),
                      device=a.device)
    step = 0
    for epoch in range(a.epochs):
        for input_ids, labels in load_sft_dataset(
                a.dataset_path, tok, seq_len=a.seq_len,
                batch_size=a.batch_size):
            loss = trainer.train_step(input_ids, labels)
            step += 1
            print(f"epoch {epoch} step {step} loss {loss:.4f}",
                  file=sys.stderr)
    save_lora(trainer.params, a.output_path)
    print(f"adapter saved to {a.output_path}")


def cmd_models_list(a) -> None:
    from ktransformers_tpu_torch.models.registry import list_models

    rows = list_models()
    wn = max(len(r["name"]) for r in rows)
    print(f"{'name':{wn}}  params  active  quant         gb      H100s")
    for r in rows:
        fit = "1 (fits)" if r["fits_h100"] else str(r["min_h100_cards"])
        print(f"{r['name']:{wn}}  {r['params_b']:>5.1f}B  "
              f"{r['active_b']:>5.1f}B  {r['quant']:<12}  "
              f"{r['total_gb']:>6.1f}  {fit}")


def cmd_models_show(a) -> None:
    from ktransformers_tpu_torch.models.registry import REGISTRY, show_model

    if a.name not in REGISTRY:
        raise CliError(f"unknown model {a.name!r}; see `models list`")
    print(json.dumps(show_model(a.name), indent=2))


def cmd_placements(a) -> None:
    from ktransformers_tpu_torch.placement.library import (
        RULES_DIR,
        available_placements,
    )

    if a.name is None:
        for n in available_placements():
            print(n)
        return
    path = os.path.join(RULES_DIR, a.name + ".json")
    if not os.path.exists(path):
        raise CliError(f"no shipped placement {a.name!r}; see `placements`")
    with open(path) as f:
        print(f.read(), end="")


def cmd_quant(a) -> None:
    from ktransformers_tpu_torch.quant.formats import QTensor

    spec, params = _load(a, save_packed=a.out_dir, device="cpu")
    kinds: dict[str, dict] = {}

    def visit(node):
        if isinstance(node, QTensor):
            ts = [t for t in (node.data, node.scales, node.zeros)
                  if t is not None]
            add(node.kind, sum(t.numel() * t.element_size() for t in ts))
        elif isinstance(node, dict):
            for v in node.values():
                visit(v)
        elif isinstance(node, list):
            for v in node:
                visit(v)
        elif hasattr(node, "gate_up"):  # MoEWeights
            visit(node.gate_up)
            visit(node.down)
        elif node is not None:
            add(str(node.dtype).removeprefix("torch."),
                node.numel() * node.element_size())

    def add(kind, nbytes):
        d = kinds.setdefault(kind, {"tensors": 0, "gb": 0.0})
        d["tensors"] += 1
        d["gb"] += nbytes / 1e9

    visit(params)
    for d in kinds.values():
        d["gb"] = round(d["gb"], 3)
    print(json.dumps({"out_dir": a.out_dir, "kinds": kinds}, indent=2))


# NVIDIA H100 SXM5 80GB data sheet: HBM3 at 3.35 TB/s
H100_HBM_BYTES_PER_S = 3.35e12


def cmd_tune(a) -> None:
    import torch

    from ktransformers_tpu_torch.models.registry import (
        H100_HBM_GB,
        REGISTRY,
        estimate_bytes,
    )

    if a.preset not in REGISTRY:
        raise CliError(f"unknown model {a.preset!r}; see `models list`")
    e = REGISTRY[a.preset]
    qk, mk = a.quant or e.quant, a.moe_quant or e.moe_quant
    spec = e.spec()
    est = estimate_bytes(e.config, qk, mk)
    if a.device == "cuda" and torch.cuda.is_available():
        props = torch.cuda.get_device_properties(0)
        card, mem_gb = props.name, props.total_memory / 1e9
        mem_from = "torch.cuda.get_device_properties(0).total_memory"
    else:
        card, mem_gb = "NVIDIA H100 80GB HBM3 (no card seen)", H100_HBM_GB
        mem_from = "registry.H100_HBM_GB"
    # decode reads the active weights once a token: its bound at the
    # data-sheet memory rate
    decode_bound = H100_HBM_BYTES_PER_S / (est["active_gb_per_token"] * 1e9)
    at = spec.attention
    kv_per_tok = (at.kv_lora_rank + at.qk_rope_head_dim if at.kind == "mla"
                  else 2 * at.num_kv_heads * at.head_dim) * 2 \
        * spec.num_layers  # bf16 pools
    fits = est["total_gb"] < mem_gb * 0.85
    free_gb = max(0.5, mem_gb * 0.92 - est["total_gb"])
    max_kv_tokens = int(free_gb * 1e9 / kv_per_tok)
    plan = {
        "model": a.preset,
        "card": card,
        "figures": (f"memory {mem_gb:.1f} GB from {mem_from}; decode bound "
                    "at the H100 SXM data-sheet HBM3 rate of 3.35 TB/s "
                    "(planning figures, not measurements)"),
        "quant": qk,
        "moe_quant": mk,
        "weights_gb": est["total_gb"],
        "mode": "resident" if fits else "host-offload (serve --offload) or "
        f">= {est['min_h100_cards']} cards",
        "decode_tok_s_bound_single": round(decode_bound, 1),
        "kv_bytes_per_token": kv_per_tok,
        "max_kv_tokens_on_card": max_kv_tokens,
        "serve": {
            "page_size": 64,
            "num_pages": max(64, max_kv_tokens // 64),
            "max_batch_size": 8 if fits else 64,
            "prefill_chunk": 256,
        },
    }
    out = json.dumps(plan, indent=2)
    print(out)
    if a.output:
        with open(a.output, "w") as f:
            f.write(out)
    if a.server_config_out:
        sc = {"quant": qk, "moe_quant": mk, "offload": not fits,
              **plan["serve"]}
        with open(a.server_config_out, "w") as f:
            f.write(json.dumps(sc, indent=2))
        print(f"server config written to {a.server_config_out}",
              file=sys.stderr)


def cmd_eval_ppl(a) -> None:
    from ktransformers_tpu_torch.engine.local_chat import (
        load_tokenizer,
        prompt_ids_error,
    )
    from ktransformers_tpu_torch.utils.eval import perplexity

    spec, params = _load(a)
    tok = load_tokenizer(a.model_path, a.tokenizer_path)
    with open(a.text_file) as f:
        ids = list(tok.encode(f.read()))[: a.max_tokens]
    err = prompt_ids_error(ids, spec.vocab_size)
    if err:
        raise CliError(err)
    ppl = perplexity(params, spec, ids, chunk=a.chunk, device=a.device)
    print(json.dumps({"perplexity": round(ppl, 4), "tokens": len(ids)}))


def cmd_eval_mc(a) -> None:
    from ktransformers_tpu_torch.utils.eval import mmlu_eval_http

    print(json.dumps(mmlu_eval_http(a.endpoint, a.dataset_json,
                                    limit=a.limit)))


# -- parser --------------------------------------------------------------------


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m ktransformers_tpu_torch.cli",
        description="ktransformers-tpu on PyTorch + CUDA (NVIDIA H100).")
    sub = ap.add_subparsers(dest="command", required=True)

    p = sub.add_parser("chat", help="interactive chat with a local model")
    p.add_argument("model_path")
    _model_options(p)
    p.add_argument("--max-new-tokens", type=int, default=512)
    p.add_argument("--temperature", type=float, default=0.6)
    p.add_argument("--top-p", type=float, default=0.95)
    p.add_argument("--max-len", type=int, default=4096)
    p.add_argument("--speculative-model", default=None,
                   help="a smaller draft model with the same vocabulary: "
                   "greedy turns (--temperature 0) run draft-model "
                   "speculation (engine/draft_spec.py)")
    p.set_defaults(fn=cmd_chat)

    p = sub.add_parser("serve", help="OpenAI / Ollama-compatible server")
    p.add_argument("model_path", nargs="?", default=None)
    _model_options(p)
    p.add_argument("--config-file", default=None,
                   help="JSON / YAML ServerConfig (serving/config.py); "
                   "flags override its values")
    p.add_argument("--host", default=None)
    p.add_argument("--port", type=int, default=None)
    p.add_argument("--api-key", default=None,
                   help="require Authorization: Bearer <key> on /v1, /api")
    p.add_argument("--model-name", default=None)
    for flag in ("--max-batch-size", "--prefill-chunk", "--num-pages",
                 "--page-size", "--max-pages-per-query", "--sparse-budget"):
        p.add_argument(flag, type=int, default=None)
    p.add_argument("--sparse-anchor", default=None,
                   choices=["quest", "block_max", "block_mean", "fixed",
                            "dynamic"])
    p.add_argument("--sparse-retrieval", default=None,
                   choices=["layer", "kvhead", "qhead"])
    p.add_argument("--offload", action=argparse.BooleanOptionalAction,
                   default=None,
                   help="routed experts computed in host memory "
                   "(offload/paged_engine.HostOffloadServeEngine)")
    p.add_argument("--no-web", dest="mount_web", action="store_const",
                   const=False, default=None,
                   help="do not serve the chat page at /")
    p.set_defaults(fn=cmd_serve)

    p = sub.add_parser("convert", help="HF / GGUF weights -> packed dir")
    p.add_argument("model_path")
    p.add_argument("out_dir")
    p.add_argument("--stream", action=argparse.BooleanOptionalAction,
                   default=False,
                   help="layer by layer with resume (bounded memory)")
    _model_options(p, device=False)
    p.set_defaults(fn=cmd_convert)

    p = sub.add_parser("bench", help="(not ported: ROADMAP item 2)")
    p.set_defaults(fn=cmd_bench)

    p = sub.add_parser("doctor", help="environment diagnostics")
    p.add_argument("--device", default="cuda")
    p.set_defaults(fn=cmd_doctor)

    p = sub.add_parser("sft", help="LoRA fine-tune on a JSON dataset")
    p.add_argument("model_path")
    p.add_argument("dataset_path")
    _model_options(p)
    p.add_argument("--output", dest="output_path",
                   default="adapter.safetensors")
    p.add_argument("--rank", type=int, default=8)
    p.add_argument("--alpha", type=float, default=16.0)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--epochs", type=int, default=1)
    p.add_argument("--batch-size", type=int, default=4)
    p.add_argument("--seq-len", type=int, default=512)
    p.set_defaults(fn=cmd_sft)

    p = sub.add_parser("models", help="model registry")
    msub = p.add_subparsers(dest="models_command", required=True)
    msub.add_parser("list", help="presets with size and H100 fit"
                    ).set_defaults(fn=cmd_models_list)
    ps = msub.add_parser("show", help="one preset's spec and advice")
    ps.add_argument("name")
    ps.set_defaults(fn=cmd_models_show)

    p = sub.add_parser("placements", help="list or print shipped rules")
    p.add_argument("name", nargs="?", default=None)
    p.set_defaults(fn=cmd_placements)

    p = sub.add_parser("quant", help="quantize to a packed dir, report")
    p.add_argument("model_path")
    p.add_argument("out_dir")
    _model_options(p, device=False)
    p.set_defaults(fn=cmd_quant)

    p = sub.add_parser("tune", help="plan serving knobs for this card")
    p.add_argument("--model", dest="preset", default="deepseek-v2-lite")
    p.add_argument("--quant", default=None)
    p.add_argument("--moe-quant", default=None)
    p.add_argument("--output", default=None)
    p.add_argument("--emit-server-config", dest="server_config_out",
                   default=None)
    p.add_argument("--device", default="cuda")
    p.set_defaults(fn=cmd_tune)

    p = sub.add_parser("eval-ppl", help="teacher-forced perplexity")
    p.add_argument("model_path")
    p.add_argument("text_file")
    _model_options(p)
    p.add_argument("--chunk", type=int, default=512)
    p.add_argument("--max-tokens", type=int, default=8192)
    p.set_defaults(fn=cmd_eval_ppl)

    p = sub.add_parser("eval-mc", help="multiple choice over HTTP")
    p.add_argument("endpoint")
    p.add_argument("dataset_json")
    p.add_argument("--limit", type=int, default=None)
    p.set_defaults(fn=cmd_eval_mc)
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    try:
        args.fn(args)
    except CliError as e:
        print(f"Error: {e}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
