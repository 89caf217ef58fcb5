"""Packed checkpoints: save and load quantized params trees (counterpart of
ktransformers_tpu/models/checkpoint.py, the same directory layout, so a
directory either package writes loads in the other).

A directory holds ``params.safetensors`` (flat "/"-joined tree paths, e.g.
"layers/1/moe/experts/gate_up/data"; bfloat16 stored as its uint16 bits,
float8 as its uint8 bits) and ``manifest.json``: {"statics": {path: node
record}, "dtypes": {name: dtype name}}. A node record is {"type": "dict",
"keys"}, {"type": "list", "len"}, {"type": "QTensor", "kind",
"group_size", "has_scales", "has_zeros"}, {"type": "MoEWeights",
"has_l2p", "has_mask", "has_lora", "lora_keys"} (and, for fused shared
experts, "n_shared_fused", which the JAX package neither writes nor
reads) or {"type": "array"} (None leaves too:
they have no tensor). An expert map and mask are stored as the
"logical_to_physical" / "expert_mask" leaves of their MoEWeights. What is stored is the tree
build_params returns, before prepare_params; a prepared tree (W4A8
offset-lo codes) is refused.

``stream_convert`` converts a provider unit by unit (the head, then each
decoder layer, each its own directory published atomically), skipping
units already written, so an interrupted conversion resumes;
``stream_load`` assembles the result.
"""

from __future__ import annotations

import json
import os
import shutil
import types

import torch

from ktransformers_tpu_torch.convert import params_from_jax
from ktransformers_tpu_torch.loader.safetensors_io import (
    SafetensorsFile,
    save_file,
)
from ktransformers_tpu_torch.ops.moe import MoEWeights
from ktransformers_tpu_torch.quant.formats import QTensor

# stored as these integer bits (numpy and the safetensors package's numpy
# reader have no such float types)
_BITS = {torch.bfloat16: torch.uint16, torch.float8_e4m3fn: torch.uint8}
_VIEWS = {"bfloat16": torch.bfloat16, "float8_e4m3fn": torch.float8_e4m3fn}


def _dtype_name(t: torch.Tensor) -> str:
    return str(t.dtype).removeprefix("torch.")


def save_params(params, out_dir: str) -> None:
    """Write an unprepared params tree (any device) to ``out_dir``."""
    os.makedirs(out_dir, exist_ok=True)
    arrays, dtypes, statics = {}, {}, {}

    def leaf(t, name):
        if t is None:
            return
        dtypes[name] = _dtype_name(t)
        bits = _BITS.get(t.dtype)
        t = t.detach().to("cpu").contiguous()
        arrays[name] = t.view(bits) if bits is not None else t

    def record(node, prefix):
        name = prefix.lstrip("/")
        if isinstance(node, QTensor):
            if node.act_quant:
                raise ValueError(
                    f"save_params: {name} holds W4A8 offset-lo codes (a "
                    "prepared tree); save the tree build_params returns")
            statics[prefix] = {
                "type": "QTensor", "kind": node.kind,
                "group_size": node.group_size,
                "has_scales": node.scales is not None,
                "has_zeros": node.zeros is not None,
            }
            for f in ("data", "scales", "zeros"):
                leaf(getattr(node, f), f"{name}/{f}")
            return
        if isinstance(node, MoEWeights):
            statics[prefix] = {
                "type": "MoEWeights",
                "has_l2p": node.logical_to_physical is not None,
                "has_mask": node.expert_mask is not None,
                "has_lora": node.lora is not None,
                "lora_keys": sorted(node.lora) if node.lora else [],
            }
            if node.n_shared_fused:
                statics[prefix]["n_shared_fused"] = node.n_shared_fused
            record(node.gate_up, prefix + "/gate_up")
            record(node.down, prefix + "/down")
            leaf(node.logical_to_physical, f"{name}/logical_to_physical")
            leaf(node.expert_mask, f"{name}/expert_mask")
            for k, v in (node.lora or {}).items():
                leaf(v, f"{name}/lora/{k}")
            return
        if isinstance(node, dict):
            statics[prefix] = {"type": "dict", "keys": sorted(node)}
            for k, v in node.items():
                record(v, f"{prefix}/{k}")
            return
        if isinstance(node, (list, tuple)):
            statics[prefix] = {"type": "list", "len": len(node)}
            for i, v in enumerate(node):
                record(v, f"{prefix}/{i}")
            return
        statics[prefix] = {"type": "array"}
        leaf(node, name)

    record(params, "")
    with open(os.path.join(out_dir, "manifest.json"), "w") as f:
        json.dump({"statics": statics, "dtypes": dtypes}, f)
    save_file(arrays, os.path.join(out_dir, "params.safetensors"))


def _read_tree(out_dir: str):
    """The stored tree with CPU torch leaves and namespaces for QTensor and
    MoEWeights nodes, in the JAX package's object shape."""
    with open(os.path.join(out_dir, "manifest.json")) as f:
        manifest = json.load(f)
    statics, dtypes = manifest["statics"], manifest["dtypes"]
    fh = SafetensorsFile(os.path.join(out_dir, "params.safetensors"))

    def arr(name):
        if name not in fh:
            return None
        t = fh.get(name)
        view = _VIEWS.get(dtypes.get(name))
        return t.view(view) if view is not None else t

    def build(prefix):
        st = statics[prefix]
        base = prefix.lstrip("/")
        kind = st["type"]
        if kind == "array":
            return arr(base)
        if kind == "QTensor":
            return types.SimpleNamespace(
                data=arr(f"{base}/data"),
                scales=arr(f"{base}/scales") if st["has_scales"] else None,
                zeros=arr(f"{base}/zeros") if st["has_zeros"] else None,
                kind=st["kind"], group_size=st["group_size"])
        if kind == "MoEWeights":
            lora = None
            if st.get("has_lora"):
                lora = {k: arr(f"{base}/lora/{k}") for k in st["lora_keys"]}
            return types.SimpleNamespace(
                gate_up=build(prefix + "/gate_up"),
                down=build(prefix + "/down"),
                logical_to_physical=arr(f"{base}/logical_to_physical")
                if st["has_l2p"] else None,
                expert_mask=arr(f"{base}/expert_mask")
                if st["has_mask"] else None,
                lora=lora, n_shared_fused=st.get("n_shared_fused", 0))
        if kind == "dict":
            return {k: build(f"{prefix}/{k}") for k in st["keys"]}
        if kind == "list":
            return [build(f"{prefix}/{i}") for i in range(st["len"])]
        raise ValueError(f"{out_dir}: unknown node type {kind!r}")

    try:
        return build("")
    finally:
        fh.close()


def load_params(out_dir: str, spec=None, device="cuda"):
    """The port's params tree on ``device`` from a directory written by
    either package's save_params: what convert.params_from_jax makes of
    the JAX package's tree (``spec`` is needed only for a tree that holds
    fused projections)."""
    return params_from_jax(_read_tree(out_dir), spec, device)


def stream_convert(provider, spec, out_dir: str, quant: str = "int8",
                   moe_quant: str | None = None, placement=None,
                   exact_gguf: bool = False, progress=None) -> None:
    """Convert unit by unit with resume: "head" (embedding, final norm,
    lm_head) and "layer_0000", ... each become a save_params directory,
    written under a temporary name and renamed when complete; a unit whose
    directory exists is skipped. Peak memory is one layer's tensors."""
    from ktransformers_tpu_torch.models.loading import build_params

    os.makedirs(out_dir, exist_ok=True)
    kw = dict(quant=quant, moe_quant=moe_quant, placement=placement,
              exact_gguf=exact_gguf, device="cpu")

    def unit_done(name):
        return os.path.exists(os.path.join(out_dir, name, "manifest.json"))

    def write_unit(name, tree):
        d = os.path.join(out_dir, name)
        tmp = d + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        save_params(tree, tmp)
        os.replace(tmp, d)  # resume never sees a partial unit

    if not unit_done("head"):
        head = build_params(provider, spec, layer_indices=[],
                            include_head=True, **kw)
        head.pop("layers")
        write_unit("head", head)
        if progress:
            progress("head")
    for li in range(spec.num_layers):
        name = f"layer_{li:04d}"
        if unit_done(name):
            continue
        part = build_params(provider, spec, layer_indices=[li],
                            include_head=False, **kw)
        write_unit(name, part["layers"][0])
        if progress:
            progress(f"layer {li + 1}/{spec.num_layers}")
    with open(os.path.join(out_dir, "stream_manifest.json"), "w") as f:
        json.dump({"num_layers": spec.num_layers, "format": 1}, f)


def stream_load(out_dir: str, spec=None, device="cuda"):
    """Assemble the params of a stream_convert directory on ``device``."""
    with open(os.path.join(out_dir, "stream_manifest.json")) as f:
        meta = json.load(f)
    params = load_params(os.path.join(out_dir, "head"), spec, device)
    params["layers"] = [
        load_params(os.path.join(out_dir, f"layer_{li:04d}"), spec, device)
        for li in range(meta["num_layers"])
    ]
    return params
