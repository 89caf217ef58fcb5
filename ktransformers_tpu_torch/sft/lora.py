"""LoRA adapters: init / split / merge / save / load (counterpart of
ktransformers_tpu/sft/lora.py).

Adapters live beside the quantized base weights: "<key>_lora" = {"a":
[K, r], "b": [r, N]} next to an attention QTensor, and MoEWeights.lora for
the routed experts; alpha / r is folded into the a factors and b starts at
zero, so a fresh adapter changes nothing. Files are safetensors keyed by
the params path exactly as the JAX package names them
("layers/3/moe/experts/lora/gate_up_a"), so an adapter written by either
package loads in the other; loader/safetensors_io.py reads and writes
them.
"""

from __future__ import annotations

import dataclasses
import re

import numpy as np
import torch

from ktransformers_tpu_torch.loader.safetensors_io import load_file, save_file
from ktransformers_tpu_torch.models.spec import ModelSpec
from ktransformers_tpu_torch.ops.moe import MoEWeights
from ktransformers_tpu_torch.quant.formats import QTensor

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


@dataclasses.dataclass(frozen=True)
class LoRAConfig:
    rank: int = 8
    alpha: float = 16.0
    # regex over module paths; the routed experts are "experts"
    target_modules: tuple[str, ...] = (
        r".*\.attn\.(q_proj|q_a|q_b|kv_a|o_proj|k_proj|v_proj)",
        r".*\.moe\.experts",
    )
    dtype: str = "float32"

    @property
    def scaling(self) -> float:
        return self.alpha / self.rank


def _targets(cfg: LoRAConfig, path: str) -> bool:
    return any(re.fullmatch(p, path) for p in cfg.target_modules)


def init_lora(params, spec: ModelSpec, cfg: LoRAConfig, seed: int = 0):
    """A new params tree with LoRA leaves added beside the targeted
    weights (the base weights are shared, not copied). The a factors are
    standard normals / sqrt(K) * alpha / r drawn from one
    np.random.default_rng(seed) in the JAX package's order, so they equal
    its factors bit for bit; the b factors are zeros. Each factor lies on
    its weight's device."""
    rng = np.random.default_rng(seed)
    dt = _DTYPES[cfg.dtype]

    def normal(shape, fan_in: int, device):
        a = (rng.standard_normal(shape).astype(np.float32)
             / np.sqrt(fan_in) * cfg.scaling)
        return torch.from_numpy(a).to(dt).to(device)

    def make(qt: QTensor):
        dev = qt.data.device
        return {"a": normal((qt.in_features, cfg.rank), qt.in_features, dev),
                "b": torch.zeros(cfg.rank, qt.out_features, dtype=dt,
                                 device=dev)}

    def walk_layer(li, lp):
        new = dict(lp)
        attn = dict(lp["attn"])
        for key, val in list(attn.items()):
            if isinstance(val, QTensor) and _targets(
                    cfg, f"layers.{li}.attn.{key}"):
                attn[key + "_lora"] = make(val)
        new["attn"] = attn
        if "moe" in lp:
            moe = dict(lp["moe"])
            ex: MoEWeights = moe["experts"]
            if _targets(cfg, f"layers.{li}.moe.experts"):
                e, d = ex.num_experts, ex.hidden_size
                f = ex.intermediate_size
                dev = ex.gate_up.data.device
                kw = dict(dtype=dt, device=dev)
                lora = {"gate_up_a": normal((e, d, cfg.rank), d, dev),
                        "gate_up_b": torch.zeros(e, cfg.rank, 2 * f, **kw)}
                lora["down_a"] = normal((e, f, cfg.rank), f, dev)
                lora["down_b"] = torch.zeros(e, cfg.rank, d, **kw)
                moe["experts"] = dataclasses.replace(ex, lora=lora)
            if moe.get("shared") is not None and _targets(
                    cfg, f"layers.{li}.moe.shared"):
                sh = dict(moe["shared"])
                for key in ("gate_up", "down"):
                    sh[key + "_lora"] = make(sh[key])
                moe["shared"] = sh
            new["moe"] = moe
        if "mlp" in lp and _targets(cfg, f"layers.{li}.mlp"):
            mlp = dict(lp["mlp"])
            for key in ("gate_up", "down"):
                mlp[key + "_lora"] = make(mlp[key])
            new["mlp"] = mlp
        return new

    new_params = dict(params)
    new_params["layers"] = [walk_layer(li, lp)
                            for li, lp in enumerate(params["layers"])]
    return new_params


def _is_lora_path(path: tuple) -> bool:
    return any(isinstance(k, str) and (k.endswith("_lora") or k == "lora")
               for k in path)


def tree_map_with_path(fn, tree, path=()):
    """fn(path, leaf) over a params tree (dicts, lists, dataclasses such as
    MoEWeights; a QTensor, a tensor or None is a leaf). Paths are tuples
    of dict keys, list indices and field names."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, path + (k,))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map_with_path(fn, v, path + (i,))
                for i, v in enumerate(tree)]
    if dataclasses.is_dataclass(tree) and not isinstance(tree, QTensor):
        return dataclasses.replace(tree, **{
            f.name: tree_map_with_path(fn, getattr(tree, f.name),
                                       path + (f.name,))
            for f in dataclasses.fields(tree)})
    return fn(path, tree)


def lora_leaves(tree) -> list[tuple[str, torch.Tensor]]:
    """(name, tensor) of every LoRA leaf, named as the JAX package names
    them in its adapter files, in tree order."""
    out = []

    def visit(path, leaf):
        if leaf is not None and _is_lora_path(path):
            out.append(("/".join(str(k) for k in path), leaf))
        return leaf

    tree_map_with_path(visit, tree)
    return out


def split_lora(params):
    """(trainable_lora, frozen_base): same-structure trees with None holes.
    The LoRA leaves come back detached with requires_grad set (sharing the
    caller's storage); the base keeps everything else."""
    lora = tree_map_with_path(
        lambda p, x: x.detach().requires_grad_(True)
        if x is not None and _is_lora_path(p) else None, params)
    base = tree_map_with_path(
        lambda p, x: None if _is_lora_path(p) else x, params)
    return lora, base


def merge_lora_params(lora, base):
    """Inverse of split_lora."""
    if isinstance(base, dict):
        return {k: merge_lora_params(lora[k], v) for k, v in base.items()}
    if isinstance(base, list):
        return [merge_lora_params(a, b) for a, b in zip(lora, base)]
    if dataclasses.is_dataclass(base) and not isinstance(base, QTensor):
        return dataclasses.replace(base, **{
            f.name: merge_lora_params(getattr(lora, f.name),
                                      getattr(base, f.name))
            for f in dataclasses.fields(base)})
    return lora if lora is not None else base


# safetensors: an 8-byte little-endian header length, a JSON header of
# {name: {"dtype", "shape", "data_offsets": [begin, end]}} padded with
# spaces to a multiple of 8, then the tensors' raw bytes back to back.
def save_lora(params, path: str) -> None:
    """Write every LoRA leaf of params to a safetensors file."""
    flat = dict(lora_leaves(params))
    if not flat:
        raise ValueError("save_lora: no LoRA leaves found")
    save_file(flat, path)


def load_lora(params, path: str):
    """params (which already holds LoRA leaves of the same config) with
    every leaf the file names replaced by the file's values, on the leaf's
    device."""
    flat = load_file(path)

    def take(p, leaf):
        name = "/".join(str(k) for k in p)
        if leaf is not None and name in flat:
            return flat[name].to(leaf.device)
        return leaf

    return tree_map_with_path(take, params)
