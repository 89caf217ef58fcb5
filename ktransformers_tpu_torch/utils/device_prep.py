"""Engine-init parameter transforms (counterpart of
ktransformers_tpu/utils/device_prep.py:prepare_params).

Applied on every device (the kernels and their plain versions take the same
layouts): bf16 absorbed-MLA mats, the attention input projections fused
into one ("qkv_a" for MLA, "qkv" for GQA), and the W4A8 offset-lo repack
of the int4 kinds (int4, int4_g, int4_gz), which the environment variable
KT_W4A8=0 switches off as in the JAX package (they then run through
quant_matmul). The
TPU-layout passes (pad_scale_sublanes, normalize_layouts) have no
counterpart here.
"""

from __future__ import annotations

import dataclasses
import os

import torch

from ktransformers_tpu_torch.quant.formats import QTensor
from ktransformers_tpu_torch.quant.w4a8 import enable_w4a8


def bf16_absorbed_mats(params):
    """Store w_uk / w_uv in bf16 (the absorbed einsums upcast to f32)."""
    for lp in params.get("layers", []):
        attn = lp.get("attn")
        for k in ("w_uk", "w_uv"):
            v = attn.get(k) if isinstance(attn, dict) else None
            if v is not None and v.dtype == torch.float32:
                attn[k] = v.to(torch.bfloat16)
    return params


def _concat_out(parts):
    """Concatenate QTensors along N, or None when their formats differ."""
    f = parts[0]
    if not all(isinstance(t, QTensor) for t in parts):
        return None
    for t in parts[1:]:
        if (t.kind != f.kind or t.group_size != f.group_size
                or t.act_quant != f.act_quant or t.data.dtype != f.data.dtype
                or t.data.shape[:-1] != f.data.shape[:-1]
                or (t.scales is None) != (f.scales is None)
                or (t.zeros is None) != (f.zeros is None)
                or (t.scales is not None and t.scales.dtype != f.scales.dtype)
                or (t.zeros is not None and t.zeros.dtype != f.zeros.dtype)):
            return None
    return dataclasses.replace(
        f,
        data=torch.cat([t.data for t in parts], dim=-1),
        scales=None if f.scales is None
        else torch.cat([t.scales for t in parts], dim=-1),
        zeros=None if f.zeros is None
        else torch.cat([t.zeros for t in parts], dim=-1),
    )


def fuse_qkv_projections(params, spec):
    """Merge each layer's attention input projections into one matmul (one
    launch and one activation quant instead of two or three): MLA q_proj
    (q_a with q_lora_rank) + kv_a -> "qkv_a", GQA q_proj + k_proj + v_proj
    -> "qkv". Where a part has a bias, the fused projection gets one
    concatenated "<fused>_bias" (zeros for a part without one), as in the
    JAX package. A gated q_proj (qwen3-next, each head's [q | gate]) goes
    in whole, so the fused weight keeps its per-head interleave. Layers
    with differing formats or a LoRA adapter on a part keep theirs, and a
    GatedDeltaNet layer has no such projections (its in_proj_qkvz /
    out_proj are repacked for W4A8 like any other weight). Mutates params
    in place."""
    a = spec.attention
    if a.kind == "mla":
        names, fkey = ("q_a" if a.q_lora_rank else "q_proj", "kv_a"), "qkv_a"
        # the MLA path without q_lora takes no q bias (models/model.py)
        bias_keys = ("q_a_bias" if a.q_lora_rank else None, "kv_a_bias")
    else:
        names, fkey = ("q_proj", "k_proj", "v_proj"), "qkv"
        bias_keys = ("q_bias", "k_bias", "v_bias")
    for li, lp in enumerate(params.get("layers", [])):
        p = lp.get("attn")
        if spec.layer_kind(li) == "linear" or p is None or any(
                n not in p or n + "_lora" in p for n in names):
            continue
        parts = [p[n] for n in names]
        fused = _concat_out(parts)
        if fused is None:
            continue
        biases = [p.get(bk) if bk else None for bk in bias_keys]
        if any(b is not None for b in biases):
            dt = next(b.dtype for b in biases if b is not None)
            p[fkey + "_bias"] = torch.cat([
                b.to(dt) if b is not None else torch.zeros(
                    t.data.shape[-1], dtype=dt, device=t.data.device)
                for t, b in zip(parts, biases)])
        p[fkey] = fused
        for n, bk in zip(names, bias_keys):
            del p[n]
            if bk:
                p.pop(bk, None)
    return params


def prepare_params(params, spec=None):
    """bf16 absorbed mats, fused QKV (when spec is given), W4A8 repack
    (unless KT_W4A8=0).

    Transforms the caller's tree in place (dicts and QTensors) and returns
    it, so the caller's params are the prepared ones afterwards; preparing
    them again changes nothing."""
    params = bf16_absorbed_mats(params)
    if spec is not None:
        params = fuse_qkv_projections(params, spec)
    if os.environ.get("KT_W4A8", "1") != "0":
        params = enable_w4a8(params)
    return params


def params_to(node, device):
    """A copy of a params tree (dicts, lists, QTensors, MoEWeights and
    other dataclasses of tensors) with every tensor on ``device``."""
    if isinstance(node, QTensor):
        return node.to(device)
    if isinstance(node, dict):
        return {k: params_to(v, device) for k, v in node.items()}
    if isinstance(node, list):
        return [params_to(v, device) for v in node]
    if isinstance(node, torch.Tensor):
        return node.to(device)
    if dataclasses.is_dataclass(node):
        return dataclasses.replace(node, **{
            f.name: params_to(getattr(node, f.name), device)
            for f in dataclasses.fields(node)})
    return node
