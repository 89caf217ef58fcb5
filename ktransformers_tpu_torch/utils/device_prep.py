"""Engine-init parameter transforms (counterpart of
ktransformers_tpu/utils/device_prep.py:prepare_params).

Applied on every device (the kernels and their plain versions take the same
layouts): bf16 absorbed-MLA mats, q_proj + kv_a fused into one "qkv_a"
projection, and the W4A8 offset-lo repack. The TPU-layout passes
(pad_scale_sublanes, normalize_layouts) have no counterpart here.
"""

from __future__ import annotations

import dataclasses

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
                or t.zeros is not None or f.zeros is not None):
            return None
    return dataclasses.replace(
        f,
        data=torch.cat([t.data for t in parts], dim=-1),
        scales=None if f.scales is None
        else torch.cat([t.scales for t in parts], dim=-1),
    )


def fuse_qkv_projections(params, spec):
    """Merge q_proj + kv_a into one "qkv_a" matmul per layer (one launch
    and one activation quant instead of two). Mutates params in place."""
    for lp in params.get("layers", []):
        p = lp.get("attn")
        if p is None or "q_proj" not in p or "kv_a" not in p:
            continue
        if "q_proj_bias" in p or "kv_a_bias" in p:
            continue
        fused = _concat_out([p["q_proj"], p["kv_a"]])
        if fused is None:
            continue
        p["qkv_a"] = fused
        del p["q_proj"], p["kv_a"]
    return params


def prepare_params(params, spec=None):
    """bf16 absorbed mats, fused QKV (when spec is given), W4A8 repack.

    Transforms the caller's tree in place (dicts and QTensors) and returns
    it, so the caller's params are the prepared ones afterwards; preparing
    them again changes nothing."""
    params = bf16_absorbed_mats(params)
    if spec is not None:
        params = fuse_qkv_projections(params, spec)
    return enable_w4a8(params)
