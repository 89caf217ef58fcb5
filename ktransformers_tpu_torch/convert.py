"""Carry parameters of the JAX package across to this port.

``params_from_jax(tree, spec, device)`` takes the JAX package's params tree
after ``jax.device_get`` (dicts, lists, and QTensor / MoEWeights objects
holding numpy arrays) and returns the port's tree. It reads objects by
their fields only and imports nothing from the JAX package. Handled:
- group scales padded along the group axis (pad_scale_sublanes, ngp > ng)
  are sliced back to the true group count;
- lane-padding columns of a fused qkv_a projection are dropped;
- int4 data already in the offset-lo encoding (act_quant, int8) and data
  not yet repacked (uint8) are both kept as they are, with the flag.
"""

from __future__ import annotations

import numpy as np
import torch

from ktransformers_tpu_torch.models.spec import ModelSpec
from ktransformers_tpu_torch.ops.moe import MoEWeights
from ktransformers_tpu_torch.quant.formats import INT4_KINDS, QTensor


def tensor_from_numpy(a, device) -> torch.Tensor:
    """numpy (including ml_dtypes bfloat16) -> torch tensor on device."""
    a = np.array(a)  # a writable, contiguous copy
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def _is_qtensor(obj) -> bool:
    if isinstance(obj, (np.ndarray, np.generic)):
        return False
    return all(hasattr(obj, f) for f in ("data", "scales", "kind",
                                         "group_size"))


def qtensor_from_jax(q, device, out_cols: int | None = None) -> QTensor:
    """One JAX QTensor -> port QTensor (scale padding and, when out_cols
    is given, padding columns removed)."""
    data = tensor_from_numpy(q.data, device)
    scales = None if q.scales is None else tensor_from_numpy(q.scales, device)
    if getattr(q, "zeros", None) is not None:
        raise ValueError("zero-point formats are not ported")
    act_quant = bool(getattr(q, "act_quant", False))
    if q.kind in INT4_KINDS and act_quant != (data.dtype == torch.int8):
        raise ValueError(f"act_quant={act_quant} with {data.dtype} data")
    if scales is not None and q.group_size:
        k = data.shape[-2] * (2 if q.kind in INT4_KINDS else 1)
        scales = scales[..., : k // q.group_size, :]
    if out_cols is not None and data.shape[-1] > out_cols:
        data = data[..., :out_cols]
        scales = None if scales is None else scales[..., :out_cols]
    return QTensor(
        data.contiguous(),
        None if scales is None else scales.contiguous(),
        None, kind=q.kind, group_size=int(q.group_size), act_quant=act_quant,
    )


def params_from_jax(tree, spec: ModelSpec, device="cuda"):
    """The JAX params tree (numpy leaves) as the port's params on device."""
    a = spec.attention
    qkv_cols = (a.num_heads * (a.qk_nope_head_dim + a.qk_rope_head_dim)
                + a.kv_lora_rank + a.qk_rope_head_dim)

    def conv(node, key=None):
        if _is_qtensor(node):
            return qtensor_from_jax(
                node, device, qkv_cols if key == "qkv_a" else None
            )
        if hasattr(node, "gate_up") and hasattr(node, "down"):
            return MoEWeights(conv(node.gate_up), conv(node.down))
        if isinstance(node, dict):
            out = {k: conv(v, k) for k, v in node.items()}
            if "qkv_a_bias" in out:
                out["qkv_a_bias"] = out["qkv_a_bias"][:qkv_cols]
            return out
        if isinstance(node, (list, tuple)):
            return [conv(v) for v in node]
        if node is None:
            return None
        return tensor_from_numpy(node, device)

    return conv(tree)
