"""Carry parameters and paged KV state of the JAX package across to this
port.

``params_from_jax(tree, spec, device)`` takes the JAX package's params tree
after ``jax.device_get`` (dicts, lists, and QTensor / MoEWeights objects
holding numpy arrays) and returns the port's tree. It reads objects by
their fields only and imports nothing from the JAX package. Handled:
- group scales padded along the group axis (pad_scale_sublanes, ngp > ng)
  are sliced back to the true group count;
- lane-padding columns of a fused qkv_a (MLA, [q_proj or q_a | kv_a]) or
  qkv (GQA) projection are dropped; every other key (q_a_norm, q_b,
  router_bias_corr, ...) crosses as it is;
- int4 data already in the offset-lo encoding (act_quant, int8) and data
  not yet repacked (uint8) are both kept as they are, with the flag;
- every format of quant/formats.py: per-channel scales [..., 1, N], zero
  points, float8_e4m3fn data and uint8 ue8m0 exponents;
- LoRA adapters: the "<key>_lora" dicts and MoEWeights.lora, and the
  expert map, mask and fused shared count (logical_to_physical,
  expert_mask, n_shared_fused);
- a GatedDeltaNet layer's leaves (conv_w, A_log, dt_bias, norm_w, the bf16
  in_proj_ba, the quantized in_proj_qkvz / out_proj) cross as they are;
  a gated q_proj is twice as wide inside the fused qkv.

``paged_cache_from_jax(kv, spec, device)`` carries a JAX PagedKVCache (MLA
or GQA pools, their page summaries for sparse decode where it keeps them,
and a hybrid model's conv tails [slots, K, conv_dim] and float32 recurrent
states [slots, Hv, dk, dv], numpy leaves) across, so a run can prefill on
one side and continue on the other. Scheduler, allocator and prefix cache
hold only Python state and need no conversion.

``mtp_params_from_jax(tree, spec, device)`` carries a JAX MTP head
(engine/mtp.py: enorm, hnorm, eh_proj, the decoder layer, final_norm)
across through the same machinery.
"""

from __future__ import annotations

import numpy as np
import torch

from ktransformers_tpu_torch.cache.paged import PagedKVCache
from ktransformers_tpu_torch.models.spec import ModelSpec
from ktransformers_tpu_torch.ops.moe import MoEWeights
from ktransformers_tpu_torch.quant.formats import INT4_KINDS, QTensor


def tensor_from_numpy(a, device) -> torch.Tensor:
    """numpy (including ml_dtypes bfloat16 and float8_e4m3fn, which numpy
    itself does not know: they cross as their bits) -> torch tensor on
    device; a torch tensor moves as it is."""
    if isinstance(a, torch.Tensor):
        return a.to(device)
    a = np.array(a)  # a writable, contiguous copy
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(device)
    if a.dtype.name == "float8_e4m3fn":
        return torch.from_numpy(a.view(np.uint8)).view(
            torch.float8_e4m3fn).to(device)
    return torch.from_numpy(a).to(device)


def _is_qtensor(obj) -> bool:
    if isinstance(obj, (np.ndarray, np.generic)):
        return False
    return all(hasattr(obj, f) for f in ("data", "scales", "kind",
                                         "group_size"))


def qtensor_from_jax(q, device, out_cols: int | None = None) -> QTensor:
    """One JAX QTensor -> port QTensor (scale / zero-point padding and,
    when out_cols is given, padding columns removed)."""
    data = tensor_from_numpy(q.data, device)
    scales = None if q.scales is None else tensor_from_numpy(q.scales, device)
    zeros = getattr(q, "zeros", None)
    zeros = None if zeros is None else tensor_from_numpy(zeros, device)
    act_quant = bool(getattr(q, "act_quant", False))
    if q.kind in INT4_KINDS and act_quant != (data.dtype == torch.int8):
        raise ValueError(f"act_quant={act_quant} with {data.dtype} data")
    if scales is not None and q.group_size:
        k = data.shape[-2] * (2 if q.kind in INT4_KINDS else 1)
        scales = scales[..., : k // q.group_size, :]
        zeros = None if zeros is None else zeros[..., : k // q.group_size, :]
    if out_cols is not None and data.shape[-1] > out_cols:
        data = data[..., :out_cols]
        scales = None if scales is None else scales[..., :out_cols]
        zeros = None if zeros is None else zeros[..., :out_cols]
    return QTensor(
        data.contiguous(),
        None if scales is None else scales.contiguous(),
        None if zeros is None else zeros.contiguous(), kind=q.kind, group_size=int(q.group_size), act_quant=act_quant,
    )


def params_from_jax(tree, spec: ModelSpec | None, device="cuda"):
    """The JAX params tree (numpy leaves) as the port's params on device.
    Without a spec the tree must hold no fused projection (an unprepared
    tree, as build_params makes and models/checkpoint.py stores)."""
    a = spec.attention if spec is not None else None
    if a is None:
        fkey, qkv_cols = None, None
    elif a.kind == "mla":
        fkey = "qkv_a"
        qkv_cols = (a.q_lora_rank or a.num_heads * (a.qk_nope_head_dim
                                                    + a.qk_rope_head_dim)
                    ) + a.kv_lora_rank + a.qk_rope_head_dim
    else:
        fkey = "qkv"
        qkv_cols = (a.num_heads * (2 if a.gated_output else 1)
                    + 2 * a.num_kv_heads) * a.head_dim

    def conv(node, key=None):
        if _is_qtensor(node):
            return qtensor_from_jax(
                node, device, qkv_cols if key == fkey else None
            )
        if hasattr(node, "gate_up") and hasattr(node, "down"):
            return MoEWeights(
                conv(node.gate_up), conv(node.down),
                conv(getattr(node, "lora", None)),
                logical_to_physical=conv(getattr(node, "logical_to_physical",
                                                 None)),
                expert_mask=conv(getattr(node, "expert_mask", None)),
                n_shared_fused=int(getattr(node, "n_shared_fused", 0)))
        if isinstance(node, dict):
            if fkey is None and ("qkv_a" in node or "qkv" in node):
                raise ValueError("a fused projection needs the model spec")
            out = {k: conv(v, k) for k, v in node.items()}
            if fkey is not None and fkey + "_bias" in out:
                out[fkey + "_bias"] = out[fkey + "_bias"][:qkv_cols]
            return out
        if isinstance(node, (list, tuple)):
            return [conv(v) for v in node]
        if node is None:
            return None
        return tensor_from_numpy(node, device)

    return conv(tree)


def paged_cache_from_jax(kv, spec: ModelSpec, device="cuda") -> PagedKVCache:
    """The JAX package's PagedKVCache after ``jax.device_get`` (bufs_a /
    bufs_b lists of numpy arrays, page_size) as the port's, on device; the
    ``spec`` it was made for marks which layers hold slot state (a hybrid
    model's linear layers); the summary planes (smin, smax, ssum, sfix,
    sdyn, float32, one a layer) cross where the cache keeps them."""
    planes = {}
    for n in PagedKVCache.PLANES:
        leaves = getattr(kv, n, None)
        if leaves is not None:
            planes[n] = [tensor_from_numpy(t, device) for t in leaves]
    return PagedKVCache(
        bufs_a=[tensor_from_numpy(a, device) for a in kv.bufs_a],
        bufs_b=[tensor_from_numpy(b, device) for b in kv.bufs_b],
        page_size=int(kv.page_size),
        linear_layers=tuple(li for li in range(spec.num_layers)
                            if spec.layer_kind(li) == "linear"),
        **planes,
    )


MTP_KEYS = ("enorm", "hnorm", "eh_proj", "layer", "final_norm")


def mtp_params_from_jax(tree, spec: ModelSpec, device="cuda") -> dict:
    """A JAX MTP head after ``jax.device_get`` as the port's, on device:
    the norms and eh_proj as tensors / QTensors, the decoder layer through
    params_from_jax (a fused projection trimmed as a model layer's)."""
    missing = [k for k in MTP_KEYS if k not in tree]
    if missing:
        raise ValueError(f"not an MTP head: no {missing}")
    out = params_from_jax({"layers": [tree["layer"]],
                           **{k: tree[k] for k in MTP_KEYS if k != "layer"}},
                          spec, device)
    out["layer"] = out.pop("layers")[0]
    return out
