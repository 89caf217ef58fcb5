"""Fuse shared experts into the routed call (counterpart of
ktransformers_tpu/ops/fuse_shared.py).

Where the shared FFN is n routed experts wide (DeepSeek: shared 2816 =
2 x 1408 in V2-Lite), it can be stored as n more experts at the end of the
routed arrays and ride the routed call as always-selected rows of weight
1.0 (or the sigmoid shared gate's value): models/model.py:_moe_mlp adds
them. A decode step then computes top-k + n gathered rows on one FFN
launch (gathered_w4a8_ffn) and no dense shared FFN (dense_w4a8_ffn)
launch in the MoE layers. The same codes and scales are used, so the
numbers change only by the order of the sums.

The params come back unchanged (as in the JAX package) where:
- the shared width is not a multiple of the routed one;
- the routed down's scale group does not divide the routed width (the
  shared down is cut along K into n experts);
- the kinds differ (unless ``requantize``: the shared weights are
  decoded and quantized again in the routed kinds, not value-exact), and
  here also where the shared down's group differs from the routed down's
  or a per-channel int4 down packs its nibbles across all of K (neither
  can be cut into experts; the JAX package would concatenate mismatched
  scales);
- the layer has LoRA, an expert map or mask, or experts in host memory.
Layers are replaced one at a time, in place in params["layers"], so one
layer's old buffers can go before the next is built.
"""

from __future__ import annotations

import dataclasses

import torch

from ktransformers_tpu_torch.ops.moe import MoEWeights
from ktransformers_tpu_torch.quant.formats import (
    INT4_KINDS,
    QTensor,
    dequantize,
    quantize,
)
from ktransformers_tpu_torch.quant.w4a8 import repack_offset_lo


def _same_format(a: QTensor, b: QTensor) -> bool:
    return (a.kind == b.kind and a.group_size == b.group_size
            and a.act_quant == b.act_quant)


def _requantized(qt: QTensor, like: QTensor) -> QTensor:
    """qt decoded and quantized again in like's kind and group (and
    repacked for W4A8 where like is)."""
    out = quantize(dequantize(qt, torch.float32), like.kind,
                   group_size=like.group_size or 128)
    return repack_offset_lo(out) if like.act_quant else out


def _cols(qt: QTensor, ranges) -> tuple:
    """(data, scales, zeros) of the given column ranges, concatenated."""
    def take(t):
        if t is None:
            return None
        return torch.cat([t[..., lo:hi] for lo, hi in ranges], dim=-1)
    return take(qt.data), take(qt.scales), take(qt.zeros)


def _stack(routed: QTensor, parts) -> QTensor:
    """routed [E, ...] with the parts (data, scales, zeros) appended as
    more experts."""
    def cat(base, extra):
        if base is None:
            return None
        return torch.cat([base] + [p[None] for p in extra], dim=0)
    return dataclasses.replace(
        routed, data=cat(routed.data, [p[0] for p in parts]),
        scales=cat(routed.scales, [p[1] for p in parts]),
        zeros=cat(routed.zeros, [p[2] for p in parts]))


def fuse_shared_experts(params, spec, requantize: bool = False):
    """params with each MoE layer's shared experts appended to its routed
    experts (MoEWeights.n_shared_fused set, "shared" removed), where the
    conditions of the module docstring allow; returns params."""
    m = spec.moe
    if m is None or not m.shared_expert_intermediate_size:
        return params
    f = m.moe_intermediate_size
    n_sh = m.shared_expert_intermediate_size // f
    if n_sh * f != m.shared_expert_intermediate_size:
        return params
    last = next((lp["moe"]["experts"] for lp in reversed(params["layers"])
                 if "moe" in lp), None)
    if isinstance(last, MoEWeights) and last.down.group_size \
            and f % last.down.group_size:
        return params
    layers = params["layers"]
    for li, lp in enumerate(layers):
        sh = lp.get("moe", {}).get("shared")
        w = lp.get("moe", {}).get("experts")
        if sh is None or not isinstance(w, MoEWeights):
            continue
        if any(k.endswith("_lora") for k in sh) or w.lora is not None \
                or w.logical_to_physical is not None \
                or w.expert_mask is not None or w.n_shared_fused:
            continue
        gu_sh, dn_sh = sh["gate_up"], sh["down"]
        if requantize and not (_same_format(gu_sh, w.gate_up)
                               and _same_format(dn_sh, w.down)):
            gu_sh = _requantized(gu_sh, w.gate_up)
            dn_sh = _requantized(dn_sh, w.down)
        if not (_same_format(gu_sh, w.gate_up)
                and _same_format(dn_sh, w.down)):
            continue
        if dn_sh.kind in INT4_KINDS and not dn_sh.group_size:
            continue
        # shared gate_up [K, 2 n f] -> n experts of [K, 2f]: gate i | up i
        gu_parts = [_cols(gu_sh, ((i * f, (i + 1) * f),
                                  ((n_sh + i) * f, (n_sh + i + 1) * f)))
                    for i in range(n_sh)]
        # shared down [n f, d] -> n experts of [f, d] (packed rows of the
        # int4 kinds, whole scale groups; per-channel scales shared)
        rows = f // 2 if dn_sh.kind in INT4_KINDS else f
        gpf = f // dn_sh.group_size if dn_sh.group_size else 0
        dn_parts = []
        for i in range(n_sh):
            if gpf:
                pick = lambda t: None if t is None else t[  # noqa: E731
                    i * gpf:(i + 1) * gpf]
            else:
                pick = lambda t: t  # noqa: E731
            dn_parts.append((dn_sh.data[i * rows:(i + 1) * rows],
                             pick(dn_sh.scales), pick(dn_sh.zeros)))
        moe = {k: v for k, v in lp["moe"].items() if k != "shared"}
        moe["experts"] = MoEWeights(
            gate_up=_stack(w.gate_up, gu_parts),
            down=_stack(w.down, dn_parts), n_shared_fused=n_sh)
        layers[li] = {**lp, "moe": moe}
    return params
