"""Expert placement from routing statistics (counterpart of
ktransformers_tpu/utils/expert_placement.py).

- ``ExpertStatsCollector`` counts each layer's routed expert ids (the
  serving engine feeds it with collect_routing);
- ``hot_expert_masks``: the experts to keep resident, by strategy
  (frequency, uniform, front-loading, random), as the JAX package picks
  them;
- ``balanced_logical_to_physical``: a greedy frequency-balanced
  assignment of experts to ep ranks (heaviest first, each to the least
  loaded rank with room), as the map logical id -> storage slot;
- ``reorder_expert_weights``: a MoEWeights with its expert axis permuted
  to that map and the map attached, composed with any map it already
  carries. Every tensor of the expert set moves together: the codes,
  scales and zero points of a repacked W4A8 gate_up / down (and any other
  per-expert tensor of a QTensor) and the LoRA factors. Fused shared
  experts (MoEWeights.n_shared_fused, stored after the routed ones) keep
  their slots: a map of the routed experts is extended by the identity
  over them (the JAX package drops them and n_shared_fused here).
The outputs do not change: moe_forward sends each logical id to its slot.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ktransformers_tpu_torch.ops.moe import MoEWeights
from ktransformers_tpu_torch.quant.formats import QTensor


class ExpertStatsCollector:
    """Per-layer expert activation counts from routed ids [..., k]."""

    def __init__(self, num_layers: int, num_experts: int):
        self.counts = np.zeros((num_layers, num_experts), np.int64)

    def record(self, layer: int, topk_idx) -> None:
        ids = np.asarray(topk_idx).reshape(-1)
        np.add.at(self.counts[layer], ids, 1)

    @property
    def frequencies(self) -> np.ndarray:
        tot = self.counts.sum(axis=1, keepdims=True)
        return self.counts / np.maximum(tot, 1)


def hot_expert_masks(freqs: np.ndarray, num_hot: int,
                     strategy: str = "frequency",
                     seed: int = 0) -> np.ndarray:
    """Per-layer bool mask [L, E] of the ``num_hot`` experts to keep
    (True = hot)."""
    n_layers, e = freqs.shape
    masks = np.zeros((n_layers, e), bool)
    if strategy == "frequency":
        for li in range(n_layers):
            masks[li, np.argsort(-freqs[li])[:num_hot]] = True
    elif strategy == "uniform":
        step = max(e // max(num_hot, 1), 1)
        masks[:, (np.arange(num_hot) * step) % e] = True
    elif strategy == "front-loading":
        masks[:, :num_hot] = True
    elif strategy == "random":
        rng = np.random.default_rng(seed)
        for li in range(n_layers):
            masks[li, rng.choice(e, num_hot, replace=False)] = True
    else:
        raise ValueError(strategy)
    return masks


def balanced_logical_to_physical(freqs: np.ndarray,
                                 ep_size: int) -> np.ndarray:
    """int32 [E]: the storage slot of each logical expert, slot p on rank
    p // (E / ep), the heaviest experts spread over the ranks first."""
    e = len(freqs)
    per = e // ep_size
    load = np.zeros(ep_size)
    fill = [[] for _ in range(ep_size)]
    for logical in np.argsort(-np.asarray(freqs)):
        s = min((r for r in range(ep_size) if len(fill[r]) < per),
                key=lambda r: load[r])
        fill[s].append(logical)
        load[s] += freqs[logical]
    l2p = np.zeros(e, np.int32)
    for s in range(ep_size):
        for slot, logical in enumerate(fill[s]):
            l2p[logical] = s * per + slot
    return l2p


def _permute(node, perm: torch.Tensor):
    """Every tensor of a QTensor (or dict of tensors) taken at perm along
    its expert axis."""
    if isinstance(node, QTensor):
        return dataclasses.replace(node, **{
            f.name: _permute(getattr(node, f.name), perm)
            for f in dataclasses.fields(node)
            if isinstance(getattr(node, f.name), torch.Tensor)})
    if isinstance(node, dict):
        return {k: _permute(v, perm) for k, v in node.items()}
    if isinstance(node, torch.Tensor):
        return node[perm.to(node.device)].contiguous()
    return node


def reorder_expert_weights(weights: MoEWeights,
                           l2p: np.ndarray) -> MoEWeights:
    """weights stored in the order of the map ``l2p`` (length E, or the
    routed experts' count with fused shared experts after them), with the
    map attached; relative to the current storage when weights already
    carry a map."""
    e = weights.num_experts
    l2p = np.asarray(l2p, np.int64)
    if len(l2p) != e:
        if len(l2p) != e - weights.n_shared_fused:
            raise ValueError(f"a map of {len(l2p)} experts for {e} "
                             f"({weights.n_shared_fused} fused shared)")
        l2p = np.concatenate([l2p, np.arange(len(l2p), e)])
    if sorted(l2p.tolist()) != list(range(e)):
        raise ValueError("logical_to_physical must be a permutation")
    p2l = np.zeros(e, np.int64)
    p2l[l2p] = np.arange(e)
    if weights.logical_to_physical is not None:
        # slot p must hold logical p2l[p], which sits at prev_l2p[p2l[p]]
        prev = weights.logical_to_physical.cpu().numpy().astype(np.int64)
        perm = prev[p2l]
    else:
        perm = p2l
    perm = torch.from_numpy(perm)
    dev = weights.gate_up.data.device
    return dataclasses.replace(
        weights, gate_up=_permute(weights.gate_up, perm),
        down=_permute(weights.down, perm),
        lora=None if weights.lora is None else _permute(weights.lora, perm),
        logical_to_physical=torch.from_numpy(l2p.astype(np.int32)).to(dev))
