"""Expert parallelism: the experts split over the ``ep`` ranks
(counterpart of ktransformers_tpu/parallel/ep.py).

Each rank holds E / ep experts, the contiguous slots [i * E/ep, (i + 1) *
E/ep) of rank i (parallel/shardings.py cuts them), and the full-length
logical_to_physical / expert_mask. Two ways to combine them, as in the JAX
package:
- ``moe_forward_ep`` ("psum"): every rank sees every token, remaps the
  routed ids to slots BEFORE it localises them (a remap applied to local
  ids would pick wrong experts), clips the ids off its shard and zeroes
  their weights, runs the port's moe_forward on its experts (its kernels)
  and the ranks' outputs are summed by an all-reduce over ep. Decode's
  way: weights stay put and the activations are on every rank anyway.
- ``moe_forward_ep_a2a``: each rank takes its T / ep tokens, sends each
  (token, slot) row to the rank that holds its expert (an all-to-all over
  a [ep, capacity, d] buffer, rows in the JAX version's stable sort by
  destination), runs the received rows through its experts, sends them
  back, combines its tokens, and an all-gather over ep gives every rank
  all T rows again. Drop-free by default (capacity T/ep * k per
  destination); ``capacity_factor`` bounds the buffer and drops the
  overflow (those rows add zero); ``pipeline_chunks`` splits the capacity
  axis into chunks, each dispatched, computed and returned in turn (the
  same rows and kernels, another schedule).
Both take x [T, d], topk_idx / topk_weights [T, k] the same on every rank
of the ep group and return [T, d] on each of them.

Both train (LoRA SFT under EP): their collectives record the gradient of
the JAX package's shard_map, which sums a replicated input's cotangent over
ep. Each rank's experts give only a part of the gradient of x and of
topk_weights, so those two enter the routed computation through
grad_all_reduce and their gradients are summed over ep there, and nowhere
else: the shared experts, the dense layers and the residual are computed
whole on every rank, and summing the whole gradient of the layer input
would multiply their part by ep. So every rank of the ep group holds the
same gradient of every replicated leaf (attention LoRA), which is not
summed over ep again.
"""

from __future__ import annotations

import dataclasses

import torch

from ktransformers_tpu_torch.ops.activations import ActivationConfig
from ktransformers_tpu_torch.ops.moe import (
    MoEWeights,
    moe_forward,
    placed_routes,
)
from ktransformers_tpu_torch.parallel.collectives import (
    all_gather,
    all_reduce,
    all_to_all,
    grad_all_reduce,
)
from ktransformers_tpu_torch.parallel.mesh import AXIS_EP, Mesh


def _shard_weights(weights: MoEWeights) -> MoEWeights:
    """This rank's experts without the map and mask, which apply to the
    global ids before the shard sees them."""
    return dataclasses.replace(weights, logical_to_physical=None,
                               expert_mask=None, n_shared_fused=0)


def moe_forward_ep(x: torch.Tensor, weights: MoEWeights,
                   topk_idx: torch.Tensor, topk_weights: torch.Tensor,
                   act: ActivationConfig, mesh: Mesh) -> torch.Tensor:
    """Expert-parallel routed forward, psum combine. ``weights`` holds this
    rank's E / ep experts."""
    ep = mesh.size(AXIS_EP)
    if ep == 1:
        return moe_forward(x, weights, topk_idx, topk_weights, act)
    e_local = weights.num_experts
    x = grad_all_reduce(x, mesh, AXIS_EP)
    topk_weights = grad_all_reduce(topk_weights, mesh, AXIS_EP)
    ids, tw = placed_routes(weights, topk_idx, topk_weights, None)
    ids_local = ids.long() - mesh.index(AXIS_EP) * e_local
    keep = (ids_local >= 0) & (ids_local < e_local)
    ids_safe = ids_local.clamp(0, e_local - 1).to(topk_idx.dtype)
    tw = torch.where(keep, tw, torch.zeros_like(tw))
    y = moe_forward(x, _shard_weights(weights), ids_safe, tw, act)
    return all_reduce(y, mesh, AXIS_EP)


def _a2a_capacity(t_local: int, k: int, ep: int,
                 capacity_factor: float | None, chunks: int) -> int:
    """Rows a rank may send each destination: t_local * k (drop-free), or
    max(8, ceil(t_local * k / ep) * factor); rounded up to whole chunks."""
    if capacity_factor is None:
        cap = t_local * k
    else:
        cap = max(8, int(-(-t_local * k // ep) * capacity_factor))
    return -(-cap // chunks) * chunks


def moe_forward_ep_a2a(x: torch.Tensor, weights: MoEWeights,
                       topk_idx: torch.Tensor, topk_weights: torch.Tensor,
                       act: ActivationConfig, mesh: Mesh,
                       capacity_factor: float | None = None,
                       pipeline_chunks: int = 1) -> torch.Tensor:
    """All-to-all expert parallelism (see the module docstring); T must
    divide by ep."""
    ep = mesh.size(AXIS_EP)
    if ep == 1:
        return moe_forward(x, weights, topk_idx, topk_weights, act)
    t, d = x.shape
    k = topk_idx.shape[1]
    if t % ep:
        raise ValueError(f"moe_forward_ep_a2a: T={t} does not divide by "
                         f"ep={ep}")
    e_local = weights.num_experts
    tl = t // ep
    cap = _a2a_capacity(tl, k, ep, capacity_factor, pipeline_chunks)
    me = mesh.index(AXIS_EP)
    rows = slice(me * tl, (me + 1) * tl)
    x = grad_all_reduce(x, mesh, AXIS_EP)
    topk_weights = grad_all_reduce(topk_weights, mesh, AXIS_EP)
    x_l = x[rows]
    ids, tw = placed_routes(weights, topk_idx[rows], topk_weights[rows],
                            None)
    w_local = _shard_weights(weights)
    dev = x.device

    flat = ids.reshape(-1).long()  # [tl*k] global slots
    dest = flat // e_local
    local_expert = flat % e_local
    order = torch.argsort(dest, stable=True)
    sorted_dest = dest[order]
    counts = torch.bincount(dest, minlength=ep)
    starts = torch.cumsum(counts, 0) - counts
    rank = torch.arange(tl * k, device=dev) - starts[sorted_dest]
    ok = rank < cap  # rows past the capacity drop
    tok = order // k
    send_x = torch.zeros((ep, cap, d), dtype=x.dtype, device=dev)
    send_x[sorted_dest[ok], rank[ok]] = x_l[tok[ok]]
    send_eid = torch.full((ep, cap), -1, dtype=torch.int32, device=dev)
    send_eid[sorted_dest[ok], rank[ok]] = local_expert[order][ok].to(
        torch.int32)

    cc = cap // pipeline_chunks
    back = []
    for ci in range(pipeline_chunks):
        sl = slice(ci * cc, (ci + 1) * cc)
        recv_x = all_to_all(send_x[:, sl], mesh, AXIS_EP)
        recv_eid = all_to_all(send_eid[:, sl], mesh, AXIS_EP)
        eids = recv_eid.reshape(ep * cc)
        valid = eids >= 0
        ids_safe = eids.clamp(0, e_local - 1)
        ones = valid.to(torch.float32)[:, None]
        y_rows = moe_forward(recv_x.reshape(ep * cc, d), w_local,
                             ids_safe[:, None], ones, act)
        back.append(all_to_all(y_rows.reshape(ep, cc, d), mesh, AXIS_EP))
    back = back[0] if pipeline_chunks == 1 else torch.cat(back, dim=1)

    rank_of_flat = torch.empty_like(rank)
    rank_of_flat[order] = rank
    kept = rank_of_flat < cap
    y_flat = back[dest, rank_of_flat.clamp(max=cap - 1)]
    w_flat = torch.where(kept, tw.reshape(-1), torch.zeros_like(
        tw.reshape(-1)))
    y_flat = torch.where(kept[:, None], y_flat, torch.zeros_like(y_flat))
    y_tok = (y_flat.reshape(tl, k, d)
             * w_flat.reshape(tl, k, 1).to(y_flat.dtype)).sum(dim=1)
    return all_gather(y_tok.to(x.dtype), mesh, AXIS_EP, dim=0)
