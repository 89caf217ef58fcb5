"""Routed-expert MoE forward (counterpart of ktransformers_tpu/ops/moe.py).

Few tokens (decode, t <= DECODE_GATHER_MAX_TOKENS) take the gather path:
one row per (token, slot), which reads only the routed experts' bytes. More
tokens (prefill) sort the (token, expert) pairs by expert and run over the
sorted rows. On either path the route is chosen as the JAX package's Pallas
hooks choose it (ops/pallas/__init__.py):
- W4A8 weights (offset-lo int4, int4_g, int4_gz) whose expert fits the
  fused FFN kernels run gate_up -> GLU -> requant -> down in one call
  (gathered_w4a8_ffn / grouped_w4a8_ffn, the GLU in float32);
- W4A8 weights the fused kernels refuse (an expert block too wide for
  their byte budget, as Mixtral-8x7B's, or a swiglu_limit) run two
  matmuls on int8 dots (gathered_w4a8_matmul / grouped_w4a8_matmul), the
  JAX package's route from gathered_quant_matmul / grouped_quant_matmul
  for repacked int4 weights, with the GLU between them in x.dtype;
- every other kernel kind (int8, fp8, int4 kinds not repacked, mxfp4,
  mxfp8) runs two matmuls with the weight decoded in the kernel
  (gathered_quant_matmul / grouped_quant_matmul), the GLU likewise;
- the kinds no kernel takes in either package (PLAIN_KINDS: bf16 with
  bf16 or float32 data, int8_g, int8_gz) run the JAX package's plain XLA
  products in plain PyTorch, on any device: the gathered einsum over the
  routed experts' codes (its gathered_matmul) and, on the sorted rows,
  the dequantized weights in the compute dtype (the ragged_dot of its
  grouped_matmul). Both take each row's expert on the device, with no host
  sync, over chunks of rows that bound the gathered weights' memory.
Any other kind raises. Per-expert LoRA factors
(MoEWeights.lora, the SFT path) are added after each expert matmul, as the
JAX package adds them, and keep the routes off the fused FFN kernels. A
call whose input needs a gradient runs its kernels through the
ops/vjp.py rules. Experts kept in host memory take the MoEWeights' place
and compute the call themselves (their ``forward``): an
OffloadedMoEWeights (offload/experts.py) streams the routed experts to the
card and runs the gathered path's matmuls there, at every T, as in the JAX
package (its ops/moe.py:362-367); a HostExperts (offload/host_engine.py)
runs the C++ expert FFN on the host. Before any route, a
``logical_to_physical`` map sends each routed id to the slot that stores
its expert (utils/expert_placement.py re-places experts), and an
``expert_mask`` zeroes the combine weight of every expert it marks as not
computed here (the JAX package's ops/moe.py:95-110, 266-270, 307-311,
454-458): on the gather path a masked row reads expert 0, on the sorted
path it sorts past every group and its rows come back zero. Across ranks
parallel/ep.py splits the experts and calls moe_forward on each shard.
"""

from __future__ import annotations

import dataclasses

import torch

from ktransformers_tpu_torch.ops.activations import (
    ActivationConfig,
    glu_activate,
)
from ktransformers_tpu_torch.ops.cuda.quant_matmul import (
    KINDS,
    gathered_quant_matmul,
    grouped_quant_matmul,
)
from ktransformers_tpu_torch.ops.cuda.w4a8_ffn import (
    GATHERED_FFN_MAX_ROWS,
    ffn_fits,
    gathered_w4a8_ffn,
    grouped_ffn_fits,
    grouped_w4a8_ffn,
)
from ktransformers_tpu_torch.ops.cuda.w4a8_matmul import (
    gathered_w4a8_matmul,
    grouped_w4a8_matmul,
    sorted_row_experts,
)
from ktransformers_tpu_torch.ops.vjp import (
    GatheredQuantMatmulFn,
    GroupedQuantMatmulFn,
    GroupedW4A8FFNFn,
    is_w4a8,
    needs_grad,
)
from ktransformers_tpu_torch.quant.formats import QTensor, dequantize

DECODE_GATHER_MAX_TOKENS = 8
# expert kinds with no kernel in either package, run as plain products
PLAIN_KINDS = ("bf16", "int8_g", "int8_gz")
# float32 bytes of gathered expert weights a plain product holds at once
PLAIN_CHUNK_BYTES = 256 << 20


@dataclasses.dataclass
class MoEWeights:
    """gate_up: QTensor [E, hidden, 2 * inter] (gate = [..., :inter]);
    down: QTensor [E, inter, hidden]; lora: optional per-expert LoRA
    factors {"gate_up_a": [E, hidden, r], "gate_up_b": [E, r, 2 * inter],
    "down_a": [E, inter, r], "down_b": [E, r, hidden]} (alpha / r folded
    into the a factors); logical_to_physical: optional int [E] slot of
    each logical expert; expert_mask: optional bool [E], True where the
    expert is computed here; n_shared_fused: shared experts stacked at the
    END of the expert arrays (ops/fuse_shared.py), always selected."""

    gate_up: QTensor
    down: QTensor
    lora: dict | None = None
    logical_to_physical: torch.Tensor | None = None
    expert_mask: torch.Tensor | None = None
    n_shared_fused: int = 0

    @property
    def num_experts(self) -> int:
        return self.gate_up.data.shape[0]

    @property
    def hidden_size(self) -> int:
        return self.gate_up.in_features

    @property
    def intermediate_size(self) -> int:
        return self.gate_up.data.shape[2] // 2


def _check_kernel_kind(w: QTensor, what: str) -> None:
    if w.kind not in KINDS and w.kind not in PLAIN_KINDS:
        raise NotImplementedError(
            f"{what}: {w.kind} experts have neither a kernel nor a plain "
            "product")


def _plain_rows(x_rows: torch.Tensor, w: QTensor, row_expert: torch.Tensor,
                dequant: bool) -> torch.Tensor:
    """Row r of x_rows [R, K] through expert row_expert[r] of w [E, K, N]
    (an id outside [0, E): the output row is zero), in plain PyTorch:
    [R, N] in x_rows.dtype. ``dequant`` False is the JAX gathered einsum
    (float32 codes; per scale group x_g . q_g, less sum(x_g) * zero, times
    the scale, groups summed), True its grouped ragged_dot (the weight
    dequantized to x.dtype, the product in x.dtype). Rows go in chunks
    whose gathered weights stay within PLAIN_CHUNK_BYTES."""
    r, kdim = x_rows.shape
    e, n = w.data.shape[0], w.data.shape[-1]
    ok = (row_expert >= 0) & (row_expert < e)
    ids = torch.where(ok, row_expert, torch.zeros_like(row_expert)).long()
    step = max(1, PLAIN_CHUNK_BYTES // (kdim * n * 4))
    outs = []
    for lo in range(0, r, step):
        sel, xc = ids[lo : lo + step], x_rows[lo : lo + step]
        if dequant:
            pick = lambda t: None if t is None else t[sel]  # noqa: E731
            wd = dequantize(dataclasses.replace(  # [c, K, N]
                w, data=w.data[sel], scales=pick(w.scales),
                zeros=pick(w.zeros)), x_rows.dtype)
            outs.append(torch.bmm(xc[:, None, :], wd)[:, 0])
            continue
        q = w.data[sel].to(torch.float32)
        xf = xc.to(torch.float32)
        if w.kind == "bf16":
            outs.append(torch.bmm(xf[:, None, :], q)[:, 0].to(x_rows.dtype))
            continue
        g = w.group_size
        ng = kdim // g
        xg = xf.reshape(-1, ng, g)
        part = torch.einsum("cGg,cGgn->cGn", xg, q.reshape(-1, ng, g, n))
        if w.kind.endswith("_gz"):
            part = part - xg.sum(dim=-1)[..., None] * w.zeros[sel][:, :ng]
        outs.append((part * w.scales[sel][:, :ng]).sum(dim=1)
                    .to(x_rows.dtype))
    y = torch.cat(outs)
    return torch.where(ok[:, None], y, torch.zeros((), dtype=y.dtype,
                                                   device=y.device))


def gathered_matmul(x: torch.Tensor, w: QTensor,
                    ids: torch.Tensor) -> torch.Tensor:
    """Decode expert matmul that reads only the routed experts' bytes.

    x [T, K] (the same input to each of the k experts) or [T, k, K]
    (per-expert inputs); w [E, K, N]; ids [T, k]. Returns [T, k, N]."""
    _check_kernel_kind(w, "gathered_matmul")
    t, k = ids.shape
    kdim = x.shape[-1]
    if x.dim() == 2:
        x_rows = x[:, None, :].expand(t, k, kdim).reshape(t * k, kdim)
    else:
        x_rows = x.reshape(t * k, kdim)
    ids = ids.reshape(t * k)
    if w.kind in PLAIN_KINDS:
        return _plain_rows(x_rows, w, ids, dequant=False).reshape(t, k, -1)
    fn = gathered_w4a8_matmul if is_w4a8(w) else gathered_quant_matmul
    if needs_grad(x_rows):
        y = GatheredQuantMatmulFn.apply(x_rows, w, ids, fn)
    else:
        y = fn(x_rows.contiguous(), w, ids)
    return y.reshape(t, k, -1)


def grouped_matmul(x: torch.Tensor, w: QTensor,
                   group_sizes: torch.Tensor) -> torch.Tensor:
    """x [m, k] rows sorted by group; w [g, k, n]; returns [m, n]. Rows
    past sum(group_sizes) come back zero."""
    _check_kernel_kind(w, "grouped_matmul")
    if w.kind in PLAIN_KINDS:
        return _plain_rows(x, w, sorted_row_experts(group_sizes, x.shape[0]),
                           dequant=True)
    fn = grouped_w4a8_matmul if is_w4a8(w) else grouped_quant_matmul
    if needs_grad(x):
        return GroupedQuantMatmulFn.apply(x, w, group_sizes, fn)
    return fn(x.contiguous(), w, group_sizes)


def moe_dispatch(topk_idx: torch.Tensor, num_experts: int):
    """Sort (token, expert) pairs by expert: (sort_order [T*k],
    token_of_row [T*k], group_sizes [E] int32). An id of num_experts (a
    masked expert) sorts after every group and is in no group's count.
    The sizes are counted on the device, into E + 1 bins whose last (the
    masked id's) is dropped: torch.bincount's counts, without its host
    read of the ids' range, which a CUDA graph capture refuses."""
    k = topk_idx.shape[1]
    flat = topk_idx.reshape(-1).to(torch.int64)
    sort_order = torch.argsort(flat, stable=True)
    token_of_row = sort_order // k
    bins = torch.zeros(num_experts + 1, dtype=torch.int32,
                       device=flat.device)
    bins.scatter_add_(0, flat, torch.ones_like(flat, dtype=torch.int32))
    return sort_order, token_of_row, bins[:num_experts]


def placed_routes(weights, topk_idx: torch.Tensor,
                  topk_weights: torch.Tensor, masked_id: int | None = 0):
    """(ids, weights) after the expert map and mask of ``weights``: each
    logical id sent to its slot, and a masked expert's weight set to 0 and
    its id to ``masked_id`` (0 on the gather path, E on the sorted path;
    None keeps it, for the EP shards, which dispatch it and add zero)."""
    ids = topk_idx
    if weights.logical_to_physical is not None:
        ids = weights.logical_to_physical.to(topk_idx.device)[
            topk_idx.long()].to(topk_idx.dtype)
    if weights.expert_mask is not None:
        local = weights.expert_mask.to(ids.device)[ids.long()]
        topk_weights = torch.where(local, topk_weights,
                                   torch.zeros_like(topk_weights))
        if masked_id is not None:
            ids = torch.where(local, ids, torch.full_like(ids, masked_id))
    return ids, topk_weights


def _gather_lora_add(h, inp, lora: dict, name: str, ids):
    """h [t, k, N] + the routed experts' LoRA product of inp ([t, K] or
    [t, k, K]) in float32, on gathered per-row factors (the gather path's
    few rows)."""
    af = lora[f"{name}_a"][ids.to(torch.int64)].to(torch.float32)
    bf = lora[f"{name}_b"][ids.to(torch.int64)].to(torch.float32)
    eq = "ted,tedr->ter" if inp.dim() == 3 else "td,tedr->ter"
    la = torch.einsum(eq, inp.to(torch.float32), af)
    return h + torch.einsum("ter,tern->ten", la, bf).to(h.dtype)


def _segment_lora_add(h, inp, lora: dict, name: str, row_expert):
    """h [M, N] + each sorted row's expert LoRA product of inp [M, K], the
    JAX package's two ragged_dots (operands in inp.dtype, float32 sums;
    the first product rounded to inp.dtype). Done without a host sync: the
    rows' products with every expert's a factor [M, E*r], the other
    experts' columns zeroed, then one product with all b factors stacked
    [E*r, N]; the zeroed columns add exact zeros. row_expert [M]: each
    row's expert."""
    a, b = lora[f"{name}_a"], lora[f"{name}_b"]
    e, k, r = a.shape
    dt = inp.dtype
    la = inp @ a.to(dt).permute(1, 0, 2).reshape(k, e * r)
    col_expert = torch.arange(e, device=inp.device).repeat_interleave(r)
    la = torch.where(row_expert.to(torch.int64)[:, None] == col_expert,
                     la, torch.zeros((), dtype=dt, device=inp.device))
    return h + (la @ b.to(dt).reshape(e * r, -1)).to(h.dtype)


def _moe_forward_gather(x, weights: MoEWeights, topk_idx, topk_weights,
                        act: ActivationConfig) -> torch.Tensor:
    t, d = x.shape
    k = topk_idx.shape[1]
    gu, dn, lora = weights.gate_up, weights.down, weights.lora
    # the fused FFN has no backward rule (nor has it in the JAX package):
    # a call that needs a gradient takes the two matmuls
    if lora is None and not needs_grad(x) and t * k <= GATHERED_FFN_MAX_ROWS \
            and ffn_fits(gu, dn, act.kind, act.swiglu_limit, t * k):
        x_rows = x[:, None, :].expand(t, k, d).reshape(t * k, d).contiguous()
        y = gathered_w4a8_ffn(x_rows, gu, dn, topk_idx.reshape(-1),
                              act.kind).reshape(t, k, d)
    else:
        inter = weights.intermediate_size
        h = gathered_matmul(x, gu, topk_idx)  # [t, k, 2F]
        if lora is not None:
            h = _gather_lora_add(h, x, lora, "gate_up", topk_idx)
        a = glu_activate(h[..., :inter], h[..., inter:], act)
        y = gathered_matmul(a, dn, topk_idx)  # [t, k, d]
        if lora is not None:
            y = _gather_lora_add(y, a, lora, "down", topk_idx)
    return (y * topk_weights[:, :, None].to(y.dtype)).sum(dim=1).to(x.dtype)


def moe_forward(x: torch.Tensor, weights: MoEWeights, topk_idx: torch.Tensor,
                topk_weights: torch.Tensor,
                act: ActivationConfig = ActivationConfig()) -> torch.Tensor:
    """x [T, d]; topk_idx [T, k] int; topk_weights [T, k] float32."""
    if not isinstance(weights, MoEWeights):
        # experts in host memory (offload/): streamed to the card
        # (OffloadedMoEWeights) or computed on the host (HostExperts)
        return weights.forward(x, topk_idx, topk_weights, act)
    t, d = x.shape
    k = topk_idx.shape[1]
    if t <= DECODE_GATHER_MAX_TOKENS:
        topk_idx, topk_weights = placed_routes(weights, topk_idx,
                                               topk_weights)
        return _moe_forward_gather(x, weights, topk_idx, topk_weights, act)
    topk_idx, topk_weights = placed_routes(weights, topk_idx, topk_weights,
                                           weights.num_experts)
    gu, dn, lora = weights.gate_up, weights.down, weights.lora
    sort_order, token_of_row, group_sizes = moe_dispatch(
        topk_idx, weights.num_experts
    )
    xs = x[token_of_row].contiguous()
    if lora is None and grouped_ffn_fits(gu, dn, act.kind, act.swiglu_limit):
        if needs_grad(xs):
            y = GroupedW4A8FFNFn.apply(xs, gu, dn, group_sizes, act.kind)
        else:
            y = grouped_w4a8_ffn(xs, gu, dn, group_sizes, act.kind)
    else:
        inter = weights.intermediate_size
        row_expert = topk_idx.reshape(-1)[sort_order]
        h = grouped_matmul(xs, gu, group_sizes)
        if lora is not None:
            h = _segment_lora_add(h, xs, lora, "gate_up", row_expert)
        a = glu_activate(h[:, :inter], h[:, inter:], act)
        y = grouped_matmul(a, dn, group_sizes)
        if lora is not None:
            y = _segment_lora_add(y, a, lora, "down", row_expert)
    combine = topk_weights.reshape(-1)[sort_order]
    y = y * combine[:, None].to(y.dtype)
    inv = torch.empty_like(sort_order)
    inv[sort_order] = torch.arange(sort_order.shape[0], device=x.device)
    return y[inv].reshape(t, k, d).sum(dim=1).to(x.dtype)


def moe_forward_dense_reference(x: torch.Tensor, weights: MoEWeights,
                                topk_idx: torch.Tensor,
                                topk_weights: torch.Tensor,
                                act: ActivationConfig = ActivationConfig()
                                ) -> torch.Tensor:
    """Every expert for every token, on the dequantized float32 weights
    (the JAX package's moe_forward_dense_reference). For tests only."""
    topk_idx, topk_weights = placed_routes(weights, topk_idx, topk_weights)
    inter = weights.intermediate_size
    gu = dequantize(weights.gate_up, torch.float32)
    dn = dequantize(weights.down, torch.float32)
    h = torch.einsum("td,edf->tef", x.to(torch.float32), gu)
    a = glu_activate(h[..., :inter], h[..., inter:], act)
    y = torch.einsum("tef,efd->ted", a, dn)
    sel = torch.take_along_dim(y, topk_idx.long()[:, :, None], dim=1)
    return (sel * topk_weights[:, :, None]).sum(dim=1).to(x.dtype)
