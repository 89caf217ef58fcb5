"""Routed-expert MoE forward (counterpart of ktransformers_tpu/ops/moe.py).

Few tokens (decode, t <= DECODE_GATHER_MAX_TOKENS) take the gather path:
one row per (token, slot), which reads only the routed experts' bytes. More
tokens (prefill) sort the (token, expert) pairs by expert and run over the
sorted rows. On either path the route is chosen as the JAX package's Pallas
hooks choose it (ops/pallas/__init__.py):
- W4A8 weights (offset-lo int4_g) whose expert fits the fused FFN kernels
  run gate_up -> GLU -> requant -> down in one call (gathered_w4a8_ffn /
  grouped_w4a8_ffn, the GLU in float32);
- W4A8 weights the fused kernels refuse (an expert block too wide for
  their byte budget, as Mixtral-8x7B's, or a swiglu_limit) run two
  matmuls on int8 dots (gathered_w4a8_matmul / grouped_w4a8_matmul), the
  JAX package's route from gathered_quant_matmul / grouped_quant_matmul
  for repacked int4 weights, with the GLU between them in x.dtype;
- every other kernel kind (int8, fp8, int4 kinds not repacked, mxfp4,
  mxfp8) runs two matmuls with the weight decoded in the kernel
  (gathered_quant_matmul / grouped_quant_matmul), the GLU likewise.
Expert kinds with no kernel raise. Per-expert LoRA factors
(MoEWeights.lora, the SFT path) are added after each expert matmul, as the
JAX package adds them, and keep the routes off the fused FFN kernels. A
call whose input needs a gradient runs its kernels through the
ops/vjp.py rules. Expert parallelism and host offload are not ported.
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
)
from ktransformers_tpu_torch.ops.vjp import (
    GatheredQuantMatmulFn,
    GroupedQuantMatmulFn,
    GroupedW4A8FFNFn,
    is_w4a8,
    needs_grad,
)
from ktransformers_tpu_torch.quant.formats import QTensor

DECODE_GATHER_MAX_TOKENS = 8


@dataclasses.dataclass
class MoEWeights:
    """gate_up: QTensor [E, hidden, 2 * inter] (gate = [..., :inter]);
    down: QTensor [E, inter, hidden]; lora: optional per-expert LoRA
    factors {"gate_up_a": [E, hidden, r], "gate_up_b": [E, r, 2 * inter],
    "down_a": [E, inter, r], "down_b": [E, r, hidden]} (alpha / r folded
    into the a factors)."""

    gate_up: QTensor
    down: QTensor
    lora: dict | None = None

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
    if w.kind not in KINDS:
        raise NotImplementedError(
            f"{what}: {w.kind} experts have no kernel (the plain expert "
            "products of the JAX package are not ported, ROADMAP Queue 1)")


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
    fn = grouped_w4a8_matmul if is_w4a8(w) else grouped_quant_matmul
    if needs_grad(x):
        return GroupedQuantMatmulFn.apply(x, w, group_sizes, fn)
    return fn(x.contiguous(), w, group_sizes)


def moe_dispatch(topk_idx: torch.Tensor, num_experts: int):
    """Sort (token, expert) pairs by expert: (sort_order [T*k],
    token_of_row [T*k], group_sizes [E] int32)."""
    k = topk_idx.shape[1]
    flat = topk_idx.reshape(-1).to(torch.int64)
    sort_order = torch.argsort(flat, stable=True)
    token_of_row = sort_order // k
    group_sizes = torch.bincount(flat, minlength=num_experts).to(torch.int32)
    return sort_order, token_of_row, group_sizes


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
    t, d = x.shape
    k = topk_idx.shape[1]
    if t <= DECODE_GATHER_MAX_TOKENS:
        return _moe_forward_gather(x, weights, topk_idx, topk_weights, act)
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
