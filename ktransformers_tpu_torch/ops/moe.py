"""Routed-expert MoE forward (counterpart of ktransformers_tpu/ops/moe.py).

Few tokens (decode, t <= DECODE_GATHER_MAX_TOKENS) take the gather path:
one FFN row per (token, slot) through gathered_w4a8_ffn, which reads only
the routed experts' bytes. More tokens (prefill) sort the (token, expert)
pairs by expert and run grouped_w4a8_ffn over the sorted rows. LoRA,
expert parallelism and host offload are not ported.
"""

from __future__ import annotations

import dataclasses

import torch

from ktransformers_tpu_torch.ops.activations import ActivationConfig
from ktransformers_tpu_torch.ops.cuda.w4a8_ffn import (
    gathered_w4a8_ffn,
    grouped_w4a8_ffn,
)
from ktransformers_tpu_torch.quant.formats import QTensor

DECODE_GATHER_MAX_TOKENS = 8


@dataclasses.dataclass
class MoEWeights:
    """gate_up: QTensor [E, hidden, 2 * inter] (gate = [..., :inter]);
    down: QTensor [E, inter, hidden]."""

    gate_up: QTensor
    down: QTensor

    @property
    def num_experts(self) -> int:
        return self.gate_up.data.shape[0]


def _fused_act(cfg: ActivationConfig) -> str:
    if cfg.swiglu_limit is not None or cfg.kind not in ("silu", "relu", "gelu"):
        raise NotImplementedError(f"activation {cfg} is not ported")
    return cfg.kind


def moe_dispatch(topk_idx: torch.Tensor, num_experts: int):
    """Sort (token, expert) pairs by expert: (sort_order [T*k],
    token_of_row [T*k], group_sizes [E] int32)."""
    k = topk_idx.shape[1]
    flat = topk_idx.reshape(-1).to(torch.int64)
    sort_order = torch.argsort(flat, stable=True)
    token_of_row = sort_order // k
    group_sizes = torch.bincount(flat, minlength=num_experts).to(torch.int32)
    return sort_order, token_of_row, group_sizes


def moe_forward(x: torch.Tensor, weights: MoEWeights, topk_idx: torch.Tensor,
                topk_weights: torch.Tensor,
                act: ActivationConfig = ActivationConfig()) -> torch.Tensor:
    """x [T, d]; topk_idx [T, k] int; topk_weights [T, k] float32."""
    t, d = x.shape
    k = topk_idx.shape[1]
    kind = _fused_act(act)
    if t <= DECODE_GATHER_MAX_TOKENS:
        x_rows = x[:, None, :].expand(t, k, d).reshape(t * k, d).contiguous()
        y = gathered_w4a8_ffn(x_rows, weights.gate_up, weights.down,
                              topk_idx.reshape(-1), kind).reshape(t, k, d)
        return (y * topk_weights[:, :, None].to(y.dtype)).sum(dim=1).to(x.dtype)
    sort_order, token_of_row, group_sizes = moe_dispatch(
        topk_idx, weights.num_experts
    )
    xs = x[token_of_row].contiguous()
    y = grouped_w4a8_ffn(xs, weights.gate_up, weights.down, group_sizes, kind)
    combine = topk_weights.reshape(-1)[sort_order]
    y = y * combine[:, None].to(y.dtype)
    inv = torch.empty_like(sort_order)
    inv[sort_order] = torch.arange(sort_order.shape[0], device=x.device)
    return y[inv].reshape(t, k, d).sum(dim=1).to(x.dtype)
