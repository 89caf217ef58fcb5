"""MoE routing (counterpart of ktransformers_tpu/ops/gate.py): softmax or
sigmoid scoring, greedy or group-limited top-k, optional correction bias.
All scoring is float32."""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class GateConfig:
    num_experts: int
    top_k: int
    scoring: str = "softmax"  # "softmax" | "sigmoid"
    group_method: str = "none"  # none | group_max | group_top2sum
    n_group: int = 1
    topk_group: int = 1
    norm_topk_prob: bool = False
    routed_scaling_factor: float = 1.0
    has_correction_bias: bool = False


def _group_limited_mask(scores: torch.Tensor, cfg: GateConfig):
    """Zero scores outside the top ``topk_group`` expert groups per token."""
    t = scores.shape[0]
    grouped = scores.reshape(t, cfg.n_group, -1)
    if cfg.group_method == "group_max":
        group_scores = grouped.amax(dim=-1)
    elif cfg.group_method == "group_top2sum":
        group_scores = torch.topk(grouped, 2, dim=-1).values.sum(dim=-1)
    else:
        raise ValueError(cfg.group_method)
    group_idx = torch.topk(group_scores, cfg.topk_group, dim=-1).indices
    group_mask = torch.zeros_like(group_scores).scatter_(1, group_idx, 1.0)
    score_mask = group_mask.repeat_interleave(
        cfg.num_experts // cfg.n_group, dim=-1
    )
    return torch.where(score_mask > 0, scores, torch.zeros_like(scores))


def route(logits: torch.Tensor, cfg: GateConfig,
          correction_bias: torch.Tensor | None = None):
    """Top-k experts per token: (topk_idx int32 [T, k], weights f32 [T, k])."""
    logits = logits.to(torch.float32)
    if cfg.scoring == "softmax":
        scores = torch.softmax(logits, dim=-1)
    elif cfg.scoring == "sigmoid":
        scores = torch.sigmoid(logits)
    else:
        raise ValueError(cfg.scoring)
    choice = scores
    if cfg.scoring == "sigmoid" and not cfg.has_correction_bias:
        choice = logits  # sigmoid saturates into ties; logits keep order
    if cfg.has_correction_bias:
        if correction_bias is None:
            raise ValueError("gate requires e_score_correction_bias")
        choice = scores + correction_bias.to(torch.float32)[None, :]
    if cfg.group_method != "none":
        choice = _group_limited_mask(choice, cfg)
    topk_idx = torch.topk(choice, cfg.top_k, dim=-1).indices
    topk_w = torch.gather(scores, 1, topk_idx)
    if cfg.norm_topk_prob:
        topk_w = topk_w / (topk_w.sum(dim=-1, keepdim=True) + 1e-20)
    topk_w = topk_w * cfg.routed_scaling_factor
    return topk_idx.to(torch.int32), topk_w
