"""Gated-MLP activations (counterpart of ktransformers_tpu/ops/activations.py)."""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F


@dataclasses.dataclass(frozen=True)
class ActivationConfig:
    kind: str = "silu"  # silu | gelu | relu | swigluoai
    swiglu_limit: float | None = None  # clamp on gate (and up)
    swiglu_alpha: float = 1.702  # swigluoai only


def glu_activate(gate: torch.Tensor, up: torch.Tensor,
                 cfg: ActivationConfig | None = None) -> torch.Tensor:
    """act(gate) * up, float32 inside, cast back to gate's dtype."""
    cfg = cfg or ActivationConfig()
    g = gate.to(torch.float32)
    u = up.to(torch.float32)
    if cfg.swiglu_limit is not None:
        g = torch.clamp(g, max=cfg.swiglu_limit)
        u = torch.clamp(u, -cfg.swiglu_limit, cfg.swiglu_limit)
    if cfg.kind == "silu":
        y = F.silu(g) * u
    elif cfg.kind == "gelu":
        y = F.gelu(g) * u
    elif cfg.kind == "relu":
        y = torch.clamp(g, min=0.0) * u
    elif cfg.kind == "swigluoai":
        y = g * torch.sigmoid(cfg.swiglu_alpha * g) * (u + 1.0)
    else:
        raise ValueError(f"unknown activation kind: {cfg.kind}")
    return y.to(gate.dtype)
