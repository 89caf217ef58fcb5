"""RMS norm (counterpart of ktransformers_tpu/ops/norm.py): float32 math,
cast back to the input dtype."""

from __future__ import annotations

import torch


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6):
    """y = x / sqrt(mean(x^2) + eps) * weight over the last axis."""
    xf = x.to(torch.float32)
    var = (xf * xf).mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * weight.to(torch.float32)).to(x.dtype)
