"""RMS norm and layer norm (counterpart of ktransformers_tpu/ops/norm.py):
float32 math, cast back to the input dtype."""

from __future__ import annotations

import torch


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6):
    """y = x / sqrt(mean(x^2) + eps) * weight over the last axis."""
    xf = x.to(torch.float32)
    var = (xf * xf).mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * weight.to(torch.float32)).to(x.dtype)


def layer_norm(x: torch.Tensor, weight: torch.Tensor,
               bias: torch.Tensor | None = None, eps: float = 1e-5):
    """y = (x - mean) / sqrt(var + eps) * weight (+ bias) over the last
    axis, the biased variance."""
    xf = x.to(torch.float32)
    mean = xf.mean(dim=-1, keepdim=True)
    var = ((xf - mean) ** 2).mean(dim=-1, keepdim=True)
    y = (xf - mean) / torch.sqrt(var + eps) * weight.to(torch.float32)
    if bias is not None:
        y = y + bias.to(torch.float32)
    return y.to(x.dtype)
