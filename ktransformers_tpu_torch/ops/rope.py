"""Rotary position embeddings (counterpart of ktransformers_tpu/ops/rope.py):
standard and DeepSeek-interleaved rope, YaRN tables, and the exact [dr, dr]
rotation matrix the fused decode-attention kernel applies."""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class RopeConfig:
    dim: int  # rotary dim (qk_rope_head_dim for MLA)
    base: float = 10000.0
    max_position: int = 4096
    scaling_type: str | None = None  # None | "yarn" | "linear"
    scaling_factor: float = 1.0
    original_max_position: int = 4096
    beta_fast: float = 32.0
    beta_slow: float = 1.0
    mscale: float = 1.0
    mscale_all_dim: float = 0.0
    interleaved: bool = False  # deepseek complex-pair layout


def _yarn_find_correction_dim(num_rotations, dim, base, max_pos):
    return (dim * math.log(max_pos / (num_rotations * 2 * math.pi))) / (
        2 * math.log(base)
    )


def _yarn_find_correction_range(low_rot, high_rot, dim, base, max_pos):
    low = math.floor(_yarn_find_correction_dim(low_rot, dim, base, max_pos))
    high = math.ceil(_yarn_find_correction_dim(high_rot, dim, base, max_pos))
    return max(low, 0), min(high, dim - 1)


def _yarn_linear_ramp(lo, hi, dim):
    if lo == hi:
        hi += 0.001
    ramp = (np.arange(dim, dtype=np.float64) - lo) / (hi - lo)
    return np.clip(ramp, 0, 1)


def yarn_get_mscale(scale: float, mscale: float = 1.0) -> float:
    if scale <= 1:
        return 1.0
    return 0.1 * mscale * math.log(scale) + 1.0


def rope_attention_scale(cfg: RopeConfig) -> float:
    """Extra softmax scale induced by YaRN mscale."""
    if cfg.scaling_type != "yarn":
        return 1.0
    m = yarn_get_mscale(cfg.scaling_factor, cfg.mscale)
    m_all = yarn_get_mscale(cfg.scaling_factor, cfg.mscale_all_dim)
    return (m / m_all) ** 2 if cfg.mscale_all_dim else m * m


def precompute_rope_tables(cfg: RopeConfig, device="cuda"):
    """(cos, sin) float32 tables [max_position, dim // 2], computed in
    float64 on the host (YaRN included) and moved to ``device``."""
    half = cfg.dim // 2
    exponent = np.arange(0, cfg.dim, 2, dtype=np.float64)[:half] / cfg.dim
    inv_freq = 1.0 / (cfg.base**exponent)
    attn_factor = 1.0
    if cfg.scaling_type == "yarn" and cfg.scaling_factor > 1.0:
        inv_freq_inter = inv_freq / cfg.scaling_factor
        lo, hi = _yarn_find_correction_range(
            cfg.beta_fast, cfg.beta_slow, cfg.dim, cfg.base,
            cfg.original_max_position,
        )
        ramp = 1.0 - _yarn_linear_ramp(lo, hi, half)
        inv_freq = inv_freq_inter * (1.0 - ramp) + inv_freq * ramp
        attn_factor = yarn_get_mscale(cfg.scaling_factor, cfg.mscale)
        m_all = yarn_get_mscale(cfg.scaling_factor, cfg.mscale_all_dim)
        attn_factor = attn_factor / m_all if cfg.mscale_all_dim else attn_factor
    elif cfg.scaling_type == "linear":
        inv_freq = inv_freq / cfg.scaling_factor
    t = np.arange(cfg.max_position, dtype=np.float64)
    freqs = np.outer(t, inv_freq)
    cos = torch.from_numpy((np.cos(freqs) * attn_factor).astype(np.float32))
    sin = torch.from_numpy((np.sin(freqs) * attn_factor).astype(np.float32))
    return cos.to(device), sin.to(device)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor, *,
               interleaved: bool = False) -> torch.Tensor:
    """Rotate the last dim of x [..., seq, dim] by cos/sin [seq, dim/2]
    (broadcast over leading dims). interleaved pairs (x[2i], x[2i+1]);
    otherwise (x[i], x[i + dim/2])."""
    xf = x.to(torch.float32)
    while cos.dim() < xf.dim() - 1:
        cos = cos[None]
        sin = sin[None]
    half = xf.shape[-1] // 2
    if interleaved:
        x1 = xf[..., 0::2]
        x2 = xf[..., 1::2]
        r1 = x1 * cos - x2 * sin
        r2 = x1 * sin + x2 * cos
        out = torch.stack([r1, r2], dim=-1).reshape(xf.shape)
    else:
        x1 = xf[..., :half]
        x2 = xf[..., half:]
        out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def rope_rotation_matrix(cos: torch.Tensor, sin: torch.Tensor,
                         interleaved: bool) -> torch.Tensor:
    """Rope as a dense [..., dr, dr] float32 matrix: x_roped = x @ R.

    cos/sin: [..., dr/2]. Value-equal to apply_rope (the off-diagonal
    zeros add exactly in float32)."""
    d2 = cos.shape[-1]
    lead = cos.shape[:-1]
    c = cos.to(torch.float32)
    s = sin.to(torch.float32)
    eye = torch.eye(d2, dtype=torch.float32, device=cos.device)
    cd = c[..., None, :] * eye
    sd = s[..., None, :] * eye
    top = torch.cat([cd, sd], dim=-1)
    bot = torch.cat([-sd, cd], dim=-1)
    rot = torch.cat([top, bot], dim=-2)
    if interleaved:
        p = torch.cat([torch.arange(d2) * 2, torch.arange(d2) * 2 + 1])
        inv = torch.argsort(p).to(cos.device)
        rot = rot[..., inv, :][..., :, inv]
    return rot.reshape(*lead, 2 * d2, 2 * d2)
