"""MLA attention in the absorbed (compressed-cache) form (counterpart of
ktransformers_tpu/ops/attention.py, MLA part).

Prefill attention is plain PyTorch (``mla_absorbed``), as it is plain XLA
in the JAX package. Decode goes through ``mla_decode_fused``, the hook
point of the fused decode kernel (ops/cuda/mla_decode.py).
"""

from __future__ import annotations

import torch

from ktransformers_tpu_torch.ops.cuda.mla_decode import (
    mla_decode_fused as _mla_decode_fused_kernel,
)

def mla_absorbed(q_nope_eff, q_pe, ckv, k_pe, *, scale: float, mask=None):
    """Attention in the compressed space; returns [B, H, Sq, R].

    q_nope_eff [B, H, Sq, R]; q_pe [B, H, Sq, Dr]; ckv [B, Skv, R];
    k_pe [B, Skv, Dr]; mask additive [B, Sq, Skv] or [Sq, Skv]."""
    qn = q_nope_eff.to(torch.float32)
    qp = q_pe.to(torch.float32)
    c = ckv.to(torch.float32)
    kp = k_pe.to(torch.float32)
    scores = (torch.einsum("bhqr,bsr->bhqs", qn, c)
              + torch.einsum("bhqd,bsd->bhqs", qp, kp)) * scale
    if mask is not None:
        if mask.dim() == 2:
            mask = mask[None]
        scores = scores + mask[:, None]
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqs,bsr->bhqr", probs, c).to(q_nope_eff.dtype)


def mla_decode_fused(qn_eff, qp_raw, ckv_kpe, gamma, rot, ckv, kpe, lengths,
                     scale: float, eps: float):
    """Fused decode attention for one new token; see
    ops/cuda/mla_decode.mla_decode_fused."""
    return _mla_decode_fused_kernel(
        qn_eff.contiguous(), qp_raw.contiguous(), ckv_kpe.contiguous(),
        gamma, rot.contiguous(), ckv, kpe, lengths, scale, eps,
    )
