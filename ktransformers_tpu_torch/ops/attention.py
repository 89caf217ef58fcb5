"""Attention over a contiguous cache (counterpart of
ktransformers_tpu/ops/attention.py): GQA (``mha``) and MLA in the absorbed
(compressed-cache) form.

``mha`` and the MLA prefill attention (``mla_absorbed``) are plain PyTorch,
as they are plain XLA in the JAX package; so is every single-user GQA step.
The blockwise variants the JAX package takes past BLOCKWISE_KV_THRESHOLD =
8192 cached positions are not ported: the plain versions run at any length.
MLA decode goes through ``mla_decode_fused`` (norm, both ropes and the
attention in one kernel) while ``MLA_FUSED`` is on, else through
``mla_decode`` after the caller has normed, roped and written the cache row
(both kernels in ops/cuda/mla_decode.py).
"""

from __future__ import annotations

import os

import torch

from ktransformers_tpu_torch.ops.cuda.mla_decode import (
    mla_decode_attention as _mla_decode_attention_kernel,
    mla_decode_fused as _mla_decode_fused_kernel,
)

# The JAX package's switch (ops/pallas/__init__.py reads KT_MLA_FUSED where
# it installs the fused hook): "0" sends single-token decode through
# mla_decode. Read once here; tests set the attribute.
MLA_FUSED = os.environ.get("KT_MLA_FUSED", "1") != "0"


def mha(q, k, v, *, scale: float, mask=None):
    """Dense attention with the GQA head-group broadcast: query head h reads
    KV head h // (H / Hkv). q [B, H, Sq, D]; k [B, Hkv, Skv, D]; v [B, Hkv,
    Skv, Dv]; mask additive, broadcastable to [B, H, Sq, Skv] ([Sq, Skv] or
    [B, Sq, Skv]). Returns [B, H, Sq, Dv] in q.dtype; float32 inside."""
    b, h, sq, d = q.shape
    hkv = k.shape[1]
    if h % hkv:
        raise ValueError(f"mha: {h} query heads over {hkv} KV heads")
    qg = q.reshape(b, hkv, h // hkv, sq, d).to(torch.float32)
    scores = torch.einsum("bkgqd,bksd->bkgqs", qg,
                          k.to(torch.float32)) * scale
    if mask is not None:
        if mask.dim() == 2:
            mask = mask[None]
        scores = scores + mask[:, None, None]
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgqs,bksd->bkgqd", probs, v.to(torch.float32))
    return out.reshape(b, h, sq, v.shape[-1]).to(q.dtype)


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


def mla_decode(q_nope_eff, q_pe, ckv, kpe, lengths, *, scale: float):
    """Single-token MLA attention over a cache that already holds the
    current token: q_nope_eff [B, H, 1, R], q_pe [B, H, 1, dr] (roped),
    lengths [B] including the current token; returns [B, H, 1, R]."""
    return _mla_decode_attention_kernel(
        q_nope_eff[:, :, 0].contiguous(), q_pe[:, :, 0].contiguous(), ckv,
        kpe, lengths.to(torch.int32), scale,
    )[:, :, None]


def absorb_kv_b_proj(kv_b_proj: torch.Tensor, num_heads: int,
                     qk_nope_head_dim: int, v_head_dim: int):
    """Split a dense kv_b_proj [R, H * (nope + v)] into the absorbed
    matrices (w_uk [H, nope, R], w_uv [H, R, v]), as the JAX package's
    absorb_kv_b_proj does."""
    r = kv_b_proj.shape[0]
    w = kv_b_proj.reshape(r, num_heads, qk_nope_head_dim + v_head_dim)
    w_uk = w[:, :, :qk_nope_head_dim].permute(1, 2, 0).contiguous()
    w_uv = w[:, :, qk_nope_head_dim:].permute(1, 0, 2).contiguous()
    return w_uk, w_uv
