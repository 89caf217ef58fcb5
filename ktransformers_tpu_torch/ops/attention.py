"""Attention over a contiguous cache (counterpart of
ktransformers_tpu/ops/attention.py): GQA (``mha``) and MLA in the absorbed
(compressed-cache) form.

``mha`` and the MLA prefill attention (``mla_absorbed``) are plain PyTorch,
as they are plain XLA in the JAX package; so is every single-user GQA step.
Both build the float32 score tensor [B, H, Sq, Skv]. From
BLOCKWISE_KV_THRESHOLD = 8192 cache positions on, models/model.py takes
their online-softmax forms instead (``mla_absorbed_blockwise``,
``mha_blockwise``, plain PyTorch as the JAX package's are plain XLA), which
walk the cache in blocks of 2048 keys and hold O(block) scores. MLA decode goes through ``mla_decode_fused`` (norm, both ropes and the
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

NEG_INF = -1e30


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


BLOCKWISE_KV_THRESHOLD = 8192  # cache positions from which models/model.py
# takes the blockwise forms; read at each call, so tests can lower it


def _online_softmax_block(state, scores, values, pv: str):
    """One KV block of the online softmax (the body of the JAX package's
    scan): state (m, l, acc) float32, scores [..., S_blk] already masked to
    NEG_INF, values contracted by the einsum ``pv``; returns the new
    state."""
    m, l, acc = state
    m_new = torch.maximum(m, scores.amax(dim=-1))
    p = torch.exp(scores - m_new[..., None])
    corr = torch.exp(m - m_new)
    l_new = l * corr + p.sum(dim=-1)
    acc_new = acc * corr[..., None] + torch.einsum(pv, p, values)
    return m_new, l_new, acc_new


def mla_absorbed_blockwise(q_nope_eff, q_pe, ckv, k_pe, q_positions, *,
                           scale: float, block_size: int = 2048):
    """Online-softmax MLA attention over KV blocks of ``block_size``
    (ktransformers_tpu/ops/attention.py:mla_absorbed_blockwise, term by
    term): shapes as mla_absorbed, causal by the absolute positions
    q_positions [B, Sq] (key s is seen by a query at position p where s <=
    p). The running max, sum and accumulator are float32; the result is acc
    / max(l, 1e-30) in q_nope_eff.dtype. The JAX package pads the cache to
    whole blocks; here the last block is cut at Skv instead (a padded key
    lies past every query's position, so causality masks it: the same
    result without a padded copy of the cache). Scores are O(block):
    [B, H, Sq, block_size]."""
    b, h, sq, r = q_nope_eff.shape
    qn = q_nope_eff.to(torch.float32)
    qp = q_pe.to(torch.float32)
    qpos = q_positions.to(torch.int64)[:, None, :, None]  # [B, 1, Sq, 1]
    dev = q_nope_eff.device
    state = (torch.full((b, h, sq), NEG_INF, dtype=torch.float32, device=dev),
             torch.zeros((b, h, sq), dtype=torch.float32, device=dev),
             torch.zeros((b, h, sq, r), dtype=torch.float32, device=dev))
    for start in range(0, ckv.shape[1], block_size):
        cf = ckv[:, start : start + block_size].to(torch.float32)
        pf = k_pe[:, start : start + block_size].to(torch.float32)
        scores = (torch.einsum("bhqr,bsr->bhqs", qn, cf)
                  + torch.einsum("bhqd,bsd->bhqs", qp, pf)) * scale
        kpos = start + torch.arange(cf.shape[1], device=dev)
        scores = torch.where(kpos <= qpos, scores, NEG_INF)
        state = _online_softmax_block(state, scores, cf, "bhqs,bsr->bhqr")
    _, l, acc = state
    return (acc / torch.clamp(l[..., None], min=1e-30)).to(q_nope_eff.dtype)


def mha_blockwise(q, k, v, q_positions, *, scale: float,
                  block_size: int = 2048):
    """Online-softmax GQA attention over KV blocks of ``block_size``
    (ktransformers_tpu/ops/attention.py:mha_blockwise, term by term):
    shapes as mha, causal by the absolute positions q_positions [B, Sq];
    float32 state, acc / max(l, 1e-30) in q.dtype; the last block cut at
    Skv (see mla_absorbed_blockwise)."""
    b, h, sq, d = q.shape
    hkv = k.shape[1]
    if h % hkv:
        raise ValueError(f"mha_blockwise: {h} query heads over {hkv} KV "
                         "heads")
    g, dv = h // hkv, v.shape[-1]
    qg = q.reshape(b, hkv, g, sq, d).to(torch.float32)
    qpos = q_positions.to(torch.int64)[:, None, None, :, None]
    dev = q.device
    state = (torch.full((b, hkv, g, sq), NEG_INF, dtype=torch.float32,
                        device=dev),
             torch.zeros((b, hkv, g, sq), dtype=torch.float32, device=dev),
             torch.zeros((b, hkv, g, sq, dv), dtype=torch.float32,
                         device=dev))
    for start in range(0, k.shape[2], block_size):
        kf = k[:, :, start : start + block_size].to(torch.float32)
        vf = v[:, :, start : start + block_size].to(torch.float32)
        scores = torch.einsum("bkgqd,bksd->bkgqs", qg, kf) * scale
        kpos = start + torch.arange(kf.shape[2], device=dev)
        scores = torch.where(kpos <= qpos, scores, NEG_INF)
        state = _online_softmax_block(state, scores, vf,
                                      "bkgqs,bksd->bkgqd")
    _, l, acc = state
    out = acc / torch.clamp(l[..., None], min=1e-30)
    return out.reshape(b, h, sq, dv).to(q.dtype)


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
