"""The decoder: embedding -> N layers (absorbed MLA attention + dense/MoE
MLP) -> norm -> lm_head, over a static-shape compressed KV cache
(counterpart of ktransformers_tpu/models/model.py, MLA families only).

Params are nested dicts of QTensors / tensors (utils/device_prep.py
prepares them). Unlike the JAX package, the KV cache is updated IN PLACE:
forward() writes the new tokens into the cache buffers and advances
cache.lengths, and returns the same cache object.
"""

from __future__ import annotations

import dataclasses

import torch

from ktransformers_tpu_torch.models.spec import ModelSpec
from ktransformers_tpu_torch.ops.activations import glu_activate
from ktransformers_tpu_torch.ops.attention import mla_absorbed, mla_decode_fused
from ktransformers_tpu_torch.ops.cuda.w4a8_ffn import (
    dense_mlp_fused,
    dense_w4a8_ffn,
)
from ktransformers_tpu_torch.ops.gate import route
from ktransformers_tpu_torch.ops.linear import linear, plinear
from ktransformers_tpu_torch.ops.moe import moe_forward
from ktransformers_tpu_torch.ops.norm import rms_norm
from ktransformers_tpu_torch.ops.rope import (
    apply_rope,
    precompute_rope_tables,
    rope_attention_scale,
    rope_rotation_matrix,
)

NEG_INF = -1e30


@dataclasses.dataclass
class KVCache:
    """Static-shape MLA cache, one buffer pair per layer:
    bufs_a[l] = ckv [B, S, R], bufs_b[l] = k_pe [B, S, Dr];
    lengths [B] int32 = tokens already cached per sequence."""

    lengths: torch.Tensor
    bufs_a: list
    bufs_b: list

    @staticmethod
    def create(spec: ModelSpec, batch: int, max_len: int,
               dtype=torch.bfloat16, device="cuda") -> "KVCache":
        a = spec.attention
        if a.kind != "mla":
            raise ValueError("KVCache: only MLA attention is ported")
        lengths = torch.zeros(batch, dtype=torch.int32, device=device)
        sa = (batch, max_len, a.kv_lora_rank)
        sb = (batch, max_len, a.qk_rope_head_dim)
        bufs_a = [torch.zeros(sa, dtype=dtype, device=device)
                  for _ in range(spec.num_layers)]
        bufs_b = [torch.zeros(sb, dtype=dtype, device=device)
                  for _ in range(spec.num_layers)]
        return KVCache(lengths, bufs_a, bufs_b)


def _attn_mask(pos_offset: torch.Tensor, q_len: int, kv_len: int):
    """Additive causal mask [B, q_len, kv_len] from per-sequence offsets."""
    dev = pos_offset.device
    qpos = pos_offset.to(torch.int64)[:, None, None] + torch.arange(
        q_len, device=dev)[None, :, None]
    kpos = torch.arange(kv_len, device=dev)[None, None, :]
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    neg = torch.full((), NEG_INF, dtype=torch.float32, device=dev)
    return torch.where(kpos <= qpos, zero, neg)


def _write_cache(buf: torch.Tensor, new: torch.Tensor, offset: torch.Tensor):
    """Write new [B, S, ...] into buf [B, Smax, ...] at per-sequence offsets
    [B], in place (device indices, no host sync); returns buf."""
    b, s = new.shape[:2]
    pos = offset.to(torch.int64)[:, None] + torch.arange(s, device=buf.device)
    rows = torch.arange(b, device=buf.device)[:, None]
    buf[rows, pos] = new.to(buf.dtype)
    return buf


def mla_qkv_proj(p, spec: ModelSpec, x):
    """q [B, S, H*(nope+dr)] and the raw kv_a output [B, S, R+Dr]; reads the
    fused "qkv_a" weight when device_prep merged q_proj and kv_a."""
    a = spec.attention
    qw = a.num_heads * (a.qk_nope_head_dim + a.qk_rope_head_dim)
    rw = a.kv_lora_rank + a.qk_rope_head_dim
    if "qkv_a" in p:
        both = plinear(p, "qkv_a", x, p.get("qkv_a_bias"))
        return both[..., :qw], both[..., qw : qw + rw]
    return plinear(p, "q_proj", x), plinear(p, "kv_a", x, p.get("kv_a_bias"))


def _mla_attention(p, spec: ModelSpec, x, layer_cache, pos_offset, rope_cs,
                   rope_rot=None):
    a = spec.attention
    b, s, _ = x.shape
    h = a.num_heads
    nope, dr, r = a.qk_nope_head_dim, a.qk_rope_head_dim, a.kv_lora_rank
    scale = a.softmax_scale or (
        (nope + dr) ** -0.5 * rope_attention_scale(spec.rope)
    )
    q, ckv_kpe = mla_qkv_proj(p, spec, x)

    if s == 1 and rope_rot is not None:
        # fused decode: kv norm + both ropes + attention over the cache and
        # the current token in one kernel; the cache write follows
        qh = q.reshape(b, h, nope + dr)
        qn_eff = torch.einsum(
            "bhn,hnr->bhr", qh[..., :nope].to(torch.float32),
            p["w_uk"].to(torch.float32),
        ).to(x.dtype)
        ctx, ckv_new, kpe_new = mla_decode_fused(
            qn_eff, qh[..., nope:], ckv_kpe, p["kv_a_norm"], rope_rot,
            layer_cache[0], layer_cache[1], pos_offset, scale,
            spec.rms_norm_eps,
        )
        ckv_buf = _write_cache(layer_cache[0], ckv_new, pos_offset)
        kpe_buf = _write_cache(layer_cache[1], kpe_new, pos_offset)
        out = torch.einsum(
            "bhr,hrv->bhv", ctx.to(torch.float32), p["w_uv"].to(torch.float32)
        ).to(x.dtype).reshape(b, 1, h * a.v_head_dim)
        return plinear(p, "o_proj", out, p.get("o_bias")), (ckv_buf, kpe_buf)

    q = q.reshape(b, s, h, nope + dr)
    q_nope, q_pe = q[..., :nope], q[..., nope:]
    ckv = rms_norm(ckv_kpe[..., :r], p["kv_a_norm"], spec.rms_norm_eps)
    k_pe = ckv_kpe[..., r:]
    cos, sin = rope_cs  # [B, S, dr/2]
    q_pe = apply_rope(q_pe.transpose(1, 2), cos[:, None], sin[:, None],
                      interleaved=spec.rope.interleaved)
    k_pe = apply_rope(k_pe, cos, sin, interleaved=spec.rope.interleaved)
    q_nope_eff = torch.einsum(
        "bshn,hnr->bhsr", q_nope.to(torch.float32), p["w_uk"].to(torch.float32)
    ).to(x.dtype)
    ckv_buf = _write_cache(layer_cache[0], ckv, pos_offset)
    kpe_buf = _write_cache(layer_cache[1], k_pe, pos_offset)
    mask = _attn_mask(pos_offset, s, ckv_buf.shape[1])
    attn = mla_absorbed(q_nope_eff, q_pe, ckv_buf, kpe_buf, scale=scale,
                        mask=mask)
    out = torch.einsum(
        "bhsr,hrv->bshv", attn.to(torch.float32), p["w_uv"].to(torch.float32)
    ).to(x.dtype).reshape(b, s, h * a.v_head_dim)
    return plinear(p, "o_proj", out, p.get("o_bias")), (ckv_buf, kpe_buf)


def _dense_mlp(p, spec: ModelSpec, x):
    """Dense GLU MLP (shared experts, dense layers), routed as the JAX
    package routes it (w4a8_ffn.dense_mlp_fused): the fused dense FFN
    kernel where the reference fuses (DeepSeek-V2-Lite's shared experts),
    else two dense W4A8 matmuls with the GLU in the compute dtype
    (DeepSeek-V2-Lite's layer-0 MLP, I = 10944 with down group 96)."""
    gu, dn = p["gate_up"], p["down"]
    act = spec.activation
    rows = x.reshape(-1, x.shape[-1])
    if dense_mlp_fused(gu, dn, act.kind, act.swiglu_limit, rows.shape[0]):
        y = dense_w4a8_ffn(rows.contiguous(), gu, dn, act.kind)
        return y.reshape(*x.shape[:-1], -1)
    hcat = plinear(p, "gate_up", x)
    f = hcat.shape[-1] // 2
    return plinear(p, "down", glu_activate(hcat[..., :f], hcat[..., f:],
                                           spec.activation))


def _moe_mlp(p, spec: ModelSpec, x):
    b, s, d = x.shape
    flat = x.reshape(b * s, d)
    logits = flat.to(torch.float32) @ p["router_w"].to(torch.float32).T
    topk_idx, topk_w = route(logits, spec.moe.gate, p.get("router_bias_corr"))
    y = moe_forward(flat, p["experts"], topk_idx, topk_w, spec.activation)
    if p.get("shared") is not None:
        y = y + _dense_mlp(p["shared"], spec, flat)
    return y.reshape(b, s, d)


def decoder_layer(lp, spec: ModelSpec, x, layer_cache, lengths, rope_cs,
                  rope_rot=None):
    """One decoder layer; returns (x, buf_a, buf_b)."""
    res = x
    xn = rms_norm(x, lp["input_norm"], spec.rms_norm_eps)
    attn_out, (buf_a, buf_b) = _mla_attention(
        lp["attn"], spec, xn, layer_cache, lengths, rope_cs, rope_rot
    )
    x = res + attn_out
    res = x
    xn = rms_norm(x, lp["post_attn_norm"], spec.rms_norm_eps)
    if "moe" in lp:
        x = res + _moe_mlp(lp["moe"], spec, xn)
    else:
        x = res + _dense_mlp(lp["mlp"], spec, xn)
    return x, buf_a, buf_b


@torch.no_grad()
def forward(params, spec: ModelSpec, tokens: torch.Tensor, cache: KVCache,
            rope_tables=None, compute_dtype=torch.bfloat16,
            logits_last_only: bool = False):
    """One pass over S new tokens per sequence (positions cache.lengths +
    arange(S)). Returns (logits [B, S, V] or [B, 1, V] with
    logits_last_only, cache); the cache is updated in place."""
    b, s = tokens.shape
    x = params["embed"][tokens].to(compute_dtype)
    if rope_tables is None:
        rope_tables = precompute_rope_tables(spec.rope, tokens.device)
    cos_t, sin_t = rope_tables
    pos = cache.lengths.to(torch.int64)[:, None] + torch.arange(
        s, device=tokens.device)[None, :]
    rope_cs = (cos_t[pos], sin_t[pos])
    rope_rot = None
    if s == 1:
        # one rotation matrix per step, shared by every layer's fused
        # decode attention
        rope_rot = rope_rotation_matrix(
            rope_cs[0][:, 0], rope_cs[1][:, 0], spec.rope.interleaved
        )
    for li, lp in enumerate(params["layers"]):
        x, buf_a, buf_b = decoder_layer(
            lp, spec, x, (cache.bufs_a[li], cache.bufs_b[li]), cache.lengths,
            rope_cs, rope_rot,
        )
        cache.bufs_a[li], cache.bufs_b[li] = buf_a, buf_b
    x = rms_norm(x, params["final_norm"], spec.rms_norm_eps)
    if logits_last_only:
        x = x[:, -1:, :]
    lm_head = params.get("lm_head")
    if lm_head is None:
        logits = x @ params["embed"].to(x.dtype).T
    else:
        logits = linear(x, lm_head)
    cache.lengths += s
    return logits, cache
