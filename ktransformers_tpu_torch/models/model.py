"""The decoder: embedding -> N layers (attention + dense/MoE MLP) -> norm
-> lm_head, over a static-shape KV cache (counterpart of
ktransformers_tpu/models/model.py). Attention is absorbed MLA over a
compressed cache (deepseek_v2 / v3) or GQA over per-head k / v (mixtral,
qwen2_moe with projection biases, qwen3_moe with per-head q / k norms, the
dense llama / qwen2 / qwen3, glm4_moe with rope over half of each head,
smallthinker with NoPE and sliding-window layers and the early router,
qwen3_next's gated attention); qwen3_next's linear layers run GatedDeltaNet
(ops/linear_attention.py) over O(1) state per sequence. Past
BLOCKWISE_KV_THRESHOLD cache positions (ops/attention.py) the plain
attention of the contiguous cache runs blockwise, on layers without a
window.

Params are nested dicts of QTensors / tensors (utils/device_prep.py
prepares them). Unlike the JAX package, the KV cache is updated IN PLACE:
forward() writes the new tokens into the cache buffers and advances
cache.lengths, and returns the same cache object. Where the written values
need a gradient (LoRA SFT, sft/train.py) the write is out of place, so the
autograd graph never sees a buffer change under it.

forward() records gradients as the caller's grad mode says: the inference
entry points (engine/generate.py, models/paged.py, serving/engine.py) run
it under torch.no_grad(). ``remat`` rematerializes each decoder layer in
the backward (torch.utils.checkpoint), the JAX package's jax.checkpoint.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.utils.checkpoint

from ktransformers_tpu_torch.models.spec import ModelSpec
from ktransformers_tpu_torch.ops.activations import glu_activate
from ktransformers_tpu_torch.ops import attention
from ktransformers_tpu_torch.ops.attention import (
    mha,
    mha_blockwise,
    mla_absorbed,
    mla_absorbed_blockwise,
    mla_decode,
    mla_decode_fused,
)
from ktransformers_tpu_torch.ops.cuda.w4a8_ffn import (
    dense_mlp_fused,
    dense_w4a8_ffn,
)
from ktransformers_tpu_torch.ops.gate import route
from ktransformers_tpu_torch.ops.linear import linear, plinear
from ktransformers_tpu_torch.ops.linear_attention import gated_delta_net
from ktransformers_tpu_torch.ops.moe import moe_forward
from ktransformers_tpu_torch.ops.vjp import DenseW4A8FFNFn, needs_grad
from ktransformers_tpu_torch.ops.norm import rms_norm
from ktransformers_tpu_torch.ops.rope import (
    apply_rope,
    precompute_rope_tables,
    rope_attention_scale,
    rope_rotation_matrix,
)
from ktransformers_tpu_torch.parallel.collectives import (
    tp_all_gather,
    tp_all_reduce,
)
from ktransformers_tpu_torch.parallel.context import get_parallel_context
from ktransformers_tpu_torch.parallel.ep import (
    moe_forward_ep,
    moe_forward_ep_a2a,
)

NEG_INF = -1e30


@dataclasses.dataclass
class KVCache:
    """Static-shape cache, one buffer pair per layer: MLA bufs_a[l] = ckv
    [B, S, R], bufs_b[l] = k_pe [B, S, Dr]; GQA bufs_a[l] = k, bufs_b[l] =
    v [B, S, Hkv, D] (k roped); a GatedDeltaNet layer's bufs_a[l] = the
    conv tail [B, K, conv_dim], bufs_b[l] = the float32 recurrent state
    [B, Hv, dk, dv]; lengths [B] int32 = tokens already cached per
    sequence."""

    lengths: torch.Tensor
    bufs_a: list
    bufs_b: list

    @staticmethod
    def create(spec: ModelSpec, batch: int, max_len: int,
               dtype=torch.bfloat16, device="cuda") -> "KVCache":
        a = spec.attention
        lengths = torch.zeros(batch, dtype=torch.int32, device=device)
        if a.kind == "mla":
            sa = (batch, max_len, a.kv_lora_rank)
            sb = (batch, max_len, a.qk_rope_head_dim)
        else:
            sa = sb = (batch, max_len, a.num_kv_heads, a.head_dim)
        bufs_a, bufs_b = [], []
        for li in range(spec.num_layers):
            if spec.layer_kind(li) == "linear":
                la = spec.linear_attn
                bufs_a.append(torch.zeros(
                    (batch, la.conv_kernel, la.conv_dim), dtype=dtype,
                    device=device))
                bufs_b.append(torch.zeros(
                    (batch, la.num_v_heads, la.head_k_dim, la.head_v_dim),
                    dtype=torch.float32, device=device))
            else:
                bufs_a.append(torch.zeros(sa, dtype=dtype, device=device))
                bufs_b.append(torch.zeros(sb, dtype=dtype, device=device))
        return KVCache(lengths, bufs_a, bufs_b)


def _q_positions(pos_offset: torch.Tensor, q_len: int):
    """Absolute positions [B, q_len] of the new tokens."""
    return pos_offset.to(torch.int64)[:, None] + torch.arange(
        q_len, device=pos_offset.device)[None, :]


def _attn_mask(pos_offset: torch.Tensor, q_len: int, kv_len: int,
               window: int = 0):
    """Additive causal mask [B, q_len, kv_len] from per-sequence offsets;
    with window > 0 keys older than ``window`` positions are masked too
    (smallthinker's sliding-window layers)."""
    dev = pos_offset.device
    qpos = _q_positions(pos_offset, q_len)[:, :, None]
    kpos = torch.arange(kv_len, device=dev)[None, None, :]
    ok = kpos <= qpos
    if window:
        ok = ok & (kpos > qpos - window)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    neg = torch.full((), NEG_INF, dtype=torch.float32, device=dev)
    return torch.where(ok, zero, neg)


def _write_cache(buf: torch.Tensor, new: torch.Tensor, offset: torch.Tensor):
    """Write new [B, S, ...] into buf [B, Smax, ...] at per-sequence offsets
    [B] (device indices, no host sync); returns the written buffer: buf
    itself, or a new tensor where ``new`` needs a gradient."""
    b, s = new.shape[:2]
    pos = offset.to(torch.int64)[:, None] + torch.arange(s, device=buf.device)
    rows = torch.arange(b, device=buf.device)[:, None]
    if needs_grad(new):
        return buf.index_put((rows, pos), new.to(buf.dtype))
    buf[rows, pos] = new.to(buf.dtype)
    return buf


def _assert_no_orphan_lora(p, legacy_names, fused_key):
    """An adapter attached after the qkv fusion under an unfused key (e.g.
    'q_proj_lora') would never apply: plinear reads '<fused_key>_lora'
    only. Raise instead."""
    orphans = [n + "_lora" for n in legacy_names if (n + "_lora") in p]
    if orphans:
        raise ValueError(
            f"LoRA adapters {orphans} are attached under pre-fusion keys but "
            f"the layer uses the fused '{fused_key}' projection; attach the "
            f"adapter as '{fused_key}_lora' or attach it before "
            "utils/device_prep.prepare_params")


def mla_qkv_proj(p, spec: ModelSpec, x):
    """q [B, S, H*(nope+dr)] and the raw kv_a output [B, S, R+Dr]; reads the
    fused "qkv_a" weight when device_prep merged q_proj (or q_a) and kv_a.
    With q_lora_rank the query goes q_a -> RMSNorm (q_a_norm) -> q_b."""
    a = spec.attention
    rw = a.kv_lora_rank + a.qk_rope_head_dim
    if "qkv_a" in p:
        _assert_no_orphan_lora(p, ("q_a", "q_proj", "kv_a"), "qkv_a")
        qw = a.q_lora_rank or a.num_heads * (
            a.qk_nope_head_dim + a.qk_rope_head_dim)
        both = plinear(p, "qkv_a", x, p.get("qkv_a_bias"))
        q, ckv_kpe = both[..., :qw], both[..., qw : qw + rw]
    elif a.q_lora_rank:
        q = plinear(p, "q_a", x, p.get("q_a_bias"))
        ckv_kpe = plinear(p, "kv_a", x, p.get("kv_a_bias"))
    else:
        q = plinear(p, "q_proj", x)
        ckv_kpe = plinear(p, "kv_a", x, p.get("kv_a_bias"))
    if a.q_lora_rank:
        q = rms_norm(q, p["q_a_norm"], spec.rms_norm_eps)
        q = plinear(p, "q_b", q)
    return q, ckv_kpe


def o_proj(p, out):
    """The attention output projection (and its bias), summed over the
    tensor-parallel ranks, each of which holds its heads' rows."""
    return tp_all_reduce(plinear(p, "o_proj", out, p.get("o_bias")))


def lm_head_logits(params, x):
    """Logits of the final hidden states x: the lm_head (its columns
    gathered over the tensor-parallel ranks) or the tied embedding."""
    lm_head = params.get("lm_head")
    if lm_head is None:
        return x @ params["embed"].to(x.dtype).T
    return tp_all_gather(linear(x, lm_head))


def gqa_qkv_proj(p, spec: ModelSpec, x):
    """Flat q [B, S, H*D] (with gated output [B, S, H*2D], each head's [q |
    gate]), k and v [B, S, Hkv*D], with the projection biases where the
    layer has them; reads the fused "qkv" weight (and its concatenated
    "qkv_bias") when device_prep merged q_proj, k_proj and v_proj."""
    a = spec.attention
    qw = a.num_heads * a.head_dim * (2 if a.gated_output else 1)
    kw = a.num_kv_heads * a.head_dim
    if "qkv" in p:
        _assert_no_orphan_lora(p, ("q_proj", "k_proj", "v_proj"), "qkv")
        qkv = plinear(p, "qkv", x, p.get("qkv_bias"))
        return qkv[..., :qw], qkv[..., qw : qw + kw], qkv[..., qw + kw :]
    return (plinear(p, "q_proj", x, p.get("q_bias")),
            plinear(p, "k_proj", x, p.get("k_bias")),
            plinear(p, "v_proj", x, p.get("v_bias")))


def gqa_split_gate(spec: ModelSpec, q_flat):
    """q_flat [..., H*D] -> (q [..., H, D], None); with gated output
    q_flat [..., H*2D] holds each head's [q | gate]: (q [..., H, D], gate
    [..., H*D])."""
    a = spec.attention
    h, d = a.num_heads, a.head_dim
    lead = q_flat.shape[:-1]
    if not a.gated_output:
        return q_flat.reshape(*lead, h, d), None
    qg = q_flat.reshape(*lead, h, 2 * d)
    return qg[..., :d], qg[..., d:].reshape(*lead, h * d)


def gqa_gate(out, gate):
    """The attention output [..., H*D] times sigmoid(gate) (qwen3-next),
    or as it is without a gate."""
    if gate is None:
        return out
    return out * torch.sigmoid(gate.to(torch.float32)).to(out.dtype)


def gqa_rope(p, spec: ModelSpec, q, k, rope_cs, use_rope: bool = True):
    """q [B, S, H, D] and k [B, S, Hkv, D] -> roped q [B, H, S, D] and
    roped k [B, S, Hkv, D], each head RMS-normed first where the spec has
    qk_norm (p["q_norm"], p["k_norm"] [D]); rope over the leading
    rotary_dim of each head (all of it, or glm4's half), the rest passed
    through, none on a NoPE layer (``use_rope`` False: positions reach it
    only through the mask); rope_cs (cos, sin) [B, S, rotary_dim/2]. Every
    GQA path (the contiguous cache and both paged forwards) goes through
    here."""
    if spec.attention.qk_norm:
        q = rms_norm(q, p["q_norm"], spec.rms_norm_eps)
        k = rms_norm(k, p["k_norm"], spec.rms_norm_eps)
    if not use_rope:
        return q.transpose(1, 2), k
    cos, sin = rope_cs
    rot = spec.attention.rotary_dim

    def rope(t):  # [B, X, S, D]
        r = apply_rope(t[..., :rot], cos[:, None], sin[:, None],
                       interleaved=spec.rope.interleaved)
        return r if rot == t.shape[-1] else torch.cat([r, t[..., rot:]], -1)

    return rope(q.transpose(1, 2)), rope(k.transpose(1, 2)).transpose(1, 2)


def gqa_project_rope(p, spec: ModelSpec, x, rope_cs, use_rope: bool = True):
    """x [B, S, d] -> roped q [B, H, S, D], roped k and v [B, S, Hkv, D],
    and the output gate [B, S, H*D] (None without gated output)."""
    a = spec.attention
    b, s, _ = x.shape
    q_flat, k_flat, v_flat = gqa_qkv_proj(p, spec, x)
    q, gate = gqa_split_gate(spec, q_flat)
    q, k = gqa_rope(p, spec, q,
                    k_flat.reshape(b, s, a.num_kv_heads, a.head_dim),
                    rope_cs, use_rope)
    return q, k, v_flat.reshape(b, s, a.num_kv_heads, a.head_dim), gate


def gqa_scale(spec: ModelSpec) -> float:
    a = spec.attention
    return a.softmax_scale or a.head_dim ** -0.5


def _gqa_attention(p, spec: ModelSpec, x, layer_cache, pos_offset, rope_cs,
                   use_rope: bool = True, window: int = 0):
    """GQA attention over the contiguous cache: the new k / v are written
    first, then ``mha`` attends over the whole buffer with a causal mask
    (and the sliding window of a windowed layer), or, on a layer without a
    window, ``mha_blockwise`` at every step once the buffer holds
    BLOCKWISE_KV_THRESHOLD positions (plain PyTorch, as XLA in the JAX
    package, models/model.py:380-396); the output gated where the spec
    says so."""
    a = spec.attention
    b, s, _ = x.shape
    q, k, v, gate = gqa_project_rope(p, spec, x, rope_cs, use_rope)
    k_buf = _write_cache(layer_cache[0], k, pos_offset)
    v_buf = _write_cache(layer_cache[1], v, pos_offset)
    if window == 0 and k_buf.shape[1] >= attention.BLOCKWISE_KV_THRESHOLD:
        out = mha_blockwise(q, k_buf.transpose(1, 2), v_buf.transpose(1, 2),
                            _q_positions(pos_offset, s),
                            scale=gqa_scale(spec))
    else:
        mask = _attn_mask(pos_offset, s, k_buf.shape[1], window)
        out = mha(q, k_buf.transpose(1, 2), v_buf.transpose(1, 2),
                  scale=gqa_scale(spec), mask=mask)
    out = gqa_gate(out.transpose(1, 2).reshape(b, s, a.num_heads * a.head_dim),
                   gate)
    return o_proj(p, out), (k_buf, v_buf)


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
        return o_proj(p, out), (ckv_buf, kpe_buf)

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
    if s == 1:
        # unfused decode: the cache row is written, so the lengths the
        # kernel gets include the current token
        attn = mla_decode(q_nope_eff, q_pe, ckv_buf, kpe_buf, pos_offset + 1,
                          scale=scale)
    elif ckv_buf.shape[1] >= attention.BLOCKWISE_KV_THRESHOLD:
        # a long buffer: O(block) scores (the JAX package's :312-316)
        attn = mla_absorbed_blockwise(q_nope_eff, q_pe, ckv_buf, kpe_buf,
                                      _q_positions(pos_offset, s),
                                      scale=scale)
    else:
        mask = _attn_mask(pos_offset, s, ckv_buf.shape[1])
        attn = mla_absorbed(q_nope_eff, q_pe, ckv_buf, kpe_buf, scale=scale,
                            mask=mask)
    out = torch.einsum(
        "bhsr,hrv->bshv", attn.to(torch.float32), p["w_uv"].to(torch.float32)
    ).to(x.dtype).reshape(b, s, h * a.v_head_dim)
    return o_proj(p, out), (ckv_buf, kpe_buf)


def _dense_mlp(p, spec: ModelSpec, x):
    """Dense GLU MLP (shared experts, dense layers), routed as the JAX
    package routes it (w4a8_ffn.dense_mlp_fused): the fused dense FFN
    kernel where the reference fuses (DeepSeek-V2-Lite's shared experts
    with W4A8 weights), else two linears with the GLU in the compute dtype
    (DeepSeek-V2-Lite's layer-0 MLP, I = 10944 with down group 96, and
    every weight format that is not W4A8). LoRA adapters keep it off the
    fused kernel (the JAX package checks gate_up_lora; down_lora alone
    would be dropped there, so both are checked here)."""
    gu, dn = p["gate_up"], p["down"]
    act = spec.activation
    rows = x.reshape(-1, x.shape[-1])
    if ("gate_up_lora" not in p and "down_lora" not in p
            and dense_mlp_fused(gu, dn, act.kind, act.swiglu_limit,
                                rows.shape[0])):
        if needs_grad(rows):
            y = DenseW4A8FFNFn.apply(rows, gu, dn, act.kind)
        else:
            y = dense_w4a8_ffn(rows.contiguous(), gu, dn, act.kind)
        return y.reshape(*x.shape[:-1], -1)
    hcat = plinear(p, "gate_up", x)
    f = hcat.shape[-1] // 2
    return plinear(p, "down", glu_activate(hcat[..., :f], hcat[..., f:],
                                           spec.activation))


def _moe_mlp(p, spec: ModelSpec, x, router_x=None, aux: list | None = None):
    """Routed experts (and the shared expert) of x [B, S, d]; the router
    reads ``router_x`` where given (smallthinker's early router: the layer
    input), else x. ``aux``, where given, gets this layer's routed ids
    [B*S, k] (the serving engine's routing statistics). Fused shared
    experts (ops/fuse_shared.py) ride the routed call as always-selected
    rows of weight 1, or the sigmoid shared gate's value, and the separate
    shared FFN then does not run (the JAX package's models/model.py:
    474-493). Under a parallel context with ep ranks the routed call goes
    through parallel/ep.py: the all-to-all dispatch where ep_impl is "a2a"
    and the tokens divide by ep, else the psum combine (:496-516)."""
    b, s, d = x.shape
    flat = x.reshape(b * s, d)
    rflat = flat if router_x is None else router_x.reshape(b * s, d)
    logits = rflat.to(torch.float32) @ p["router_w"].to(torch.float32).T
    topk_idx, topk_w = route(logits, spec.moe.gate, p.get("router_bias_corr"))
    if aux is not None:
        aux.append(topk_idx)
    experts = p["experts"]
    n_fused = getattr(experts, "n_shared_fused", 0)
    ctx = get_parallel_context()
    ep = ctx.ep_size if ctx is not None else 1
    gate = None
    if spec.moe.shared_expert_gate:
        gate = torch.sigmoid(flat.to(torch.float32)
                             @ p["shared_gate"].to(torch.float32).T)
    if n_fused:
        # the shared experts' slots follow all E routed ones (this rank
        # holds E / ep of the stored experts under EP)
        t = topk_idx.shape[0]
        e_routed = experts.num_experts * ep - n_fused
        sh_ids = torch.arange(e_routed, e_routed + n_fused,
                              dtype=topk_idx.dtype,
                              device=topk_idx.device).expand(t, n_fused)
        sh_w = (gate.expand(t, n_fused) if gate is not None
                else torch.ones((t, n_fused), device=topk_w.device))
        topk_idx = torch.cat([topk_idx, sh_ids], dim=-1)
        topk_w = torch.cat([topk_w, sh_w.to(topk_w.dtype)], dim=-1)
    if ep > 1:
        if ctx.ep_impl == "a2a" and flat.shape[0] % ctx.ep_size == 0:
            y = moe_forward_ep_a2a(flat, experts, topk_idx, topk_w,
                                   spec.activation, ctx.mesh,
                                   pipeline_chunks=ctx.ep_pipeline_chunks)
        else:
            y = moe_forward_ep(flat, experts, topk_idx, topk_w,
                               spec.activation, ctx.mesh)
    else:
        y = moe_forward(flat, experts, topk_idx, topk_w, spec.activation)
    if not n_fused and p.get("shared") is not None:
        y_sh = _dense_mlp(p["shared"], spec, flat)
        if gate is not None:
            # qwen2-moe: the shared expert scaled by a sigmoid gate [T, 1]
            y_sh = y_sh * gate.to(y_sh.dtype)
        y = y + y_sh
    return y.reshape(b, s, d)


def early_router_input(spec: ModelSpec, x):
    """The router's input of a layer whose input is x: x itself (before
    the attention norm) under smallthinker's early router, else None (the
    router reads the post-attention hidden state)."""
    return x if spec.moe is not None and spec.moe.early_router else None


def mlp(lp, spec: ModelSpec, xn, router_x=None, aux: list | None = None):
    """The layer's MoE (its router on ``router_x`` where given; its routed
    ids appended to ``aux``) or dense MLP of the normed hidden state xn,
    summed over the tensor-parallel ranks (each holds its share of every
    intermediate width)."""
    if "moe" in lp:
        return tp_all_reduce(_moe_mlp(lp["moe"], spec, xn, router_x, aux))
    return tp_all_reduce(_dense_mlp(lp["mlp"], spec, xn))


def linear_layer_state(p, spec: ModelSpec, xn, conv, rec, valid=None):
    """A GatedDeltaNet layer over its states conv [B, K, C] / rec [B, Hv,
    dk, dv]: (output, new conv in conv's dtype, new rec)."""
    out, new_conv, new_rec = gated_delta_net(p, spec.linear_attn, xn, conv,
                                             rec, spec.rms_norm_eps, valid)
    return out, new_conv.to(conv.dtype), new_rec


def decoder_layer(lp, spec: ModelSpec, x, layer_cache, lengths, rope_cs,
                  rope_rot=None, kind: str = "full", use_rope: bool = True,
                  window: int = 0):
    """One decoder layer; returns (x, buf_a, buf_b). ``kind`` "linear" runs
    GatedDeltaNet over the layer's states; ``use_rope`` / ``window`` are
    the layer's (spec.layer_uses_rope / layer_window)."""
    res = x
    router_x = early_router_input(spec, x)
    xn = rms_norm(x, lp["input_norm"], spec.rms_norm_eps)
    if kind == "linear":
        attn_out, buf_a, buf_b = linear_layer_state(
            lp["attn"], spec, xn, layer_cache[0], layer_cache[1])
    elif spec.attention.kind == "mla":
        attn_out, (buf_a, buf_b) = _mla_attention(
            lp["attn"], spec, xn, layer_cache, lengths, rope_cs, rope_rot)
    else:
        attn_out, (buf_a, buf_b) = _gqa_attention(
            lp["attn"], spec, xn, layer_cache, lengths, rope_cs, use_rope,
            window)
    x = res + attn_out
    res = x
    xn = rms_norm(x, lp["post_attn_norm"], spec.rms_norm_eps)
    return res + mlp(lp, spec, xn, router_x), buf_a, buf_b


def forward(params, spec: ModelSpec, tokens: torch.Tensor, cache: KVCache,
            rope_tables=None, compute_dtype=torch.bfloat16,
            logits_last_only: bool = False, remat: bool = False,
            return_hidden: bool = False):
    """One pass over S new tokens per sequence (positions cache.lengths +
    arange(S)). Returns (logits [B, S, V] or [B, 1, V] with
    logits_last_only, cache), and with return_hidden the pre-final-norm
    hidden states [B, S, H] of every position as a third value (what an
    MTP draft head consumes, engine/mtp.py); the cache is updated in
    place. With remat
    (and gradients recorded) each decoder layer keeps only its input for
    the backward and runs again there: activation memory of one layer
    instead of all, for a second forward of every layer."""
    b, s = tokens.shape
    x = params["embed"][tokens].to(compute_dtype)
    if rope_tables is None:
        rope_tables = precompute_rope_tables(spec.rope, tokens.device)
    cos_t, sin_t = rope_tables
    pos = _q_positions(cache.lengths, s)
    rope_cs = (cos_t[pos], sin_t[pos])
    rope_rot = None
    if s == 1 and attention.MLA_FUSED and spec.attention.kind == "mla":
        # one rotation matrix per step, shared by every layer's fused
        # decode attention
        rope_rot = rope_rotation_matrix(
            rope_cs[0][:, 0], rope_cs[1][:, 0], spec.rope.interleaved
        )
    for li, lp in enumerate(params["layers"]):
        args = (lp, spec, x, (cache.bufs_a[li], cache.bufs_b[li]),
                cache.lengths, rope_cs, rope_rot, spec.layer_kind(li),
                spec.layer_uses_rope(li), spec.layer_window(li))
        if remat and torch.is_grad_enabled():
            x, buf_a, buf_b = torch.utils.checkpoint.checkpoint(
                decoder_layer, *args, use_reentrant=False)
        else:
            x, buf_a, buf_b = decoder_layer(*args)
        cache.bufs_a[li], cache.bufs_b[li] = buf_a, buf_b
    hidden = x
    x = rms_norm(x, params["final_norm"], spec.rms_norm_eps)
    if logits_last_only:
        x = x[:, -1:, :]
    logits = lm_head_logits(params, x)
    cache.lengths = cache.lengths + s  # a new tensor: a layer may hold the old
    if return_hidden:
        return logits, cache, hidden
    return logits, cache
