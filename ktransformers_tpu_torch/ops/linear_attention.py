"""Gated DeltaNet linear attention, Qwen3-Next's hybrid layers
(counterpart of ktransformers_tpu/ops/linear_attention.py).

A depthwise causal conv (K shifts), l2-normed q / k and the gated delta
rule

    S_t = exp(g_t) * S_{t-1}
    S_t = S_t + k_t (beta_t * (v_t - S_t^T k_t))^T
    o_t = S_t^T q_t

run as a Python loop over the chunk's positions (the JAX package's
lax.scan) for prefill and one step for decode. State per layer is O(1) in
the context: the conv tail [B, K, C] and the float32 recurrent matrix
[B, Hv, dk, dv]. Plain PyTorch, as the reference is plain XLA: there is no
Pallas kernel to port. On the card the loop costs some ten launches a
position (a 256-token chunk some 2,500 a layer); a chunked kernel is on
ROADMAP's held list.

Weights come pre-permuted (models/loading.py) into the [q | k | v | z]
column order, so the splits here are contiguous.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from ktransformers_tpu_torch.ops.linear import linear
from ktransformers_tpu_torch.ops.norm import rms_norm


@dataclasses.dataclass(frozen=True)
class LinearAttentionSpec:
    num_v_heads: int
    num_k_heads: int
    head_k_dim: int
    head_v_dim: int
    conv_kernel: int = 4

    @property
    def key_dim(self) -> int:
        return self.num_k_heads * self.head_k_dim

    @property
    def value_dim(self) -> int:
        return self.num_v_heads * self.head_v_dim

    @property
    def conv_dim(self) -> int:
        return 2 * self.key_dim + self.value_dim


def _l2norm(x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    x = x.to(torch.float32)
    return x * torch.rsqrt((x * x).sum(dim=-1, keepdim=True) + eps)


def _live(s: int, valid: torch.Tensor) -> torch.Tensor:
    """[B, S] bool: position t of row b is live (t < valid[b])."""
    return torch.arange(s, device=valid.device)[None, :] < valid[:, None]


def causal_conv(x, weight, conv_state=None, valid=None):
    """Depthwise causal conv + silu. x [B, S, C]; weight [C, K]; conv_state
    [B, K, C] (the K inputs before this chunk) or None (zeros); valid [B]
    (optional): rows t >= valid[b] are padding, and the new state holds the
    last K inputs before the padding. Returns (y [B, S, C] in x.dtype,
    new_state [B, K, C])."""
    b, s, c = x.shape
    k = weight.shape[1]
    if conv_state is None:
        conv_state = torch.zeros((b, k, c), dtype=x.dtype, device=x.device)
    full = torch.cat([conv_state.to(x.dtype), x], dim=1)  # [B, K + S, C]
    ext = full[:, 1:]
    w = weight.to(torch.float32)
    y = torch.zeros((b, s, c), dtype=torch.float32, device=x.device)
    for j in range(k):
        y = y + ext[:, j:j + s].to(torch.float32) * w[:, j]
    if valid is None:
        new_state = full[:, -k:]
    else:  # full position valid[b] + j holds x[valid - K + j]
        idx = valid.to(torch.int64)[:, None] + torch.arange(
            k, device=x.device)[None, :]
        new_state = torch.gather(full, 1, idx[:, :, None].expand(b, k, c))
    return F.silu(y).to(x.dtype), new_state


def gated_delta_scan(q, k, v, g, beta, state=None, valid=None):
    """q, k [B, S, Hv, dk] (already repeated to the v heads), v [B, S, Hv,
    dv], g / beta [B, S, Hv]; state [B, Hv, dk, dv] float32 or None; valid
    [B] (optional): steps t >= valid[b] leave row b's state untouched.
    Returns (out [B, S, Hv, dv] float32, final state), HF's
    torch_recurrent_gated_delta_rule with use_qk_l2norm_in_kernel."""
    b, s, h, dk = q.shape
    dv = v.shape[-1]
    q = _l2norm(q) * dk ** -0.5
    k = _l2norm(k)
    v = v.to(torch.float32)
    decay = torch.exp(g.to(torch.float32))
    beta = beta.to(torch.float32)
    if state is None:
        state = torch.zeros((b, h, dk, dv), dtype=torch.float32,
                            device=q.device)
    live = None if valid is None else _live(s, valid)
    outs = []
    for t in range(s):
        k_t = k[:, t]
        new = state * decay[:, t, :, None, None]
        kv_mem = torch.einsum("bhkv,bhk->bhv", new, k_t)
        delta = (v[:, t] - kv_mem) * beta[:, t, :, None]
        new = new + k_t[..., None] * delta[:, :, None, :]
        outs.append(torch.einsum("bhkv,bhk->bhv", new, q[:, t]))
        if live is not None:
            new = torch.where(live[:, t, None, None, None], new, state)
        state = new
    return torch.stack(outs, dim=1), state


def gated_delta_net(p: dict, spec: LinearAttentionSpec, x, conv_state,
                    rec_state, rms_eps: float = 1e-6, valid=None):
    """The GatedDeltaNet block: projections, conv, delta rule, gated RMS
    norm per v head, output projection. x [B, S, H]; conv_state [B, K,
    conv_dim] or None; rec_state [B, Hv, dk, dv] float32 or None; valid [B]
    (optional): rows t >= valid[b] are padding and leave both states
    untouched. Returns (y [B, S, H], conv_state, rec_state)."""
    b, s, _ = x.shape
    hv, hk = spec.num_v_heads, spec.num_k_heads
    dk, dv = spec.head_k_dim, spec.head_v_dim
    r = hv // hk
    if valid is not None:
        # zero the padding so it cannot reach the conv window
        x = x * _live(s, valid)[..., None].to(x.dtype)
    qkvz = linear(x, p["in_proj_qkvz"])  # [q | k | v | z]
    ba = linear(x, p["in_proj_ba"])  # [b | a]
    kq, vd = spec.key_dim, spec.value_dim
    qkv = qkvz[..., : 2 * kq + vd]
    z = qkvz[..., 2 * kq + vd:].reshape(b, s, hv, dv)
    bgate, a = ba[..., :hv], ba[..., hv:]

    qkv, new_conv = causal_conv(qkv, p["conv_w"], conv_state, valid)
    q = qkv[..., :kq].reshape(b, s, hk, dk)
    k = qkv[..., kq: 2 * kq].reshape(b, s, hk, dk)
    v = qkv[..., 2 * kq:].reshape(b, s, hv, dv)

    beta = torch.sigmoid(bgate.to(torch.float32))
    sp = a.to(torch.float32) + p["dt_bias"].to(torch.float32)
    g = -torch.exp(p["A_log"].to(torch.float32)) * torch.logaddexp(
        sp, torch.zeros_like(sp))  # jax.nn.softplus
    if r > 1:
        q = torch.repeat_interleave(q, r, dim=2)
        k = torch.repeat_interleave(k, r, dim=2)

    out, new_rec = gated_delta_scan(q, k, v, g, beta, rec_state, valid)
    normed = rms_norm(out, p["norm_w"], rms_eps).to(torch.float32) \
        * F.silu(z.to(torch.float32))
    y = normed.reshape(b, s, hv * dv).to(x.dtype)
    return linear(y, p["out_proj"]), new_conv, new_rec
