"""Fused MLA decode attention: kernel wrapper (csrc/mla_decode.cu) and its
plain PyTorch version.

Replaces ktransformers_tpu/ops/pallas/mla_decode.py:mla_decode_fused.
Bound on the card: the valid cache bytes, lengths[b] * (R + dr) elements
per sequence. ``lengths`` is the OLD cached length (current token
excluded); the caller writes the returned ckv_new / kpe_new into the cache.
"""

from __future__ import annotations

import torch

from ktransformers_tpu_torch.ops.cuda import LAUNCHES
from ktransformers_tpu_torch.ops.cuda import _build
from ktransformers_tpu_torch.ops.cuda.w4a8_matmul import check_cuda_operands

NEG_INF = -1e30
KERNEL_R, KERNEL_DR, KERNEL_HG = 512, 64, 4


def mla_decode_fused_ref(qn_eff, qp_raw, ckv_kpe, gamma, rot, ckv, kpe,
                         lengths, scale: float, eps: float):
    """Plain version: (ctx [B, H, R], ckv_new [B, 1, R], kpe_new [B, 1, dr])."""
    b, h, r = qn_eff.shape
    smax = ckv.shape[1]
    rotf = rot.to(torch.float32)
    qp = torch.matmul(qp_raw.to(torch.float32), rotf)  # [B, H, dr]
    kv = ckv_kpe.to(torch.float32)[:, 0]  # [B, R + dr]
    ckv_raw = kv[:, :r]
    ms = (ckv_raw * ckv_raw).mean(dim=-1, keepdim=True)
    ckvn = ckv_raw * torch.rsqrt(ms + eps) * gamma.to(torch.float32)
    kpen = torch.matmul(kv[:, None, r:], rotf)[:, 0]  # [B, dr]
    qn = qn_eff.to(torch.float32)
    cf = ckv.to(torch.float32)
    kf = kpe.to(torch.float32)
    s_cache = (torch.einsum("bhr,bsr->bhs", qn, cf)
               + torch.einsum("bhd,bsd->bhs", qp, kf)) * scale
    kpos = torch.arange(smax, device=ckv.device)[None, None, :]
    s_cache = torch.where(kpos < lengths.to(torch.int64)[:, None, None],
                          s_cache, torch.full_like(s_cache, NEG_INF))
    s_cur = ((qn * ckvn[:, None, :]).sum(-1)
             + (qp * kpen[:, None, :]).sum(-1)) * scale  # [B, H]
    p = torch.softmax(torch.cat([s_cache, s_cur[..., None]], dim=-1), dim=-1)
    ctx = (torch.einsum("bhs,bsr->bhr", p[..., :smax], cf)
           + p[..., smax:] * ckvn[:, None, :])
    return (ctx.to(qn_eff.dtype), ckvn[:, None].to(ckv.dtype),
            kpen[:, None].to(kpe.dtype))


def mla_decode_fused(qn_eff, qp_raw, ckv_kpe, gamma, rot, ckv, kpe, lengths,
                     scale: float, eps: float):
    """kv_a RMSNorm + rope (as rotation) + flash attention over the cache
    plus the current token, one launch on the card.

    qn_eff [B, H, R] absorbed query; qp_raw [B, H, dr] un-roped; ckv_kpe
    [B, 1, R + dr] raw kv_a output; gamma [R] float32; rot [B, dr, dr]
    float32; ckv [B, S, R], kpe [B, S, dr] cache (old contents); lengths
    [B] int32 old cached length."""
    what = "mla_decode_fused"
    b, h, r = qn_eff.shape
    dr = qp_raw.shape[-1]
    smax = ckv.shape[1]
    shapes = {
        "qp_raw": (qp_raw, (b, h, dr)), "ckv_kpe": (ckv_kpe, (b, 1, r + dr)),
        "gamma": (gamma, (r,)), "rot": (rot, (b, dr, dr)),
        "ckv": (ckv, (b, smax, r)), "kpe": (kpe, (b, smax, dr)),
        "lengths": (lengths, (b,)),
    }
    for name, (t, want) in shapes.items():
        if tuple(t.shape) != want:
            raise ValueError(f"{what}: {name} is {tuple(t.shape)}, want {want}")
    if qn_eff.device.type == "cpu":
        return mla_decode_fused_ref(qn_eff, qp_raw, ckv_kpe, gamma, rot, ckv,
                                    kpe, lengths, scale, eps)
    if qn_eff.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {qn_eff.device}")
    if (r, dr) != (KERNEL_R, KERNEL_DR) or h % KERNEL_HG:
        raise ValueError(f"{what}: kernel takes R={KERNEL_R}, dr={KERNEL_DR}, "
                         f"H % {KERNEL_HG} == 0; got R={r} dr={dr} H={h}")
    dt = qn_eff.dtype
    if dt not in (torch.float32, torch.bfloat16) or any(
        t.dtype != dt for t in (qp_raw, ckv_kpe, ckv, kpe)
    ):
        raise ValueError(f"{what}: qn/qp/ckv_kpe/ckv/kpe must share float32 "
                         "or bfloat16")
    if gamma.dtype != torch.float32 or rot.dtype != torch.float32:
        raise ValueError(f"{what}: gamma and rot must be float32")
    if lengths.dtype != torch.int32:
        raise ValueError(f"{what}: lengths must be int32")
    launch, outs = mla_launcher(qn_eff, qp_raw, ckv_kpe, gamma, rot, ckv,
                                kpe, lengths, scale, eps)
    launch()
    LAUNCHES[what] += 1
    return outs


def mla_launcher(qn_eff, qp_raw, ckv_kpe, gamma, rot, ckv, kpe, lengths,
                 scale: float, eps: float):
    """Allocates the outputs of a CUDA call; returns (launch, outputs),
    where launch() runs only the kernel."""
    what = "mla_decode_fused"
    check_cuda_operands(what, qn_eff.device, qn_eff, qp_raw, ckv_kpe, gamma,
                        rot, ckv, kpe, lengths)
    b, h, r = qn_eff.shape
    dr, dt = qp_raw.shape[-1], qn_eff.dtype
    ctx = torch.empty_like(qn_eff)
    ckv_new = torch.empty(b, 1, r, dtype=dt, device=qn_eff.device)
    kpe_new = torch.empty(b, 1, dr, dtype=dt, device=qn_eff.device)
    fn = _build.lib("mla_decode").kt_mla_decode_fused

    def launch():
        err = fn(
            qn_eff.data_ptr(), qp_raw.data_ptr(), ckv_kpe.data_ptr(),
            gamma.data_ptr(), rot.data_ptr(), ckv.data_ptr(), kpe.data_ptr(),
            lengths.data_ptr(), b, h, ckv.shape[1], float(scale), float(eps),
            int(dt == torch.bfloat16), ctx.data_ptr(), ckv_new.data_ptr(),
            kpe_new.data_ptr(),
            torch.cuda.current_stream(qn_eff.device).cuda_stream,
        )
        _build.check(err, what)

    return launch, (ctx, ckv_new, kpe_new)
