"""MLA decode attention: kernel wrappers (csrc/mla_decode.cu) and their
plain PyTorch versions.

mla_decode_fused replaces
ktransformers_tpu/ops/pallas/mla_decode.py:mla_decode_fused: ``lengths`` is
the OLD cached length (current token excluded); the caller writes the
returned ckv_new / kpe_new into the cache. mla_decode_attention replaces
:mla_decode_attention: the cache already holds the current token and
``lengths`` INCLUDES it. Bound on the card, both: the valid cache bytes,
lengths[b] * (R + dr) elements per sequence.

mla_decode_fused routes a CUDA call by ``route``: bf16 operands take
mla_decode_split_kernel (the cached rows split over blocks by
``decode_split_plan``, the current token in a block of its own, all merged
in the same launch), float32 keeps the first version,
mla_decode_fused_kernel. mla_decode_attention routes by
``attention_route``: bf16 operands take the same split kernel without the
current-token block (mla_decode_split_kernel<false>, the same plan),
float32 keeps the first version, mla_decode_attention_kernel.
"""

from __future__ import annotations

import torch

from ktransformers_tpu_torch.ops.cuda import LAUNCHES, ROUTED_LAUNCHES
from ktransformers_tpu_torch.ops.cuda import _build
from ktransformers_tpu_torch.ops.cuda.w4a8_matmul import (
    check_cuda_operands,
    scratch,
    sm_count,
)

NEG_INF = -1e30
KERNEL_R, KERNEL_DR, KERNEL_HG = 512, 64, 4
# mla_decode_split_kernel (csrc/mla_decode.cu): 16 heads a block (one mma
# row group), splits of whole 16-row units, at most DECODE_MAX_SPLITS
# splits (the merge's weights live in shared memory), and a state record
# of m [16], l [16] and acc [16, R] floats for each split and for the
# current token
DECODE_HEADS = 16
DECODE_UNIT = 16
DECODE_MIN_SPAN = 64
DECODE_MAX_SPLITS = 32
DECODE_REC = 2 * DECODE_HEADS + DECODE_HEADS * KERNEL_R
KERNEL_NAMES = {"split": "mla_decode_split_kernel"}
ATTENTION_KERNEL_NAMES = {"split": "mla_decode_split_kernel<false>"}


def route(dtype: torch.dtype) -> str:
    """The kernel of a CUDA mla_decode_fused call: "split"
    (mla_decode_split_kernel) for bf16 operands, "fused"
    (mla_decode_fused_kernel, the first version) for float32, whose card
    tests hold 1e-5 and which bf16 products could not."""
    return "split" if dtype == torch.bfloat16 else "fused"


def attention_route(dtype: torch.dtype) -> str:
    """The kernel of a CUDA mla_decode_attention call: "split"
    (mla_decode_split_kernel<false>) for bf16 operands, "first"
    (mla_decode_attention_kernel) for float32, as ``route``."""
    return "split" if dtype == torch.bfloat16 else "first"


def decode_split_plan(b: int, s: int, h: int, sms: int) -> tuple[int, int]:
    """(splits, span) of a mla_decode_split_kernel launch over a cache of
    capacity ``s`` rows: split j takes rows [j * span, (j + 1) * span), so
    every row lies in exactly one split (the current token has a block of
    its own). The plan reads no length (they live on the card): (B x head
    tiles x splits) aims at one block an SM, with at least DECODE_MIN_SPAN
    rows a split (a multiple of DECODE_UNIT) and at most DECODE_MAX_SPLITS
    splits."""
    tiles = b * -(-h // DECODE_HEADS)
    want = max(1, -(-sms // tiles))
    span = max(DECODE_MIN_SPAN, -(-s // want), -(-s // DECODE_MAX_SPLITS))
    span = -(-span // DECODE_UNIT) * DECODE_UNIT
    return -(-s // span), span


def mla_decode_fused_ref(qn_eff, qp_raw, ckv_kpe, gamma, rot, ckv, kpe,
                         lengths, scale: float, eps: float):
    """Plain version: (ctx [B, H, R], ckv_new [B, 1, R], kpe_new [B, 1, dr]).
    Cache rows at or past lengths[b] are cut away before any arithmetic
    (they may hold anything)."""
    b, h, r = qn_eff.shape
    smax = ckv.shape[1]
    kpos = torch.arange(smax, device=ckv.device)[None, None, :]
    live = kpos < lengths.to(torch.int64)[:, None, None]  # [B, 1, S]
    rotf = rot.to(torch.float32)
    qp = torch.matmul(qp_raw.to(torch.float32), rotf)  # [B, H, dr]
    kv = ckv_kpe.to(torch.float32)[:, 0]  # [B, R + dr]
    ckv_raw = kv[:, :r]
    ms = (ckv_raw * ckv_raw).mean(dim=-1, keepdim=True)
    ckvn = ckv_raw * torch.rsqrt(ms + eps) * gamma.to(torch.float32)
    kpen = torch.matmul(kv[:, None, r:], rotf)[:, 0]  # [B, dr]
    qn = qn_eff.to(torch.float32)
    zero = torch.zeros((), dtype=torch.float32, device=ckv.device)
    cf = torch.where(live[:, 0, :, None], ckv.to(torch.float32), zero)
    kf = torch.where(live[:, 0, :, None], kpe.to(torch.float32), zero)
    s_cache = (torch.einsum("bhr,bsr->bhs", qn, cf)
               + torch.einsum("bhd,bsd->bhs", qp, kf)) * scale
    s_cache = torch.where(live, s_cache, torch.full_like(s_cache, NEG_INF))
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
    kernel = route(dt)
    launch, outs = mla_launcher(qn_eff, qp_raw, ckv_kpe, gamma, rot, ckv,
                                kpe, lengths, scale, eps, kernel)
    launch()
    LAUNCHES[what] += 1
    if kernel in KERNEL_NAMES:
        ROUTED_LAUNCHES[KERNEL_NAMES[kernel]] += 1
    return outs


def mla_launcher(qn_eff, qp_raw, ckv_kpe, gamma, rot, ckv, kpe, lengths,
                 scale: float, eps: float, kernel: str | None = None):
    """Allocates the outputs of a CUDA call; returns (launch, outputs),
    where launch() runs only the kernel. ``kernel`` ("split" or "fused")
    overrides ``route``, for a measurement."""
    what = "mla_decode_fused"
    check_cuda_operands(what, qn_eff.device, qn_eff, qp_raw, ckv_kpe, gamma,
                        rot, ckv, kpe, lengths)
    b, h, r = qn_eff.shape
    dr, dt = qp_raw.shape[-1], qn_eff.dtype
    kernel = kernel or route(dt)
    if (r, dr) != (KERNEL_R, KERNEL_DR) or (kernel == "fused"
                                             and h % KERNEL_HG):
        raise ValueError(f"{what}: kernel takes R={KERNEL_R}, dr={KERNEL_DR}"
                         + (f", H % {KERNEL_HG} == 0" if kernel == "fused"
                            else "") + f"; got R={r} dr={dr} H={h}")
    if kernel == "split" and dt != torch.bfloat16:
        raise ValueError(f"{what}: mla_decode_split_kernel takes bfloat16")
    dev = qn_eff.device
    ctx = torch.empty_like(qn_eff)
    ckv_new = torch.empty(b, 1, r, dtype=dt, device=dev)
    kpe_new = torch.empty(b, 1, dr, dtype=dt, device=dev)
    if kernel == "split":
        smax = ckv.shape[1]
        splits, span = decode_split_plan(b, smax, h, sm_count(dev))
        pairs = b * -(-h // DECODE_HEADS)
        part, cnt = scratch(dev, pairs * (splits + 1) * DECODE_REC, pairs,
                            "mla_decode_split")
        split_fn = _build.lib("mla_decode").kt_mla_decode_split

        def launch_split():
            err = split_fn(
                qn_eff.data_ptr(), qp_raw.data_ptr(), ckv_kpe.data_ptr(),
                gamma.data_ptr(), rot.data_ptr(), ckv.data_ptr(),
                kpe.data_ptr(), lengths.data_ptr(), b, h, smax, splits, span,
                float(scale), float(eps), part.data_ptr(), cnt.data_ptr(),
                ctx.data_ptr(),
                ckv_new.data_ptr(), kpe_new.data_ptr(),
                torch.cuda.current_stream(dev).cuda_stream,
            )
            _build.check(err, what)

        return launch_split, (ctx, ckv_new, kpe_new)
    fn = _build.lib("mla_decode").kt_mla_decode_fused

    def launch():
        err = fn(
            qn_eff.data_ptr(), qp_raw.data_ptr(), ckv_kpe.data_ptr(),
            gamma.data_ptr(), rot.data_ptr(), ckv.data_ptr(), kpe.data_ptr(),
            lengths.data_ptr(), b, h, ckv.shape[1], float(scale), float(eps),
            int(dt == torch.bfloat16), ctx.data_ptr(), ckv_new.data_ptr(),
            kpe_new.data_ptr(), torch.cuda.current_stream(dev).cuda_stream,
        )
        _build.check(err, what)

    return launch, (ctx, ckv_new, kpe_new)


def mla_decode_attention_ref(qn, qp, ckv, kpe, lengths, scale: float):
    """Plain version: [B, H, R]. Rows at or past lengths[b] are cut away
    before any arithmetic (they may hold anything); a sequence with no live
    row gives zeros."""
    smax = ckv.shape[1]
    live = (torch.arange(smax, device=ckv.device)[None, :]
            < lengths.to(torch.int64)[:, None])  # [B, S]
    zero = torch.zeros((), dtype=torch.float32, device=ckv.device)
    cf = torch.where(live[..., None], ckv.to(torch.float32), zero)
    kf = torch.where(live[..., None], kpe.to(torch.float32), zero)
    s = (torch.einsum("bhr,bsr->bhs", qn.to(torch.float32), cf)
         + torch.einsum("bhd,bsd->bhs", qp.to(torch.float32), kf)) * scale
    s = torch.where(live[:, None, :], s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(live[:, None, :], torch.exp(s - m), zero)
    l = p.sum(dim=-1, keepdim=True)
    ctx = torch.einsum("bhs,bsr->bhr", p, cf) / torch.clamp(l, min=1e-30)
    return ctx.to(qn.dtype)


def attention_launcher(qn, qp, ckv, kpe, lengths, scale: float,
                       kernel: str | None = None):
    """(launch, out) of a CUDA mla_decode_attention call; launch() runs
    only the kernel. ``kernel`` ("split" or "first") overrides
    ``attention_route``, for a measurement."""
    what = "mla_decode_attention"
    check_cuda_operands(what, qn.device, qn, qp, ckv, kpe, lengths)
    b, h, _ = qn.shape
    smax = ckv.shape[1]
    dev = qn.device
    kernel = kernel or attention_route(qn.dtype)
    out = torch.empty_like(qn)
    stream = torch.cuda.current_stream(dev).cuda_stream
    if kernel == "split":
        if qn.dtype != torch.bfloat16:
            raise ValueError(f"{what}: mla_decode_split_kernel takes "
                             "bfloat16")
        splits, span = decode_split_plan(b, smax, h, sm_count(dev))
        pairs = b * -(-h // DECODE_HEADS)
        part, cnt = scratch(dev, pairs * splits * DECODE_REC, pairs,
                            "mla_decode_split")
        split_fn = _build.lib("mla_decode").kt_mla_decode_attention_split

        def launch_split():
            err = split_fn(
                qn.data_ptr(), qp.data_ptr(), ckv.data_ptr(), kpe.data_ptr(),
                lengths.data_ptr(), b, h, smax, splits, span, float(scale),
                part.data_ptr(), cnt.data_ptr(), out.data_ptr(), stream)
            _build.check(err, what)

        return launch_split, out
    if h % KERNEL_HG:
        raise ValueError(f"{what}: the first version takes H % {KERNEL_HG} "
                         f"== 0; got H={h}")
    fn = _build.lib("mla_decode").kt_mla_decode_attention

    def launch():
        err = fn(
            qn.data_ptr(), qp.data_ptr(), ckv.data_ptr(), kpe.data_ptr(),
            lengths.data_ptr(), b, h, smax, float(scale),
            int(qn.dtype == torch.bfloat16), out.data_ptr(), stream,
        )
        _build.check(err, what)

    return launch, out


def mla_decode_attention(qn, qp, ckv, kpe, lengths, scale: float):
    """Flash decode of one query token per sequence over a contiguous
    compressed cache: score = (qn . ckv + qp . kpe) * scale over the rows
    s < lengths[b], value = ckv; [B, H, R].

    qn [B, H, R] absorbed query; qp [B, H, dr] roped; ckv [B, S, R], kpe
    [B, S, dr]; lengths [B] int32, the current token INCLUDED (its row is
    already in the cache)."""
    what = "mla_decode_attention"
    b, h, r = qn.shape
    dr = qp.shape[-1]
    smax = ckv.shape[1]
    shapes = {"qp": (qp, (b, h, dr)), "ckv": (ckv, (b, smax, r)),
              "kpe": (kpe, (b, smax, dr)), "lengths": (lengths, (b,))}
    for name, (t, want) in shapes.items():
        if tuple(t.shape) != want:
            raise ValueError(f"{what}: {name} is {tuple(t.shape)}, want {want}")
    if qn.device.type == "cpu":
        return mla_decode_attention_ref(qn, qp, ckv, kpe, lengths, scale)
    if qn.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {qn.device}")
    if (r, dr) != (KERNEL_R, KERNEL_DR):
        raise ValueError(f"{what}: kernel takes R={KERNEL_R}, dr={KERNEL_DR}; "
                         f"got R={r} dr={dr}")
    dt = qn.dtype
    if dt not in (torch.float32, torch.bfloat16) or any(
            t.dtype != dt for t in (qp, ckv, kpe)):
        raise ValueError(f"{what}: qn/qp/ckv/kpe must share float32 or "
                         "bfloat16")
    if lengths.dtype != torch.int32:
        raise ValueError(f"{what}: lengths must be int32")
    kernel = attention_route(dt)
    launch, out = attention_launcher(qn, qp, ckv, kpe, lengths, scale, kernel)
    launch()
    LAUNCHES[what] += 1
    if kernel in ATTENTION_KERNEL_NAMES:
        ROUTED_LAUNCHES[ATTENTION_KERNEL_NAMES[kernel]] += 1
    return out
