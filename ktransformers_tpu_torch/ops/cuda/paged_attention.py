"""Attention over a paged KV pool: kernel wrappers and their plain PyTorch
versions.

Replaces ktransformers_tpu/ops/pallas/paged_attention.py: mla_paged_decode
and :mla_paged_prefill (absorbed MLA, csrc/paged_attention.cu; pools ckv
[P, page, R] and kpe [P, page, Dr]), gqa_paged_decode and
:gqa_paged_prefill (GQA, csrc/gqa_paged_attention.cu; pools k and v [P,
page, Hkv, D], query head h on KV head h // (H / Hkv), an optional sliding
``window``). Page tables are int32 [B, Pmax], padded with page 0. Pages
are recycled without clearing, so rows at or past a sequence's live length
may hold anything (NaN included): the kernels never read them and the
plain versions zero them before the products.

Three meanings of ``lengths`` meet here:
- mla_paged_decode, gqa_paged_decode: the valid KV length INCLUDING the
  current token (the caller has written it to the pages and passes old
  length + 1);
- mla_paged_prefill, gqa_paged_prefill: the OLD cached length, the chunk
  excluded; the chunk (already written) adds ``valid`` live tokens, so
  live KV = lengths + valid;
- ops/cuda/mla_decode.mla_decode_fused: the old length, current token
  EXCLUDED (it reads the current token from its own operands).

Bound on the card: decode by the bytes of the live rows; prefill at the
serving shapes by the operations of its two products.

Four wrappers route a CUDA call by the operands' type; float32 keeps
the first versions, whose card tests hold 1e-5 and which bf16 products
could not:
- mla_paged_decode by ``decode_route``: bf16 takes
  mla_paged_decode_split_kernel (each sequence's positions split over
  blocks by ops/cuda/mla_decode.decode_split_plan, 16 heads an mma row
  group, the splits merged in the same launch), float32
  mla_paged_decode_kernel;
- mla_paged_prefill by ``prefill_route``: bf16 takes
  mla_prefill_mma_kernel (tensor cores, RG heads x 16 positions a block by
  ``prefill_plan``), float32 mla_paged_prefill_kernel;
- gqa_paged_decode by ``gqa_decode_route``: bf16 takes
  gqa_decode_split_kernel (each sequence's keys split over
  ``gqa_decode_split_plan`` blocks, the G query heads of a KV head an mma
  row group, the splits merged in the same launch), float32
  gqa_paged_decode_kernel and its combine launch;
- gqa_paged_prefill by ``gqa_prefill_route``: bf16 takes
  gqa_prefill_mma_kernel (tensor cores, 64 or 128 flattened query rows a
  block by ``gqa_prefill_plan``), float32 gqa_paged_prefill_kernel.
"""

from __future__ import annotations

import torch

from ktransformers_tpu_torch.ops.cuda import LAUNCHES, ROUTED_LAUNCHES
from ktransformers_tpu_torch.ops.cuda import _build
from ktransformers_tpu_torch.ops.cuda import mla_decode as MD
from ktransformers_tpu_torch.ops.cuda.mla_decode import (
    DECODE_HEADS,
    DECODE_REC,
    KERNEL_DR,
    KERNEL_HG,
    KERNEL_R,
    NEG_INF,
)
from ktransformers_tpu_torch.ops.cuda.w4a8_matmul import (
    check_cuda_operands,
    device_kind,
    scratch,
    sm_count,
)

# mla_prefill_mma_kernel (csrc/paged_attention.cu): a block holds RG heads
# x PREFILL_POSITIONS positions, RG one of PREFILL_HEADS
PREFILL_POSITIONS = 16
PREFILL_HEADS = (4, 2)
PREFILL_KERNEL_NAMES = {"mma": "mla_prefill_mma_kernel"}
DECODE_KERNEL_NAMES = {"split": "mla_paged_decode_split_kernel"}


def decode_route(dtype: torch.dtype) -> str:
    """The kernel of a CUDA mla_paged_decode call: "split"
    (mla_paged_decode_split_kernel) for bf16 operands, "first"
    (mla_paged_decode_kernel) for float32."""
    return "split" if dtype == torch.bfloat16 else "first"


def prefill_route(dtype: torch.dtype) -> str:
    """The kernel of a CUDA mla_paged_prefill call: "mma"
    (mla_prefill_mma_kernel) for bf16 operands, "first"
    (mla_paged_prefill_kernel) for float32, whose card tests hold 1e-5 and
    which bf16 products could not."""
    return "mma" if dtype == torch.bfloat16 else "first"


def prefill_plan(c: int, h: int, s: int, sms: int) -> int:
    """Heads a block of mla_prefill_mma_kernel: 4 (64 query rows, each
    staged key tile serving 4 heads) where that gives more than one block
    for every two SMs, else 2 (32 rows, twice the blocks). On the H100 4
    wins from 128 blocks on and 2 at 64 (ops/cuda/split_sweep.py)."""
    blocks = c * -(-h // 4) * -(-s // PREFILL_POSITIONS)
    return 4 if 2 * blocks > sms else 2


def gather_pages(buf: torch.Tensor, page_tables: torch.Tensor) -> torch.Tensor:
    """[P, page, ...] x [B, Pmax] -> [B, Pmax * page, ...] (a copy)."""
    g = buf[page_tables.to(torch.int64)]
    b, pmax, page = g.shape[:3]
    return g.reshape(b, pmax * page, *g.shape[3:])


def _live_rows(pages, page_tables, live):
    """Gathered pages [B, Smax, ...] as float32 with the rows at or past
    live [B] zeroed (recycled rows may hold NaN)."""
    g = gather_pages(pages, page_tables).to(torch.float32)
    kpos = torch.arange(g.shape[1], device=g.device)
    ok = (kpos[None, :] < live.to(torch.int64)[:, None]).reshape(
        *g.shape[:2], *([1] * (g.dim() - 2)))
    return torch.where(ok, g, torch.zeros((), device=g.device))


def _live_kv(ckv_pages, kpe_pages, page_tables, live):
    """Gathered ckv / kpe as float32 with the rows at or past live [B]
    zeroed, and the key positions [1, Smax]."""
    ckv = _live_rows(ckv_pages, page_tables, live)
    kpos = torch.arange(ckv.shape[1], device=ckv.device)[None, :]
    return ckv, _live_rows(kpe_pages, page_tables, live), kpos


def _masked_softmax_ctx(scores, ok, ckv, eq: str):
    neg = torch.full((), NEG_INF, dtype=torch.float32, device=scores.device)
    scores = torch.where(ok, scores, neg)
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.exp(scores - m)
    p = torch.where(ok, p, torch.zeros_like(p))
    l = p.sum(dim=-1, keepdim=True)
    return torch.einsum(eq, p, ckv) / torch.clamp(l, min=1e-30)


def mla_paged_decode_ref(q_nope_eff, q_pe, ckv_pages, kpe_pages, page_tables,
                         lengths, scale: float):
    """Plain version: gather the pages, masked softmax in float32 with
    kpos < lengths. A row with no live key gives zeros."""
    ckv, kpe, kpos = _live_kv(ckv_pages, kpe_pages, page_tables, lengths)
    qn = q_nope_eff.to(torch.float32)
    qp = q_pe.to(torch.float32)
    scores = (torch.einsum("bhr,bsr->bhs", qn, ckv)
              + torch.einsum("bhd,bsd->bhs", qp, kpe)) * scale
    ok = (kpos < lengths.to(torch.int64)[:, None])[:, None, :]
    ctx = _masked_softmax_ctx(scores, ok.expand_as(scores), ckv,
                              "bhs,bsr->bhr")
    return ctx.to(q_nope_eff.dtype)


def mla_paged_prefill_ref(q_nope_eff, q_pe, ckv_pages, kpe_pages, page_tables,
                          lengths, valid, scale: float):
    """Plain version: query row qs sees kpos <= lengths + qs and
    kpos < lengths + valid. Rows qs >= valid are padding: they see every
    live key and come back finite."""
    s = q_nope_eff.shape[2]
    old = lengths.to(torch.int64)
    live = old + valid.to(torch.int64)
    ckv, kpe, kpos = _live_kv(ckv_pages, kpe_pages, page_tables, live)
    qn = q_nope_eff.to(torch.float32)
    qp = q_pe.to(torch.float32)
    scores = (torch.einsum("bhqr,bsr->bhqs", qn, ckv)
              + torch.einsum("bhqd,bsd->bhqs", qp, kpe)) * scale
    qpos = old[:, None] + torch.arange(s, device=qn.device)[None, :]
    ok = ((kpos[:, None, :] <= qpos[:, :, None])
          & (kpos[:, None, :] < live[:, None, None]))[:, None]
    ctx = _masked_softmax_ctx(scores, ok.expand_as(scores), ckv,
                              "bhqs,bsr->bhqr")
    return ctx.to(q_nope_eff.dtype)


def _check_common(what, q_nope_eff, q_pe, ckv_pages, kpe_pages, page_tables,
                  lengths, lead: tuple):
    r, dr = q_nope_eff.shape[-1], q_pe.shape[-1]
    if q_pe.shape[:-1] != q_nope_eff.shape[:-1]:
        raise ValueError(f"{what}: q_pe is {tuple(q_pe.shape)}, q_nope_eff "
                         f"{tuple(q_nope_eff.shape)}")
    if (ckv_pages.dim() != 3 or kpe_pages.dim() != 3
            or ckv_pages.shape[-1] != r or kpe_pages.shape[-1] != dr
            or ckv_pages.shape[:2] != kpe_pages.shape[:2]):
        raise ValueError(f"{what}: pools are {tuple(ckv_pages.shape)} / "
                         f"{tuple(kpe_pages.shape)}, want [P, page, {r}] / "
                         f"[P, page, {dr}]")
    b = lead[0]
    if page_tables.dim() != 2 or page_tables.shape[0] != b:
        raise ValueError(f"{what}: page_tables must be [{b}, Pmax]")
    if tuple(lengths.shape) != (b,):
        raise ValueError(f"{what}: lengths must be [{b}]")
    if page_tables.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise ValueError(f"{what}: page_tables and lengths must be int32")


def _check_cuda(what, q_nope_eff, q_pe, ckv_pages, kpe_pages, *ints):
    r, dr = q_nope_eff.shape[-1], q_pe.shape[-1]
    if (r, dr) != (KERNEL_R, KERNEL_DR):
        raise ValueError(f"{what}: kernel takes R={KERNEL_R}, dr={KERNEL_DR}; "
                         f"got R={r} dr={dr}")
    dt = q_nope_eff.dtype
    if dt not in (torch.float32, torch.bfloat16) or any(
            t.dtype != dt for t in (q_pe, ckv_pages, kpe_pages)):
        raise ValueError(f"{what}: queries and pools must share float32 or "
                         "bfloat16")
    check_cuda_operands(what, q_nope_eff.device, q_nope_eff, q_pe, ckv_pages,
                        kpe_pages, *ints)


def decode_launcher(q_nope_eff, q_pe, ckv_pages, kpe_pages, page_tables,
                    lengths, scale: float, kernel: str | None = None):
    """Checks a CUDA call and allocates its output; returns (launch, out),
    where launch() runs only the kernel. ``kernel`` ("split" or "first")
    overrides ``decode_route``, for a measurement."""
    what = "mla_paged_decode"
    _check_cuda(what, q_nope_eff, q_pe, ckv_pages, kpe_pages, page_tables,
                lengths)
    b, h, _ = q_nope_eff.shape
    dt = q_nope_eff.dtype
    kernel = kernel or decode_route(dt)
    if kernel == "first" and h % KERNEL_HG:
        raise ValueError(f"{what}: kernel takes H % {KERNEL_HG} == 0; got {h}")
    if kernel == "split" and dt != torch.bfloat16:
        raise ValueError(f"{what}: mla_paged_decode_split_kernel takes "
                         "bfloat16")
    out = torch.empty_like(q_nope_eff)
    lib = _build.lib("paged_attention")
    page, pmax = ckv_pages.shape[1], page_tables.shape[1]
    if kernel == "split":
        dev = out.device
        # the plan reads the module attribute, so a test can force one
        splits, span = MD.decode_split_plan(b, pmax * page, h, sm_count(dev))
        pairs = b * -(-h // DECODE_HEADS)
        part, cnt = scratch(dev, pairs * splits * DECODE_REC, pairs,
                            "mla_paged_decode_split")

        def launch_split():
            err = lib.kt_mla_paged_decode_split(
                q_nope_eff.data_ptr(), q_pe.data_ptr(), ckv_pages.data_ptr(),
                kpe_pages.data_ptr(), page_tables.data_ptr(),
                lengths.data_ptr(), b, h, page, pmax, splits, span,
                float(scale), part.data_ptr(), cnt.data_ptr(), out.data_ptr(),
                torch.cuda.current_stream(dev).cuda_stream,
            )
            _build.check(err, what)

        return launch_split, out
    fn = lib.kt_mla_paged_decode
    is_bf16 = int(dt == torch.bfloat16)

    def launch():
        err = fn(
            q_nope_eff.data_ptr(), q_pe.data_ptr(), ckv_pages.data_ptr(),
            kpe_pages.data_ptr(), page_tables.data_ptr(), lengths.data_ptr(),
            b, h, page, pmax, float(scale), is_bf16, out.data_ptr(),
            torch.cuda.current_stream(out.device).cuda_stream,
        )
        _build.check(err, what)

    return launch, out


def prefill_launcher(q_nope_eff, q_pe, ckv_pages, kpe_pages, page_tables,
                     lengths, valid, scale: float, kernel: str | None = None):
    """As decode_launcher, for mla_paged_prefill. ``kernel`` ("mma" or
    "first") overrides ``prefill_route``, for a measurement."""
    what = "mla_paged_prefill"
    _check_cuda(what, q_nope_eff, q_pe, ckv_pages, kpe_pages, page_tables,
                lengths, valid)
    c, h, s, _ = q_nope_eff.shape
    dt = q_nope_eff.dtype
    kernel = kernel or prefill_route(dt)
    if kernel == "mma" and dt != torch.bfloat16:
        raise ValueError(f"{what}: mla_prefill_mma_kernel takes bfloat16")
    out = torch.empty_like(q_nope_eff)
    lib = _build.lib("paged_attention")
    page, pmax = ckv_pages.shape[1], page_tables.shape[1]
    if kernel == "mma":
        fn = lib.kt_mla_prefill_mma
        mode = prefill_plan(c, h, s, sm_count(out.device))
    else:  # the first version's last int is the dtype flag
        fn, mode = lib.kt_mla_paged_prefill, int(dt == torch.bfloat16)

    def launch():
        err = fn(
            q_nope_eff.data_ptr(), q_pe.data_ptr(), ckv_pages.data_ptr(),
            kpe_pages.data_ptr(), page_tables.data_ptr(), lengths.data_ptr(),
            valid.data_ptr(), c, h, s, page, pmax, float(scale), mode,
            out.data_ptr(), torch.cuda.current_stream(out.device).cuda_stream,
        )
        _build.check(err, what)

    return launch, out


def mla_paged_decode(q_nope_eff, q_pe, ckv_pages, kpe_pages, page_tables,
                     lengths, scale: float) -> torch.Tensor:
    """One query token per sequence over its pages; [B, H, R] in the
    compressed space.

    q_nope_eff [B, H, R] absorbed query; q_pe [B, H, Dr] roped; ckv_pages
    [P, page, R]; kpe_pages [P, page, Dr]; page_tables [B, Pmax] int32;
    lengths [B] int32 = valid KV length INCLUDING the current token. An
    inactive row of a fixed-shape batch (zero table, length 1) reads row 0
    of page 0 and gives a finite, ignored result."""
    what = "mla_paged_decode"
    if q_nope_eff.dim() != 3:
        raise ValueError(f"{what}: q_nope_eff must be [B, H, R]")
    _check_common(what, q_nope_eff, q_pe, ckv_pages, kpe_pages, page_tables,
                  lengths, q_nope_eff.shape[:1])
    if device_kind(q_nope_eff, what) == "cpu":
        return mla_paged_decode_ref(q_nope_eff, q_pe, ckv_pages, kpe_pages,
                                    page_tables, lengths, scale)
    kernel = decode_route(q_nope_eff.dtype)
    launch, out = decode_launcher(q_nope_eff, q_pe, ckv_pages, kpe_pages,
                                  page_tables, lengths, scale, kernel)
    launch()
    LAUNCHES[what] += 1
    if kernel in DECODE_KERNEL_NAMES:
        ROUTED_LAUNCHES[DECODE_KERNEL_NAMES[kernel]] += 1
    return out


def mla_paged_prefill(q_nope_eff, q_pe, ckv_pages, kpe_pages, page_tables,
                      lengths, valid, scale: float) -> torch.Tensor:
    """Causal attention of a chunk of S new tokens per sequence over its
    pages, the chunk's KV already written; [C, H, S, R].

    q_nope_eff [C, H, S, R]; q_pe [C, H, S, Dr] roped; lengths [C] int32 =
    OLD cached length (chunk excluded); valid [C] int32 = live tokens of
    the chunk (rows qs >= valid are padding and come back finite)."""
    what = "mla_paged_prefill"
    if q_nope_eff.dim() != 4:
        raise ValueError(f"{what}: q_nope_eff must be [C, H, S, R]")
    _check_common(what, q_nope_eff, q_pe, ckv_pages, kpe_pages, page_tables,
                  lengths, q_nope_eff.shape[:1])
    if tuple(valid.shape) != tuple(lengths.shape) or valid.dtype != torch.int32:
        raise ValueError(f"{what}: valid must be int32 [C]")
    if device_kind(q_nope_eff, what) == "cpu":
        return mla_paged_prefill_ref(q_nope_eff, q_pe, ckv_pages, kpe_pages,
                                     page_tables, lengths, valid, scale)
    kernel = prefill_route(q_nope_eff.dtype)
    launch, out = prefill_launcher(q_nope_eff, q_pe, ckv_pages, kpe_pages,
                                   page_tables, lengths, valid, scale, kernel)
    launch()
    LAUNCHES[what] += 1
    if kernel in PREFILL_KERNEL_NAMES:
        ROUTED_LAUNCHES[PREFILL_KERNEL_NAMES[kernel]] += 1
    return out


# ---- GQA ----

# head dims the kernels take: 128, and Qwen3-Next's 256 (every kernel of
# csrc/gqa_paged_attention.cu is instantiated for both)
GQA_KERNEL_D = (128, 256)
GQA_KERNEL_GMAX = 16  # query heads per KV head the float32 decode takes
# gqa_decode_split_kernel (csrc/gqa_paged_attention.cu): the G query heads
# of a KV head are the rows of one mma row group; a split takes a multiple
# of GQA_DECODE_UNIT keys, at least GQA_DECODE_MIN_SPAN (one tile); at most
# GQA_DECODE_MAX_SPLITS splits (one merge record a lane), each writing a
# record of m [16], l [16] and acc [16, D] floats; the plan fills the card
# with GQA_DECODE_BLOCKS_PER_SM[D] blocks an SM, as many as the kernel's
# shared memory lets one SM hold (two at D = 128, one at D = 256)
GQA_SPLIT_GMAX = 16
GQA_DECODE_UNIT = 16
GQA_DECODE_MIN_SPAN = 64
GQA_DECODE_MAX_SPLITS = 32
GQA_DECODE_BLOCKS_PER_SM = {128: 2, 256: 1}


def gqa_decode_rec(d: int) -> int:
    """Floats of one split's record at head dim d: m [16], l [16], acc
    [16, d]."""
    return 2 * GQA_SPLIT_GMAX + GQA_SPLIT_GMAX * d


GQA_DECODE_KERNEL_NAMES = {"split": "gqa_decode_split_kernel"}
# gqa_prefill_mma_kernel (csrc/gqa_paged_attention.cu): a block holds one
# of GQA_PREFILL_ROWS flattened (position, head) query rows of one KV head
# with 8 warps (at 64 rows two warps a 16-row group, splitting the keys)
GQA_PREFILL_ROWS = (64, 128)
GQA_PREFILL_KERNEL_NAMES = {"mma": "gqa_prefill_mma_kernel"}


def gqa_decode_route(dtype: torch.dtype) -> str:
    """The kernel of a CUDA gqa_paged_decode call: "split"
    (gqa_decode_split_kernel) for bf16 operands, "first"
    (gqa_paged_decode_kernel and its combine launch) for float32."""
    return "split" if dtype == torch.bfloat16 else "first"


def gqa_decode_split_plan(b: int, hkv: int, capacity: int, sms: int,
                          d: int = 128) -> int:
    """Splits a (sequence, KV head) of a gqa_decode_split_kernel launch over
    pools of ``capacity`` = pmax * page positions a sequence at head dim
    ``d``: the most for which (B x Hkv x splits) blocks fit the card at
    once (GQA_DECODE_BLOCKS_PER_SM[d] blocks an SM), at most
    GQA_DECODE_MAX_SPLITS and no more than the
    capacity's tiles. On the H100 at Mixtral's serving batch (B = 8, Hkv =
    8) that is 4, which beat 5 and 8 at window 0 and 512
    (ops/cuda/split_sweep.py). A pure function of the shapes: the lengths
    stay on the card, where each block cuts its sequence's keys
    (gqa_decode_split_rows)."""
    fit = GQA_DECODE_BLOCKS_PER_SM[d] * sms // (b * hkv)
    return max(1, min(fit, GQA_DECODE_MAX_SPLITS,
                      -(-capacity // GQA_DECODE_MIN_SPAN)))


def gqa_decode_split_rows(length: int, window: int, splits: int) -> list:
    """The keys [start, end) each split of gqa_decode_split_kernel takes of
    a sequence of ``length`` live keys (as the kernel's split_chunk cuts
    them): the keys the query sees, [kbeg, length) with kbeg = max(0,
    length - window) under a window, in runs of max(GQA_DECODE_MIN_SPAN,
    ceil(n / splits) rounded up to GQA_DECODE_UNIT) keys; splits past the
    last key get an empty run."""
    kbeg = max(0, length - window) if window > 0 else 0
    per = -(-(length - kbeg) // splits)
    chunk = max(GQA_DECODE_MIN_SPAN,
                -(-per // GQA_DECODE_UNIT) * GQA_DECODE_UNIT)
    return [(kbeg + j * chunk, min(length, kbeg + (j + 1) * chunk))
            for j in range(splits)]


def gqa_prefill_route(dtype: torch.dtype) -> str:
    """The kernel of a CUDA gqa_paged_prefill call: "mma"
    (gqa_prefill_mma_kernel) for bf16 operands, "first"
    (gqa_paged_prefill_kernel) for float32. No other call takes the first
    version."""
    return "mma" if dtype == torch.bfloat16 else "first"


def gqa_prefill_plan(c: int, h: int, hkv: int, s: int, sms: int) -> int:
    """Flattened query rows a block of gqa_prefill_mma_kernel: 128 (each
    staged K / V tile serving 128 rows) where that gives more than one
    block for every two SMs, else 64 (twice the blocks, each tile's keys
    split between the two warps of a row group). On the H100 at Mixtral's
    widths 64 won at 64 blocks of 128 rows (C = 1, S = 256), 128 at 128
    and 256 (C = 2, S = 256; S = 512) (ops/cuda/split_sweep.py)."""
    blocks = c * hkv * -(-(h // hkv) * s // 128)
    return 128 if 2 * blocks > sms else 64


def gqa_paged_decode_ref(q, k_pages, v_pages, page_tables, lengths,
                         scale: float, window: int = 0):
    """Plain version: gather the pages, masked softmax in float32 over
    kpos < lengths (and kpos >= lengths - window with a window). A row
    with no live key gives zeros."""
    b, h, d = q.shape
    hkv = k_pages.shape[2]
    live = lengths.to(torch.int64)
    k = _live_rows(k_pages, page_tables, live)  # [B, Smax, Hkv, D]
    v = _live_rows(v_pages, page_tables, live)
    kpos = torch.arange(k.shape[1], device=k.device)[None, :]
    ok = kpos < live[:, None]
    if window > 0:
        ok = ok & (kpos >= live[:, None] - window)
    qg = q.to(torch.float32).reshape(b, hkv, h // hkv, d)
    scores = torch.einsum("bkgd,bskd->bkgs", qg, k) * scale
    ctx = _masked_softmax_ctx(scores, ok[:, None, None].expand_as(scores), v,
                              "bkgs,bskd->bkgd")
    return ctx.reshape(b, h, d).to(q.dtype)


def gqa_paged_prefill_ref(q, k_pages, v_pages, page_tables, lengths, valid,
                          scale: float, window: int = 0):
    """Plain version: query row qs (position lengths + qs) sees kpos <=
    lengths + qs, kpos < lengths + valid and, with a window, kpos >
    lengths + qs - window. Rows qs >= valid are padding: they see every live
    key (in the window) and come back finite."""
    c, h, s, d = q.shape
    hkv = k_pages.shape[2]
    old = lengths.to(torch.int64)
    live = old + valid.to(torch.int64)
    k = _live_rows(k_pages, page_tables, live)
    v = _live_rows(v_pages, page_tables, live)
    kpos = torch.arange(k.shape[1], device=k.device)[None, None, :]
    qpos = (old[:, None]
            + torch.arange(s, device=q.device)[None, :])[..., None]
    ok = (kpos <= qpos) & (kpos < live[:, None, None])
    if window > 0:
        ok = ok & (kpos > qpos - window)
    qg = q.to(torch.float32).reshape(c, hkv, h // hkv, s, d)
    scores = torch.einsum("ckgqd,cskd->ckgqs", qg, k) * scale
    ctx = _masked_softmax_ctx(scores, ok[:, None, None].expand_as(scores), v,
                              "ckgqs,cskd->ckgqd")
    return ctx.reshape(c, h, s, d).to(q.dtype)


def _check_gqa(what, q, k_pages, v_pages, page_tables, lengths, b):
    h, d = q.shape[1], q.shape[-1]
    if (k_pages.dim() != 4 or k_pages.shape != v_pages.shape
            or k_pages.shape[-1] != d):
        raise ValueError(f"{what}: pools are {tuple(k_pages.shape)} / "
                         f"{tuple(v_pages.shape)}, want [P, page, Hkv, {d}]")
    if h % k_pages.shape[2]:
        raise ValueError(f"{what}: {h} query heads over {k_pages.shape[2]} "
                         "KV heads")
    if page_tables.dim() != 2 or page_tables.shape[0] != b:
        raise ValueError(f"{what}: page_tables must be [{b}, Pmax]")
    if tuple(lengths.shape) != (b,):
        raise ValueError(f"{what}: lengths must be [{b}]")
    if page_tables.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise ValueError(f"{what}: page_tables and lengths must be int32")


def _check_gqa_cuda(what, q, k_pages, v_pages, *ints):
    if q.shape[-1] not in GQA_KERNEL_D:
        raise ValueError(f"{what}: kernel takes D in {GQA_KERNEL_D}; got "
                         f"{q.shape[-1]}")
    dt = q.dtype
    if dt not in (torch.float32, torch.bfloat16) or any(
            t.dtype != dt for t in (k_pages, v_pages)):
        raise ValueError(f"{what}: queries and pools must share float32 or "
                         "bfloat16")
    check_cuda_operands(what, q.device, q, k_pages, v_pages, *ints)


def gqa_decode_launcher(q, k_pages, v_pages, page_tables, lengths,
                        scale: float, window: int = 0,
                        kernel: str | None = None):
    """Checks a CUDA call and allocates its output; returns (launch, out),
    where launch() runs only the kernel. ``kernel`` ("split" or "first")
    overrides ``gqa_decode_route``, for a measurement."""
    what = "gqa_paged_decode"
    _check_gqa_cuda(what, q, k_pages, v_pages, page_tables, lengths)
    b, h, _ = q.shape
    hkv = k_pages.shape[2]
    kernel = kernel or gqa_decode_route(q.dtype)
    if kernel == "split" and q.dtype != torch.bfloat16:
        raise ValueError(f"{what}: gqa_decode_split_kernel takes bfloat16")
    gmax = GQA_SPLIT_GMAX if kernel == "split" else GQA_KERNEL_GMAX
    if h // hkv > gmax:
        raise ValueError(f"{what}: kernel takes at most {gmax} query heads "
                         f"per KV head; got {h // hkv}")
    out = torch.empty_like(q)
    lib = _build.lib("gqa_paged_attention")
    page, pmax = k_pages.shape[1], page_tables.shape[1]
    d = q.shape[-1]
    if kernel == "split":
        dev = out.device
        splits = gqa_decode_split_plan(b, hkv, pmax * page, sm_count(dev),
                                       d)
        part = cnt = None
        if splits > 1:
            part, cnt = scratch(dev, b * hkv * splits * gqa_decode_rec(d),
                                b * hkv, "gqa_decode_split")

        def launch_split():
            err = lib.kt_gqa_decode_split(
                q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                page_tables.data_ptr(), lengths.data_ptr(), b, h, hkv, page,
                pmax, int(window), splits, float(scale), d,
                None if part is None else part.data_ptr(),
                None if cnt is None else cnt.data_ptr(), out.data_ptr(),
                torch.cuda.current_stream(dev).cuda_stream,
            )
            _build.check(err, what)

        return launch_split, out
    # per (sequence, KV head, piece of the key range): G maxima, G sums and
    # G x D context sums, merged by the kernel's second launch
    pieces = lib.kt_gqa_decode_pieces(page, pmax)
    part = torch.empty(b * pieces * h * (q.shape[-1] + 2) if pieces > 1
                       else 0, dtype=torch.float32, device=q.device)
    is_bf16 = int(q.dtype == torch.bfloat16)

    def launch():
        err = lib.kt_gqa_paged_decode(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            page_tables.data_ptr(), lengths.data_ptr(), b, h, hkv, page, pmax,
            int(window), float(scale), is_bf16, d, out.data_ptr(),
            part.data_ptr(), torch.cuda.current_stream(out.device).cuda_stream,
        )
        _build.check(err, what)

    return launch, out


def gqa_prefill_launcher(q, k_pages, v_pages, page_tables, lengths, valid,
                         scale: float, window: int = 0,
                         kernel: str | None = None):
    """As gqa_decode_launcher, for gqa_paged_prefill. ``kernel`` ("mma"
    or "first") overrides ``gqa_prefill_route``, for a measurement."""
    what = "gqa_paged_prefill"
    _check_gqa_cuda(what, q, k_pages, v_pages, page_tables, lengths, valid)
    c, h, s, _ = q.shape
    hkv = k_pages.shape[2]
    kernel = kernel or gqa_prefill_route(q.dtype)
    if kernel == "mma" and q.dtype != torch.bfloat16:
        raise ValueError(f"{what}: gqa_prefill_mma_kernel takes bfloat16")
    out = torch.empty_like(q)
    lib = _build.lib("gqa_paged_attention")
    page, pmax = k_pages.shape[1], page_tables.shape[1]
    if kernel == "mma":
        fn = lib.kt_gqa_prefill_mma
        mode = gqa_prefill_plan(c, h, hkv, s, sm_count(out.device))
    else:  # the first version's last int is the dtype flag
        fn, mode = lib.kt_gqa_paged_prefill, int(q.dtype == torch.bfloat16)

    def launch():
        err = fn(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            page_tables.data_ptr(), lengths.data_ptr(), valid.data_ptr(), c,
            h, hkv, s, page, pmax, int(window), float(scale), mode,
            q.shape[-1], out.data_ptr(),
            torch.cuda.current_stream(out.device).cuda_stream,
        )
        _build.check(err, what)

    return launch, out


def gqa_paged_decode(q, k_pages, v_pages, page_tables, lengths, scale: float,
                     window: int = 0) -> torch.Tensor:
    """One query token per sequence over its k / v pages; [B, H, D].

    q [B, H, D] roped; k_pages / v_pages [P, page, Hkv, D]; page_tables
    [B, Pmax] int32; lengths [B] int32 = valid KV length INCLUDING the
    current token; window > 0 keeps only the last ``window`` keys. An
    inactive row of a fixed-shape batch (zero table, length 1) reads row 0
    of page 0 and gives a finite, ignored result."""
    what = "gqa_paged_decode"
    if q.dim() != 3:
        raise ValueError(f"{what}: q must be [B, H, D]")
    _check_gqa(what, q, k_pages, v_pages, page_tables, lengths, q.shape[0])
    if device_kind(q, what) == "cpu":
        return gqa_paged_decode_ref(q, k_pages, v_pages, page_tables,
                                    lengths, scale, window)
    kernel = gqa_decode_route(q.dtype)
    launch, out = gqa_decode_launcher(q, k_pages, v_pages, page_tables,
                                      lengths, scale, window, kernel)
    launch()
    LAUNCHES[what] += 1
    if kernel in GQA_DECODE_KERNEL_NAMES:
        ROUTED_LAUNCHES[GQA_DECODE_KERNEL_NAMES[kernel]] += 1
    return out


def gqa_paged_prefill(q, k_pages, v_pages, page_tables, lengths, valid,
                      scale: float, window: int = 0) -> torch.Tensor:
    """Causal attention of a chunk of S new tokens per sequence over its
    k / v pages, the chunk's KV already written; [C, H, S, D].

    q [C, H, S, D] roped; lengths [C] int32 = OLD cached length (chunk
    excluded); valid [C] int32 = live tokens of the chunk (rows qs >= valid
    are padding and come back finite)."""
    what = "gqa_paged_prefill"
    if q.dim() != 4:
        raise ValueError(f"{what}: q must be [C, H, S, D]")
    _check_gqa(what, q, k_pages, v_pages, page_tables, lengths, q.shape[0])
    if (tuple(valid.shape) != tuple(lengths.shape)
            or valid.dtype != torch.int32):
        raise ValueError(f"{what}: valid must be int32 [C]")
    if device_kind(q, what) == "cpu":
        return gqa_paged_prefill_ref(q, k_pages, v_pages, page_tables,
                                     lengths, valid, scale, window)
    kernel = gqa_prefill_route(q.dtype)
    launch, out = gqa_prefill_launcher(q, k_pages, v_pages, page_tables,
                                       lengths, valid, scale, window, kernel)
    launch()
    LAUNCHES[what] += 1
    if kernel in GQA_PREFILL_KERNEL_NAMES:
        ROUTED_LAUNCHES[GQA_PREFILL_KERNEL_NAMES[kernel]] += 1
    return out
