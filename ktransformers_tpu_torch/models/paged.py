"""Paged-KV forward: the serving engine's model step (counterpart of
ktransformers_tpu/models/paged.py; MLA and GQA attention).

Same math as models/model.py ``forward``, but the KV cache is a page pool
(cache/paged.py) addressed through per-sequence page tables. Two entry
points:
- ``forward_paged(tokens [B, S], page_tables, lengths)``: a chunked
  prefill (S > 1) or a batched decode step (S == 1);
- ``forward_paged_mixed``: the decode batch and C prefill chunks in ONE
  pass over the weights.
Attention goes through ops/cuda/paged_attention.py (mla_paged_decode /
mla_paged_prefill, gqa_paged_decode / gqa_paged_prefill), which read the
pool through the page table; rope and the page writes happen here, before
the kernels run. The pools are updated IN PLACE and the same PagedKVCache
is returned.

The JAX package switches its plain paged attention to the blockwise forms
past BLOCKWISE_KV_THRESHOLD positions (its models/paged.py:240, :358). Here
no switch is needed: the paged kernels (rows 12-15 of PERF.md's table)
walk the pages in tiles of keys on the card, so no score tensor of the
whole cache is made. Their plain versions, which run only for CPU tensors
(the tests' small pools), gather the pages whole.

A hybrid model's GatedDeltaNet layers (qwen3-next) hold no pages: they
read and write their O(1) state at the rows' slots (``slots``, the decode
batch's rows by default), and padding (``valid``) leaves it untouched. The
fused mixed step refuses a hybrid model, as in the JAX package. A windowed
layer (smallthinker) hands its window to the paged kernels; a NoPE layer
skips rope; qwen3-next's attention output is gated.

Sparse long-context decode (ops/sparse_attention.py): where the cache
keeps page summaries, every step updates them, in place, with the keys it
writes (padding rows into the trash page 0); with ``sparse_budget`` each
decode row (S == 1, and on GQA layers without a window) attends only the
top-``sparse_budget`` pages its anchor scores select, in plain PyTorch,
instead of the paged decode kernel; prefill chunks stay dense. A budget
without summaries raises.

``collect_routing`` (forward_paged) also returns each MoE layer's routed
ids [n_moe_layers, B*S, k], logical ids before any fused shared expert or
expert map: the serving engine's routing statistics for expert
re-placement (the JAX package's models/paged.py:774, 798, 890). Under a
parallel context the layers split and combine as in models/model.py.
"""

from __future__ import annotations

import torch

from ktransformers_tpu_torch.cache.paged import PagedKVCache
from ktransformers_tpu_torch.models.model import (
    early_router_input,
    gqa_gate,
    gqa_project_rope,
    gqa_qkv_proj,
    gqa_rope,
    gqa_scale,
    gqa_split_gate,
    linear_layer_state,
    lm_head_logits,
    mla_qkv_proj,
    mlp,
    o_proj,
)
from ktransformers_tpu_torch.models.spec import ModelSpec
from ktransformers_tpu_torch.ops.cuda.paged_attention import (
    gqa_paged_decode,
    gqa_paged_prefill,
    mla_paged_decode,
    mla_paged_prefill,
)
from ktransformers_tpu_torch.ops.norm import rms_norm
from ktransformers_tpu_torch.ops.sparse_attention import (
    ANCHOR_PLANE,
    check_sparse_kinds,
    sparse_gqa_decode,
    sparse_mla_decode,
    update_page_summaries_cfg,
)
from ktransformers_tpu_torch.ops.rope import (
    apply_rope,
    precompute_rope_tables,
    rope_attention_scale,
)


def _page_ids(page_tables, lengths, s: int, page_size: int, valid=None):
    """(pid, pos) [B, S]: the page and position of each new row; rows
    j >= valid[b] (padding) go to page 0, the trash page, and the table
    index is clamped into the table before the lookup."""
    dev = page_tables.device
    pos = lengths.to(torch.int64)[:, None] + torch.arange(s, device=dev)[None]
    pidx = torch.clamp(pos // page_size, 0, page_tables.shape[1] - 1)
    pid = torch.gather(page_tables.to(torch.int64), 1, pidx)  # [B, S]
    if valid is not None:
        keep = torch.arange(s, device=dev)[None, :] < valid[:, None]
        pid = torch.where(keep, pid, torch.zeros_like(pid))
    return pid, pos


def _write_pages(buf, new, page_tables, lengths, page_size, valid=None):
    """Scatter new [B, S, ...] into the pages at positions lengths[b] + j,
    in place; returns buf.

    ``valid`` [B] (optional): rows j >= valid[b] are padding (bucketed
    prefill chunks). Their writes are redirected to page 0 (the serving
    engine's trash page) at slot pos % page; several may land on one slot,
    in no defined order, which is harmless only there."""
    b, s = new.shape[:2]
    pid, pos = _page_ids(page_tables, lengths, s, page_size, valid)
    slot = pos % page_size
    buf[pid.reshape(-1), slot.reshape(-1)] = new.reshape(
        b * s, *new.shape[2:]).to(buf.dtype)
    return buf


def _summarize(summ, keys, page_tables, lengths, page_size, valid=None):
    """Fold the keys [B, S, ...] just written into the layer's summary
    planes (in place), when the cache keeps them."""
    if summ is not None:
        pid, pos = _page_ids(page_tables, lengths, keys.shape[1], page_size,
                             valid)
        update_page_summaries_cfg(summ, keys, pid, pos, page_size)


def _sparse_mla(q_nope, q_pe, bufs, summ, tables, lengths, page_size, scale,
                sparse):
    """Sparse MLA decode of rows [B, H, R] / [B, H, Dr] over the pages
    their anchors select: [B, H, 1, R] float32."""
    budget, anchor, retrieval = sparse
    return sparse_mla_decode(
        q_nope.to(torch.float32), q_pe.to(torch.float32), bufs[0], bufs[1],
        summ["smin"], summ["smax"], tables, lengths + 1, page_size, budget,
        scale, anchor=anchor, retrieval=retrieval, planes=summ)[:, :, None]


def _sparse_gqa(q, bufs, summ, tables, lengths, page_size, scale, sparse):
    """Sparse GQA decode of rows q [B, H, D]: [B, H, D] float32."""
    budget, anchor, retrieval = sparse
    return sparse_gqa_decode(
        q, bufs[0], bufs[1], summ["smin"], summ["smax"], tables, lengths + 1,
        page_size, budget, scale, anchor=anchor, retrieval=retrieval,
        planes=summ)


def _scale(spec: ModelSpec) -> float:
    a = spec.attention
    return a.softmax_scale or (
        (a.qk_nope_head_dim + a.qk_rope_head_dim) ** -0.5
        * rope_attention_scale(spec.rope))


def _split_rope_absorb(p, spec: ModelSpec, q, k_pe, rope_cs, dtype):
    """q [B, S, H, nope + dr] and k_pe [B, S, dr] -> absorbed q_nope
    [B, H, S, R], roped q_pe [B, H, S, dr], roped k_pe [B, S, dr]."""
    nope = spec.attention.qk_nope_head_dim
    cos, sin = rope_cs
    inter = spec.rope.interleaved
    q_pe = apply_rope(q[..., nope:].transpose(1, 2), cos[:, None],
                      sin[:, None], interleaved=inter)
    k_pe = apply_rope(k_pe, cos, sin, interleaved=inter)
    q_nope_eff = torch.einsum(
        "bshn,hnr->bhsr", q[..., :nope].to(torch.float32),
        p["w_uk"].to(torch.float32)).to(dtype)
    return q_nope_eff, q_pe, k_pe


def _unabsorb(p, spec: ModelSpec, ctx, dtype):
    """ctx [B, H, S, R] -> [B, S, H * v]."""
    out = torch.einsum("bhsr,hrv->bshv", ctx.to(torch.float32),
                       p["w_uv"].to(torch.float32)).to(dtype)
    return out.reshape(out.shape[0], out.shape[1], -1)


def _mla_paged(p, spec: ModelSpec, x, bufs, page_tables, lengths, rope_cs,
               page_size, valid=None, summ=None, sparse=None):
    """x [B, S, d] -> (attention output [B, S, d], (buf_a, buf_b)); the
    layer's summary planes ``summ`` (or None) take the new keys, and with
    ``sparse`` (budget, anchor, retrieval) a decode step attends the pages
    they select."""
    a = spec.attention
    b, s, _ = x.shape
    h, r = a.num_heads, a.kv_lora_rank
    q, ckv_kpe = mla_qkv_proj(p, spec, x)
    q = q.reshape(b, s, h, a.qk_nope_head_dim + a.qk_rope_head_dim)
    ckv = rms_norm(ckv_kpe[..., :r], p["kv_a_norm"], spec.rms_norm_eps)
    q_nope_eff, q_pe, k_pe = _split_rope_absorb(
        p, spec, q, ckv_kpe[..., r:], rope_cs, x.dtype)
    buf_a = _write_pages(bufs[0], ckv, page_tables, lengths, page_size, valid)
    buf_b = _write_pages(bufs[1], k_pe, page_tables, lengths, page_size,
                         valid)
    _summarize(summ, torch.cat([ckv, k_pe], -1), page_tables, lengths,
               page_size, valid)
    scale = _scale(spec)
    if s == 1 and sparse is not None:
        ctx = _sparse_mla(q_nope_eff[:, :, 0], q_pe[:, :, 0], (buf_a, buf_b),
                          summ, page_tables, lengths, page_size, scale,
                          sparse)
    elif s == 1:
        # the kernel's lengths include the token just written
        ctx = mla_paged_decode(
            q_nope_eff[:, :, 0].contiguous(), q_pe[:, :, 0].contiguous(),
            buf_a, buf_b, page_tables, lengths + 1, scale)[:, :, None]
    else:
        v_arr = valid if valid is not None else torch.full_like(lengths, s)
        ctx = mla_paged_prefill(
            q_nope_eff.contiguous(), q_pe.contiguous(), buf_a, buf_b,
            page_tables, lengths, v_arr, scale)
    out = _unabsorb(p, spec, ctx, x.dtype)
    return o_proj(p, out), (buf_a, buf_b)


def _mla_paged_mixed(p, spec: ModelSpec, rows, bufs, dec_tables, dec_lengths,
                     pre_table, pre_length, pre_valid, dec_rope_cs,
                     pre_rope_cs, page_size, b_dec, s_pre, summ=None,
                     sparse=None):
    """Mixed-step MLA attention: ONE projection / output pass over the
    concatenated decode + prefill rows [1, B + C*S, d]; the attention core
    splits into mla_paged_decode (B rows; the sparse decode with
    ``sparse``) and mla_paged_prefill (C chunks of S tokens, distinct
    queries)."""
    a = spec.attention
    h, r, dr = a.num_heads, a.kv_lora_rank, a.qk_rope_head_dim
    hd = a.qk_nope_head_dim + dr
    c_pre = pre_table.shape[0]

    q, ckv_kpe = mla_qkv_proj(p, spec, rows)
    q = q[0]
    ckv_all = rms_norm(ckv_kpe[0, :, :r], p["kv_a_norm"], spec.rms_norm_eps)
    kpe_all = ckv_kpe[0, :, r:]

    qn_d, qpe_d, kpe_d = _split_rope_absorb(
        p, spec, q[:b_dec].reshape(b_dec, 1, h, hd),
        kpe_all[:b_dec].reshape(b_dec, 1, dr), dec_rope_cs, rows.dtype)
    qn_p, qpe_p, kpe_p = _split_rope_absorb(
        p, spec, q[b_dec:].reshape(c_pre, s_pre, h, hd),
        kpe_all[b_dec:].reshape(c_pre, s_pre, dr), pre_rope_cs, rows.dtype)
    ckv_d = ckv_all[:b_dec].reshape(b_dec, 1, r)
    ckv_p = ckv_all[b_dec:].reshape(c_pre, s_pre, r)

    # cache writes before any read: decode rows first, then the chunks,
    # on disjoint page sets (padding rows all go to the trash page)
    buf_a = _write_pages(bufs[0], ckv_d, dec_tables, dec_lengths, page_size)
    buf_b = _write_pages(bufs[1], kpe_d, dec_tables, dec_lengths, page_size)
    buf_a = _write_pages(buf_a, ckv_p, pre_table, pre_length, page_size,
                         pre_valid)
    buf_b = _write_pages(buf_b, kpe_p, pre_table, pre_length, page_size,
                         pre_valid)
    _summarize(summ, torch.cat([ckv_d, kpe_d], -1), dec_tables, dec_lengths,
               page_size)
    _summarize(summ, torch.cat([ckv_p, kpe_p], -1), pre_table, pre_length,
               page_size, pre_valid)

    scale = _scale(spec)
    if sparse is not None:
        ctx_d = _sparse_mla(qn_d[:, :, 0], qpe_d[:, :, 0], (buf_a, buf_b),
                            summ, dec_tables, dec_lengths, page_size, scale,
                            sparse)
    else:
        ctx_d = mla_paged_decode(
            qn_d[:, :, 0].contiguous(), qpe_d[:, :, 0].contiguous(), buf_a,
            buf_b, dec_tables, dec_lengths + 1, scale)[:, :, None]
    ctx_p = mla_paged_prefill(
        qn_p.contiguous(), qpe_p.contiguous(), buf_a, buf_b, pre_table,
        pre_length, pre_valid, scale)  # [C, H, S, R]

    out_rows = torch.cat(
        [_unabsorb(p, spec, ctx_d, rows.dtype).reshape(b_dec, -1),
         _unabsorb(p, spec, ctx_p, rows.dtype).reshape(c_pre * s_pre, -1)],
        dim=0)[None]  # [1, B + C*S, H*v]
    return o_proj(p, out_rows), (buf_a, buf_b)


def _gqa_paged(p, spec: ModelSpec, x, bufs, page_tables, lengths, rope_cs,
               page_size, valid=None, use_rope: bool = True, window: int = 0,
               summ=None, sparse=None):
    """x [B, S, d] -> (attention output [B, S, d], (k pages, v pages));
    ``use_rope`` / ``window`` are the layer's; ``summ`` / ``sparse`` as
    in _mla_paged (a windowed layer keeps the paged decode kernel)."""
    b, s, _ = x.shape
    q, k, v, gate = gqa_project_rope(p, spec, x, rope_cs, use_rope)
    buf_a = _write_pages(bufs[0], k, page_tables, lengths, page_size, valid)
    buf_b = _write_pages(bufs[1], v, page_tables, lengths, page_size, valid)
    _summarize(summ, k, page_tables, lengths, page_size, valid)
    if s == 1 and sparse is not None and window == 0:
        out = _sparse_gqa(q[:, :, 0], (buf_a, buf_b), summ, page_tables,
                          lengths, page_size, gqa_scale(spec), sparse)
        out = out.to(x.dtype).reshape(b, 1, -1)
    elif s == 1:
        # the kernel's lengths include the token just written
        out = gqa_paged_decode(q[:, :, 0].contiguous(), buf_a, buf_b,
                               page_tables, lengths + 1, gqa_scale(spec),
                               window)
        out = out.reshape(b, 1, -1)
    else:
        v_arr = valid if valid is not None else torch.full_like(lengths, s)
        out = gqa_paged_prefill(q.contiguous(), buf_a, buf_b, page_tables,
                                lengths, v_arr, gqa_scale(spec), window)
        out = out.transpose(1, 2).reshape(b, s, -1)
    out = gqa_gate(out, gate)
    return o_proj(p, out), (buf_a, buf_b)


def _gqa_paged_mixed(p, spec: ModelSpec, rows, bufs, dec_tables, dec_lengths,
                     pre_table, pre_length, pre_valid, dec_rope_cs,
                     pre_rope_cs, page_size, b_dec, s_pre,
                     use_rope: bool = True, window: int = 0, summ=None,
                     sparse=None):
    """Mixed-step GQA attention (see _mla_paged_mixed): ONE projection /
    output pass over the B + C*S rows; the attention core splits into
    gqa_paged_decode (B rows; the sparse decode with ``sparse`` on a layer
    without a window) and gqa_paged_prefill (C chunks of S)."""
    a = spec.attention
    h, hkv, d = a.num_heads, a.num_kv_heads, a.head_dim
    c_pre = pre_table.shape[0]
    q_flat, k_flat, v_flat = gqa_qkv_proj(p, spec, rows)
    q_all, gate = gqa_split_gate(spec, q_flat[0])
    k_all = k_flat[0].reshape(-1, hkv, d)
    v_all = v_flat[0].reshape(-1, hkv, d)
    q_d, k_d = gqa_rope(p, spec, q_all[:b_dec, None], k_all[:b_dec, None],
                        dec_rope_cs, use_rope)
    q_p, k_p = gqa_rope(p, spec, q_all[b_dec:].reshape(c_pre, s_pre, h, d),
                        k_all[b_dec:].reshape(c_pre, s_pre, hkv, d),
                        pre_rope_cs, use_rope)
    v_d = v_all[:b_dec, None]
    v_p = v_all[b_dec:].reshape(c_pre, s_pre, hkv, d)

    # cache writes before any read: decode rows first, then the chunks,
    # on disjoint page sets (padding rows all go to the trash page)
    buf_a = _write_pages(bufs[0], k_d, dec_tables, dec_lengths, page_size)
    buf_b = _write_pages(bufs[1], v_d, dec_tables, dec_lengths, page_size)
    buf_a = _write_pages(buf_a, k_p, pre_table, pre_length, page_size,
                         pre_valid)
    buf_b = _write_pages(buf_b, v_p, pre_table, pre_length, page_size,
                         pre_valid)
    _summarize(summ, k_d, dec_tables, dec_lengths, page_size)
    _summarize(summ, k_p, pre_table, pre_length, page_size, pre_valid)

    scale = gqa_scale(spec)
    if sparse is not None and window == 0:
        out_d = _sparse_gqa(q_d[:, :, 0], (buf_a, buf_b), summ, dec_tables,
                            dec_lengths, page_size, scale,
                            sparse).to(rows.dtype)
    else:
        out_d = gqa_paged_decode(q_d[:, :, 0].contiguous(), buf_a, buf_b,
                                 dec_tables, dec_lengths + 1, scale,
                                 window)  # [B, H, D]
    out_p = gqa_paged_prefill(q_p.contiguous(), buf_a, buf_b, pre_table,
                              pre_length, pre_valid, scale,
                              window)  # [C, H, S, D]
    out_rows = torch.cat(
        [out_d.reshape(b_dec, h * d),
         out_p.transpose(1, 2).reshape(c_pre * s_pre, h * d)],
        dim=0)[None]  # [1, B + C*S, H*D]
    out_rows = gqa_gate(out_rows, gate)
    return o_proj(p, out_rows), (buf_a, buf_b)


def sparse_args(kv: PagedKVCache, spec: ModelSpec, budget, anchor: str,
                retrieval: str):
    """(budget, anchor, retrieval) for the attention calls, or None without
    a budget; raises ValueError for a budget the cache keeps no summaries
    for (the anchor's plane included) or kinds the attention does not
    take."""
    if budget is None:
        return None
    check_sparse_kinds(anchor, retrieval, spec.attention.kind)
    plane = ANCHOR_PLANE.get(anchor, "smin")
    if kv.smin is None or getattr(kv, plane) is None:
        raise ValueError(
            f"sparse_budget with the {anchor} anchor needs a cache made "
            f"with summaries=True, anchor={anchor!r} (no {plane} plane)")
    if budget < 1:
        raise ValueError(f"sparse_budget {budget} < 1")
    return (int(budget), anchor, retrieval)


@torch.no_grad()
def forward_paged_mixed(params, spec: ModelSpec, dec_tokens, pre_tokens,
                        kv: PagedKVCache, dec_tables, dec_lengths, pre_table,
                        pre_length, pre_valid, rope_tables=None,
                        compute_dtype=torch.bfloat16,
                        sparse_budget: int | None = None,
                        sparse_anchor: str = "quest",
                        sparse_retrieval: str = "layer"):
    """ONE model pass for a mixed scheduler batch: the decode batch and C
    prefill chunks (distinct queries) share every dense / MoE weights pass.

    dec_tokens [B]; pre_tokens [C, S] padded chunks ([S] accepted as
    C = 1); dec_tables [B, Pmax], dec_lengths [B]; pre_table [C, Pmax],
    pre_length [C] tokens already cached per query, pre_valid [C] live
    tokens of each chunk. Returns (dec_logits [B, V], pre_last_logits
    [C, V] at each chunk's last valid row, kv). A hybrid model (linear
    layers) raises: its engine runs decode and prefill apart. With
    ``sparse_budget`` the decode rows attend the top pages by their
    ``sparse_anchor`` scores (``sparse_retrieval``: a page set a sequence,
    a query head (MLA) or a KV head (GQA)); the chunks stay dense and
    update the summaries."""
    sparse = sparse_args(kv, spec, sparse_budget, sparse_anchor,
                         sparse_retrieval)
    if spec.hybrid:
        raise ValueError("forward_paged_mixed: the fused mixed step does "
                         "not run hybrid linear-attention layers")
    mla = spec.attention.kind == "mla"
    dev = dec_tokens.device
    b = dec_tokens.shape[0]
    if pre_tokens.dim() == 1:
        pre_tokens = pre_tokens[None]
    c, s = pre_tokens.shape
    x_d = params["embed"][dec_tokens].to(compute_dtype)
    x_p = params["embed"][pre_tokens.reshape(-1)].to(compute_dtype)
    rows = torch.cat([x_d, x_p], dim=0)[None]  # [1, B + C*S, d]

    if rope_tables is None:
        rope_tables = precompute_rope_tables(spec.rope, dev)
    cos_t, sin_t = rope_tables
    dec_pos = dec_lengths.to(torch.int64)[:, None]
    pre_pos = pre_length.to(torch.int64)[:, None] + torch.arange(
        s, device=dev)[None, :]
    dec_rope = (cos_t[dec_pos], sin_t[dec_pos])
    pre_rope = (cos_t[pre_pos], sin_t[pre_pos])

    for li, lp in enumerate(params["layers"]):
        res = rows
        router_x = early_router_input(spec, rows)
        xn = rms_norm(rows, lp["input_norm"], spec.rms_norm_eps)
        args = (lp["attn"], spec, xn, (kv.bufs_a[li], kv.bufs_b[li]),
                dec_tables, dec_lengths, pre_table, pre_length, pre_valid,
                dec_rope, pre_rope, kv.page_size, b, s)
        summ = kv.planes(li)
        attn_out, (kv.bufs_a[li], kv.bufs_b[li]) = (
            _mla_paged_mixed(*args, summ, sparse) if mla
            else _gqa_paged_mixed(*args, spec.layer_uses_rope(li),
                                  spec.layer_window(li), summ, sparse))
        rows = res + attn_out
        res = rows
        xn = rms_norm(rows, lp["post_attn_norm"], spec.rms_norm_eps)
        rows = res + mlp(lp, spec, xn, router_x)

    x = rms_norm(rows[0], params["final_norm"], spec.rms_norm_eps)
    # decode rows + each prefill chunk's last VALID row
    pre_last = (b + torch.arange(c, device=dev) * s
                + torch.clamp(pre_valid.to(torch.int64) - 1, min=0))
    sel = torch.cat([torch.arange(b, device=dev), pre_last])
    logits = lm_head_logits(params, x[sel])  # [B + C, V]
    return logits[:b], logits[b:], kv


@torch.no_grad()
def forward_paged(params, spec: ModelSpec, tokens, kv: PagedKVCache,
                  page_tables, lengths, rope_tables=None,
                  compute_dtype=torch.bfloat16, logits_last_only: bool = True,
                  valid=None, collect_routing: bool = False,
                  sparse_budget: int | None = None,
                  sparse_anchor: str = "quest",
                  sparse_retrieval: str = "layer", slots=None):
    """tokens [B, S] at positions lengths[b] + arange(S); page_tables
    [B, Pmax] int32; lengths [B] int32 tokens already cached.

    ``valid`` [B] int32: tokens[b, valid[b]:] are padding (bucketed prefill
    chunks, or the inactive rows of a hybrid model's decode batch); their
    KV writes go to the trash page, they leave a linear layer's state
    untouched and, with logits_last_only, the logits row is taken at
    position valid[b] - 1. ``slots`` [B] int64 (hybrid models): the state
    row of each batch row in the linear layers' buffers, arange(B) when
    None (the decode batch's rows are its slots). ``sparse_*`` as in
    forward_paged_mixed, for a decode step (S == 1). Returns (logits
    [B, 1 or S, V], kv), and with ``collect_routing`` the routed ids
    [n_moe_layers, B*S, k] as a third value; the pools, states and
    summaries are updated in place."""
    sparse = sparse_args(kv, spec, sparse_budget, sparse_anchor,
                         sparse_retrieval)
    routing = [] if collect_routing else None
    mla = spec.attention.kind == "mla"
    dev = tokens.device
    b, s = tokens.shape
    x = params["embed"][tokens].to(compute_dtype)
    if rope_tables is None:
        rope_tables = precompute_rope_tables(spec.rope, dev)
    cos_t, sin_t = rope_tables
    pos = lengths.to(torch.int64)[:, None] + torch.arange(
        s, device=dev)[None, :]
    rope_cs = (cos_t[pos], sin_t[pos])

    for li, lp in enumerate(params["layers"]):
        res = x
        router_x = early_router_input(spec, x)
        xn = rms_norm(x, lp["input_norm"], spec.rms_norm_eps)
        bufs = (kv.bufs_a[li], kv.bufs_b[li])
        if spec.layer_kind(li) == "linear":
            if slots is None:
                slots = torch.arange(b, device=dev)
            attn_out, conv, rec = linear_layer_state(
                lp["attn"], spec, xn, bufs[0][slots], bufs[1][slots], valid)
            bufs[0][slots] = conv
            bufs[1][slots] = rec
        elif mla:
            attn_out, _ = _mla_paged(lp["attn"], spec, xn, bufs, page_tables,
                                     lengths, rope_cs, kv.page_size, valid,
                                     kv.planes(li), sparse)
        else:
            attn_out, _ = _gqa_paged(
                lp["attn"], spec, xn, bufs, page_tables, lengths, rope_cs,
                kv.page_size, valid, spec.layer_uses_rope(li),
                spec.layer_window(li), kv.planes(li), sparse)
        x = res + attn_out
        res = x
        xn = rms_norm(x, lp["post_attn_norm"], spec.rms_norm_eps)
        x = res + mlp(lp, spec, xn, router_x, routing)

    x = rms_norm(x, params["final_norm"], spec.rms_norm_eps)
    if logits_last_only:
        if valid is not None:
            last = torch.clamp(valid.to(torch.int64) - 1, min=0)
            x = x[torch.arange(b, device=dev), last][:, None]
        else:
            x = x[:, -1:, :]
    if collect_routing:
        return lm_head_logits(params, x), kv, torch.stack(routing)
    return lm_head_logits(params, x), kv
