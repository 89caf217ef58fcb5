"""Sparse decode attention over the page pool: page summaries and top-K
page retrieval (counterpart of ktransformers_tpu/ops/sparse_attention.py).

Each KV page keeps small summaries of its keys; at decode the pages are
scored against the query, the top-``budget`` page-table slots are attended
and the rest skipped, so a step's attention reads O(budget * page) keys
instead of O(context). The page holding the current position is always
selected.

Anchors (the summary planes, per page and layer, of cache/paged.py):
- "quest": elementwise min / max of the page's keys; the score is the
  upper bound sum_d max(q_d * min_d, q_d * max_d) of any key's score;
- "block_max": q . (elementwise max);
- "block_mean": q . mean of the keys (the running sum over the page's live
  count);
- "fixed": q . the page's first key;
- "dynamic": q . an anchor key chosen by observed attention
  (``set_dynamic_anchors``, fed by ``snapkv_page_scores``).
Retrieval: "layer" (one page set a sequence, scores maxed over heads),
"qhead" (MLA: a page set per query head), "kvhead" (GQA: a page set per KV
head).

Plain PyTorch, as the JAX package's is plain XLA (gathers and a masked
softmax in float32); the selection's top-k runs on the device. Unlike the
JAX package, the pruned attention zeroes the keys and values of the rows
past a sequence's length before it reads them: there a zero softmax weight
times a NaN left in a recycled page's dead rows would reach the output.
Selected slots are compared as sets: ``torch.topk`` may order equal
bounds differently from ``jax.lax.top_k``, and the attention over the
selected pages does not depend on their order.

The planes are updated in place, as the pools are (models/paged.py). The
"first key of a page" writes (fixed) and the dynamic anchors' writes index
only the rows they write, chosen by a mask (which waits for the card once
a call); no write goes through an out-of-range index.
"""

from __future__ import annotations

import torch

NEG_INF = -1e30

ANCHOR_KINDS = ("quest", "block_max", "block_mean", "fixed", "dynamic")
RETRIEVAL_KINDS = ("layer", "kvhead", "qhead")
# the retrievals each attention kind takes
MLA_RETRIEVALS = ("layer", "qhead")
GQA_RETRIEVALS = ("layer", "kvhead")
# the planes each anchor reads besides smin / smax, which every cache with
# summaries holds
ANCHOR_PLANE = {"block_mean": "ssum", "fixed": "sfix", "dynamic": "sdyn"}


def check_sparse_kinds(anchor: str, retrieval: str, attention: str) -> None:
    """Raise ValueError for an anchor or retrieval the attention kind
    ("mla" or "gqa") does not take."""
    if anchor not in ANCHOR_KINDS:
        raise ValueError(f"sparse anchor {anchor!r}: one of {ANCHOR_KINDS}")
    allowed = MLA_RETRIEVALS if attention == "mla" else GQA_RETRIEVALS
    if retrieval not in allowed:
        raise ValueError(f"sparse retrieval {retrieval!r} for "
                         f"{attention.upper()} attention: one of {allowed}")


def _flat(new_k, pid):
    return (new_k.reshape(-1, *new_k.shape[2:]).to(torch.float32),
            pid.reshape(-1).to(torch.int64))


def _reduce(plane, idx, flat, how: str) -> None:
    """plane[idx[i]] = how(plane[idx[i]], flat[i]) elementwise, in place."""
    full = idx.reshape(-1, *([1] * (flat.dim() - 1))).expand_as(flat)
    plane.scatter_reduce_(0, full, flat, how)


def update_page_summaries(smin, smax, new_k, pid):
    """Elementwise min / max of new keys [B, S, ...] into their pages pid
    [B, S], in place; returns (smin, smax)."""
    flat, idx = _flat(new_k, pid)
    _reduce(smin, idx, flat, "amin")
    _reduce(smax, idx, flat, "amax")
    return smin, smax


def update_page_summaries_cfg(planes: dict, new_k, pid, pos,
                              page_size: int) -> dict:
    """Update the planes present in ``planes`` (name -> tensor or None of
    smin, smax, ssum, sfix) with new keys [B, S, ...] written at pages pid
    [B, S] and positions pos [B, S], in place; returns ``planes``."""
    flat, idx = _flat(new_k, pid)
    if planes.get("smin") is not None:
        _reduce(planes["smin"], idx, flat, "amin")
    if planes.get("smax") is not None:
        _reduce(planes["smax"], idx, flat, "amax")
    if planes.get("ssum") is not None:
        planes["ssum"].index_add_(0, idx, flat)
    if planes.get("sfix") is not None:
        # a page's fixed anchor is its first row's key: each row writes
        # the key of its page's first row where this call holds that row
        # (the same row of the same sequence, off = pos % page_size rows
        # back), else the page's anchor as it is. Rows of one page write
        # one value, and nothing is read back to the host, so a captured
        # decode step can take it
        b, s = pos.shape
        back = torch.arange(s, device=pos.device) - pos % page_size
        row = (torch.arange(b, device=pos.device)[:, None] * s
               + back.clamp(min=0)).reshape(-1)
        held = (back >= 0).reshape(-1, *([1] * (flat.dim() - 1)))
        fixed = planes["sfix"]
        fixed[idx] = torch.where(held, flat[row], fixed[idx])
    return planes


def set_dynamic_anchors(planes: dict, buf_k, page_tables, page_scores_tok,
                        lengths, page_size: int) -> dict:
    """DYNAMIC anchors: each live page's anchor is the key of its token
    with the highest observed mass (snapkv_page_scores' token_mass
    [B, Pmax, page]); buf_k [P, page, D...], page_tables [B, Pmax]. Writes
    planes["sdyn"] in place at the live pages only; returns planes."""
    _, pmax, _ = page_scores_tok.shape
    best = page_scores_tok.argmax(-1).reshape(-1)  # [B*Pmax]
    pid = page_tables.reshape(-1).to(torch.int64)
    base = torch.arange(pmax, device=lengths.device)[None, :] * page_size
    live = (base < lengths[:, None]).reshape(-1)
    keys = buf_k[pid[live], best[live]].to(torch.float32)
    planes["sdyn"][pid[live]] = keys
    return planes


def snapkv_page_scores(q_obs, buf_a, buf_b, page_tables, lengths,
                       page_size: int, scale: float, is_mla: bool = True):
    """SnapKV-style observation pass: the softmax mass of the observation
    window's queries (the last W positions, each causal) over the cached
    prefix, summed per (page, token). q_obs: MLA [B, W, H, R + Dr] (the
    absorbed latent query and the roped q_pe), GQA [B, W, H, D]. Returns
    (page_mass [B, Pmax], token_mass [B, Pmax, page])."""
    b, w, h = q_obs.shape[:3]
    pt = page_tables.to(torch.int64)
    k_a = buf_a[pt].to(torch.float32)  # [B, Pmax, page, ...]
    pmax, page = k_a.shape[1], k_a.shape[2]
    dev = q_obs.device
    pos = torch.arange(pmax * page, device=dev).reshape(pmax, page)
    live = pos[None] < lengths[:, None, None]  # [B, Pmax, page]
    if is_mla:
        keys = torch.cat([k_a, buf_b[pt].to(torch.float32)], -1)
        keys = torch.where(live[..., None], keys, 0.0)
        scores = torch.einsum("bwhd,bspd->bwhsp", q_obs.to(torch.float32),
                              keys)
    else:
        hkv = k_a.shape[3]
        keys = torch.where(live[..., None, None], k_a, 0.0)
        qg = q_obs.reshape(b, w, hkv, h // hkv, -1).to(torch.float32)
        scores = torch.einsum("bwkgd,bspkd->bwkgsp", qg, keys).reshape(
            b, w, h, pmax, page)
    scores = scores * scale
    scores = torch.where(live[:, None, None], scores, NEG_INF)
    # each window query at position lengths - W + w sees the keys up to it
    qpos = lengths[:, None].to(torch.int64) - w + torch.arange(
        w, device=dev)[None, :]
    causal = pos[None, None] <= qpos[:, :, None, None]  # [B, W, Pmax, page]
    scores = torch.where(causal[:, :, None], scores, NEG_INF)
    attn = torch.softmax(scores.reshape(b, w, h, -1), dim=-1).reshape(
        scores.shape)
    token_mass = attn.sum((1, 2))  # [B, Pmax, page]
    return token_mass.sum(-1), token_mass


def preselect_pages(page_mass, lengths, page_size: int, keep: int,
                    recent: int = 2):
    """Keep-mask [B, Pmax]: the top-``keep`` pages by observation mass, the
    ``recent`` newest live pages always among them."""
    b, pmax = page_mass.shape
    dev = page_mass.device
    last_slot = torch.clamp(lengths.to(torch.int64) - 1, min=0) // page_size
    slot = torch.arange(pmax, device=dev)[None]
    recent_mask = (slot > last_slot[:, None] - recent) & (
        slot <= last_slot[:, None])
    boosted = torch.where(recent_mask, torch.inf, page_mass)
    sel = torch.topk(boosted, min(keep, pmax), dim=-1).indices
    mask = torch.zeros((b, pmax), dtype=torch.bool, device=dev)
    mask.scatter_(1, sel, True)
    return mask


# -- selection ---------------------------------------------------------------


def _anchor_plane(planes, page_tables, anchor: str, lengths,
                  page_size: int):
    """The dot-product anchor of every page-table slot [B, Pmax, ...]."""
    pt = page_tables.to(torch.int64)
    if anchor == "block_max":
        return planes["smax"][pt].to(torch.float32)
    if anchor == "block_mean":
        a = planes["ssum"][pt].to(torch.float32)
        base = torch.arange(pt.shape[1], device=pt.device)[None] * page_size
        cnt = torch.clamp(lengths[:, None].to(torch.int64) - base, 1,
                          page_size).to(torch.float32)
        return a / cnt.reshape(*cnt.shape, *([1] * (a.dim() - 2)))
    if anchor in ("fixed", "dynamic"):
        return planes[ANCHOR_PLANE[anchor]][pt].to(torch.float32)
    raise ValueError(f"anchor {anchor}")


def _anchor_scores(qf, planes, page_tables, anchor: str, lengths=None,
                   page_size: int = 64):
    """Per-page scores [B, H, Pmax] of queries qf [B, H, Dsum] (float32):
    the quest bound or the dot product with a page anchor."""
    if anchor == "quest":
        pt = page_tables.to(torch.int64)
        lo = planes["smin"][pt].to(torch.float32)
        hi = planes["smax"][pt].to(torch.float32)
        contrib = torch.maximum(qf[:, :, None, :] * lo[:, None],
                                qf[:, :, None, :] * hi[:, None])
        return contrib.sum(-1)
    a = _anchor_plane(planes, page_tables, anchor, lengths, page_size)
    return torch.einsum("bhd,bpd->bhp", qf, a)


def _finalize(bound, page_tables, lengths, page_size: int, budget: int,
              keep_mask=None):
    """bound [B, Pmax] -> the top-``budget`` page-table slots [B, budget]
    (at most Pmax): dead slots and those outside ``keep_mask`` last, the
    current position's slot first."""
    pmax = page_tables.shape[1]
    dev = bound.device
    slots = torch.arange(pmax, device=dev)[None, :]
    lengths = lengths.to(torch.int64)
    bound = torch.where(slots * page_size < lengths[:, None], bound, NEG_INF)
    if keep_mask is not None:
        bound = torch.where(keep_mask, bound, NEG_INF)
    last_slot = torch.clamp(lengths - 1, min=0) // page_size
    bound = bound + torch.where(slots == last_slot[:, None], 1e30, 0.0)
    return torch.topk(bound, min(budget, pmax), dim=-1).indices


def select_pages(q_cat, planes, page_tables, lengths, page_size: int,
                 budget: int, anchor: str = "quest",
                 retrieval: str = "layer", keep_mask=None):
    """MLA page selection for q_cat [B, H, R + Dr]: retrieval "layer" ->
    slots [B, budget]; "qhead" -> slots [B, H, budget]."""
    scores = _anchor_scores(q_cat.to(torch.float32), planes, page_tables,
                            anchor, lengths, page_size)  # [B, H, Pmax]
    if retrieval == "layer":
        return _finalize(scores.amax(1), page_tables, lengths, page_size,
                         budget, keep_mask)
    if retrieval == "qhead":
        b, h, pmax = scores.shape
        flat = _finalize(
            scores.reshape(b * h, pmax),
            page_tables.repeat_interleave(h, 0),
            lengths.repeat_interleave(h), page_size, budget,
            None if keep_mask is None else keep_mask.repeat_interleave(h, 0))
        return flat.reshape(b, h, -1)
    raise ValueError(f"retrieval {retrieval} for MLA")


def select_pages_gqa(q, planes, page_tables, lengths, page_size: int,
                     budget: int, num_kv_heads: int, anchor: str = "quest",
                     retrieval: str = "layer", keep_mask=None):
    """GQA page selection for q [B, H, D] over [P, Hkv, D] planes:
    retrieval "layer" -> slots [B, budget]; "kvhead" -> slots
    [B, Hkv, budget]."""
    b, h, d = q.shape
    hkv = num_kv_heads
    qg = q.reshape(b, hkv, h // hkv, d).to(torch.float32)
    if anchor == "quest":
        pt = page_tables.to(torch.int64)
        lo = planes["smin"][pt].to(torch.float32)  # [B, Pmax, Hkv, D]
        hi = planes["smax"][pt].to(torch.float32)
        contrib = torch.maximum(qg[:, None] * lo[:, :, :, None],
                                qg[:, None] * hi[:, :, :, None])
        scores = contrib.sum(-1).permute(0, 2, 3, 1)  # [B, Hkv, G, Pmax]
    else:
        a = _anchor_plane(planes, page_tables, anchor, lengths, page_size)
        scores = torch.einsum("bkgd,bpkd->bkgp", qg, a)
    if retrieval == "layer":
        return _finalize(scores.amax((1, 2)), page_tables, lengths,
                         page_size, budget, keep_mask)
    if retrieval == "kvhead":
        per_kv = scores.amax(2)  # [B, Hkv, Pmax]
        pmax = per_kv.shape[-1]
        return _finalize(
            per_kv.reshape(b * hkv, pmax),
            page_tables.repeat_interleave(hkv, 0),
            lengths.repeat_interleave(hkv), page_size, budget,
            None if keep_mask is None
            else keep_mask.repeat_interleave(hkv, 0)).reshape(b, hkv, -1)
    raise ValueError(f"retrieval {retrieval} for GQA")


# -- pruned attention ----------------------------------------------------------


def _live_rows(sel, lengths, page_size: int):
    """live [..., budget, page]: the selected slots' positions below each
    sequence's length (lengths broadcast over sel's middle axes)."""
    pos = sel[..., None] * page_size + torch.arange(
        page_size, device=sel.device)
    lens = lengths.to(torch.int64).reshape(-1, *([1] * (sel.dim())))
    return pos < lens


def _softmax_rows(scores, live, lead: int):
    """Softmax over the last (budget * page) positions of scores, the dead
    rows masked out."""
    scores = torch.where(live, scores, NEG_INF)
    shape = scores.shape
    return torch.softmax(scores.reshape(*shape[:lead], -1), dim=-1).reshape(
        shape)


def sparse_mla_decode(q_abs, q_pe, buf_a, buf_b, smin, smax, page_tables,
                      lengths, page_size: int, budget: int, scale: float,
                      anchor: str = "quest", retrieval: str = "layer",
                      planes: dict | None = None, keep_mask=None):
    """q_abs [B, H, R] absorbed latent queries, q_pe [B, H, Dr]; ckv pages
    buf_a [P, page, R], k_pe pages buf_b [P, page, Dr]; lengths [B]
    INCLUDING the current token. Returns the latent outputs [B, H, R]
    (float32) over the top-``budget`` pages."""
    b, h, r = q_abs.shape
    if planes is None:
        planes = {"smin": smin, "smax": smax}
    q_cat = torch.cat([q_abs, q_pe], -1)
    sel = select_pages(q_cat, planes, page_tables, lengths, page_size,
                       budget, anchor, retrieval, keep_mask)
    pt = page_tables.to(torch.int64)
    qa = q_abs.to(torch.float32)
    qp = q_pe.to(torch.float32)
    if retrieval == "layer":
        pid = torch.gather(pt, 1, sel)  # [B, S]
        live = _live_rows(sel, lengths, page_size)  # [B, S, page]
        ckv = torch.where(live[..., None], buf_a[pid].to(torch.float32), 0.0)
        kpe = torch.where(live[..., None], buf_b[pid].to(torch.float32), 0.0)
        scores = (torch.einsum("bhr,bspr->bhsp", qa, ckv)
                  + torch.einsum("bhd,bspd->bhsp", qp, kpe)) * scale
        attn = _softmax_rows(scores, live[:, None], 2)
        return torch.einsum("bhsp,bspr->bhr", attn, ckv)
    # qhead: a page set per head
    pid = torch.gather(pt[:, None].expand(-1, h, -1), 2, sel)  # [B, H, S]
    live = _live_rows(sel, lengths, page_size)  # [B, H, S, page]
    ckv = torch.where(live[..., None], buf_a[pid].to(torch.float32), 0.0)
    kpe = torch.where(live[..., None], buf_b[pid].to(torch.float32), 0.0)
    scores = (torch.einsum("bhr,bhspr->bhsp", qa, ckv)
              + torch.einsum("bhd,bhspd->bhsp", qp, kpe)) * scale
    attn = _softmax_rows(scores, live, 2)
    return torch.einsum("bhsp,bhspr->bhr", attn, ckv)


def sparse_gqa_decode(q, buf_k, buf_v, smin, smax, page_tables, lengths,
                      page_size: int, budget: int, scale: float,
                      anchor: str = "quest", retrieval: str = "layer",
                      planes: dict | None = None, keep_mask=None):
    """q [B, H, D]; k / v pages [P, page, Hkv, D]; lengths [B] INCLUDING
    the current token. Returns [B, H, D] (float32) over the top-``budget``
    pages (a set a sequence, or a set a KV head)."""
    b, h, d = q.shape
    hkv = buf_k.shape[2]
    g = h // hkv
    if planes is None:
        planes = {"smin": smin, "smax": smax}
    sel = select_pages_gqa(q, planes, page_tables, lengths, page_size,
                           budget, hkv, anchor, retrieval, keep_mask)
    pt = page_tables.to(torch.int64)
    qg = q.reshape(b, hkv, g, d).to(torch.float32)
    if retrieval == "layer":
        pid = torch.gather(pt, 1, sel)  # [B, S]
        live = _live_rows(sel, lengths, page_size)  # [B, S, page]
        k = torch.where(live[..., None, None], buf_k[pid].to(torch.float32),
                        0.0)  # [B, S, page, Hkv, D]
        v = torch.where(live[..., None, None], buf_v[pid].to(torch.float32),
                        0.0)
        scores = torch.einsum("bkgd,bspkd->bkgsp", qg, k) * scale
        attn = _softmax_rows(scores, live[:, None, None], 3)
        return torch.einsum("bkgsp,bspkd->bkgd", attn, v).reshape(b, h, d)
    # kvhead: a page set per KV head
    pid = torch.gather(pt[:, None].expand(-1, hkv, -1), 2, sel)  # [B,Hkv,S]
    heads = torch.arange(hkv, device=q.device)[None, :, None]
    live = _live_rows(sel, lengths, page_size)  # [B, Hkv, S, page]
    k = torch.where(live[..., None], buf_k[pid, :, heads].to(torch.float32),
                    0.0)  # [B, Hkv, S, page, D]
    v = torch.where(live[..., None], buf_v[pid, :, heads].to(torch.float32),
                    0.0)
    scores = torch.einsum("bkgd,bkspd->bkgsp", qg, k) * scale
    attn = _softmax_rows(scores, live[:, :, None], 3)
    return torch.einsum("bkgsp,bkspd->bkgd", attn, v).reshape(b, h, d)
