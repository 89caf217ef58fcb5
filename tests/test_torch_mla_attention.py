"""The rules and walks of the two bf16 MLA attention kernels,
mla_decode_split_kernel (mla_decode_fused, csrc/mla_decode.cu) and
mla_prefill_mma_kernel (mla_paged_prefill, csrc/paged_attention.cu), and
plain emulations of both walks held against the JAX package's Pallas
kernels (interpret mode) on the same numpy inputs.

The CUDA kernels run only on the card (tests/test_torch_cuda.py -k mla and
chip_smoke.py hold them to the plain versions there). What these tests hold
on the CPU:
- the route tables of ops/cuda/mla_decode.route and
  ops/cuda/paged_attention.prefill_route (bf16 to the new kernels, float32
  to the first versions) and the prefill block shape (prefill_plan);
- the decode split plan (decode_split_plan, a pure function of the shapes):
  every cached row in exactly one split, the current token in a block of
  its own (counted once), splits past the length writing no state, for
  lengths 0 .. 2048 and caches of up to 8192 rows;
- the kernels' arithmetic in their order: for decode, per split tiles of
  64 rows into (m, l, acc) in log2 units, the current token's state
  (s_cur, 1, normed ckv), then the merge of the live splits in split order
  and the current token's last; for
  prefill, blocks of (head, position) rows (RG heads x 16 positions), key
  tiles of 32 up to the block's causal limit, the mask kpos <= old + qs
  and kpos < old + valid.

Tolerances, as a share of the reference's largest magnitude:
- 2e-5 for the float32 walks against the Pallas kernels: both sides
  accumulate in float32 and differ only in the order of sums and in exp2
  of log2-scaled scores against exp;
- 1e-2 for the bf16 walks (queries, keys and P rounded to bf16 as the
  kernels' mma operands): the bf16 rounding of 8 mantissa bits, the
  tolerance the card tests hold the kernels to.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ktransformers_tpu.ops.pallas import mla_decode as jmd
from ktransformers_tpu.ops.pallas import paged_attention as jpa
from ktransformers_tpu.ops.rope import rope_rotation_matrix as j_rot
from ktransformers_tpu_torch.ops.cuda import mla_decode as MD
from ktransformers_tpu_torch.ops.cuda import paged_attention as PA
from tests.test_torch_model import one_torch_thread  # noqa: F401

F32_TOL = 2e-5
BF16_TOL = 1e-2
LOG2E = 1.4426950408889634
NEG = -1e30
DECODE_TK = 64  # rows a tile of mla_decode_split_kernel
PREFILL_TK = 32  # keys a tile of mla_prefill_mma_kernel


def _rel(out, ref):
    out, ref = np.asarray(out, np.float32), np.asarray(ref, np.float32)
    return float(np.abs(out - ref).max() / np.abs(ref).max())


def _bf(t: torch.Tensor, on: bool) -> torch.Tensor:
    return t.to(torch.bfloat16).to(torch.float32) if on else t


# ------------------------------------------------------------ route tables


@pytest.mark.parametrize("dtype, decode, prefill", [
    (torch.bfloat16, "split", "mma"), (torch.float32, "fused", "first")])
def test_route_tables(dtype, decode, prefill):
    """bf16 calls take the tensor-core kernels; float32 calls keep the first
    versions, whose card tests hold 1e-5 (bf16 products could not)."""
    assert MD.route(dtype) == decode
    assert PA.prefill_route(dtype) == prefill
    assert MD.KERNEL_NAMES == {"split": "mla_decode_split_kernel"}
    assert PA.PREFILL_KERNEL_NAMES == {"mma": "mla_prefill_mma_kernel"}


@pytest.mark.parametrize("c, h, s, sms, want", [
    (1, 16, 256, 132, 2),     # the mixed step's chunk: 64 blocks at 4 heads
    (2, 16, 256, 132, 4),     # 128 blocks at 4 heads
    (1, 16, 512, 132, 4),
    (2, 16, 512, 132, 4),     # 256 blocks at 4 heads
    (1, 128, 256, 132, 4),    # DeepSeek-V2's 128 heads
    (1, 4, 16, 132, 2),
    (1, 16, 264, 132, 4),     # 68 blocks: more than one for two SMs
])
def test_prefill_plan(c, h, s, sms, want):
    """Four heads a block (each staged key tile serves four heads) where
    that gives more than one block for every two SMs, else two (twice the
    blocks): on the H100 four heads won at 128 and 256 blocks, two at 64."""
    assert PA.prefill_plan(c, h, s, sms) == want
    assert want in PA.PREFILL_HEADS


# ------------------------------------------------------------- split plan

PLAN_SHAPES = [(b, s, h) for b in (1, 8) for s in (64, 1024, 2048, 4096,
                                                   8192)
               for h in (16, 32)] + [(3, 100, 4), (1, 16, 8)]


def _split_rows(length: int, splits: int, span: int):
    """The cache rows [start, end) of each split, as the kernel cuts them."""
    return [(j * span, min(length, (j + 1) * span)) for j in range(splits)]


@pytest.mark.parametrize("b, s, h", PLAN_SHAPES)
def test_decode_split_plan_covers_every_row_once(b, s, h):
    splits, span = MD.decode_split_plan(b, s, h, 132)
    assert 1 <= splits <= MD.DECODE_MAX_SPLITS
    assert span % MD.DECODE_UNIT == 0
    assert splits * span >= s and (splits - 1) * span < s
    assert span >= min(MD.DECODE_MIN_SPAN, -(-s // MD.DECODE_UNIT)
                       * MD.DECODE_UNIT)
    for length in (0, 1, 15, 16, 63, 64, 512, 2047, 2048, s - 1, s):
        if length > s:
            continue
        rows = _split_rows(length, splits, span)
        seen = np.zeros(s, np.int32)
        for lo, hi in rows:
            seen[lo:max(lo, hi)] += 1
        assert (seen[:length] == 1).all() and (seen[length:] == 0).all()
        # the merge reads splits 0 .. live - 1 (every split that starts
        # below the length) and the current token's state
        live = min(splits, -(-length // span))
        assert all(hi > lo for lo, hi in rows[:live])
        assert all(hi <= lo for lo, hi in rows[live:])


@pytest.mark.parametrize("b, want", [(1, 16), (8, 128)])
def test_decode_split_plan_blocks(b, want):
    """The main path's cache (max_len 1024, 16 heads): at the serving batch
    of 8 about one block an SM; at one sequence the DECODE_MIN_SPAN floor
    (64 rows a split) holds it to 16 blocks."""
    splits, span = MD.decode_split_plan(b, 1024, 16, 132)
    assert b * splits == want and span == 64


# ------------------------------------------------------------- emulations


def _online(state, scores, vals, ok, round_p):
    """One tile into (m, l, acc) as the kernels do it: scores in log2
    units, masked keys out of the max and at p = 0, P rounded to bf16 for
    P V where round_p."""
    m, l, acc = state
    x = torch.where(ok, scores, torch.full_like(scores, NEG))
    m_new = torch.maximum(m, x.amax(-1))
    corr = torch.exp2(m - m_new)
    p = torch.where(ok, torch.exp2(scores - m_new[:, None]),
                    torch.zeros_like(scores))
    l = l * corr + p.sum(-1)
    acc = acc * corr[:, None] + _bf(p, round_p) @ vals
    return m_new, l, acc


def decode_walk(qn, qp_raw, kv, gamma, rot, ckv, kpe, lengths, scale, eps,
                splits, span, bf16):
    """mla_decode_split_kernel's walk: (ctx [B, H, R], ckv_new, kpe_new,
    states), states[b][j] = the (m, l) split j of sequence b wrote (None
    for a split with no row: it writes nothing and the merge skips it),
    states[b][splits] the current token's block's."""
    b, h, r = qn.shape
    sl = scale * LOG2E
    qp = qp_raw @ rot
    ckv_raw = kv[:, 0, :r]
    ckvn = ckv_raw * torch.rsqrt((ckv_raw * ckv_raw).mean(-1, keepdim=True)
                                 + eps) * gamma
    kpen = (kv[:, :, r:] @ rot)[:, 0]
    ctx = torch.zeros(b, h, r)
    states = []
    for i in range(b):
        s_cur = ((qn[i] * ckvn[i]).sum(-1) + (qp[i] * kpen[i]).sum(-1)) * sl
        q = _bf(torch.cat([qn[i], qp[i]], -1), bf16)
        length = int(lengths[i])
        recs = []
        for lo, hi in _split_rows(length, splits, span):
            if hi <= lo:
                recs.append(None)
                continue
            st = (torch.full((h,), NEG), torch.zeros(h), torch.zeros(h, r))
            for k0 in range(lo, hi, DECODE_TK):
                k1 = min(hi, k0 + DECODE_TK)
                keys = _bf(torch.cat([ckv[i, k0:k1], kpe[i, k0:k1]], -1), bf16)
                ok = torch.ones(h, k1 - k0, dtype=torch.bool)
                st = _online(st, (q @ keys.T) * sl, keys[:, :r], ok, bf16)
            recs.append(st)
        # the current token's block: m = s_cur, l = 1, acc = normed ckv
        recs.append((s_cur.clone(), torch.ones(h),
                     ckvn[i][None].expand(h, r).clone()))
        live = [st for st in recs if st is not None]
        m_all = torch.stack([st[0] for st in live])  # [live, H]
        big = m_all.amax(0)
        w = torch.exp2(m_all - big)
        norm = (torch.stack([st[1] for st in live]) * w).sum(0)
        for k, st in enumerate(live):
            ctx[i] += (w[k] / norm)[:, None] * st[2]
        states.append([None if st is None else (st[0], st[1]) for st in recs])
    return ctx, ckvn[:, None], kpen[:, None], states


def _decode_case(rng, b, h, smax, lens, r=64, dr=16):
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    qn, qp, kv = f(b, h, r), f(b, h, dr), f(b, 1, r + dr)
    gamma = f(r) * 0.1 + 1.0
    rot = np.array(j_rot(jnp.asarray(f(b, dr // 2)),
                           jnp.asarray(f(b, dr // 2)), True))
    ckv, kpe = f(b, smax, r), f(b, smax, dr)
    return qn, qp, kv, gamma, rot, ckv, kpe, np.asarray(lens, np.int32)


@pytest.mark.parametrize("h", [4, 20])
@pytest.mark.parametrize("plan", [(1, 256), (4, 64), (16, 16)])
@pytest.mark.parametrize("bf16", [False, True])
def test_decode_walk_matches_pallas(h, plan, bf16):
    """Lengths 0 (the current token alone), 1, 15, 16, 63, 64, 65 and 255
    (the current token fills the cache) over a 256-row cache, under one
    split, four and sixteen; H = 20 takes two head tiles of 16 on the
    card (heads are independent, so the walk needs no tile)."""
    rng = np.random.default_rng(h + plan[0])
    lens = [0, 1, 15, 16, 63, 64, 65, 255]
    arrays = _decode_case(rng, len(lens), h, 256, lens)
    scale, eps = (32 + 16) ** -0.5, 1e-6
    ref = jmd.mla_decode_fused(*map(jnp.asarray, arrays), scale=scale,
                               eps=eps, block_s=64, interpret=True)
    out = decode_walk(*map(torch.from_numpy, arrays), scale, eps, *plan,
                      bf16)
    tol = BF16_TOL if bf16 else F32_TOL
    for o, rf in zip(out[:3], ref):
        assert _rel(o.numpy(), np.asarray(rf)) <= tol
    # the port's plain version (what the card tests hold the kernel to)
    plain = MD.mla_decode_fused_ref(*map(torch.from_numpy, arrays), scale,
                                    eps)
    for o, p in zip(out[:3], plain):
        assert _rel(o.numpy(), p.numpy()) <= tol


def test_decode_walk_states():
    """The current token's block holds (s_cur, 1) and is counted once; a
    split past the length writes nothing (a length-0 sequence has the
    current token alone); the live splits hold l >= 1 (the key at the max
    gives p = 1)."""
    rng = np.random.default_rng(0)
    lens = [0, 40]
    arrays = _decode_case(rng, 2, 4, 128, lens)
    *_, states = decode_walk(*map(torch.from_numpy, arrays), 0.2, 1e-6, 8,
                             16, False)
    assert len(states[0]) == len(states[1]) == 9
    assert all(st is None for st in states[0][:8])
    for seq in states:
        assert seq[8][1].tolist() == [1.0] * 4
    assert all(st is not None and bool((st[1] >= 1).all())
               for st in states[1][:3])
    assert all(st is None for st in states[1][3:8])


def prefill_walk(qn, qp, ckv_pages, kpe_pages, tables, lengths, valid, scale,
                 heads, bf16):
    """mla_prefill_mma_kernel's walk: blocks of `heads` heads x 16
    positions of one chunk, key tiles of 32 up to the block's causal limit
    (read through the page table), [C, H, S, R]."""
    c, h, s, r = qn.shape
    page = ckv_pages.shape[1]
    sl = scale * LOG2E
    out = torch.zeros(c, h, s, r)
    for ci in range(c):
        old, live = int(lengths[ci]), int(lengths[ci]) + int(valid[ci])
        live = min(live, page * tables.shape[1])
        for p0 in range(0, s, 16):
            pos = torch.arange(p0, min(p0 + 16, s))
            limit = min(live, old + int(pos[-1]) + 1)
            for h0 in range(0, h, heads):
                hs = torch.arange(h0, min(h0 + heads, h))
                # (head, position) rows, one row group a head
                q = _bf(torch.cat([qn[ci][hs][:, pos], qp[ci][hs][:, pos]],
                                  -1).reshape(-1, r + qp.shape[-1]), bf16)
                lim = torch.clamp(old + pos + 1, max=live).repeat(len(hs))
                st = (torch.full((q.shape[0],), NEG), torch.zeros(q.shape[0]),
                      torch.zeros(q.shape[0], r))
                for k0 in range(0, limit, PREFILL_TK):
                    kpos = torch.arange(k0, min(limit, k0 + PREFILL_TK))
                    rows = tables[ci][kpos // page].long() * page + kpos % page
                    keys = _bf(torch.cat([ckv_pages.reshape(-1, r)[rows],
                                          kpe_pages.reshape(-1, qp.shape[-1])
                                          [rows]], -1), bf16)
                    ok = kpos[None, :] < lim[:, None]
                    st = _online(st, (q @ keys.T) * sl, keys[:, :r], ok, bf16)
                ctx = st[2] / torch.clamp(st[1], min=1e-30)[:, None]
                out[ci][h0:h0 + len(hs), p0:p0 + len(pos)] = ctx.reshape(
                    len(hs), len(pos), r)
    return out


def _pool(rng, b, pmax, page, live, r, dr):
    """As tests/test_torch_paged.py: shuffled tables, NaN in every row the
    kernels must not read."""
    num_pages = b * pmax + 1
    perm = rng.permutation(num_pages - 1)[: b * pmax] + 1
    tables = perm.reshape(b, pmax).astype(np.int32)
    ckv = np.full((num_pages, page, r), np.nan, np.float32)
    kpe = np.full((num_pages, page, dr), np.nan, np.float32)
    for i, n in enumerate(live):
        for pos in range(n):
            pid, slot = tables[i, pos // page], pos % page
            ckv[pid, slot] = rng.standard_normal(r)
            kpe[pid, slot] = rng.standard_normal(dr)
    return ckv, kpe, tables


@pytest.mark.parametrize("old", ["zero", "mid_page", "page_aligned"])
@pytest.mark.parametrize("h, heads", [(4, 4), (4, 2), (6, 4)])
@pytest.mark.parametrize("bf16", [False, True])
def test_prefill_walk_matches_pallas(old, h, heads, bf16):
    """Chunks of S = 40 positions (two full blocks of 16 and a partial
    one) with valid < S and == S after an old length of 0, mid-page or
    page-aligned; H = 6 leaves a block of 4 heads half empty. Padding rows
    (qs >= valid) see every live key and are compared too."""
    r, dr, page, pmax, s = 32, 16, 16, 8, 40
    rng = np.random.default_rng(h + heads + len(old))
    old_len = {"zero": 0, "mid_page": page // 2 + 1, "page_aligned": page}[old]
    olds, valids = [old_len, old_len], [s - 9, s]
    ckv, kpe, tables = _pool(rng, 2, pmax, page,
                             [o + v for o, v in zip(olds, valids)], r, dr)
    qn = rng.standard_normal((2, h, s, r)).astype(np.float32)
    qp = rng.standard_normal((2, h, s, dr)).astype(np.float32)
    lengths, valid = np.asarray(olds, np.int32), np.asarray(valids, np.int32)
    ref = np.asarray(jpa.mla_paged_prefill(
        *map(jnp.asarray, (qn, qp, ckv, kpe, tables, lengths, valid)),
        scale=0.2, block_q=8, interpret=True))
    args = [torch.from_numpy(a) for a in (qn, qp, ckv, kpe, tables, lengths,
                                          valid)]
    out = prefill_walk(*args, 0.2, heads, bf16).numpy()
    assert np.isfinite(out).all() and np.isfinite(ref).all()
    tol = BF16_TOL if bf16 else F32_TOL
    assert _rel(out, ref) <= tol
    plain = PA.mla_paged_prefill_ref(*args, 0.2).numpy()
    assert _rel(out, plain) <= tol


def test_prefill_walk_empty_chunk_is_zero():
    """An empty chunk on an empty cache: no key tile, zeros (as the plain
    version)."""
    r, dr = 32, 16
    rng = np.random.default_rng(1)
    ckv, kpe, tables = _pool(rng, 1, 2, 8, [0], r, dr)
    qn = torch.randn(1, 2, 8, r)
    qp = torch.randn(1, 2, 8, dr)
    ints = [torch.from_numpy(tables), torch.tensor([0], dtype=torch.int32),
            torch.tensor([0], dtype=torch.int32)]
    out = prefill_walk(qn, qp, torch.from_numpy(ckv), torch.from_numpy(kpe),
                       *ints, 0.2, 2, True)
    assert torch.all(out == 0)
    plain = PA.mla_paged_prefill_ref(qn, qp, torch.from_numpy(ckv),
                                     torch.from_numpy(kpe), *ints, 0.2)
    assert torch.all(plain == 0)


def test_prefill_tiles_skip_past_the_causal_limit():
    """A block's walk stops at min(live, old + its last position + 1): the
    first positions' blocks of a long chunk read fewer key tiles, and no
    tile past the live length."""
    old, valid, s = 100, 64, 64
    tiles = []
    for p0 in range(0, s, 16):
        limit = min(old + valid, old + min(p0 + 16, s))
        tiles.append(-(-limit // PREFILL_TK))
    assert tiles == [4, 5, 5, 6]
    assert max(tiles) * PREFILL_TK >= old + valid > (max(tiles) - 1) * 32


def test_jax_runs_on_the_cpu():
    assert jax.default_backend() == "cpu"
