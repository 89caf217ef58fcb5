"""The rules and walks of the two bf16 paged-attention kernels redesigned
for the tensor cores, mla_paged_decode_split_kernel (mla_paged_decode,
csrc/paged_attention.cu) and gqa_prefill_mma_kernel (gqa_paged_prefill,
csrc/gqa_paged_attention.cu), and plain emulations of both walks held
against the JAX package's Pallas kernels (interpret mode) on the same numpy
inputs, with shuffled page tables and NaN in every pool row the kernels
must not read.

The CUDA kernels run only on the card (tests/test_torch_cuda.py
-k "gqa or mla_paged" and chip_smoke.py hold them to the plain versions
there). What these tests hold on the CPU:
- the route tables of ops/cuda/paged_attention.decode_route and
  gqa_prefill_route (bf16 to the new kernels, float32 to the first
  versions) and the GQA block shape (gqa_prefill_plan);
- the paged decode's split plan (ops/cuda/mla_decode.decode_split_plan
  over the pool's pmax * page positions, a pure function of the shapes):
  every position in exactly one split for lengths 0 .. 2048 at page 16 /
  64 / 128, and the splits that start at or past the length write no
  state;
- the kernels' arithmetic in their order: for the MLA paged decode, per
  split tiles of 64 positions through the page table into (m, l, acc) in
  log2 units, then the merge of the live splits in split order; for the
  GQA prefill, blocks of 64 or 128 flattened (position, head) rows, 16-row
  groups over the G heads of a KV head, key tiles of 64 from the block's
  window start (rounded down to a tile) to its causal limit, each row's
  own causal limit and window, the keys of a tile split between two
  warps at 64 rows and their states merged, padding rows.

Tolerances, as a share of the reference's largest magnitude:
- 2e-5 for the float32 walks: both sides accumulate in float32 and differ
  only in the order of sums and in exp2 of log2-scaled scores against
  exp;
- 1e-2 for the bf16 walks (queries, keys, values and P rounded to bf16 as
  the kernels' mma operands): the bf16 rounding of 8 mantissa bits, the
  tolerance the card tests hold the kernels to.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ktransformers_tpu.ops.pallas import paged_attention as jpa
from ktransformers_tpu_torch.ops.cuda import mla_decode as MD
from ktransformers_tpu_torch.ops.cuda import paged_attention as PA
from tests.test_torch_mla_attention import _bf, _online, _rel
from tests.test_torch_model import one_torch_thread  # noqa: F401

F32_TOL = 2e-5
BF16_TOL = 1e-2
LOG2E = 1.4426950408889634
NEG = -1e30
TK = 64  # positions a key tile of either kernel


# ------------------------------------------------------------ route tables


@pytest.mark.parametrize("dtype, decode, prefill", [
    (torch.bfloat16, "split", "mma"), (torch.float32, "first", "first")])
def test_route_tables(dtype, decode, prefill):
    """bf16 calls take the tensor-core kernels; float32 calls keep the
    first versions, whose card tests hold 1e-5 (bf16 products could
    not)."""
    assert PA.decode_route(dtype) == decode
    assert PA.gqa_prefill_route(dtype) == prefill
    assert PA.DECODE_KERNEL_NAMES == {
        "split": "mla_paged_decode_split_kernel"}
    assert PA.GQA_PREFILL_KERNEL_NAMES == {"mma": "gqa_prefill_mma_kernel"}


@pytest.mark.parametrize("c, h, hkv, s, sms, want", [
    (1, 32, 8, 256, 132, 64),     # the mixed step's chunk: 64 blocks at 128
    (2, 32, 8, 256, 132, 128),    # 128 blocks at 128 rows
    (1, 32, 8, 512, 132, 128),
    (2, 32, 8, 512, 132, 128),    # 256 blocks at 128 rows
    (1, 8, 2, 16, 132, 64),
    (1, 32, 8, 264, 132, 128),    # 72 blocks: more than one for two SMs
    (1, 32, 4, 256, 132, 64),     # Qwen3-30B-A3B's chunk (G = 8): 64 blocks
    (1, 28, 4, 256, 132, 64),     # Qwen2-57B-A14B's (G = 7): 56 blocks
    (2, 28, 4, 256, 132, 128),    # two of them: 112
])
def test_gqa_prefill_plan(c, h, hkv, s, sms, want):
    """128 rows a block (each staged K / V tile serving 128 rows) where
    that gives more than one block for every two SMs, else 64 (twice the
    blocks, the keys of each tile split between two warps): on the H100,
    64 won at 64 blocks of 128 rows, 128 at 128 and 256."""
    assert PA.gqa_prefill_plan(c, h, hkv, s, sms) == want
    assert want in PA.GQA_PREFILL_ROWS


# ------------------------------------------------------------- split plan


def _split_rows(length: int, splits: int, span: int):
    """The positions [start, end) of each split, as the kernel cuts them."""
    return [(j * span, min(length, (j + 1) * span)) for j in range(splits)]


@pytest.mark.parametrize("b", [1, 8])
@pytest.mark.parametrize("page", [16, 64, 128])
def test_paged_split_plan_covers_every_position_once(page, b):
    """At the serving pool (2048 positions a sequence, 16 heads) every
    position below the length lies in exactly one split, for every length
    0 .. 2048, and the merge reads exactly the splits that hold a
    position (those starting below the length)."""
    pmax = 2048 // page
    splits, span = MD.decode_split_plan(b, pmax * page, 16, 132)
    assert 1 <= splits <= MD.DECODE_MAX_SPLITS
    assert splits * span >= pmax * page > (splits - 1) * span
    for length in range(pmax * page + 1):
        rows = _split_rows(length, splits, span)
        live = min(splits, -(-length // span))
        assert all(hi > lo for lo, hi in rows[:live])
        assert all(hi <= lo for lo, hi in rows[live:])
        # the live splits tile [0, length) in order, without gap or overlap
        edges = [0] + [hi for _, hi in rows[:live]]
        assert [lo for lo, _ in rows[:live]] == edges[:-1]
        assert edges[-1] == length


@pytest.mark.parametrize("b, want", [(1, 32), (8, 128)])
def test_paged_split_plan_blocks(b, want):
    """The serving pool (32 pages of 64 a sequence, 16 heads): at the
    decode batch of 8, 16 splits of 128 positions (about one block an SM);
    at one sequence the cap of DECODE_MAX_SPLITS splits of 64."""
    splits, span = MD.decode_split_plan(b, 2048, 16, 132)
    assert b * splits == want
    assert span == (64 if b == 1 else 128)


# ------------------------------------------------------------- MLA decode

R, DR, H = 64, 16, 4
DECODE_LENS = [0, 1, 15, 16, 63, 64, 65, 200, 256]


def _pool(rng, b, pmax, page, live, widths):
    """Pools [b * pmax + 1, page, *width] on shuffled tables, NaN except
    the first live[i] positions of sequence i."""
    n = b * pmax + 1
    tables = (rng.permutation(n - 1)[: b * pmax] + 1).reshape(
        b, pmax).astype(np.int32)
    pools = []
    for width in widths:
        buf = np.full((n * page, *width), np.nan, np.float32)
        for i, ln in enumerate(live):
            pos = np.arange(ln)
            rows = tables[i, pos // page].astype(np.int64) * page + pos % page
            buf[rows] = rng.standard_normal((ln, *width))
        pools.append(buf.reshape(n, page, *width))
    return pools, tables


@functools.lru_cache(maxsize=None)
def _decode_case(page: int):
    """numpy operands over 256 positions a sequence, and the Pallas
    kernel's output (interpret mode) on the sequences with a live key."""
    rng = np.random.default_rng(page)
    pmax = 256 // page
    (ckv, kpe), tables = _pool(rng, len(DECODE_LENS), pmax, page,
                               DECODE_LENS, [(R,), (DR,)])
    qn = rng.standard_normal((len(DECODE_LENS), H, R)).astype(np.float32)
    qp = rng.standard_normal((len(DECODE_LENS), H, DR)).astype(np.float32)
    lengths = np.asarray(DECODE_LENS, np.int32)
    ref = np.asarray(jpa.mla_paged_decode(
        *map(jnp.asarray, (qn[1:], qp[1:], ckv, kpe, tables[1:],
                           lengths[1:])), scale=0.2, interpret=True))
    return (qn, qp, ckv, kpe, tables, lengths), ref


def paged_decode_walk(qn, qp, ckv_pages, kpe_pages, tables, lengths, scale,
                      splits, span, bf16):
    """mla_paged_decode_split_kernel's walk: (ctx [B, H, R], states),
    states[b][j] = the (m, l) split j of sequence b wrote (None for a
    split with no position: it writes nothing and the merge skips it)."""
    b, h, r = qn.shape
    page, pmax = ckv_pages.shape[1], tables.shape[1]
    dr = qp.shape[-1]
    ckv_rows, kpe_rows = ckv_pages.reshape(-1, r), kpe_pages.reshape(-1, dr)
    sl = scale * LOG2E
    ctx = torch.zeros(b, h, r)
    states = []
    for i in range(b):
        length = min(max(int(lengths[i]), 0), page * pmax)
        q = _bf(torch.cat([qn[i], qp[i]], -1), bf16)
        recs = []
        for lo, hi in _split_rows(length, splits, span):
            if hi <= lo:
                recs.append(None)
                continue
            st = (torch.full((h,), NEG), torch.zeros(h), torch.zeros(h, r))
            for k0 in range(lo, hi, TK):
                pos = torch.arange(k0, min(hi, k0 + TK))
                rows = tables[i][pos // page].long() * page + pos % page
                keys = _bf(torch.cat([ckv_rows[rows], kpe_rows[rows]], -1),
                           bf16)
                ok = torch.ones(h, len(pos), dtype=torch.bool)
                st = _online(st, (q @ keys.T) * sl, keys[:, :r], ok, bf16)
            recs.append(st)
        live = [st for st in recs if st is not None]
        if live:  # the merge in split order; no live split gives zeros
            m_all = torch.stack([st[0] for st in live])  # [live, H]
            w = torch.exp2(m_all - m_all.amax(0))
            norm = (torch.stack([st[1] for st in live]) * w).sum(0)
            for k, st in enumerate(live):
                ctx[i] += (w[k] / norm)[:, None] * st[2]
        states.append([None if st is None else (st[0], st[1])
                       for st in recs])
    return ctx, states


@pytest.mark.parametrize("plan", ["one", "four", "planned", "most"])
@pytest.mark.parametrize("page", [16, 64])
@pytest.mark.parametrize("bf16", [False, True])
def test_paged_decode_walk_matches_pallas(page, plan, bf16):
    """Lengths 0 (zeros), 1, on and around 16-row units and 64-row tiles,
    200 and 256 (the whole pool) over pools of page 16 / 64, under one
    split, four, the plan's and 16 splits of 16 positions (tiles shorter
    than 64); the sequences with a live key against the Pallas kernel, all
    of them against the port's plain version."""
    arrays, ref = _decode_case(page)
    s = 256
    splits, span = {"one": (1, s), "four": (4, s // 4), "most": (16, 16),
                    "planned": MD.decode_split_plan(len(DECODE_LENS), s, H,
                                                    132)}[plan]
    args = [torch.from_numpy(a) for a in arrays]
    out, states = paged_decode_walk(*args, 0.2, splits, span, bf16)
    tol = BF16_TOL if bf16 else F32_TOL
    assert _rel(out[1:].numpy(), ref) <= tol
    assert torch.all(out[0] == 0)
    plain = PA.mla_paged_decode_ref(*args, 0.2)
    assert _rel(out.numpy(), plain.numpy()) <= tol
    # a split that starts at or past the length writes no state
    for length, recs in zip(DECODE_LENS, states):
        assert [st is None for st in recs] == [
            lo >= length for lo, _ in _split_rows(s, splits, span)]


# ------------------------------------------------------------ GQA prefill

D, HKV, S = 128, 2, 40
GQA_OLDS = [0, 17, 16, 150]
GQA_VALIDS = [40, 33, 40, 29]


@functools.lru_cache(maxsize=None)
def _gqa_case(g: int, window: int):
    """numpy operands (page 16, 256 positions a chunk) and the Pallas
    kernel's output (interpret mode)."""
    rng = np.random.default_rng(g * 100 + window)
    page, pmax = 16, 16
    live = [o + v for o, v in zip(GQA_OLDS, GQA_VALIDS)]
    (k, v), tables = _pool(rng, len(live), pmax, page, live,
                           [(HKV, D), (HKV, D)])
    q = rng.standard_normal((len(live), g * HKV, S, D)).astype(np.float32)
    lengths = np.asarray(GQA_OLDS, np.int32)
    valid = np.asarray(GQA_VALIDS, np.int32)
    arrays = (q, k, v, tables, lengths, valid)
    ref = np.asarray(jpa.gqa_paged_prefill(
        *map(jnp.asarray, arrays), D ** -0.5, window=window,
        interpret=True))
    return arrays, ref


def gqa_prefill_walk(q, k_pages, v_pages, tables, lengths, valid, scale,
                     window, rows_block, bf16):
    """gqa_prefill_mma_kernel's walk, [C, H, S, D]: per (chunk, KV head)
    blocks of rows_block flattened rows (row = s * G + g), 16-row groups,
    key tiles of 64 from the block's window start (rounded down) to its
    causal limit, a row's keys lo <= kpos < hi; at 64 rows a block each
    tile's keys split in two halves walked with their own states, merged
    at the end."""
    c, h, s, d = q.shape
    page, hkv = k_pages.shape[1], k_pages.shape[2]
    g = h // hkv
    rows = g * s
    ksp = 2 if rows_block == 64 else 1
    kw = TK // ksp
    sl = scale * LOG2E
    out = torch.zeros(c, h, s, d)
    for ci in range(c):
        old = max(int(lengths[ci]), 0)
        total = min(old + max(int(valid[ci]), 0), page * tables.shape[1])
        for kh in range(hkv):
            kpool = k_pages[:, :, kh].reshape(-1, d)
            vpool = v_pages[:, :, kh].reshape(-1, d)
            # flattened rows: row fr is head kh * g + fr % g, position fr // g
            qflat = q[ci, kh * g:(kh + 1) * g].transpose(0, 1).reshape(
                rows, d)
            for r0 in range(0, rows, rows_block):
                last = min(r0 + rows_block, rows) - 1
                limit = min(total, old + last // g + 1)
                kbeg = max(0, old + r0 // g - window + 1) if window else 0
                first = kbeg // TK * TK
                nt = -(-(limit - first) // TK) if kbeg < limit else 0
                for w0 in range(r0, last + 1, 16):
                    fr = torch.arange(w0, min(w0 + 16, rows))
                    qpos = old + fr // g
                    hi = torch.clamp(qpos + 1, max=total)
                    lo = qpos - window + 1 if window else torch.zeros_like(
                        qpos)
                    qr = _bf(qflat[fr], bf16)
                    parts = []
                    for part in range(ksp):
                        st = (torch.full((len(fr),), NEG),
                              torch.zeros(len(fr)), torch.zeros(len(fr), d))
                        for t in range(nt):
                            kb = first + t * TK + part * kw
                            kpos = torch.arange(kb, kb + kw)
                            live = kpos < limit  # rows past it: zero-filled
                            rws = tables[ci][torch.where(
                                live, kpos, 0) // page].long() * page + \
                                torch.where(live, kpos, 0) % page
                            zero = torch.zeros(())
                            kt = _bf(torch.where(live[:, None], kpool[rws],
                                                 zero), bf16)
                            vt = _bf(torch.where(live[:, None], vpool[rws],
                                                 zero), bf16)
                            ok = (kpos[None] >= lo[:, None]) & (
                                kpos[None] < hi[:, None])
                            st = _online(st, (qr @ kt.T) * sl, vt, ok, bf16)
                        parts.append(st)
                    m, l, acc = parts[0]
                    if ksp == 2:  # the pair's merge
                        m1, l1, acc1 = parts[1]
                        mm = torch.maximum(m, m1)
                        a0, a1 = torch.exp2(m - mm), torch.exp2(m1 - mm)
                        l = l * a0 + l1 * a1
                        acc = acc * a0[:, None] + acc1 * a1[:, None]
                    ctx = acc / torch.clamp(l, min=1e-30)[:, None]
                    out[ci, kh * g + fr % g, fr // g] = ctx
    return out


@pytest.mark.parametrize("rows_block", [64, 128])
@pytest.mark.parametrize("window", [0, 20])
@pytest.mark.parametrize("g", [1, 4, 6, 7, 8, 12])
@pytest.mark.parametrize("bf16", [False, True])
def test_gqa_prefill_walk_matches_pallas(g, window, rows_block, bf16):
    """Chunks of S = 40 after old lengths 0, mid-page, page-aligned and
    150 (a window start past the first key tile), valid < S and == S;
    G = 6 and 7 (Qwen2-57B-A14B) leave 16-row groups and 64- / 128-row
    blocks that straddle positions, G = 8 is Qwen3's, G = 12 GLM-4.5-Air's
    (96 over 8). Live rows against
    the Pallas kernel; every row, padding rows included, against the
    port's plain version (with a window the two packages differ on a
    padding row whose window holds no key: zeros in the port)."""
    arrays, ref = _gqa_case(g, window)
    args = [torch.from_numpy(a) for a in arrays]
    out = gqa_prefill_walk(*args, D ** -0.5, window, rows_block,
                           bf16).numpy()
    assert np.isfinite(out).all()
    tol = BF16_TOL if bf16 else F32_TOL
    live = np.arange(S)[None, :] < np.asarray(GQA_VALIDS)[:, None]
    assert _rel(out.transpose(0, 2, 1, 3)[live],
                ref.transpose(0, 2, 1, 3)[live]) <= tol
    plain = PA.gqa_paged_prefill_ref(*args, D ** -0.5, window=window)
    assert _rel(out, plain.numpy()) <= tol


def test_gqa_prefill_walk_empty_chunk_is_zero():
    """An empty chunk on an empty cache: no key tile, zeros (as the plain
    version)."""
    rng = np.random.default_rng(3)
    (k, v), tables = _pool(rng, 1, 2, 16, [0], [(HKV, D), (HKV, D)])
    q = torch.randn(1, 4 * HKV, 8, D)
    ints = [torch.from_numpy(tables), torch.tensor([0], dtype=torch.int32),
            torch.tensor([0], dtype=torch.int32)]
    pools = [torch.from_numpy(k), torch.from_numpy(v)]
    out = gqa_prefill_walk(q, *pools, *ints, 0.1, 0, 64, True)
    assert torch.all(out == 0)
    assert torch.all(PA.gqa_paged_prefill_ref(q, *pools, *ints, 0.1) == 0)


def test_jax_runs_on_the_cpu():
    assert jax.default_backend() == "cpu"
