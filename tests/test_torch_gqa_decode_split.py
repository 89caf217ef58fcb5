"""The rules and the walk of the bf16 paged GQA decode redesigned as a
one-launch split-KV kernel on the tensor cores, gqa_decode_split_kernel
(gqa_paged_decode, csrc/gqa_paged_attention.cu), held against the JAX
package's Pallas kernel (interpret mode) on the same numpy inputs, with
shuffled page tables and NaN in every pool row the kernel must not read.

The CUDA kernel runs only on the card (tests/test_torch_cuda.py
-k gqa_decode and chip_smoke.py hold it to the plain version there). What
these tests hold on the CPU:
- the route table of ops/cuda/paged_attention.gqa_decode_route (bf16 to
  the split kernel, float32 to the first version);
- the split plan (gqa_decode_split_plan, a pure function of the shapes)
  and the cut each block makes of its sequence's keys from the length on
  the card (gqa_decode_split_rows, the kernel's split_chunk): every key
  the query sees, [max(0, len - window), len), in exactly one split, in
  order, for every length of the pool at B = 1 and 8, page 16 and 64;
  no split takes a key outside the window, and the splits past the last
  key take none (their blocks write no state and the merge skips them);
- the kernel's arithmetic in its order: per (sequence, KV head) the G
  query heads as the rows of one mma row group, per split key tiles of
  64 read through the page table, each tile's keys split between 4 warps
  (16 each) with their own online softmax in log2 units, P rounded to
  bf16 before P V where the operands are bf16; the warps' states merged
  in warp order, then the splits' in split order (weights exp2(m_i - M) /
  L); a sequence with no key gives zeros.

Tolerances, as a share of the reference's largest magnitude:
- 2e-5 for the float32 walk: both sides accumulate in float32 and differ
  only in the order of sums and in exp2 of log2-scaled scores against exp;
- 1e-2 for the bf16 walk (queries, keys, values and P rounded to bf16 as
  the kernel's mma operands): the bf16 rounding of 8 mantissa bits, the
  tolerance the card tests hold the kernel to.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ktransformers_tpu.ops.pallas import paged_attention as jpa
from ktransformers_tpu_torch.ops.cuda import paged_attention as PA
from tests.test_torch_mla_attention import _bf, _online, _rel
from tests.test_torch_model import one_torch_thread  # noqa: F401
from tests.test_torch_paged_attention_mma import _pool

F32_TOL = 2e-5
BF16_TOL = 1e-2
LOG2E = 1.4426950408889634
NEG = -1e30
TK = 64     # keys a tile
WARPS = 4   # warps a block, 16 keys of each tile apiece
D, HKV = 128, 2
LENS = [0, 1, 15, 16, 17, 63, 64, 65, 130, 200, 256]


def test_route_table():
    """bf16 calls take the split kernel; float32 calls keep the first
    version (and its combine launch), whose card tests hold 1e-5; both take
    up to 16 query heads a KV head (the first version 8 until GLM-4.5-Air's
    12 needed more)."""
    assert PA.gqa_decode_route(torch.bfloat16) == "split"
    assert PA.gqa_decode_route(torch.float32) == "first"
    assert PA.GQA_DECODE_KERNEL_NAMES == {"split": "gqa_decode_split_kernel"}
    assert PA.GQA_SPLIT_GMAX == 16 and PA.GQA_KERNEL_GMAX == 16


# --------------------------------------------------------------- split plan


@pytest.mark.parametrize("b, hkv, capacity, want", [
    (8, 8, 2048, 4),    # Mixtral's serving batch: 256 blocks
    (1, 8, 2048, 32),   # one sequence: the cap of 32 splits
    (4, 2, 128, 2),     # a small pool: no more splits than tiles
    (64, 8, 2048, 1),   # a batch that fills the card alone
    (8, 4, 2048, 8),    # the Qwen models' serving batch: 4 KV heads
    (1, 4, 2048, 32),
])
def test_split_plan(b, hkv, capacity, want):
    """The most splits whose (B x Hkv x splits) blocks fit the card at
    once, two an SM; at most 32 splits (one merge record a lane) and no
    more than the pool's 64-key tiles."""
    assert PA.gqa_decode_split_plan(b, hkv, capacity, 132) == want


@pytest.mark.parametrize("b, capacity, want", [
    (8, 4672, 8),   # Qwen3-Next's serving batch (2 KV heads): 128 blocks
    (1, 4672, 32),  # one sequence: the cap
    (8, 576, 8),    # 9 tiles, one SM's block each for 8 x 2 x 8 blocks
    (64, 4672, 1),
])
def test_split_plan_d256(b, capacity, want):
    """At head dim 256 the kernel's shared memory (206 KB) lets an SM hold
    one block, so the plan fills the card with one an SM: half the D = 128
    splits where the card, not the cap or the tiles, sets the count."""
    assert PA.GQA_DECODE_BLOCKS_PER_SM == {128: 2, 256: 1}
    assert PA.gqa_decode_split_plan(b, 2, capacity, 132, 256) == want
    assert PA.gqa_decode_split_plan(b, 2, capacity, 132, 128) >= want


@pytest.mark.parametrize("window", [0, 20, 512])
@pytest.mark.parametrize("b", [1, 8])
@pytest.mark.parametrize("page", [16, 64])
def test_split_rows_cover_every_key_once(page, b, window):
    """At Mixtral's serving pool (2048 positions a sequence, 8 KV heads),
    for every length 0 .. 2048: the live splits tile the keys the query
    sees in order, without gap or overlap, each at least one 64-key tile
    and a multiple of 16 keys but for the last; the splits past the last
    key are empty, so no split takes a key outside the window."""
    capacity = 2048
    splits = PA.gqa_decode_split_plan(b, 8, capacity, 132)
    assert 1 <= splits <= PA.GQA_DECODE_MAX_SPLITS
    for length in range(capacity + 1):
        kbeg = max(0, length - window) if window else 0
        runs = PA.gqa_decode_split_rows(length, window, splits)
        assert len(runs) == splits
        live = [(lo, hi) for lo, hi in runs if hi > lo]
        assert runs[:len(live)] == live
        edges = [kbeg] + [hi for _, hi in live]
        assert [lo for lo, _ in live] == edges[:-1] and edges[-1] == length
        for lo, hi in live[:-1]:
            assert hi - lo >= PA.GQA_DECODE_MIN_SPAN
            assert (hi - lo) % PA.GQA_DECODE_UNIT == 0
        assert all(kbeg <= lo and hi <= length for lo, hi in live)


def test_split_rows_leave_splits_without_keys():
    """A window shorter than a split's least keys (20 < 64) leaves one live
    split and the rest empty; so does a short sequence; a long one gives
    every split work, even under a window of 512."""
    assert PA.gqa_decode_split_rows(2048, 20, 5) == [(2028, 2048)] + [
        (2028 + 64 * j, 2048) for j in range(1, 5)]
    assert sum(hi > lo for lo, hi in PA.gqa_decode_split_rows(65, 0, 5)) == 2
    runs = PA.gqa_decode_split_rows(2048, 512, 5)
    assert all(hi > lo for lo, hi in runs)
    assert runs[0][0] == 1536 and runs[-1][1] == 2048


# ---------------------------------------------------------------- the walk


@functools.lru_cache(maxsize=None)
def _case(g: int, window: int, page: int):
    """numpy operands over 256 positions a sequence (the last row an
    inactive batch row: zero table, length 1, on page 0's finite row 0)
    and the Pallas kernel's output (interpret mode) on the rows with a
    key."""
    rng = np.random.default_rng(g * 1000 + window + page)
    pmax = 256 // page
    b = len(LENS) + 1
    (k, v), tables = _pool(rng, b, pmax, page, LENS + [0],
                           [(HKV, D), (HKV, D)])
    k[0, 0] = rng.standard_normal((HKV, D))
    v[0, 0] = rng.standard_normal((HKV, D))
    tables[-1] = 0
    q = rng.standard_normal((b, g * HKV, D)).astype(np.float32)
    lengths = np.asarray(LENS + [1], np.int32)
    live = lengths > 0
    ref = np.asarray(jpa.gqa_paged_decode(
        *map(jnp.asarray, (q[live], k, v, tables[live], lengths[live])),
        D ** -0.5, window=window, interpret=True))
    return (q, k, v, tables, lengths), ref


def decode_walk(q, k_pages, v_pages, tables, lengths, scale, window, splits,
                bf16):
    """gqa_decode_split_kernel's walk: (out [B, H, D], states),
    states[b][j] = the (m, l) split j of sequence b wrote for KV head 0
    (None for a split with no key: it writes nothing and the merge skips
    it)."""
    b, h, d = q.shape
    page, hkv = k_pages.shape[1], k_pages.shape[2]
    pmax = tables.shape[1]
    g = h // hkv
    sl = scale * LOG2E
    out = torch.zeros(b, h, d)
    states = []
    for i in range(b):
        length = min(max(int(lengths[i]), 0), page * pmax)
        runs = PA.gqa_decode_split_rows(length, window, splits)
        for kh in range(hkv):
            kpool = k_pages[:, :, kh].reshape(-1, d)
            vpool = v_pages[:, :, kh].reshape(-1, d)
            qr = _bf(q[i, kh * g:(kh + 1) * g], bf16)
            recs = []
            for lo, hi in runs:
                if hi <= lo:
                    recs.append(None)
                    continue
                warps = [(torch.full((g,), NEG), torch.zeros(g),
                          torch.zeros(g, d)) for _ in range(WARPS)]
                for k0 in range(lo, hi, TK):
                    for w in range(WARPS):
                        kb = k0 + w * (TK // WARPS)
                        if kb >= hi:
                            continue
                        kpos = torch.arange(kb, kb + TK // WARPS)
                        live = kpos < hi  # rows past it: zero-filled
                        at = torch.where(live, kpos, 0)
                        rows = tables[i][at // page].long() * page + at % page
                        zero = torch.zeros(())
                        kt = _bf(torch.where(live[:, None], kpool[rows], zero),
                                 bf16)
                        vt = _bf(torch.where(live[:, None], vpool[rows], zero),
                                 bf16)
                        ok = live[None].expand(g, -1)
                        warps[w] = _online(warps[w], (qr @ kt.T) * sl, vt,
                                           ok, bf16)
                # the warps' states in warp order
                mm = torch.stack([st[0] for st in warps]).amax(0)
                a = [torch.exp2(st[0] - mm) for st in warps]
                ll = sum(st[1] * aw for st, aw in zip(warps, a))
                acc = sum(st[2] * aw[:, None] for st, aw in zip(warps, a))
                recs.append((mm, ll, acc))
            live_recs = [st for st in recs if st is not None]
            rows_out = slice(kh * g, (kh + 1) * g)
            if splits == 1 and live_recs:
                m, ll, acc = live_recs[0]
                out[i, rows_out] = acc / torch.clamp(ll, min=1e-30)[:, None]
            elif live_recs:  # the merge in split order
                m_all = torch.stack([st[0] for st in live_recs])
                wts = torch.exp2(m_all - m_all.amax(0))
                inv = 1.0 / torch.clamp(
                    (torch.stack([st[1] for st in live_recs]) * wts).sum(0),
                    min=1e-30)
                for k, st in enumerate(live_recs):
                    out[i, rows_out] += (wts[k] * inv)[:, None] * st[2]
            if kh == 0:
                states.append([None if st is None else (st[0], st[1])
                               for st in recs])
    return out, states


@pytest.mark.parametrize("plan", ["one", "planned"])
@pytest.mark.parametrize("window", [0, 20])
@pytest.mark.parametrize("g", [1, 4, 6, 7, 8, 12, 16])
@pytest.mark.parametrize("bf16", [False, True])
def test_walk_matches_pallas(g, window, plan, bf16):
    """Lengths 0 (zeros), 1, on and around 16-key units and 64-key tiles,
    130, 200 and 256 (the whole pool) and an inactive batch row over a
    pool of page 16; G = 1, 4, 6, 7, 8, 12 (GLM-4.5-Air) and 16 query heads
    a KV head; window 0
    and 20 (one live split, the others without a key); one split and the
    plan's four. The rows with a key against the Pallas kernel, all of
    them against the port's plain version."""
    arrays, ref = _case(g, window, 16)
    args = [torch.from_numpy(a) for a in arrays]
    splits = 1 if plan == "one" else PA.gqa_decode_split_plan(
        len(LENS) + 1, HKV, 256, 132)
    assert plan == "one" or splits == 4
    out, states = decode_walk(*args, D ** -0.5, window, splits, bf16)
    assert torch.isfinite(out).all()
    tol = BF16_TOL if bf16 else F32_TOL
    live = np.asarray(LENS + [1]) > 0
    assert _rel(out[live].numpy(), ref) <= tol
    assert torch.all(out[0] == 0)
    plain = PA.gqa_paged_decode_ref(*args, D ** -0.5, window=window)
    assert _rel(out.numpy(), plain.numpy()) <= tol
    # a split with no key writes no state
    for length, recs in zip(LENS + [1], states):
        assert [st is None for st in recs] == [
            hi <= lo for lo, hi in PA.gqa_decode_split_rows(length, window,
                                                            splits)]


def test_walk_page_64_most_splits():
    """Page 64 (four pages a sequence) at the most splits the kernel takes
    (32: all but a few hold no key), bf16, against the Pallas kernel."""
    arrays, ref = _case(4, 0, 64)
    args = [torch.from_numpy(a) for a in arrays]
    out, _ = decode_walk(*args, D ** -0.5, 0, PA.GQA_DECODE_MAX_SPLITS, True)
    live = np.asarray(LENS + [1]) > 0
    assert _rel(out[live].numpy(), ref) <= BF16_TOL


def test_no_key_in_the_window_gives_zeros():
    """A sequence with no key (length 0), with or without a window, gives
    zeros in the walk and in the plain version; the inactive row (zero
    table, length 1) a finite result."""
    arrays, _ = _case(4, 20, 16)
    args = [torch.from_numpy(a) for a in arrays]
    for window in (0, 20):
        out, states = decode_walk(*args, D ** -0.5, window, 4, True)
        assert torch.all(out[0] == 0) and all(st is None
                                              for st in states[0])
        plain = PA.gqa_paged_decode_ref(*args, D ** -0.5, window=window)
        assert torch.all(plain[0] == 0)
        assert torch.isfinite(out[-1]).all() and out[-1].abs().max() > 0


def test_jax_runs_on_the_cpu():
    assert jax.default_backend() == "cpu"
