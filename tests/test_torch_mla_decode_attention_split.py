"""bf16 mla_decode_attention (row 6) on mla_decode_split_kernel<false>
(csrc/mla_decode.cu): the split-KV decode of mla_decode_fused without its
current-token block, for a cache that already holds the current token
(lengths count it, qp comes roped).

On the CPU:
- the route (``attention_route``: bf16 to the split kernel, float32 to the
  first version) and the kernel's name among the routed kernels;
- the split plan it shares with row 5 (``decode_split_plan``, a pure
  function of (B, S, H, SMs), lengths never read on the host) at the
  shapes the card and chip_smoke.py time, with the counts: every live row
  in exactly one split, no current-token block, the merge reading only the
  splits that hold a row (none for an empty sequence, which gives zeros);
- the kernel's arithmetic in its order (tiles of 64 rows per split into
  (m, l, acc) in log2 units, the live splits merged in split order)
  against the JAX package's Pallas kernel in interpret mode and against
  the port's plain version: 2e-5 of the largest output in float32 (order
  of sums, exp2 of log2-scaled scores against exp), 1e-2 with bf16 mma
  operands (queries, keys and P rounded to bf16), the card's tolerance.

On the card (the ``cuda`` fixture; skipped here): B = 1 and 8, lengths
{0, 1, 63, 64, 65, 2048} over S = 4096, NaN in every cache row the kernel
must not read: every output row within 1e-2 of its own largest value of
the plain version, a second call bit-identical, one launch counted on the
split kernel; float32 keeps the first version:

    python -m pytest --noconftest tests/test_torch_mla_decode_attention_split.py -q
"""

import numpy as np
import pytest
import torch

from ktransformers_tpu_torch.ops.cuda import (
    LAUNCHES,
    ROUTED_KERNELS,
    ROUTED_LAUNCHES,
)
from ktransformers_tpu_torch.ops.cuda import mla_decode as MD

F32_TOL = 2e-5
BF16_TOL = 1e-2
LOG2E = 1.4426950408889634
NEG = -1e30
TK = 64  # rows a tile of the split kernel
SPLIT = "mla_decode_split_kernel<false>"


@pytest.fixture
def cuda():
    """The card, or a skip: CUDA kernels cannot run on the CPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


# ------------------------------------------------------------------ route


@pytest.mark.parametrize("dtype, want", [(torch.bfloat16, "split"),
                                         (torch.float32, "first")])
def test_attention_route(dtype, want):
    assert MD.attention_route(dtype) == want
    assert MD.ATTENTION_KERNEL_NAMES == {"split": SPLIT}
    assert ROUTED_KERNELS[SPLIT] == ("mla_decode_attention",)


# ------------------------------------------------------------- split plan


@pytest.mark.parametrize("b, s, want", [
    (1, 512, (8, 64)),      # row 6's 512 rows at B = 1: the 64-row floor
    (1, 2048, (32, 64)),    # 2048 rows: 32 splits, the most
    (1, 4096, (32, 128)),   # the card tests' S = 4096
    (8, 2048, (16, 128)),   # B = 8: 128 blocks, about one an SM
    (8, 4096, (16, 256)),
    (1, 1024, (16, 64)),    # the Generator's max_len
])
def test_attention_split_plan(b, s, want):
    """(splits, span) at 16 heads on 132 SMs; the grid is (B, splits, 1)
    with no block for a current token."""
    assert MD.decode_split_plan(b, s, 16, 132) == want


def _split_rows(length, splits, span):
    return [(j * span, min(length, (j + 1) * span)) for j in range(splits)]


@pytest.mark.parametrize("b, s", [(1, 512), (1, 2048), (1, 4096), (8, 2048),
                                  (8, 4096)])
def test_every_live_row_in_one_split(b, s):
    """The rows of each length in [0, S] (those the card tests take and
    every page boundary) lie in exactly one split; the merge reads the
    ceil(length / span) splits that hold a row, none at length 0."""
    splits, span = MD.decode_split_plan(b, s, 16, 132)
    for length in sorted({0, 1, 63, 64, 65, 2047, 2048, s - 1, s}):
        if length > s:
            continue
        rows = _split_rows(length, splits, span)
        seen = np.zeros(s, np.int32)
        for lo, hi in rows:
            seen[lo:max(lo, hi)] += 1
        assert (seen[:length] == 1).all() and (seen[length:] == 0).all()
        live = min(splits, -(-length // span))
        assert sum(hi > lo for lo, hi in rows) == live
        assert all(hi > lo for lo, hi in rows[:live])


# -------------------------------------------------------------- emulation


def _bf(t, on):
    return t.to(torch.bfloat16).to(torch.float32) if on else t


def attention_walk(qn, qp, ckv, kpe, lengths, scale, splits, span, bf16):
    """mla_decode_split_kernel<false>'s walk: per sequence, split j takes
    rows [j span, min(length, (j + 1) span)) in tiles of 64 into (m, l,
    acc) in log2 units (P rounded to bf16 for P V where bf16); a split
    with no row writes nothing; the last block merges the live splits in
    split order with weights exp2(m_j - M) / L; no state gives zeros."""
    b, h, r = qn.shape
    sl = scale * LOG2E
    out = torch.zeros(b, h, r)
    for i in range(b):
        q = _bf(torch.cat([qn[i], qp[i]], -1), bf16)
        recs = []
        for lo, hi in _split_rows(int(lengths[i]), splits, span):
            if hi <= lo:
                continue
            m, l, acc = torch.full((h,), NEG), torch.zeros(h), torch.zeros(h, r)
            for k0 in range(lo, hi, TK):
                keys = _bf(torch.cat([ckv[i, k0:min(hi, k0 + TK)],
                                      kpe[i, k0:min(hi, k0 + TK)]], -1), bf16)
                x = (q @ keys.T) * sl
                m_new = torch.maximum(m, x.amax(-1))
                corr = torch.exp2(m - m_new)
                p = torch.exp2(x - m_new[:, None])
                l = l * corr + p.sum(-1)
                acc = acc * corr[:, None] + _bf(p, bf16) @ keys[:, :r]
                m = m_new
            recs.append((m, l, acc))
        if not recs:
            continue
        ms = torch.stack([st[0] for st in recs])
        w = torch.exp2(ms - ms.amax(0))
        norm = (torch.stack([st[1] for st in recs]) * w).sum(0)
        for k, st in enumerate(recs):
            out[i] += (w[k] / norm)[:, None] * st[2]
    return out


def _case(rng, b, h, smax, lens, r=64, dr=16):
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    qn, qp, ckv, kpe = f(b, h, r), f(b, h, dr), f(b, smax, r), f(b, smax, dr)
    for i, n in enumerate(lens):
        ckv[i, n:] = np.nan  # never read: the walk cuts at the length
        kpe[i, n:] = np.nan
    return qn, qp, ckv, kpe, np.asarray(lens, np.int32)


@pytest.mark.parametrize("h", [4, 20])
@pytest.mark.parametrize("plan", [(1, 256), (4, 64), (16, 16)])
@pytest.mark.parametrize("bf16", [False, True])
def test_walk_matches_pallas(h, plan, bf16):
    """Lengths 0, 1, 63, 64, 65, 200 and 256 (the whole cache) over a
    256-row cache under one split, four and sixteen; H = 20 is two head
    tiles of 16 on the card (heads are independent). Held to the Pallas
    kernel (interpret mode, float32) and to the port's plain version."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from ktransformers_tpu.ops.pallas import mla_decode as jmd

    rng = np.random.default_rng(h + plan[0])
    lens = [0, 1, 63, 64, 65, 200, 256]
    arrays = _case(rng, len(lens), h, 256, lens)
    scale = (32 + 16) ** -0.5
    with jax.default_device(jax.devices("cpu")[0]):  # float32 on the CPU
        ref = np.asarray(jmd.mla_decode_attention(
            *map(jnp.asarray, arrays), scale=scale, block_s=64,
            interpret=True))
    out = attention_walk(*map(torch.from_numpy, arrays), scale, *plan, bf16)
    assert not out[0].abs().max().item()  # length 0: zeros
    tol = BF16_TOL if bf16 else F32_TOL
    assert np.isfinite(out.numpy()).all()
    err = np.abs(out.numpy() - ref).max() / np.abs(ref).max()
    assert err <= tol, err
    plain = MD.mla_decode_attention_ref(*map(torch.from_numpy, arrays),
                                        scale)
    assert float((out - plain).abs().max() / plain.abs().max()) <= tol


# ------------------------------------------------------------ on the card


def _card_case(cuda, lens, smax=4096, h=16, dtype=torch.bfloat16, seed=0):
    g = torch.Generator(device=cuda)
    g.manual_seed(seed)

    def rn(*s):
        return torch.randn(*s, generator=g, device=cuda).to(dtype)

    b = len(lens)
    qn, qp = rn(b, h, 512), rn(b, h, 64)
    ckv, kpe = rn(b, smax, 512), rn(b, smax, 64)
    for i, n in enumerate(lens):
        ckv[i, n:] = float("nan")
        kpe[i, n:] = float("nan")
    lengths = torch.tensor(lens, dtype=torch.int32, device=cuda)
    return qn, qp, ckv, kpe, lengths, (128 + 64) ** -0.5


def _rows_rel(out, ref):
    """The worst output row's error against its own largest value (rows of
    an empty sequence must be zero on both sides)."""
    d = (out.float() - ref.float()).abs().amax(-1)
    top = ref.float().abs().amax(-1)
    assert bool((d[top == 0] == 0).all())
    return float((d / top.clamp_min(1e-30)).max())


@pytest.mark.cuda
@pytest.mark.parametrize("lens", [[0], [1], [63], [64], [65], [2048],
                                  [0, 1, 63, 64, 65, 2048, 4096, 1000]])
def test_split_kernel_on_the_card(cuda, lens):
    args = _card_case(cuda, lens, seed=len(lens) + lens[-1])
    before = (LAUNCHES["mla_decode_attention"], ROUTED_LAUNCHES[SPLIT])
    out = MD.mla_decode_attention(*args)
    torch.cuda.synchronize()
    assert (LAUNCHES["mla_decode_attention"], ROUTED_LAUNCHES[SPLIT]) == (
        before[0] + 1, before[1] + 1)
    assert out.dtype == torch.bfloat16
    assert bool(torch.isfinite(out.float()).all())
    ref = MD.mla_decode_attention_ref(*args)
    assert _rows_rel(out, ref) <= BF16_TOL
    for i, n in enumerate(lens):
        if n == 0:
            assert not out[i].float().abs().max().item()
    assert torch.equal(MD.mla_decode_attention(*args), out)


@pytest.mark.cuda
def test_split_beside_the_first_version(cuda):
    """The first version on the same bf16 operands is held to the same
    plain version (what chip_smoke.py times beside the split kernel)."""
    args = _card_case(cuda, [1, 64, 65, 512, 513, 1000, 2047, 2048],
                      smax=2048)
    ref = MD.mla_decode_attention_ref(*args)
    for kernel in ("split", "first"):
        launch, out = MD.attention_launcher(*args, kernel=kernel)
        launch()
        torch.cuda.synchronize()
        assert _rows_rel(out, ref) <= BF16_TOL, kernel


@pytest.mark.cuda
def test_float32_keeps_the_first_version(cuda):
    args = _card_case(cuda, [0, 5, 300], smax=512, dtype=torch.float32)
    before = ROUTED_LAUNCHES[SPLIT]
    out = MD.mla_decode_attention(*args)
    torch.cuda.synchronize()
    assert ROUTED_LAUNCHES[SPLIT] == before
    ref = MD.mla_decode_attention_ref(*args)
    assert float((out - ref).abs().max() / ref.abs().max()) <= 1e-5


@pytest.mark.cuda
def test_split_kernel_refuses_float32(cuda):
    args = _card_case(cuda, [5], smax=64, dtype=torch.float32)
    with pytest.raises(ValueError, match="bfloat16"):
        MD.attention_launcher(*args, kernel="split")
