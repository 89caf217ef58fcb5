"""The port's CUDA kernels on the card against their plain versions on the
CPU, at small and ragged shapes that chip_smoke.py's bench shapes do not
reach: row counts that leave partial tiles, a down group of 96, repeated
and missing experts, rows past the grouped total, an empty cache.

Needs an NVIDIA GPU: every test carries the ``cuda`` marker (registered in
tests/conftest.py) and skips elsewhere (the decision is taken inside the
``cuda`` fixture, never at import). This file imports nothing of JAX, so
it runs on a machine without it:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

(``--noconftest`` because tests/conftest.py imports JAX.)

Tolerances, as a share of the reference's largest magnitude:
- 1e-5 for float32 outputs of the dense matmul, the activation prep and
  the MLA decode: the integer dots are exact on both sides and only the
  order of float32 sums differs;
- 1e-2 for the FFN kernels: the GLU output's float32 sums run in another
  order than on the CPU, which can move an int8 code of the requant by
  one step (1/127 of its group's largest value);
- 1e-2 for bfloat16 outputs (8 mantissa bits);
- 1e-5 (float32) and 1e-2 (bfloat16) for the two paged-attention kernels:
  float32 accumulation on both sides, another order of sums;
- the same 1e-5 / 1e-2 for the quant_matmul family (the weight is decoded
  and rounded to the activations' type identically on both sides) and for
  mla_decode_attention;
- 1e-5 / 1e-2 for the gathered and grouped W4A8 matmuls (as the dense one)
  and for the two GQA paged-attention kernels (as the MLA ones);
- 1e-5 / 1e-2 for the W4A8 GEMV at the main path's widths, held to the
  plain group dot of the kernel's own activation codes on the card (the
  prep is held to its plain version by test_w4a8_prep), and 1e-2 for the
  W4A8 FFN on tensor cores (as the FFN kernels);
- 1e-2 for the bf16 attention kernels on the tensor cores
  (mla_decode_split_kernel and mla_prefill_mma_kernel, `-k mla`;
  mla_paged_decode_split_kernel and gqa_prefill_mma_kernel,
  `-k "gqa or mla_paged"`, each sequence or chunk against its own largest
  value): bf16 scores summed in float32, P rounded to bf16 before P V;
  float32 calls keep the first versions at 1e-5;
- 1e-5 for the transposed matmuls of the SFT backward at these widths
  (N <= 3648; dx is float32; both sides round the same operands to bf16,
  the kernel sums their products on the tensor cores, the plain version
  in f32 FMAs), and 1e-2 for dx through ops/vjp.QuantMatmulFn on the card
  (returned in bf16).
"""

import dataclasses

import numpy as np
import pytest
import torch

from ktransformers_tpu_torch.ops.cuda import LAUNCHES, ROUTED_LAUNCHES
from ktransformers_tpu_torch.ops.cuda import w4a8_ffn as F
from ktransformers_tpu_torch.ops.cuda import w4a8_matmul as MM
from ktransformers_tpu_torch.ops.cuda import paged_attention as PA
from ktransformers_tpu_torch.ops.cuda import mla_decode as MD
from ktransformers_tpu_torch.ops.cuda import quant_matmul as QM
from ktransformers_tpu_torch.ops.cuda import quant_matmul_t as QT
from ktransformers_tpu_torch.ops.cuda.mla_decode import mla_decode_fused
from ktransformers_tpu_torch.ops.rope import rope_rotation_matrix
from ktransformers_tpu_torch.quant.formats import quantize
from ktransformers_tpu_torch.quant.w4a8 import repack_offset_lo, w4a8_prep

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    """The card, or a skip: CUDA kernels cannot run on the CPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _rel(out: torch.Tensor, ref: torch.Tensor) -> float:
    out, ref = out.detach().float().cpu(), ref.detach().float().cpu()
    return float((out - ref).abs().max() / ref.abs().max())


def _w(rng, shape, gs=128):
    w = rng.standard_normal(shape).astype(np.float32) * 0.1
    return repack_offset_lo(quantize(torch.from_numpy(w), "int4_g", gs))


def _x(rng, *shape):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))


def _counted(name, fn):
    before = LAUNCHES[name]
    out = fn()
    torch.cuda.synchronize()
    assert LAUNCHES[name] == before + 1, name
    return out


@pytest.mark.parametrize("m", [1, 3, 8, 72])
@pytest.mark.parametrize("gs", [64, 128])
def test_dense_w4a8_matmul(cuda, m, gs):
    rng = np.random.default_rng(m * gs)
    w, x = _w(rng, (256, 384), gs), _x(rng, m, 256)
    out = _counted("dense_w4a8_matmul",
                   lambda: MM.dense_w4a8_matmul(x.to(cuda), w.to(cuda)))
    assert out.dtype == torch.float32
    assert _rel(out, MM.w4a8_matmul_ref(x, w)) <= 1e-5
    xb = x.bfloat16()
    out = MM.dense_w4a8_matmul(xb.to(cuda), w.to(cuda))
    assert out.dtype == torch.bfloat16
    assert _rel(out, MM.w4a8_matmul_ref(xb, w)) <= 1e-2


@pytest.mark.parametrize("m, k, gs", [(1, 2048, 128), (5, 192, 96),
                                      (70, 256, 64)])
def test_w4a8_prep(cuda, m, k, gs):
    """Codes and scales bit-exact (the group maxima do not depend on the
    order of reduction), the sums t to float32 rounding."""
    x = _x(np.random.default_rng(m), m, k)
    out = _counted("w4a8_prep",
                   lambda: MM.prep_activations(x.to(cuda), k, gs))
    ref = w4a8_prep(x, k, gs)
    for name, a, b in zip(("qa", "qb", "sa", "sb"), out, ref):
        assert torch.equal(a.cpu(), b), name
    assert _rel(out[4], ref[4]) <= 1e-5


@pytest.mark.parametrize("act", ["silu", "relu", "gelu"])
def test_gathered_w4a8_ffn(cuda, act):
    rng = np.random.default_rng(11)
    gu, dn = _w(rng, (8, 256, 2 * 128), 64), _w(rng, (8, 128, 256), 64)
    x = _x(rng, 7, 256)
    ids = torch.tensor([3, 0, 5, 3, 7, 1, 3], dtype=torch.int32)
    out = _counted("gathered_w4a8_ffn", lambda: F.gathered_w4a8_ffn(
        x.to(cuda), gu.to(cuda), dn.to(cuda), ids.to(cuda), act))
    assert _rel(out, F.gathered_w4a8_ffn_ref(x, gu, dn, ids, act)) <= 1e-2


@pytest.mark.parametrize("m", [1, 33])
def test_dense_w4a8_ffn_down_group_96(cuda, m):
    """inter 576 takes a down group of 96, as the 10944 of
    DeepSeek-V2-Lite's dense layer does."""
    rng = np.random.default_rng(20 + m)
    gu, dn = _w(rng, (256, 2 * 576)), _w(rng, (576, 256))
    assert dn.group_size == 96
    x = _x(rng, m, 256)
    out = _counted("dense_w4a8_ffn", lambda: F.dense_w4a8_ffn(
        x.to(cuda), gu.to(cuda), dn.to(cuda)))
    assert _rel(out, F.dense_w4a8_ffn_ref(x, gu, dn)) <= 1e-2


def test_grouped_w4a8_ffn_empty_expert_and_tail(cuda):
    """Expert 1 has no rows, the group sizes cut tiles short, and the
    rows past their sum come back zero."""
    rng = np.random.default_rng(5)
    gu, dn = _w(rng, (4, 256, 2 * 256)), _w(rng, (4, 256, 256))
    xs = _x(rng, 24, 256)
    sizes = torch.tensor([5, 0, 11, 3], dtype=torch.int32)
    out = _counted("grouped_w4a8_ffn", lambda: F.grouped_w4a8_ffn(
        xs.to(cuda), gu.to(cuda), dn.to(cuda), sizes.to(cuda)))
    assert torch.all(out[19:] == 0)
    assert _rel(out, F.grouped_w4a8_ffn_ref(xs, gu, dn, sizes)) <= 1e-2


@pytest.mark.parametrize("dtype, tol", [(torch.float32, 1e-5),
                                        (torch.bfloat16, 1e-2)])
def test_mla_decode_fused(cuda, dtype, tol):
    """Cached lengths 0 (the current token alone), 37 and 63 of 64."""
    rng = np.random.default_rng(2)
    b, h, r, dr, smax = 3, 8, 512, 64, 64
    qn, qp, kv = _x(rng, b, h, r), _x(rng, b, h, dr), _x(rng, b, 1, r + dr)
    gamma = _x(rng, r) * 0.1 + 1.0
    rot = rope_rotation_matrix(_x(rng, b, dr // 2), _x(rng, b, dr // 2), True)
    ckv, kpe = _x(rng, b, smax, r), _x(rng, b, smax, dr)
    lengths = torch.tensor([0, 37, 63], dtype=torch.int32)
    cast = [t.to(dtype) for t in (qn, qp, kv)] + [gamma, rot] + [
        t.to(dtype) for t in (ckv, kpe)] + [lengths]
    args = (0.07, 1e-6)
    split = ROUTED_LAUNCHES["mla_decode_split_kernel"]
    out = _counted("mla_decode_fused", lambda: mla_decode_fused(
        *[t.to(cuda) for t in cast], *args))
    # bf16 takes the split kernel, float32 the first version
    assert ROUTED_LAUNCHES["mla_decode_split_kernel"] == split + (
        dtype == torch.bfloat16)
    ref = mla_decode_fused(*cast, *args)
    for o, rf in zip(out, ref):
        assert o.dtype == dtype
        assert _rel(o, rf) <= tol


def _paged_pool(rng, b, pmax, page, dtype, live):
    """Shuffled page tables over a pool whose unused pages, and whose rows
    at or past each sequence's live length, are NaN."""
    r, dr = 512, 64
    num_pages = b * pmax + 1
    perm = rng.permutation(num_pages - 1)[: b * pmax] + 1
    tables = torch.from_numpy(perm.reshape(b, pmax).astype(np.int32))
    ckv = torch.full((num_pages, page, r), float("nan"))
    kpe = torch.full((num_pages, page, dr), float("nan"))
    for i, n in enumerate(live):
        for pos in range(n):
            pid, slot = int(tables[i, pos // page]), pos % page
            ckv[pid, slot] = _x(rng, r)
            kpe[pid, slot] = _x(rng, dr)
    return ckv.to(dtype), kpe.to(dtype), tables


@pytest.mark.parametrize("page, pmax", [(8, 8), (16, 8), (64, 4), (128, 2)])
@pytest.mark.parametrize("dtype, tol", [(torch.float32, 1e-5),
                                        (torch.bfloat16, 1e-2)])
def test_mla_paged_decode(cuda, page, pmax, dtype, tol):
    """Lengths 0 (no key: zeros), 1, one page, one page + 1, all pages;
    every row the kernel must not read is NaN."""
    rng = np.random.default_rng(page)
    lens = [0, 1, page, page + 1, page * pmax - 1, page * pmax]
    b, h = len(lens), 8
    ckv, kpe, tables = _paged_pool(rng, b, pmax, page, dtype, lens)
    qn, qp = _x(rng, b, h, 512).to(dtype), _x(rng, b, h, 64).to(dtype)
    lengths = torch.tensor(lens, dtype=torch.int32)
    args = (qn, qp, ckv, kpe, tables, lengths)
    out = _counted("mla_paged_decode", lambda: PA.mla_paged_decode(
        *[t.to(cuda) for t in args], 0.07))
    ref = PA.mla_paged_decode(*args, 0.07)
    assert out.dtype == dtype and bool(torch.isfinite(out.float()).all())
    assert torch.all(out[0] == 0)
    assert _rel(out, ref) <= tol


@pytest.mark.parametrize("page, pmax, s", [(8, 16, 16), (16, 8, 64),
                                           (64, 4, 128), (128, 2, 48)])
@pytest.mark.parametrize("dtype, tol", [(torch.float32, 1e-5),
                                        (torch.bfloat16, 1e-2)])
def test_mla_paged_prefill(cuda, page, pmax, s, dtype, tol):
    """Old lengths 0, mid-page and page-aligned, valid < S and == S, and
    an empty chunk on an empty cache (zeros); rows past the live length
    are NaN. Rows >= valid are padding: finite, not compared."""
    rng = np.random.default_rng(page + s)
    room = page * pmax - s
    olds = [0, min(page // 2 + 1, room), min(page, room), 0]
    valids = [s - 5, s, s - 1, 0]
    c, h = len(olds), 4
    live = [o + v for o, v in zip(olds, valids)]
    ckv, kpe, tables = _paged_pool(rng, c, pmax, page, dtype, live)
    qn, qp = _x(rng, c, h, s, 512).to(dtype), _x(rng, c, h, s, 64).to(dtype)
    lengths = torch.tensor(olds, dtype=torch.int32)
    valid = torch.tensor(valids, dtype=torch.int32)
    args = (qn, qp, ckv, kpe, tables, lengths, valid)
    mma = ROUTED_LAUNCHES["mla_prefill_mma_kernel"]
    out = _counted("mla_paged_prefill", lambda: PA.mla_paged_prefill(
        *[t.to(cuda) for t in args], 0.07))
    # bf16 takes the tensor-core kernel, float32 the first version
    assert ROUTED_LAUNCHES["mla_prefill_mma_kernel"] == mma + (
        dtype == torch.bfloat16)
    ref = PA.mla_paged_prefill(*args, 0.07)
    assert out.dtype == dtype and bool(torch.isfinite(out.float()).all())
    assert torch.all(out[3] == 0)
    for i, v in enumerate(valids[:3]):
        assert _rel(out[i, :, :v], ref[i, :, :v]) <= tol, i
    # padding rows see every live key, as in the plain version
    assert _rel(out[0, :, s - 5:], ref[0, :, s - 5:]) <= tol


def _decode_inputs(rng, b, h, smax, lens):
    """bf16 operands of mla_decode_fused, every cache row at or past
    lens[i] NaN."""
    r, dr = 512, 64
    bf = torch.bfloat16
    qn, qp, kv = _x(rng, b, h, r), _x(rng, b, h, dr), _x(rng, b, 1, r + dr)
    gamma = _x(rng, r) * 0.1 + 1.0
    rot = rope_rotation_matrix(_x(rng, b, dr // 2), _x(rng, b, dr // 2), True)
    ckv, kpe = _x(rng, b, smax, r), _x(rng, b, smax, dr)
    for i, n in enumerate(lens):
        ckv[i, n:] = float("nan")
        kpe[i, n:] = float("nan")
    lengths = torch.tensor(lens, dtype=torch.int32)
    return ([t.to(bf) for t in (qn, qp, kv)] + [gamma, rot]
            + [t.to(bf) for t in (ckv, kpe)] + [lengths])


@pytest.mark.parametrize("h", [4, 8, 16, 32])
@pytest.mark.parametrize("smax, lens", [
    (64, [0, 1, 63]),                                 # one split
    (2048, [0, 1, 15, 16, 63, 64, 65, 2047]),         # many; the full cache
    (4096, [2048]),                                   # one sequence, 32 splits
])
def test_mla_decode_split(cuda, h, smax, lens):
    """mla_decode_split_kernel through mla_decode_fused (bf16) against the
    plain version: H a multiple of 16 or not, one split and many (the
    plan's), lengths 0 (the current token alone), on and around 16-row
    units and 64-row tiles, and S - 1 (the current token fills the cache);
    every cache row at or past lengths[b] NaN. A second call gives the same
    bits (the merge's counters were set back)."""
    rng = np.random.default_rng(h + smax)
    cast = _decode_inputs(rng, len(lens), h, smax, lens)
    on = [t.to(cuda) for t in cast]
    args = (0.07, 1e-6)
    split = ROUTED_LAUNCHES["mla_decode_split_kernel"]
    out = _counted("mla_decode_fused", lambda: mla_decode_fused(*on, *args))
    assert ROUTED_LAUNCHES["mla_decode_split_kernel"] == split + 1
    again = mla_decode_fused(*on, *args)
    ref = MD.mla_decode_fused_ref(*cast, *args)
    for o, a, rf in zip(out, again, ref):
        assert o.dtype == torch.bfloat16
        assert bool(torch.isfinite(o.float()).all())
        assert torch.equal(o, a)
        assert _rel(o, rf) <= 1e-2


@pytest.mark.parametrize("splits", ["one", "most"])
def test_mla_decode_split_plans(cuda, splits, monkeypatch):
    """The kernel at a forced plan: one split of the whole cache, and the
    most splits (DECODE_MAX_SPLITS of 32 rows)."""
    rng = np.random.default_rng(4)
    lens = [0, 17, 700, 1023]
    cast = _decode_inputs(rng, len(lens), 16, 1024, lens)
    plan = (1, 1024) if splits == "one" else (MD.DECODE_MAX_SPLITS, 32)
    monkeypatch.setattr(MD, "decode_split_plan", lambda *a: plan)
    out = mla_decode_fused(*[t.to(cuda) for t in cast], 0.07, 1e-6)
    ref = MD.mla_decode_fused_ref(*cast, 0.07, 1e-6)
    for o, rf in zip(out, ref):
        assert _rel(o, rf) <= 1e-2


@pytest.mark.parametrize("h", [4, 6, 8, 16, 32])
@pytest.mark.parametrize("heads", [4, 2])
def test_mla_prefill_mma(cuda, h, heads, monkeypatch):
    """mla_prefill_mma_kernel at both block shapes (4 or 2 heads x 16
    positions) against the plain version: H not a multiple of the block's
    heads, old lengths 0, 1, mid-page, page-aligned and 2048 - S, valid <
    S and == S (S not a multiple of 16), an empty chunk on an empty cache;
    every pool row past the live length NaN. Rows >= valid are padding:
    finite, compared too (they see every live key). A second call gives
    the same bits."""
    rng = np.random.default_rng(h * heads)
    page, pmax, s = 64, 40, 120
    olds = [0, 1, 33, 64, 2048 - s, 0]
    valids = [s - 7, s, s - 1, 50, s, 0]
    c = len(olds)
    live = [o + v for o, v in zip(olds, valids)]
    ckv, kpe, tables = _paged_pool(rng, c, pmax, page, torch.bfloat16, live)
    qn = _x(rng, c, h, s, 512).bfloat16()
    qp = _x(rng, c, h, s, 64).bfloat16()
    lengths = torch.tensor(olds, dtype=torch.int32)
    valid = torch.tensor(valids, dtype=torch.int32)
    args = (qn, qp, ckv, kpe, tables, lengths, valid)
    on = [t.to(cuda) for t in args]
    monkeypatch.setattr(PA, "prefill_plan", lambda *a: heads)
    launch, out = PA.prefill_launcher(*on, 0.07, "mma")
    launch()
    torch.cuda.synchronize()
    first = out.clone()
    launch()
    ref = PA.mla_paged_prefill_ref(*args, 0.07)
    assert bool(torch.isfinite(out.float()).all())
    assert torch.equal(out, first)
    assert torch.all(out[5] == 0)
    for i in range(c - 1):
        assert _rel(out[i], ref[i]) <= 1e-2, i


def test_mla_prefill_mma_plan_route(cuda):
    """The wrapper's bf16 call at the mixed step's chunk takes the
    tensor-core kernel (counted in ROUTED_LAUNCHES) and gives the bits its
    launcher gives."""
    rng = np.random.default_rng(9)
    ckv, kpe, tables = _paged_pool(rng, 1, 8, 64, torch.bfloat16, [300])
    qn = _x(rng, 1, 16, 256, 512).bfloat16()
    qp = _x(rng, 1, 16, 256, 64).bfloat16()
    ints = (tables, torch.tensor([44], dtype=torch.int32),
            torch.tensor([256], dtype=torch.int32))
    on = [t.to(cuda) for t in (qn, qp, ckv, kpe, *ints)]
    mma = ROUTED_LAUNCHES["mla_prefill_mma_kernel"]
    out = _counted("mla_paged_prefill",
                   lambda: PA.mla_paged_prefill(*on, 0.07))
    assert ROUTED_LAUNCHES["mla_prefill_mma_kernel"] == mma + 1
    launch, want = PA.prefill_launcher(*on, 0.07, "mma")
    launch()
    assert torch.equal(out, want)


def test_paged_wrappers_raise_on_what_the_kernels_do_not_take(cuda):
    rng = np.random.default_rng(0)
    ckv, kpe, tables = _paged_pool(rng, 1, 2, 8, torch.float32, [3])
    lengths = torch.tensor([3], dtype=torch.int32)
    qn, qp = _x(rng, 1, 4, 512), _x(rng, 1, 4, 64)
    on = lambda *ts: [t.to(cuda) for t in ts]  # noqa: E731
    with pytest.raises(ValueError, match="int32"):
        PA.mla_paged_decode(*on(qn, qp, ckv, kpe, tables.long(), lengths),
                            0.1)
    with pytest.raises(ValueError, match="H % 4"):
        PA.mla_paged_decode(*on(qn[:, :3].contiguous(),
                                qp[:, :3].contiguous(), ckv, kpe, tables,
                                lengths), 0.1)
    with pytest.raises(ValueError, match="R=512"):
        PA.mla_paged_decode(*on(qn[..., :64].contiguous(), qp,
                                ckv[..., :64].contiguous(), kpe, tables,
                                lengths), 0.1)
    with pytest.raises(ValueError, match="contiguous"):
        # sliced on the card: .to() would lay a strided slice out densely
        PA.mla_paged_decode(_x(rng, 1, 8, 512).to(cuda)[:, ::2],
                            *on(qp, ckv, kpe, tables, lengths), 0.1)


def test_wrappers_raise_instead_of_falling_back(cuda):
    rng = np.random.default_rng(0)
    w = _w(rng, (256, 384)).to(cuda)
    x = _x(rng, 4, 512).to(cuda)
    with pytest.raises(ValueError, match="contiguous"):
        MM.dense_w4a8_matmul(x[:, ::2], w)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        MM.dense_w4a8_matmul(x[:, :256].half(), w)


# ------------------------------------------------ quant_matmul family, row 6

QM_KINDS = ("int8", "fp8", "int4", "int4_g", "int4_gz", "mxfp4", "mxfp8")


def _qw(rng, shape, kind, gs=128):
    w = rng.standard_normal(shape).astype(np.float32) * 0.1
    return quantize(torch.from_numpy(w), kind, gs)


def _both_dtypes(run, ref, x):
    """run / ref take the activations; float32 held to 1e-5, bf16 to 1e-2."""
    out = run(x)
    assert out.dtype == torch.float32 and _rel(out, ref(x)) <= 1e-5
    xb = x.bfloat16()
    out = run(xb)
    assert out.dtype == torch.bfloat16 and _rel(out, ref(xb)) <= 1e-2


@pytest.mark.parametrize("m", [1, 3, 19])
@pytest.mark.parametrize("kind", QM_KINDS)
def test_quant_matmul(cuda, kind, m):
    """K = 192 takes a group of 96 for the int4 group kinds; N = 40 is no
    multiple of the block's 128 columns; 3 and 19 rows leave partial
    tiles."""
    rng = np.random.default_rng(m)
    w, x = _qw(rng, (192, 40), kind), _x(rng, m, 192)
    wc = w.to(cuda)
    _counted("quant_matmul", lambda: QM.quant_matmul(x.to(cuda), wc))
    _both_dtypes(lambda v: QM.quant_matmul(v.to(cuda), wc),
                 lambda v: QM.quant_matmul_ref(v, w), x)


@pytest.mark.parametrize("kind", ["int4", "int4_g"])
def test_quant_matmul_offset_lo(cuda, kind):
    rng = np.random.default_rng(5)
    w, x = _qw(rng, (256, 72), kind), _x(rng, 4, 256)
    ref = QM.quant_matmul_ref(x, w)
    w.data = (w.data ^ 8).view(torch.int8)  # the offset-lo encoding
    w.act_quant = True
    out = QM.quant_matmul(x.to(cuda), w.to(cuda))
    assert _rel(out, ref) <= 1e-5
    assert _rel(QM.quant_matmul_ref(x, w), ref) == 0.0


@pytest.mark.parametrize("kind", QM_KINDS)
def test_gathered_quant_matmul(cuda, kind):
    rng = np.random.default_rng(6)
    w, x = _qw(rng, (8, 128, 72), kind), _x(rng, 7, 128)
    ids = torch.tensor([3, 0, 5, 3, 7, 1, 3], dtype=torch.int32)
    wc = w.to(cuda)
    _counted("gathered_quant_matmul", lambda: QM.gathered_quant_matmul(
        x.to(cuda), wc, ids.to(cuda)))
    _both_dtypes(
        lambda v: QM.gathered_quant_matmul(v.to(cuda), wc, ids.to(cuda)),
        lambda v: QM.gathered_quant_matmul_ref(v, w, ids), x)


@pytest.mark.parametrize("kind", QM_KINDS)
def test_grouped_quant_matmul(cuda, kind):
    """Empty experts, groups that leave partial tiles, and a tail of rows
    past the total, which must come back zero."""
    rng = np.random.default_rng(7)
    w, x = _qw(rng, (5, 128, 48), kind), _x(rng, 88, 128)
    sizes = torch.tensor([9, 0, 70, 0, 4], dtype=torch.int32)
    wc = w.to(cuda)
    out = _counted("grouped_quant_matmul", lambda: QM.grouped_quant_matmul(
        x.to(cuda), wc, sizes.to(cuda)))
    assert not out[83:].abs().max().item()
    _both_dtypes(
        lambda v: QM.grouped_quant_matmul(v.to(cuda), wc, sizes.to(cuda)),
        lambda v: QM.grouped_quant_matmul_ref(v, w, sizes), x)


def test_quant_matmul_padded_scales_and_exponent_zero(cuda):
    """Scale tensors with more group rows than K / G, and a ue8m0 exponent
    of 0 (scale 0)."""
    rng = np.random.default_rng(8)
    x = _x(rng, 2, 128)
    for kind in ("int4_gz", "mxfp4"):
        w = _qw(rng, (128, 40), kind, 64)
        ref = QM.quant_matmul_ref(x, w)
        pad = lambda t: torch.cat([t, torch.zeros_like(t)])  # noqa: E731
        w.scales = pad(w.scales)
        w.zeros = None if w.zeros is None else pad(w.zeros)
        assert _rel(QM.quant_matmul(x.to(cuda), w.to(cuda)), ref) <= 1e-5
    w.scales[0] = 0
    ref = QM.quant_matmul_ref(x, w)
    out = QM.quant_matmul(x.to(cuda), w.to(cuda))
    assert bool(torch.isfinite(out).all()) and _rel(out, ref) <= 1e-5


def test_quant_matmul_refuses_on_the_card(cuda):
    rng = np.random.default_rng(9)
    w = _qw(rng, (128, 42), "int8")  # N no multiple of 4
    with pytest.raises(ValueError, match="multiples of 4"):
        QM.quant_matmul(_x(rng, 1, 128).to(cuda), w.to(cuda))
    w = _qw(rng, (128, 40), "int8")
    with pytest.raises(ValueError, match="operands on"):
        QM.quant_matmul(_x(rng, 1, 128).to(cuda), w)  # weight on the CPU


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mla_decode_attention(cuda, dtype):
    """Full kernel widths (R 512, dr 64), NaN in every cache row at or past
    lengths[b]: lengths on and around multiples of the 8 warps, one row,
    the whole cache and an empty sequence."""
    rng = np.random.default_rng(10)
    b, h, r, dr, smax = 7, 8, 512, 64, 96
    lengths = torch.tensor([1, 8, 9, 64, 65, 96, 0], dtype=torch.int32)
    qn, qp = _x(rng, b, h, r).to(dtype), _x(rng, b, h, dr).to(dtype)
    ckv, kpe = _x(rng, b, smax, r).to(dtype), _x(rng, b, smax, dr).to(dtype)
    for i, n in enumerate(lengths.tolist()):
        ckv[i, n:] = float("nan")
        kpe[i, n:] = float("nan")
    scale = (128 + 64) ** -0.5
    out = _counted("mla_decode_attention", lambda: MD.mla_decode_attention(
        qn.to(cuda), qp.to(cuda), ckv.to(cuda), kpe.to(cuda),
        lengths.to(cuda), scale))
    ref = MD.mla_decode_attention_ref(qn, qp, ckv, kpe, lengths, scale)
    assert out.dtype == dtype and bool(torch.isfinite(out).all())
    assert not out[6].abs().max().item()
    assert _rel(out, ref) <= (1e-5 if dtype == torch.float32 else 1e-2)


def test_mla_decode_attention_refuses(cuda):
    z = lambda *s: torch.zeros(*s, device=cuda)  # noqa: E731
    with pytest.raises(ValueError, match="kernel takes"):
        MD.mla_decode_attention(z(1, 4, 64), z(1, 4, 16), z(1, 8, 64),
                                z(1, 8, 16), z(1).int(), 1.0)
    with pytest.raises(ValueError, match="int32"):
        MD.mla_decode_attention(z(1, 4, 512), z(1, 4, 64), z(1, 8, 512),
                                z(1, 8, 64), z(1).long(), 1.0)


# ------------------------------------------ the Mixtral path's four kernels


@pytest.mark.parametrize("gs", [32, 128])
def test_gathered_w4a8_matmul(cuda, gs):
    """Repeated and missing experts; float32 and bfloat16 activations."""
    rng = np.random.default_rng(gs + 1)
    w, x = _w(rng, (8, 256, 136), gs), _x(rng, 7, 256)
    ids = torch.tensor([3, 0, 5, 3, 7, 1, 3], dtype=torch.int32)
    wc = w.to(cuda)
    out = _counted("gathered_w4a8_matmul", lambda: MM.gathered_w4a8_matmul(
        x.to(cuda), wc, ids.to(cuda)))
    assert out.dtype == torch.float32
    assert _rel(out, MM.gathered_w4a8_matmul_ref(x, w, ids)) <= 1e-5
    xb = x.bfloat16()
    out = MM.gathered_w4a8_matmul(xb.to(cuda), wc, ids.to(cuda))
    assert out.dtype == torch.bfloat16
    assert _rel(out, MM.gathered_w4a8_matmul_ref(xb, w, ids)) <= 1e-2


def test_grouped_w4a8_matmul_empty_expert_and_tail(cuda):
    """Expert 1 has no rows, the group sizes cut the 8-row tiles short,
    and the rows past their sum come back zero."""
    rng = np.random.default_rng(6)
    w, xs = _w(rng, (4, 256, 200), 64), _x(rng, 29, 256)
    sizes = torch.tensor([5, 0, 11, 9], dtype=torch.int32)
    out = _counted("grouped_w4a8_matmul", lambda: MM.grouped_w4a8_matmul(
        xs.to(cuda), w.to(cuda), sizes.to(cuda)))
    assert torch.all(out[25:] == 0)
    assert _rel(out, MM.grouped_w4a8_matmul_ref(xs, w, sizes)) <= 1e-5


def _gqa_pool(rng, b, pmax, page, dtype, live, hkv=2, d=128):
    """Shuffled page tables over k / v pools [P, page, hkv, d] whose
    unused pages, and rows at or past each live length, are NaN."""
    num_pages = b * pmax + 1
    perm = rng.permutation(num_pages - 1)[: b * pmax] + 1
    tables = torch.from_numpy(perm.reshape(b, pmax).astype(np.int32))
    k = torch.full((num_pages, page, hkv, d), float("nan"))
    v = torch.full_like(k, float("nan"))
    for i, n in enumerate(live):
        for pos in range(n):
            pid, slot = int(tables[i, pos // page]), pos % page
            k[pid, slot] = _x(rng, hkv, d)
            v[pid, slot] = _x(rng, hkv, d)
    return k.to(dtype), v.to(dtype), tables


@pytest.mark.parametrize("page, pmax", [(16, 8), (64, 4), (64, 8), (16, 40)])
@pytest.mark.parametrize("window", [0, 40])
@pytest.mark.parametrize("dtype, tol", [(torch.float32, 1e-5),
                                        (torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("g", [4, 12, 16])
def test_gqa_paged_decode(cuda, page, pmax, window, dtype, tol, g):
    """Lengths 1, one page, one page + 1, all pages (current token
    included), and across the kernel's 256-key pieces where the pool holds
    more than one (pools of 512 and 640 keys: 2 and 3 pieces merged by its
    second launch); 4, 12 (GLM-4.5-Air) and 16 query heads a KV head over 2
    KV heads; with a window only the last ``window`` keys count. Every row
    the kernel must not read is NaN."""
    rng = np.random.default_rng(page + window)
    lens = [1, page, page + 1, page * pmax]
    if page * pmax > 256:
        lens += [256, 257, page * pmax - 1]
    b = len(lens)
    k, v, tables = _gqa_pool(rng, b, pmax, page, dtype, lens)
    q = _x(rng, b, 2 * g, 128).to(dtype)
    lengths = torch.tensor(lens, dtype=torch.int32)
    args = (q, k, v, tables, lengths)
    out = _counted("gqa_paged_decode", lambda: PA.gqa_paged_decode(
        *[t.to(cuda) for t in args], 0.088, window=window))
    ref = PA.gqa_paged_decode(*args, 0.088, window=window)
    assert out.dtype == dtype and bool(torch.isfinite(out.float()).all())
    assert _rel(out, ref) <= tol


@pytest.mark.parametrize("page, pmax, s", [(16, 8, 32), (64, 4, 96)])
@pytest.mark.parametrize("window", [0, 40])
@pytest.mark.parametrize("dtype, tol", [(torch.float32, 1e-5),
                                        (torch.bfloat16, 1e-2)])
def test_gqa_paged_prefill(cuda, page, pmax, s, window, dtype, tol):
    """Old lengths 0, mid-page and page-aligned, valid < S and == S, and
    an empty chunk on an empty cache (zeros). Rows >= valid are padding:
    finite, and compared where the window leaves them a key."""
    rng = np.random.default_rng(page + s + window)
    room = page * pmax - s
    olds = [0, min(page // 2 + 1, room), min(page, room), 0]
    valids = [s - 5, s, s - 1, 0]
    c = len(olds)
    live = [o + v for o, v in zip(olds, valids)]
    k, v, tables = _gqa_pool(rng, c, pmax, page, dtype, live)
    q = _x(rng, c, 8, s, 128).to(dtype)
    lengths = torch.tensor(olds, dtype=torch.int32)
    valid = torch.tensor(valids, dtype=torch.int32)
    args = (q, k, v, tables, lengths, valid)
    out = _counted("gqa_paged_prefill", lambda: PA.gqa_paged_prefill(
        *[t.to(cuda) for t in args], 0.088, window=window))
    ref = PA.gqa_paged_prefill(*args, 0.088, window=window)
    assert out.dtype == dtype and bool(torch.isfinite(out.float()).all())
    assert torch.all(out[3] == 0)
    for i, n in enumerate(valids[:3]):
        assert _rel(out[i, :, :n], ref[i, :, :n]) <= tol, i
    assert _rel(out[0, :, s - 5:], ref[0, :, s - 5:]) <= tol


def test_gqa_wrappers_raise_on_what_the_kernels_do_not_take(cuda):
    rng = np.random.default_rng(0)
    k, v, tables = _gqa_pool(rng, 1, 2, 8, torch.float32, [3], hkv=1)
    lengths = torch.tensor([3], dtype=torch.int32)
    on = lambda *ts: [t.to(cuda) for t in ts]  # noqa: E731
    with pytest.raises(ValueError, match="at most 16"):
        PA.gqa_paged_decode(*on(_x(rng, 1, 32, 128), k, v, tables, lengths),
                            0.1)
    with pytest.raises(ValueError, match=r"D in \(128, 256\)"):
        PA.gqa_paged_decode(*on(_x(rng, 1, 4, 64), k[..., :64].contiguous(),
                                v[..., :64].contiguous(), tables, lengths),
                            0.1)
    with pytest.raises(ValueError, match="share"):
        PA.gqa_paged_decode(*on(_x(rng, 1, 4, 128).bfloat16(), k, v, tables,
                                lengths), 0.1)
    with pytest.raises(ValueError, match="at most 16"):
        PA.gqa_paged_decode(*on(_x(rng, 1, 32, 128).bfloat16(),
                                k.bfloat16(), v.bfloat16(), tables,
                                lengths), 0.1)


# --------------------------------------- transposed matmuls, rows 16 and 17

QT_KINDS = QM_KINDS + ("int4_g offset-lo",)


def _tw(rng, shape, kind):
    w = _qw(rng, shape, kind.split()[0])
    return repack_offset_lo(w) if kind.endswith("offset-lo") else w


@pytest.mark.parametrize("n", [3648, 1824])
@pytest.mark.parametrize("m", [1, 9])
@pytest.mark.parametrize("kind", QT_KINDS)
def test_quant_matmul_t(cuda, kind, m, n):
    """N = 3648 (the fused qkv_a) and 1824 leave a partial last step of the
    contraction; K = 192 takes a group of 96 for the int4 group kinds."""
    rng = np.random.default_rng(m + n)
    w, dy = _tw(rng, (192, n), kind), _x(rng, m, n)
    wc = w.to(cuda)
    for d in (dy, dy.bfloat16()):
        out = _counted("quant_matmul_t",
                       lambda: QT.quant_matmul_t(d.to(cuda), wc))
        assert out.dtype == torch.float32 and out.shape == (m, 192)
        assert _rel(out, QT.quant_matmul_t_ref(d, w)) <= 1e-5


@pytest.mark.parametrize("n", [3648, 1824])
@pytest.mark.parametrize("kind", QT_KINDS)
def test_grouped_quant_matmul_t(cuda, kind, n):
    """Empty experts, partial tiles, and rows past the total (zero)."""
    rng = np.random.default_rng(n)
    w, dy = _tw(rng, (5, 128, n), kind), _x(rng, 88, n).bfloat16()
    sizes = torch.tensor([9, 0, 70, 0, 4], dtype=torch.int32)
    out = _counted("grouped_quant_matmul_t",
                   lambda: QT.grouped_quant_matmul_t(
                       dy.to(cuda), w.to(cuda), sizes.to(cuda)))
    assert not out[83:].abs().max().item()
    assert _rel(out, QT.grouped_quant_matmul_t_ref(dy, w, sizes)) <= 1e-5


@pytest.mark.parametrize("kind", QT_KINDS)
def test_gathered_quant_matmul_t(cuda, kind):
    rng = np.random.default_rng(8)
    w, dy = _tw(rng, (8, 128, 1824), kind), _x(rng, 7, 1824).bfloat16()
    ids = torch.tensor([3, 0, 5, 3, 7, 1, 3], dtype=torch.int32)
    out = _counted("grouped_quant_matmul_t",
                   lambda: QT.gathered_quant_matmul_t(
                       dy.to(cuda), w.to(cuda), ids.to(cuda)))
    assert _rel(out, QT.gathered_quant_matmul_t_ref(dy, w, ids)) <= 1e-5


def test_quant_matmul_fn_backward(cuda):
    """dx through the autograd rule on the card: the W4A8 forward (row 1),
    then row 16, against the plain transposed matmul on the CPU."""
    from ktransformers_tpu_torch.ops.vjp import QuantMatmulFn

    rng = np.random.default_rng(9)
    w = _tw(rng, (256, 1824), "int4_g offset-lo")
    x = _x(rng, 9, 256).bfloat16().to(cuda).requires_grad_(True)
    g = _x(rng, 9, 1824)
    y = QuantMatmulFn.apply(x, w.to(cuda))
    before = LAUNCHES["quant_matmul_t"]
    (dx,) = torch.autograd.grad((y.float() * g.to(cuda)).sum(), x)
    torch.cuda.synchronize()
    assert LAUNCHES["quant_matmul_t"] == before + 1
    assert dx.dtype == torch.bfloat16
    ref = QT.quant_matmul_t_ref(g.bfloat16(), w)
    assert _rel(dx, ref) <= 1e-2


def test_transposed_wrappers_refuse_on_the_card(cuda):
    rng = np.random.default_rng(10)
    w = _qw(rng, (128, 40), "int8").to(cuda)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        QT.quant_matmul_t(_x(rng, 4, 40).half().to(cuda), w)
    w2 = _qw(rng, (128, 42), "int8").to(cuda)
    with pytest.raises(ValueError, match="multiple of 4"):
        QT.quant_matmul_t(_x(rng, 4, 42).to(cuda), w2)


# ------------------- tensor-core kernels at M >= 16, rows 9 / 11 and 1 / 8


def _bf(rng, *shape):
    return _x(rng, *shape).bfloat16()


def _routes(mod, *args):
    assert mod.route(*args) == "mma", args


@pytest.mark.parametrize("m", [16, 64, 1000])
@pytest.mark.parametrize("kind", QM_KINDS)
def test_quant_mma_dense(cuda, kind, m):
    """bf16 activations of at least MMA_MIN_ROWS rows take
    quant_mma_kernel: N = 3648 (the fused qkv_a, no multiple of the 128
    columns of a block), 1000 rows leave a partial 64-row tile."""
    rng = np.random.default_rng(m)
    w, x = _qw(rng, (256, 3648), kind), _bf(rng, m, 256)
    _routes(QM, x.dtype, m, "dense", kind, 256, 3648, QM.rows_per_group(w))
    out = _counted("quant_matmul",
                   lambda: QM.quant_matmul(x.to(cuda), w.to(cuda)))
    assert out.dtype == torch.bfloat16
    assert _rel(out, QM.quant_matmul_ref(x, w)) <= 1e-2


@pytest.mark.parametrize("kind", QM_KINDS)
def test_quant_mma_group_96(cuda, kind):
    """K = 192: a group of 96 (48 storage rows, three 16-row stages of a
    nibble kind) for the int4 group kinds, as layer 0's down projection."""
    rng = np.random.default_rng(96)
    w, x = _qw(rng, (192, 256), kind), _bf(rng, 40, 192)
    if kind in ("int4_g", "int4_gz"):
        assert w.group_size == 96
    _routes(QM, x.dtype, 40, "dense", kind, 192, 256, QM.rows_per_group(w))
    out = QM.quant_matmul(x.to(cuda), w.to(cuda))
    assert _rel(out, QM.quant_matmul_ref(x, w)) <= 1e-2


@pytest.mark.parametrize("kind", QM_KINDS + ("int4_g offset-lo",))
def test_quant_mma_grouped_empty_expert_and_tail(cuda, kind):
    """Sorted rows over 5 experts: two empty, one longer than a 64-row
    tile, and 17 rows past the total, which must come back zero."""
    rng = np.random.default_rng(11)
    if kind == "int4_g offset-lo":
        w = _qw(rng, (5, 256, 176), "int4_g")
        w.data = (w.data ^ 8).view(torch.int8)
        w.act_quant = True
    else:
        w = _qw(rng, (5, 256, 176), kind)
    x = _bf(rng, 250, 256)
    sizes = torch.tensor([70, 0, 130, 0, 33], dtype=torch.int32)
    _routes(QM, x.dtype, 250, "grouped", w.kind, 256, 176,
            QM.rows_per_group(w))
    out = _counted("grouped_quant_matmul", lambda: QM.grouped_quant_matmul(
        x.to(cuda), w.to(cuda), sizes.to(cuda)))
    assert not out[233:].abs().max().item()
    assert _rel(out, QM.grouped_quant_matmul_ref(x, w, sizes)) <= 1e-2


def test_quant_mma_leaves_float32_on_the_first_version(cuda):
    """float32 activations keep quant_rows_kernel (their roundings): the
    float32 tolerance holds at 64 rows."""
    rng = np.random.default_rng(12)
    w, x = _qw(rng, (256, 3648), "int4_g"), _x(rng, 64, 256)
    assert QM.route(x.dtype, 64, "dense", "int4_g", 256, 3648, 64) == "rows"
    out = QM.quant_matmul(x.to(cuda), w.to(cuda))
    assert _rel(out, QM.quant_matmul_ref(x, w)) <= 1e-5


@pytest.mark.parametrize("m", [16, 64, 1000])
def test_w4a8_mma_dense(cuda, m):
    """Both activation types at N = 3648 and 16, 64 and 1000 rows."""
    rng = np.random.default_rng(30 + m)
    w, x = _w(rng, (256, 3648)), _x(rng, m, 256)
    _routes(MM, m, "dense", 128, 3648)
    wc = w.to(cuda)
    out = _counted("dense_w4a8_matmul",
                   lambda: MM.dense_w4a8_matmul(x.to(cuda), wc))
    assert out.dtype == torch.float32
    assert _rel(out, MM.w4a8_matmul_ref(x, w)) <= 1e-5
    xb = x.bfloat16()
    out = MM.dense_w4a8_matmul(xb.to(cuda), wc)
    assert out.dtype == torch.bfloat16
    assert _rel(out, MM.w4a8_matmul_ref(xb, w)) <= 1e-2


def test_w4a8_mma_group_96(cuda):
    """gs/2 = 48 bytes a group: one k32 and one k16 step."""
    rng = np.random.default_rng(41)
    w, x = _w(rng, (576, 256)), _x(rng, 40, 576)
    assert w.group_size == 96
    _routes(MM, 40, "dense", 96, 256)
    out = MM.dense_w4a8_matmul(x.to(cuda), w.to(cuda))
    assert _rel(out, MM.w4a8_matmul_ref(x, w)) <= 1e-5


@pytest.mark.parametrize("dtype, tol", [(torch.float32, 1e-5),
                                        (torch.bfloat16, 1e-2)])
def test_w4a8_mma_grouped_empty_expert_and_tail(cuda, dtype, tol):
    """Sorted rows over 5 experts: two empty, one longer than a 64-row
    tile, N = 208 (a partial 128-column block), and 17 rows past the
    total, which must come back zero."""
    rng = np.random.default_rng(42)
    w, xs = _w(rng, (5, 256, 208)), _x(rng, 250, 256).to(dtype)
    sizes = torch.tensor([70, 0, 130, 0, 33], dtype=torch.int32)
    _routes(MM, 250, "grouped", 128, 208)
    out = _counted("grouped_w4a8_matmul", lambda: MM.grouped_w4a8_matmul(
        xs.to(cuda), w.to(cuda), sizes.to(cuda)))
    assert out.dtype == dtype and torch.all(out[233:] == 0)
    assert _rel(out, MM.grouped_w4a8_matmul_ref(xs, w, sizes)) <= tol


@pytest.mark.parametrize("entry", ["dense", "grouped"])
def test_mma_and_first_version_agree(cuda, entry):
    """The two kernels of one entry on the same bf16 operands, each forced
    through the launchers' ``kernel`` argument (a measurement hook)."""
    rng = np.random.default_rng(43)
    x = _bf(rng, 96, 256).to(cuda)
    sizes = torch.tensor([40, 0, 50], dtype=torch.int32, device=cuda)
    qw = _qw(rng, (3, 256, 384), "int8").to(cuda)
    ww = _w(rng, (3, 256, 384)).to(cuda)
    if entry == "dense":
        calls = ((QM.dense_launcher, (x, QM.expert_slice(qw, 2))),
                 (MM.dense_w4a8_launcher, (x, QM.expert_slice(ww, 2))))
    else:
        calls = ((QM.grouped_launcher, (x, qw, sizes)),
                 (MM.grouped_launcher, (x, ww, sizes)))
    for launcher, args in calls:
        outs = []
        for kernel in ("rows", "mma"):
            launch, out = launcher(*args, kernel)
            launch()
            outs.append(out)
        assert _rel(outs[1], outs[0]) <= 1e-2


# -------------- the one-row GEMV (rows 9-10) and the wgmma kernel (16-17)


def _gemv_w(rng, kind, k, n):
    """A weight of K = 10944 with group 96 for the int4 group kinds (layer
    0's down projection), the registry's group otherwise."""
    gs = 96 if kind in ("int4_g", "int4_gz") else 128
    return _qw(rng, (k, n), kind, gs).to("cuda")


def _splits(monkeypatch, mod, plan, fixed):
    """Force a split count (and its granule) through the planner the
    launcher calls: fixed(*args) -> the plan to use."""
    monkeypatch.setattr(mod, plan, fixed)


@pytest.mark.parametrize("split", ["one", "most"])
@pytest.mark.parametrize("n", [3648, 2048])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("kind", QM_KINDS)
def test_quant_gemv(cuda, kind, dtype, n, split, monkeypatch):
    """quant_gemv_kernel at M = 1, K = 10944 (group 96 for the int4 group
    kinds), N = 3648 / 2048, with one split and with the largest split the
    rows allow: against the plain version, bit-identical on a second call,
    and the forced first version within the same tolerance."""
    rng = np.random.default_rng(n + len(kind))
    k = 10944
    w = _gemv_w(rng, kind, k, n)
    x = _x(rng, 1, k).to(dtype).to(cuda)
    rpg = QM.rows_per_group(w)
    assert QM.route(dtype, 1, "dense", kind, k, n, rpg) == "gemv"
    kr = w.data.shape[-2]
    most = kr // QM.GEMV_UNIT // QM.GEMV_LANES
    real = QM.gemv_plan
    _splits(monkeypatch, QM, "gemv_plan",
            lambda *a: (1, 1) if split == "one" else (most, 1))
    before = QM.ROUTED_LAUNCHES["quant_gemv_kernel"]
    out = _counted("quant_matmul", lambda: QM.quant_matmul(x, w))
    assert QM.ROUTED_LAUNCHES["quant_gemv_kernel"] == before + 1
    tol = 1e-2 if dtype == torch.bfloat16 else 1e-5
    assert out.dtype == dtype
    assert _rel(out, QM.quant_matmul_ref(x, w)) <= tol
    assert torch.equal(QM.quant_matmul(x, w), out)
    launch, first = QM.dense_launcher(x, w, "rows")
    launch()
    assert _rel(first, QM.quant_matmul_ref(x, w)) <= tol
    monkeypatch.setattr(QM, "gemv_plan", real)
    assert _rel(QM.quant_matmul(x, w), QM.quant_matmul_ref(x, w)) <= tol


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("kind", QM_KINDS)
def test_quant_gemv_gathered(cuda, kind, dtype):
    """The gathered entry through ops/moe.gathered_matmul: x [T, k, K]
    (per-expert inputs) and x [T, K], experts repeated within and across
    tokens, 6 and 48 rows; bit-identical on a second call; the forced
    first version on the same operands."""
    from ktransformers_tpu_torch.ops.moe import gathered_matmul

    rng = np.random.default_rng(77)
    w = _qw(rng, (8, 1408, 2048), kind).to(cuda)
    tol = 1e-2 if dtype == torch.bfloat16 else 1e-5
    for t in (1, 8):
        ids = torch.from_numpy(rng.integers(0, 8, (t, 6))).to(torch.int32)
        ids[0, 1] = ids[0, 0]  # a repeated expert
        ids = ids.to(cuda)
        for x in (_x(rng, t, 6, 1408), _x(rng, t, 1408)):
            x = x.to(dtype).to(cuda)
            before = QM.ROUTED_LAUNCHES["quant_gemv_kernel"]
            out = gathered_matmul(x, w, ids)
            torch.cuda.synchronize()
            assert QM.ROUTED_LAUNCHES["quant_gemv_kernel"] == before + 1
            rows = (x if x.dim() == 3 else x[:, None].expand(t, 6, 1408))
            rows = rows.reshape(t * 6, 1408).contiguous()
            ref = QM.gathered_quant_matmul_ref(rows, w, ids.reshape(-1))
            assert _rel(out.reshape(t * 6, -1), ref) <= tol
            assert torch.equal(gathered_matmul(x, w, ids), out)
            launch, first = QM.gathered_launcher(rows, w, ids.reshape(-1),
                                                 "rows")
            launch()
            assert _rel(first, ref) <= tol


def test_quant_gemv_counters_reset(cuda):
    """Calls of several shapes in a row share one set of counters and
    partials: each sees its counters back at zero (a wrong last block would
    leave stale sums or no output)."""
    rng = np.random.default_rng(78)
    for k, n in ((2048, 3648), (10944, 2048), (2048, 3648), (1408, 2048)):
        w, x = _qw(rng, (k, n), "int8").to(cuda), _bf(rng, 1, k).to(cuda)
        for _ in range(3):
            assert _rel(QM.quant_matmul(x, w),
                        QM.quant_matmul_ref(x, w)) <= 1e-2
    _, cnt = MM._SCRATCH[(str(x.device), "gemv")]
    assert not cnt.any()


@pytest.mark.parametrize("m", [1, 64, 200, 512])
@pytest.mark.parametrize("kind", QT_KINDS)
def test_quant_wgmma_t(cuda, kind, m):
    """quant_wgmma_t_kernel at N = 3648 (no multiple of 64 or 128: a partial
    last stage), K = 512 (two column blocks of 256 dx columns at 128-row
    tiles, four of 128 at 64-row tiles; both nibble halves of each), M = 1
    / 64 (64-row tiles) and 200 / 512 (128-row tiles, 200 a partial one),
    bf16 and float32 dy: against the plain version, bit-identical on a
    second call, the forced first version within tolerance."""
    rng = np.random.default_rng(m + len(kind))
    w = _tw(rng, (512, 3648), kind).to(cuda)
    assert QT._route(w) == "wgmma"
    for dt in (torch.bfloat16, torch.float32):
        dy = _x(rng, m, 3648).to(dt).to(cuda)
        before = QT.ROUTED_LAUNCHES["quant_wgmma_t_kernel"]
        out = _counted("quant_matmul_t", lambda: QT.quant_matmul_t(dy, w))
        assert QT.ROUTED_LAUNCHES["quant_wgmma_t_kernel"] == before + 1
        ref = QT.quant_matmul_t_ref(dy, w)
        assert out.dtype == torch.float32 and _rel(out, ref) <= 1e-5
        assert torch.equal(QT.quant_matmul_t(dy, w), out)
        launch, first = QT.dense_t_launcher(dy, w, "rows")
        launch()
        assert _rel(first, ref) <= 1e-5


@pytest.mark.parametrize("splits", [1, 7])
def test_quant_wgmma_t_splits(cuda, splits, monkeypatch):
    """The contraction split in 1 and 7 runs (the largest for N = 3648 at
    8 stages a split): the same result within float32 rounding, each
    bit-identical on a repeat."""
    rng = np.random.default_rng(90)
    w = _tw(rng, (256, 3648), "int4_g offset-lo").to(cuda)
    dy = _bf(rng, 512, 3648).to(cuda)
    monkeypatch.setattr(QT, "t_plan", lambda *a: splits)
    out = QT.quant_matmul_t(dy, w)
    assert _rel(out, QT.quant_matmul_t_ref(dy, w)) <= 1e-5
    assert torch.equal(QT.quant_matmul_t(dy, w), out)


@pytest.mark.parametrize("kind", QT_KINDS)
def test_quant_wgmma_t_grouped(cuda, kind):
    """Sorted rows over 6 experts: two empty, one longer than a 64-row
    tile, and 17 rows past the total (zero), N = 3648; the gathered entry
    with a repeated expert; bit-identical repeats; the forced first
    version."""
    rng = np.random.default_rng(91)
    w = _tw(rng, (6, 256, 3648), kind).to(cuda)
    dy = _bf(rng, 250, 3648).to(cuda)
    sizes = torch.tensor([70, 0, 130, 0, 30, 3], dtype=torch.int32,
                         device=cuda)
    out = _counted("grouped_quant_matmul_t",
                   lambda: QT.grouped_quant_matmul_t(dy, w, sizes))
    assert not out[233:].abs().max().item()
    ref = QT.grouped_quant_matmul_t_ref(dy, w, sizes)
    assert _rel(out, ref) <= 1e-5
    assert torch.equal(QT.grouped_quant_matmul_t(dy, w, sizes), out)
    launch, first = QT.grouped_t_launcher(dy, w, sizes, "rows")
    launch()
    assert _rel(first, ref) <= 1e-5
    ids = torch.tensor([3, 0, 5, 3, 2, 1, 3], dtype=torch.int32, device=cuda)
    d7 = dy[:7].contiguous()
    out = QT.gathered_quant_matmul_t(d7, w, ids)
    ref = QT.gathered_quant_matmul_t_ref(d7, w, ids)
    assert _rel(out, ref) <= 1e-5
    assert torch.equal(QT.gathered_quant_matmul_t(d7, w, ids), out)


# ------ the W4A8 GEMV (rows 1 at M = 1, 7, the FFN's down at decode) and
# ------ the FFN's gate_up on tensor cores (rows 3 at M >= 2 and 4)


def _dw(shape, gs=128, seed=0):
    """An int4_g weight repacked for W4A8, drawn on the card (the main
    path's widths are too large to quantize on the host)."""
    from ktransformers_tpu_torch.models.init import _Draw

    rd = _Draw(seed, torch.device("cuda"), torch.bfloat16)
    return repack_offset_lo(rd.q(shape, "int4_g", gs))


def _dx(seed, *shape, dtype=torch.bfloat16):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randn(*shape, device="cuda", generator=g).to(dtype)


def _dot_ref(x, w, row_expert):
    """The plain W4A8 product on the card from the kernel's own activation
    codes (MM.prep_activations, held to the plain prep by test_w4a8_prep):
    the GEMV alone against the plain group dot, float32 [R, N]."""
    qa, qb, sa, sb, t = MM.prep_activations(x, w.in_features, w.group_size)
    out = torch.zeros(x.shape[0], w.out_features, device=x.device)
    for e in torch.unique(row_expert).tolist():
        idx = torch.nonzero(row_expert == e).flatten()
        e = int(e)
        out[idx] = MM.w4a8_group_dot(qa[idx], qb[idx], sa[idx], sb[idx],
                                     t[idx], w.data[e], w.scales[e],
                                     w.group_size // 2)
    return out


def _dense_ref(x, w):
    """_dot_ref of a dense call: one expert."""
    return _dot_ref(x, MM.lift(w), torch.zeros(1, dtype=torch.int32,
                                               device=x.device))


def _gemv_routed(fn):
    before = MM.ROUTED_LAUNCHES["w4a8_gemv_kernel"]
    out = fn()
    torch.cuda.synchronize()
    assert MM.ROUTED_LAUNCHES["w4a8_gemv_kernel"] == before + 1
    return out


# DeepSeek-V2-Lite's projections at single-user decode: qkv_a, o_proj,
# lm_head, layer 0's gate_up and down (group 96)
GEMV_DENSE = [(2048, 3648, 128), (2048, 2048, 128), (2048, 102400, 128),
              (2048, 21888, 128), (10944, 2048, 96)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("k, n, gs", GEMV_DENSE)
def test_w4a8_gemv_dense(cuda, k, n, gs, dtype):
    """w4a8_gemv_kernel at M = 1 on the main path's shapes: against the
    plain group dot of the same codes (1e-5 float32, 1e-2 bf16),
    bit-identical on a second call, and the forced first version within
    the same tolerance."""
    w, x = _dw((k, n), gs, seed=k + n), _dx(k + n, 1, k, dtype=dtype)
    assert MM.route(1, "dense", gs, n) == "gemv"
    out = _gemv_routed(lambda: _counted(
        "dense_w4a8_matmul", lambda: MM.dense_w4a8_matmul(x, w)))
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    ref = _dense_ref(x, w)
    assert out.dtype == dtype and _rel(out, ref) <= tol
    assert torch.equal(MM.dense_w4a8_matmul(x, w), out)
    launch, first = MM.dense_w4a8_launcher(x, w, "rows")
    launch()
    assert _rel(first, ref) <= tol


@pytest.mark.parametrize("split", ["one", "most"])
@pytest.mark.parametrize("k, n, gs", [(576, 208, 96), (1024, 3648, 128)])
def test_w4a8_gemv_splits(cuda, k, n, gs, split, monkeypatch):
    """One split, and one a scale group (N = 208: a partial column block;
    group 96: 48 storage rows = 6 units, two of the eight lanes idle)."""
    w, x = _dw((k, n), gs, seed=k), _dx(k, 1, k, dtype=torch.float32)
    groups = k // gs
    monkeypatch.setattr(MM, "w4a8_gemv_plan", lambda *a: (
        1 if split == "one" else groups, gs // 2 // MM.GEMV_UNIT))
    out = MM.dense_w4a8_matmul(x, w)
    assert _rel(out, _dense_ref(x, w)) <= 1e-5
    assert torch.equal(MM.dense_w4a8_matmul(x, w), out)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("what", ["gate_up", "down"])
def test_w4a8_gemv_gathered_mixtral(cuda, what, dtype):
    """Mixtral-8x7B's experts at decode: 2 rows (one token's top-2) and 16
    rows (8 tokens, repeated experts): rows that share an expert read it
    once; against the plain group dot, bit-identical repeats, the forced
    first version."""
    k, n = (4096, 28672) if what == "gate_up" else (14336, 4096)
    w = _dw((8, k, n), 128, seed=7)
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    for r in (2, 16):
        g = torch.Generator().manual_seed(r)
        ids = torch.topk(torch.randn(r // 2, 8, generator=g), 2,
                         dim=-1).indices.reshape(-1).to(torch.int32).to(cuda)
        x = _dx(r, r, k, dtype=dtype)
        assert MM.route(r, "gathered", 128, n) == "gemv"
        out = _gemv_routed(lambda: MM.gathered_w4a8_matmul(x, w, ids))
        ref = _dot_ref(x, w, ids)
        assert _rel(out, ref) <= tol
        assert torch.equal(MM.gathered_w4a8_matmul(x, w, ids), out)
        launch, first = MM.gathered_launcher(x, w, ids, "rows")
        launch()
        assert _rel(first, ref) <= tol


@pytest.mark.parametrize("ids", ["equal", "random", "one"])
def test_w4a8_gemv_gathered_rows(cuda, ids):
    """All 128 rows on one expert (64 chunks of two rows in one tile), 128
    rows over 4 experts, one row; group 96 at K = 576."""
    r = {"equal": 128, "random": 128, "one": 1}[ids]
    g = torch.Generator().manual_seed(r)
    idv = (torch.full((r,), 2) if ids == "equal"
           else torch.randint(0, 4, (r,), generator=g))
    idv = idv.to(torch.int32).to(cuda)
    w, x = _dw((4, 576, 256), 96, seed=3), _dx(5, r, 576,
                                                dtype=torch.float32)
    out = _gemv_routed(lambda: MM.gathered_w4a8_matmul(x, w, idv))
    assert _rel(out, _dot_ref(x, w, idv)) <= 1e-5
    assert torch.equal(MM.gathered_w4a8_matmul(x, w, idv), out)


def test_w4a8_gemv_counters_reset(cuda):
    """Calls of several shapes in a row share one set of counters and
    partials; each finds its counters at zero and leaves them so."""
    for k, n in ((2048, 3648), (10944, 2048), (2048, 3648), (1408, 2048)):
        gs = 96 if k == 10944 else 128
        w, x = _dw((k, n), gs, seed=k), _dx(k, 1, k)
        for _ in range(3):
            ref = _dense_ref(x, w)
            assert _rel(MM.dense_w4a8_matmul(x, w), ref) <= 1e-2
    _, cnt = MM._SCRATCH[(str(x.device), "w4a8_gemv")]
    assert not cnt.any()


def _ffn_routed(kernel, fn):
    names = F.ROUTE_KERNELS[kernel]
    before = [MM.ROUTED_LAUNCHES[k] for k in names]
    out = fn()
    torch.cuda.synchronize()
    assert [MM.ROUTED_LAUNCHES[k] for k in names] == [b + 1 for b in before]
    return out


@pytest.mark.parametrize("act", ["silu", "relu", "gelu"])
def test_w4a8_ffn_gemv_down(cuda, act):
    """The FFN's one-row tiles (w4a8_ffn_gemv_kernel, then the GEMV down)
    on DeepSeek-V2-Lite's experts: 6 routed rows, 48 rows with repeats,
    and the shared experts at M = 1; against the plain version on the card
    (1e-2: the requant may move a code by one step), bit-identical."""
    gu, dn = _dw((64, 2048, 2816), seed=1), _dw((64, 1408, 2048), seed=2)
    g = torch.Generator().manual_seed(3)
    for tokens in (1, 8):
        ids = torch.stack([torch.randperm(64, generator=g)[:6]
                           for _ in range(tokens)]).reshape(-1)
        ids = ids.to(torch.int32).to(cuda)
        x = _dx(tokens, 6 * tokens, 2048)
        assert F.ffn_route(6 * tokens, "gathered", 128, 128, 1408,
                           2048) == "gemv"
        out = _ffn_routed("gemv", lambda: F.gathered_w4a8_ffn(
            x, gu, dn, ids, act))
        assert _rel(out, F.gathered_w4a8_ffn_ref(x, gu, dn, ids, act)) <= 1e-2
        assert torch.equal(F.gathered_w4a8_ffn(x, gu, dn, ids, act), out)
    sgu, sdn = _dw((2048, 5632), seed=4), _dw((2816, 2048), seed=5)
    x = _dx(9, 1, 2048, dtype=torch.float32)
    out = _ffn_routed("gemv", lambda: F.dense_w4a8_ffn(x, sgu, sdn, act))
    assert _rel(out, F.dense_w4a8_ffn_ref(x, sgu, sdn, act)) <= 1e-2
    assert torch.equal(F.dense_w4a8_ffn(x, sgu, sdn, act), out)


def _poison_unrouted(w, ids):
    """w with the scales of every expert no row routes to set to NaN: a
    kernel that reads one gives NaN."""
    used = torch.zeros(w.data.shape[0], dtype=torch.bool, device=w.data.device)
    used[ids.long()] = True
    scales = w.scales.clone()
    scales[~used] = float("nan")
    return dataclasses.replace(w, scales=scales)


def _poison_scratch(name):
    """Fill a split kernel's partials with NaN (they are written before they
    are read, so a call must not see them)."""
    for (_, what), (part, _) in MM._SCRATCH.items():
        if what == name:
            part.fill_(float("nan"))


@pytest.mark.parametrize("act", ["silu", "gelu"])
@pytest.mark.parametrize("rows", [6, 48, 16])
def test_w4a8_ffn_gemv(cuda, rows, act):
    """w4a8_ffn_gemv_kernel (gate_up + GLU + requant) and the GEMV down on
    DeepSeek-V2-Lite's routed experts (64 of gate_up [2048, 2816], down
    [1408, 2048]): 6 distinct rows (4 splits), 48 rows of 8 tokens with
    repeats (one split), 16 rows over 4 experts (tiles of two rows: rows
    outnumber the experts used, so the tile count has dead tiles). The
    unrouted experts' scales and the split partials hold NaN; against the
    plain version (1e-2), bit-identical on a second call, the counters back
    at zero, the first version (ffn_up_kernel<1>) on the same operands
    within the tolerance."""
    gu, dn = _dw((64, 2048, 2816), seed=1), _dw((64, 1408, 2048), seed=2)
    g = torch.Generator().manual_seed(rows)
    if rows == 16:
        ids = torch.randint(0, 4, (16,), generator=g)
    else:
        ids = torch.stack([torch.randperm(64, generator=g)[:6]
                           for _ in range(rows // 6)]).reshape(-1)
    ids = ids.to(torch.int32).to(cuda)
    gu, dn = _poison_unrouted(gu, ids), _poison_unrouted(dn, ids)
    x = _dx(rows, rows, 2048)
    assert F.ffn_route(rows, "gathered", 128, 128, 1408, 2048) == "gemv"
    _poison_scratch("w4a8_ffn_gemv")
    out = _ffn_routed("gemv", lambda: _counted(
        "gathered_w4a8_ffn", lambda: F.gathered_w4a8_ffn(x, gu, dn, ids,
                                                         act)))
    ref = F.gathered_w4a8_ffn_ref(x, gu, dn, ids, act)
    assert bool(torch.isfinite(out.float()).all())
    assert _rel(out, ref) <= 1e-2
    assert torch.equal(F.gathered_w4a8_ffn(x, gu, dn, ids, act), out)
    for what in ("w4a8_ffn_gemv", "w4a8_gemv"):
        key = (str(x.device), what)
        assert key not in MM._SCRATCH or not MM._SCRATCH[key][1].any()
    launch, first = F.gathered_launcher(x, gu, dn, ids, act, "rows")
    launch()
    assert _rel(first, ref) <= 1e-2


@pytest.mark.parametrize("split", ["planned", "one", "most"])
@pytest.mark.parametrize("gs_up, gs_dn, inter", [
    (128, 128, 2816), (64, 64, 384), (96, 96, 576), (128, 32, 256)])
def test_w4a8_ffn_gemv_shapes(cuda, gs_up, gs_dn, inter, split,
                              monkeypatch):
    """The one-row gate_up at other groups (gate_up 64 / 96, down groups
    of 64, 96 and 32: fewer columns than a block's 128 a half) and forced
    split counts (one; one a scale group), a dense call of one row and a
    gathered call of 5 rows on 3 experts (a repeat): against the plain
    version, bit-identical."""
    k = 576 if gs_up == 96 else 512
    assert F.ffn_route(1, "dense", gs_up, gs_dn, inter, k) == "gemv"
    if split != "planned":
        fixed = 1 if split == "one" else k // gs_up
        monkeypatch.setattr(F, "ffn_gemv_plan", lambda *a: (
            fixed, gs_up // 2 // MM.GEMV_UNIT))
    sgu, sdn = _dw((k, 2 * inter), gs_up, seed=8), _dw((inter, k), gs_dn,
                                                      seed=9)
    x = _dx(10, 1, k, dtype=torch.float32)
    out = _ffn_routed("gemv", lambda: F.dense_w4a8_ffn(x, sgu, sdn))
    assert _rel(out, F.dense_w4a8_ffn_ref(x, sgu, sdn)) <= 1e-2
    assert torch.equal(F.dense_w4a8_ffn(x, sgu, sdn), out)
    gu, dn = _dw((3, k, 2 * inter), gs_up, seed=10), _dw((3, inter, k),
                                                        gs_dn, seed=11)
    ids = torch.tensor([2, 0, 2, 1, 0], dtype=torch.int32, device=cuda)
    x = _dx(12, 5, k)
    out = _ffn_routed("gemv", lambda: F.gathered_w4a8_ffn(x, gu, dn, ids,
                                                          "relu"))
    assert _rel(out, F.gathered_w4a8_ffn_ref(x, gu, dn, ids,
                                             "relu")) <= 1e-2
    assert torch.equal(F.gathered_w4a8_ffn(x, gu, dn, ids, "relu"), out)


def test_w4a8_ffn_gemv_refuses(cuda):
    """A gate_up group of 8 (4 storage rows: no whole 8-row unit) keeps the
    first version; the GEMV, forced, raises rather than running it."""
    gu, dn = _dw((256, 512), 8, seed=12), _dw((256, 256), 128, seed=13)
    x = _dx(14, 1, 256)
    assert F.ffn_route(1, "dense", 8, 128, 256, 256) == "rows"
    before = MM.ROUTED_LAUNCHES["w4a8_ffn_gemv_kernel"]
    out = F.dense_w4a8_ffn(x, gu, dn)
    assert MM.ROUTED_LAUNCHES["w4a8_ffn_gemv_kernel"] == before
    assert _rel(out, F.dense_w4a8_ffn_ref(x, gu, dn)) <= 1e-2
    with pytest.raises(ValueError, match="group of 16s"):
        F.dense_launcher(x, gu, dn, "silu", "gemv")


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("m", [2, 8, 256, 520])
def test_w4a8_ffn_mma_dense(cuda, m, dtype):
    """w4a8_ffn_mma_kernel + w4a8_mma_kernel on the shared experts (I =
    2816, 22 down groups) at a decode batch, a chunk and a mixed step
    (520: a partial 64-row tile): against the plain version, bit-identical
    on a second call, the forced first version within the tolerance."""
    sgu, sdn = _dw((2048, 5632), seed=4), _dw((2816, 2048), seed=5)
    x = _dx(m, m, 2048, dtype=dtype)
    assert F.ffn_route(m, "dense", 128, 128, 2816, 2048) == "mma"
    out = _ffn_routed("mma", lambda: _counted(
        "dense_w4a8_ffn", lambda: F.dense_w4a8_ffn(x, sgu, sdn)))
    ref = F.dense_w4a8_ffn_ref(x, sgu, sdn)
    assert out.dtype == dtype and _rel(out, ref) <= 1e-2
    assert torch.equal(F.dense_w4a8_ffn(x, sgu, sdn), out)
    launch, first = F.dense_launcher(x, sgu, sdn, "silu", "rows")
    launch()
    assert _rel(first, ref) <= 1e-2


@pytest.mark.parametrize("gs_up, act", [(128, "relu"), (128, "gelu"),
                                        (96, "silu")])
def test_w4a8_ffn_mma_acts_and_group_96(cuda, gs_up, act):
    """Each activation, and a gate_up group of 96 (K = 576: one k32 and one
    k16 step a group) with I = 384 (three down groups)."""
    k = 576 if gs_up == 96 else 512
    gu, dn = _dw((k, 768), gs_up, seed=6), _dw((384, k), 128, seed=7)
    x = _dx(8, 40, k, dtype=torch.float32)
    assert F.ffn_route(40, "dense", gs_up, 128, 384, k) == "mma"
    out = _ffn_routed("mma", lambda: F.dense_w4a8_ffn(x, gu, dn, act))
    assert _rel(out, F.dense_w4a8_ffn_ref(x, gu, dn, act)) <= 1e-2
    assert torch.equal(F.dense_w4a8_ffn(x, gu, dn, act), out)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("tokens", [256, 520])
def test_w4a8_ffn_mma_grouped(cuda, tokens, dtype):
    """DeepSeek-V2-Lite's routed experts over 1536 / 3120 sorted rows
    (top-6 of 64), expert 5 emptied and 40 rows past the total, which must
    come back zero; against the plain version, bit-identical, the forced
    first version."""
    gu, dn = _dw((64, 2048, 2816), seed=1), _dw((64, 1408, 2048), seed=2)
    g = torch.Generator().manual_seed(tokens)
    topk = torch.stack([torch.randperm(63, generator=g)[:6]
                        for _ in range(tokens)])
    topk = topk + (topk >= 5).long()  # no row on expert 5
    sizes = torch.bincount(topk.reshape(-1), minlength=64).to(torch.int32)
    assert sizes[5] == 0
    sizes = sizes.to(cuda)
    m = 6 * tokens + 40
    xs = _dx(tokens, m, 2048, dtype=dtype)
    out = _ffn_routed("mma", lambda: _counted(
        "grouped_w4a8_ffn", lambda: F.grouped_w4a8_ffn(xs, gu, dn, sizes)))
    assert torch.all(out[6 * tokens:] == 0)
    ref = F.grouped_w4a8_ffn_ref(xs, gu, dn, sizes)
    assert _rel(out, ref) <= 1e-2
    assert torch.equal(F.grouped_w4a8_ffn(xs, gu, dn, sizes), out)
    launch, first = F.grouped_launcher(xs, gu, dn, sizes, "silu", "rows")
    launch()
    assert _rel(first, ref) <= 1e-2


# ------------------------- redesigned paged attention, rows 12 and 15 (bf16)


def _bf_pool(rng, b, pmax, page, live, widths):
    """bf16 pools [b * pmax + 1, page, *width] (one per width) on shuffled
    tables; every row at or past a sequence's live length, and every page no
    table names, is NaN, except row 0 of page 0 (the serving pool's trash
    page, which an inactive batch row reads)."""
    n = b * pmax + 1
    tables = (rng.permutation(n - 1)[: b * pmax] + 1).reshape(
        b, pmax).astype(np.int32)
    pools = []
    for width in widths:
        buf = np.full((n * page, *width), np.nan, np.float32)
        buf[0] = rng.standard_normal(width)
        for i, ln in enumerate(live):
            pos = np.arange(ln)
            rows = tables[i, pos // page].astype(np.int64) * page + pos % page
            buf[rows] = rng.standard_normal((ln, *width))
        pools.append(torch.from_numpy(buf.reshape(n, page, *width))
                     .bfloat16())
    return pools, torch.from_numpy(tables)


def _mla_paged_case(rng, page, h, lens):
    """bf16 operands of mla_paged_decode over 2048 positions a sequence;
    the last row is an inactive batch row (zero table, length 1)."""
    pmax = 2048 // page
    b = len(lens) + 1
    (ckv, kpe), tables = _bf_pool(rng, b, pmax, page, lens + [0],
                                  [(512,), (64,)])
    tables[-1] = 0
    qn = _x(rng, b, h, 512).bfloat16()
    qp = _x(rng, b, h, 64).bfloat16()
    lengths = torch.tensor(lens + [1], dtype=torch.int32)
    return qn, qp, ckv, kpe, tables, lengths


MLA_PAGED_LENS = [0, 1, 15, 16, 63, 64, 65, 127, 128, 129, 1000, 2047, 2048]


@pytest.mark.parametrize("h", [4, 8, 32])
@pytest.mark.parametrize("page", [16, 64, 128])
def test_mla_paged_decode_split(cuda, page, h):
    """mla_paged_decode_split_kernel through mla_paged_decode (bf16)
    against the plain version: page 16 / 64 / 128 over 2048 positions, H
    below one head tile of 16 (4, 8) and two tiles (32); lengths 0 (zeros),
    1, on and around 16-row units, 64-row tiles, pages and 128-row spans,
    2047 and 2048; an inactive batch row; every pool row no sequence owns
    NaN. A second call gives the same bits (the merge's counters were set
    back), and ROUTED_LAUNCHES counts one a call."""
    rng = np.random.default_rng(page + h)
    lens = sorted(set(MLA_PAGED_LENS + [page - 1, page, page + 1]))
    args = _mla_paged_case(rng, page, h, lens)
    on = [t.to(cuda) for t in args]
    split = ROUTED_LAUNCHES["mla_paged_decode_split_kernel"]
    out = _counted("mla_paged_decode",
                   lambda: PA.mla_paged_decode(*on, 0.07))
    assert ROUTED_LAUNCHES["mla_paged_decode_split_kernel"] == split + 1
    again = PA.mla_paged_decode(*on, 0.07)
    ref = PA.mla_paged_decode_ref(*args, 0.07)
    assert out.dtype == torch.bfloat16
    assert bool(torch.isfinite(out.float()).all())
    assert torch.equal(out, again)
    assert torch.all(out[0] == 0)
    for i in range(1, len(lens) + 1):
        assert _rel(out[i], ref[i]) <= 1e-2, lens[i] if i < len(lens) else i


def _nan_tailed(t: torch.Tensor, device) -> torch.Tensor:
    """t [B, H, W] on device as the head of a buffer whose next 8 rows
    (where heads H .. H + 7 of a 16-row tile at H = 8 would sit) are NaN."""
    b, h, w = t.shape
    buf = torch.full((b * h + 8, w), float("nan"), dtype=t.dtype,
                     device=device)
    buf[: b * h] = t.reshape(b * h, w).to(device)
    return buf[: b * h].view(b, h, w)


@pytest.mark.parametrize("entry", ["mla_decode_fused", "mla_paged_decode"])
def test_mla_split_kernels_at_a_tensor_parallel_rank(cuda, entry):
    """DeepSeek-V2-Lite's 16 heads over tp = 2 leave 8 a rank: half of the
    16-row mma group of mla_decode_split_kernel and
    mla_paged_decode_split_kernel. The queries are followed in memory by
    NaN rows, every cache or pool row at or past a length is NaN: the
    outputs are finite and within 1e-2 of the plain version (the kernels
    load rows past H as zeros and store only rows below H), and the split
    kernel took the call."""
    rng = np.random.default_rng(8)
    h = 8
    if entry == "mla_decode_fused":
        cast = _decode_inputs(rng, 3, h, 2048, [0, 511, 2047])
        on = [t.to(cuda) for t in cast]
        on[0], on[1] = _nan_tailed(cast[0], cuda), _nan_tailed(cast[1], cuda)
        kernel = "mla_decode_split_kernel"
        split = ROUTED_LAUNCHES[kernel]
        out = _counted(entry, lambda: mla_decode_fused(*on, 0.07, 1e-6))
        ref = MD.mla_decode_fused_ref(*cast, 0.07, 1e-6)
    else:
        lens = [1, 64, 65, 512, 2048]
        cast = _mla_paged_case(rng, 64, h, lens)
        on = [t.to(cuda) for t in cast]
        on[0], on[1] = _nan_tailed(cast[0], cuda), _nan_tailed(cast[1], cuda)
        kernel = "mla_paged_decode_split_kernel"
        split = ROUTED_LAUNCHES[kernel]
        out = (_counted(entry, lambda: PA.mla_paged_decode(*on, 0.07)),)
        ref = (PA.mla_paged_decode_ref(*cast, 0.07),)
    assert ROUTED_LAUNCHES[kernel] == split + 1
    for o, rf in zip(out, ref):
        assert bool(torch.isfinite(o.float()).all())
        assert _rel(o, rf) <= 1e-2


@pytest.mark.parametrize("splits", ["one", "most"])
def test_mla_paged_decode_split_plans(cuda, splits, monkeypatch):
    """The kernel at a forced plan: one split of all 2048 positions, and
    the most splits (DECODE_MAX_SPLITS of 64 positions)."""
    rng = np.random.default_rng(5)
    args = _mla_paged_case(rng, 64, 16, [0, 17, 700, 2048])
    plan = (1, 2048) if splits == "one" else (MD.DECODE_MAX_SPLITS, 64)
    monkeypatch.setattr(MD, "decode_split_plan", lambda *a: plan)
    out = PA.mla_paged_decode(*[t.to(cuda) for t in args], 0.07)
    ref = PA.mla_paged_decode_ref(*args, 0.07)
    assert torch.all(out[0] == 0)
    for i in range(1, 5):
        assert _rel(out[i], ref[i]) <= 1e-2, i


def test_mla_paged_decode_routes(cuda):
    """float32 keeps the first version (not counted as routed, 1e-5); the
    first version on bf16 operands (kernel="first", what chip_smoke.py
    times beside the split kernel) agrees at 1e-2."""
    rng = np.random.default_rng(6)
    args = _mla_paged_case(rng, 64, 8, [0, 5, 300])
    f32 = [t.float() if t.is_floating_point() else t for t in args]
    split = ROUTED_LAUNCHES["mla_paged_decode_split_kernel"]
    out = _counted("mla_paged_decode", lambda: PA.mla_paged_decode(
        *[t.to(cuda) for t in f32], 0.07))
    assert ROUTED_LAUNCHES["mla_paged_decode_split_kernel"] == split
    assert _rel(out, PA.mla_paged_decode_ref(*f32, 0.07)) <= 1e-5
    launch, first = PA.decode_launcher(*[t.to(cuda) for t in args], 0.07,
                                       kernel="first")
    launch()
    assert _rel(first, PA.mla_paged_decode_ref(*args, 0.07)) <= 1e-2


def _gqa_prefill_case(rng, page, g, s, olds, valids, hkv=2, d=128,
                      span=2048):
    """bf16 operands of gqa_paged_prefill over ``span`` positions a
    chunk."""
    pmax = span // page
    live = [o + v for o, v in zip(olds, valids)]
    (k, v), tables = _bf_pool(rng, len(olds), pmax, page, live,
                              [(hkv, d), (hkv, d)])
    q = _x(rng, len(olds), g * hkv, s, d).bfloat16()
    return (q, k, v, tables, torch.tensor(olds, dtype=torch.int32),
            torch.tensor(valids, dtype=torch.int32))


@pytest.mark.parametrize("window", [0, 20, 512])
@pytest.mark.parametrize("g", [1, 4, 6, 7, 8, 12])
@pytest.mark.parametrize("page", [16, 64, 128])
def test_gqa_prefill_mma(cuda, page, g, window):
    """gqa_prefill_mma_kernel through gqa_paged_prefill (bf16) against the
    plain version: G = 1, 4, 6 and 7 (16 rows and the 64- / 128-row blocks
    not a multiple of it: Qwen2-57B-A14B's 28 over 4), 8 and 12
    (GLM-4.5-Air's 96 over 8) query heads a KV head; window 0, 20, 512; old lengths 0, 1, on and around a
    page, a 64-key tile and 2048 - S, valid < S and == S (S = 100, not a
    multiple of 16), an empty chunk on an empty cache (zeros); every pool
    row past the live length NaN. Padding rows (s >= valid) are compared
    too and finite: they see every live key in their window, and a row
    whose window holds none gives zeros in both. A second call gives the
    same bits; ROUTED_LAUNCHES counts one a call."""
    rng = np.random.default_rng(page * g + window)
    s = 100
    olds = [0, 1, page - 1, page + 1, 64, 2048 - s, 0]
    valids = [s - 7, s, s - 1, 37, s, s, 0]
    args = _gqa_prefill_case(rng, page, g, s, olds, valids)
    on = [t.to(cuda) for t in args]
    mma = ROUTED_LAUNCHES["gqa_prefill_mma_kernel"]
    out = _counted("gqa_paged_prefill", lambda: PA.gqa_paged_prefill(
        *on, 0.088, window=window))
    assert ROUTED_LAUNCHES["gqa_prefill_mma_kernel"] == mma + 1
    again = PA.gqa_paged_prefill(*on, 0.088, window=window)
    ref = PA.gqa_paged_prefill_ref(*args, 0.088, window=window)
    assert out.dtype == torch.bfloat16
    assert bool(torch.isfinite(out.float()).all())
    assert torch.equal(out, again)
    assert torch.all(out[-1] == 0)
    for i in range(len(olds) - 1):
        assert _rel(out[i], ref[i]) <= 1e-2, (olds[i], valids[i])


@pytest.mark.parametrize("rows", [64, 128])
def test_gqa_prefill_mma_plans(cuda, rows, monkeypatch):
    """Both block shapes at Mixtral's widths (32 query heads over 8 KV
    heads) and the mixed step's chunk (S = 256 after 256, and a padded
    continued chunk beside a fresh one), the plan forced."""
    rng = np.random.default_rng(rows)
    args = _gqa_prefill_case(rng, 64, 4, 256, [256, 0], [256, 200], hkv=8)
    monkeypatch.setattr(PA, "gqa_prefill_plan", lambda *a: rows)
    launch, out = PA.gqa_prefill_launcher(*[t.to(cuda) for t in args],
                                          0.088, kernel="mma")
    launch()
    ref = PA.gqa_paged_prefill_ref(*args, 0.088)
    assert bool(torch.isfinite(out.float()).all())
    for i in range(2):
        assert _rel(out[i], ref[i]) <= 1e-2, i


def test_gqa_prefill_routes(cuda):
    """float32 keeps the first version (not counted as routed, 1e-5); the
    first version on bf16 operands (kernel="first") agrees at 1e-2."""
    rng = np.random.default_rng(7)
    args = _gqa_prefill_case(rng, 16, 4, 40, [0, 19], [40, 33])
    f32 = [t.float() if t.is_floating_point() else t for t in args]
    mma = ROUTED_LAUNCHES["gqa_prefill_mma_kernel"]
    out = _counted("gqa_paged_prefill", lambda: PA.gqa_paged_prefill(
        *[t.to(cuda) for t in f32], 0.088))
    assert ROUTED_LAUNCHES["gqa_prefill_mma_kernel"] == mma
    assert _rel(out, PA.gqa_paged_prefill_ref(*f32, 0.088)) <= 1e-5
    launch, first = PA.gqa_prefill_launcher(*[t.to(cuda) for t in args],
                                            0.088, kernel="first")
    launch()
    assert _rel(first, PA.gqa_paged_prefill_ref(*args, 0.088)) <= 1e-2


# ------------------------------- redesigned paged GQA decode, row 13 (bf16)


def _gqa_decode_case(rng, page, g, lens, hkv=2, d=128, span=2048):
    """bf16 operands of gqa_paged_decode over ``span`` positions a
    sequence; the last row is an inactive batch row (zero table, length
    1)."""
    pmax = span // page
    b = len(lens) + 1
    (k, v), tables = _bf_pool(rng, b, pmax, page, lens + [0],
                              [(hkv, d), (hkv, d)])
    tables[-1] = 0
    q = _x(rng, b, g * hkv, d).bfloat16()
    lengths = torch.tensor(lens + [1], dtype=torch.int32)
    return q, k, v, tables, lengths


GQA_DECODE_LENS = [0, 1, 15, 16, 17, 63, 64, 65, 127, 128, 129, 1000, 2047,
                   2048]


@pytest.mark.parametrize("window", [0, 20, 512])
@pytest.mark.parametrize("g", [1, 4, 6, 7, 8, 12, 16])
@pytest.mark.parametrize("page", [16, 64, 128])
def test_gqa_decode_split(cuda, page, g, window):
    """gqa_decode_split_kernel through gqa_paged_decode (bf16) against the
    plain version: page 16 / 64 / 128 over 2048 positions, G = 1, 4, 6, 7
    (Qwen2-57B-A14B), 8 (Qwen3), 12 (GLM-4.5-Air) and 16 query heads a KV
    head (one mma row group, rows past G zero and never stored), window 0, 20 (fewer keys
    than a split's least) and 512; lengths 0 (zeros), 1, on and around
    16-key units, 64-key tiles and pages, 1000, 2047 and 2048; an inactive
    batch row; every pool row no sequence owns NaN, and the split partials
    NaN before the call. A second call gives the same bits (the counters
    were set back), and ROUTED_LAUNCHES counts one a call."""
    rng = np.random.default_rng(page * g + window)
    lens = sorted(set(GQA_DECODE_LENS + [page - 1, page, page + 1]))
    args = _gqa_decode_case(rng, page, g, lens)
    on = [t.to(cuda) for t in args]
    split = ROUTED_LAUNCHES["gqa_decode_split_kernel"]
    _poison_scratch("gqa_decode_split")
    out = _counted("gqa_paged_decode", lambda: PA.gqa_paged_decode(
        *on, 0.088, window=window))
    assert ROUTED_LAUNCHES["gqa_decode_split_kernel"] == split + 1
    again = PA.gqa_paged_decode(*on, 0.088, window=window)
    ref = PA.gqa_paged_decode_ref(*args, 0.088, window=window)
    assert out.dtype == torch.bfloat16
    assert bool(torch.isfinite(out.float()).all())
    assert torch.equal(out, again)
    assert torch.all(out[0] == 0)
    for i in range(1, len(lens) + 1):
        assert _rel(out[i], ref[i]) <= 1e-2, lens[i] if i < len(lens) else i
    _, cnt = MM._SCRATCH[(str(out.device), "gqa_decode_split")]
    assert not cnt.any()


@pytest.mark.parametrize("splits", [1, 32])
@pytest.mark.parametrize("window", [0, 512])
def test_gqa_decode_split_plans(cuda, splits, window, monkeypatch):
    """The kernel at Mixtral's widths (32 query heads over 8 KV heads) at a
    forced plan: one split (the block writes the output itself), and the
    most splits (32: most hold no key of a short sequence or a window)."""
    rng = np.random.default_rng(splits + window)
    args = _gqa_decode_case(rng, 64, 4, [0, 17, 700, 2048], hkv=8)
    monkeypatch.setattr(PA, "gqa_decode_split_plan", lambda *a: splits)
    out = PA.gqa_paged_decode(*[t.to(cuda) for t in args], 0.088,
                              window=window)
    ref = PA.gqa_paged_decode_ref(*args, 0.088, window=window)
    assert torch.all(out[0] == 0)
    for i in range(1, 5):
        assert _rel(out[i], ref[i]) <= 1e-2, i


@pytest.mark.parametrize("h, hkv", [(32, 4), (28, 4), (96, 8)])
def test_gqa_qwen_widths(cuda, h, hkv):
    """Both kernels at the Qwen and GLM widths, at the plans their wrappers
    pick: Qwen3-30B-A3B's 32 and Qwen2-57B-A14B's 28 query heads over 4 KV
    heads of 128 and GLM-4.5-Air's 96 over 8 (G = 12), page 64; the serving batch of 8 at decode (lengths 0, 1, on
    and around pages, 2048) and a mixed step's chunk of 256 after 256 and
    two chunks (one fresh, one continued and padded) at prefill; every
    pool row no sequence owns NaN; each row within 1e-2 of its plain
    version's, the launches counted on the redesigned kernels."""
    rng = np.random.default_rng(h)
    g = h // hkv
    lens = [0, 1, 63, 64, 65, 700, 2047]
    args = _gqa_decode_case(rng, 64, g, lens, hkv=hkv)
    split = ROUTED_LAUNCHES["gqa_decode_split_kernel"]
    out = PA.gqa_paged_decode(*[t.to(cuda) for t in args], 0.088)
    assert ROUTED_LAUNCHES["gqa_decode_split_kernel"] == split + 1
    ref = PA.gqa_paged_decode_ref(*args, 0.088)
    assert torch.all(out[0] == 0)
    for i in range(1, len(lens) + 1):
        assert _rel(out[i], ref[i]) <= 1e-2, i
    for olds, valids in (([256], [256]), ([0, 256], [256, 200])):
        pargs = _gqa_prefill_case(rng, 64, g, 256, olds, valids, hkv=hkv)
        mma = ROUTED_LAUNCHES["gqa_prefill_mma_kernel"]
        out = PA.gqa_paged_prefill(*[t.to(cuda) for t in pargs], 0.088)
        assert ROUTED_LAUNCHES["gqa_prefill_mma_kernel"] == mma + 1
        ref = PA.gqa_paged_prefill_ref(*pargs, 0.088)
        assert bool(torch.isfinite(out.float()).all())
        for i in range(len(olds)):
            assert _rel(out[i], ref[i]) <= 1e-2, (olds[i], valids[i])


@pytest.mark.parametrize("window", [0, 20, 512])
@pytest.mark.parametrize("g", [8, 16])
def test_gqa_d256(cuda, g, window):
    """Rows 13 and 15 at head dim 256 (Qwen3-Next: 16 query heads over 2 KV
    heads, G = 8; and G = 16), page 64, bf16 on the redesigned kernels and
    float32 on the first versions: decode lengths 0, 1, on and around
    tiles and pages, 2047 and an inactive row; prefill chunks of 100 (old
    lengths 0, 1, 63, 65, 64 and 1948, valid < S and == S, an empty chunk),
    each against its plain version (1e-2 bf16, 1e-5 float32), every pool
    row no sequence owns NaN, the split partials NaN before the call; a
    second bf16 call gives the same bits."""
    rng = np.random.default_rng(g + window)
    lens = [0, 1, 15, 16, 17, 63, 64, 65, 700, 2047]
    args = _gqa_decode_case(rng, 64, g, lens, d=256)
    f32 = [t.float() if t.is_floating_point() else t for t in args]
    split = ROUTED_LAUNCHES["gqa_decode_split_kernel"]
    _poison_scratch("gqa_decode_split")
    on = [t.to(cuda) for t in args]
    out = PA.gqa_paged_decode(*on, 0.0625, window=window)
    assert ROUTED_LAUNCHES["gqa_decode_split_kernel"] == split + 1
    assert torch.equal(out, PA.gqa_paged_decode(*on, 0.0625, window=window))
    ref = PA.gqa_paged_decode_ref(*args, 0.0625, window=window)
    first = PA.gqa_paged_decode(*[t.to(cuda) for t in f32], 0.0625,
                                window=window)
    ref32 = PA.gqa_paged_decode_ref(*f32, 0.0625, window=window)
    assert torch.all(out[0] == 0) and torch.all(first[0] == 0)
    for i in range(1, len(lens) + 1):
        assert _rel(out[i], ref[i]) <= 1e-2, i
        assert _rel(first[i], ref32[i]) <= 1e-5, i
    s = 100
    olds = [0, 1, 63, 65, 64, 2048 - s, 0]
    valids = [s - 7, s, s - 1, 37, s, s, 0]
    pargs = _gqa_prefill_case(rng, 64, g, s, olds, valids, d=256)
    p32 = [t.float() if t.is_floating_point() else t for t in pargs]
    mma = ROUTED_LAUNCHES["gqa_prefill_mma_kernel"]
    on = [t.to(cuda) for t in pargs]
    out = PA.gqa_paged_prefill(*on, 0.0625, window=window)
    assert ROUTED_LAUNCHES["gqa_prefill_mma_kernel"] == mma + 1
    assert torch.equal(out, PA.gqa_paged_prefill(*on, 0.0625, window=window))
    ref = PA.gqa_paged_prefill_ref(*pargs, 0.0625, window=window)
    first = PA.gqa_paged_prefill(*[t.to(cuda) for t in p32], 0.0625,
                                 window=window)
    ref32 = PA.gqa_paged_prefill_ref(*p32, 0.0625, window=window)
    assert bool(torch.isfinite(out.float()).all())
    assert torch.all(out[-1] == 0)
    for i in range(len(olds) - 1):
        assert _rel(out[i], ref[i]) <= 1e-2, (olds[i], valids[i])
        assert _rel(first[i], ref32[i]) <= 1e-5, (olds[i], valids[i])


@pytest.mark.parametrize("rows", [64, 128])
def test_gqa_d256_prefill_plans(cuda, rows, monkeypatch):
    """Both block shapes at head dim 256 (16 query heads over 2 KV heads):
    a mixed step's chunk of 256 after 256 and a padded continued chunk
    beside a fresh one, the plan forced."""
    rng = np.random.default_rng(rows + 256)
    args = _gqa_prefill_case(rng, 64, 8, 256, [256, 0], [256, 200], d=256)
    monkeypatch.setattr(PA, "gqa_prefill_plan", lambda *a: rows)
    launch, out = PA.gqa_prefill_launcher(*[t.to(cuda) for t in args],
                                          0.0625, kernel="mma")
    launch()
    ref = PA.gqa_paged_prefill_ref(*args, 0.0625)
    assert bool(torch.isfinite(out.float()).all())
    for i in range(2):
        assert _rel(out[i], ref[i]) <= 1e-2, i


def test_gqa_window_past_the_window(cuda):
    """SmallThinker-21B's windowed layers: 28 query heads over 4 KV heads
    of 128 (G = 7), window 4096, decode lengths 4,097, 4,608 and 8,200 (keys
    before the window never read: they are NaN) and a 256-token prefill
    chunk after 4,352 and after 7,944, on both redesigned kernels, against
    the plain versions; the decode's K rows before each window are NaN,
    so a read of one would show."""
    rng = np.random.default_rng(4096)
    lens = [4097, 4608, 8200]
    args = _gqa_decode_case(rng, 64, 7, lens, hkv=4, span=8256)
    k, v = args[1], args[2]
    tables = args[3]
    for i, n in enumerate(lens):  # keys outside the window: NaN
        pos = torch.arange(n - 4096)
        k.view(-1, 4, 128)[tables[i].long()[pos // 64] * 64 + pos % 64] = \
            float("nan")
    out = PA.gqa_paged_decode(*[t.to(cuda) for t in args], 0.088,
                              window=4096)
    ref = PA.gqa_paged_decode_ref(*args, 0.088, window=4096)
    for i in range(len(lens)):
        assert _rel(out[i], ref[i]) <= 1e-2, lens[i]
    pargs = _gqa_prefill_case(rng, 64, 7, 256, [4352, 7944], [256, 256],
                              hkv=4, span=8256)
    out = PA.gqa_paged_prefill(*[t.to(cuda) for t in pargs], 0.088,
                               window=4096)
    ref = PA.gqa_paged_prefill_ref(*pargs, 0.088, window=4096)
    for i in range(2):
        assert _rel(out[i], ref[i]) <= 1e-2, i


def test_gqa_decode_routes(cuda):
    """float32 keeps the first version (not counted as routed, 1e-5); the
    first version on bf16 operands (kernel="first", what chip_smoke.py
    times beside the split kernel) agrees at 1e-2."""
    rng = np.random.default_rng(6)
    args = _gqa_decode_case(rng, 64, 4, [5, 300, 700])
    f32 = [t.float() if t.is_floating_point() else t for t in args]
    split = ROUTED_LAUNCHES["gqa_decode_split_kernel"]
    out = _counted("gqa_paged_decode", lambda: PA.gqa_paged_decode(
        *[t.to(cuda) for t in f32], 0.088))
    assert ROUTED_LAUNCHES["gqa_decode_split_kernel"] == split
    assert _rel(out, PA.gqa_paged_decode_ref(*f32, 0.088)) <= 1e-5
    launch, first = PA.gqa_decode_launcher(*[t.to(cuda) for t in args],
                                           0.088, kernel="first")
    launch()
    assert _rel(first, PA.gqa_paged_decode_ref(*args, 0.088)) <= 1e-2


@pytest.mark.parametrize("kind", ["bf16", "f32", "int8_g"])
@pytest.mark.parametrize("t", [3, 12])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_expert_products_on_card(cuda, kind, t, dtype):
    """Experts of the kinds no kernel takes (ops/moe.py PLAIN_KINDS) run
    the plain products on the card: the gather path (3 tokens) and the
    grouped path (12) equal the CPU's within 1e-5 (float32) / 1e-2 (bf16),
    and no custom kernel launches."""
    from ktransformers_tpu_torch.ops.moe import MoEWeights, moe_forward
    from ktransformers_tpu_torch.quant.formats import quantize

    rng = np.random.default_rng(t)
    gu = quantize(_x(rng, 6, 128, 96) * 0.1, kind, 32)
    dn = quantize(_x(rng, 6, 48, 128) * 0.1, kind, 32)
    idx = torch.from_numpy(np.stack([rng.permutation(6)[:2]
                                     for _ in range(t)]))
    w = torch.from_numpy(rng.random((t, 2)).astype(np.float32))
    x = _x(rng, t, 128).to(getattr(torch, dtype))
    ref = moe_forward(x, MoEWeights(gu, dn), idx, w)
    before = (dict(LAUNCHES), dict(ROUTED_LAUNCHES))
    out = moe_forward(x.to(cuda), MoEWeights(gu.to(cuda), dn.to(cuda)),
                      idx.to(cuda), w.to(cuda))
    torch.cuda.synchronize()
    assert (dict(LAUNCHES), dict(ROUTED_LAUNCHES)) == before
    assert out.device.type == "cuda" and out.dtype == x.dtype
    assert _rel(out, ref) <= (1e-5 if dtype == "float32" else 1e-2)


@pytest.mark.parametrize("m", [4, 5])
def test_verify_step_shapes(cuda, m):
    """The speculative verify step's k + 1 = 4 / 5 rows at
    DeepSeek-V2-Lite's widths: row 1 on w4a8_mma (1e-2, bf16 out), row 3
    on the FFN's tensor-core kernel and row 2's (k + 1) x 6 gathered rows
    (1e-2, the FFN kernels' tolerance), each against its plain version."""
    rng = np.random.default_rng(60 + m)
    x = _x(rng, m, 2048).bfloat16()
    w = _w(rng, (2048, 3648))
    before = ROUTED_LAUNCHES["w4a8_mma_kernel"]
    out = MM.dense_w4a8_matmul(x.to(cuda), w.to(cuda))
    torch.cuda.synchronize()
    assert ROUTED_LAUNCHES["w4a8_mma_kernel"] == before + 1
    assert _rel(out, MM.w4a8_matmul_ref(x, w)) <= 1e-2
    gu, dn = _w(rng, (2048, 2 * 2816)), _w(rng, (2816, 2048))
    before = ROUTED_LAUNCHES["w4a8_ffn_mma_kernel"]
    out = F.dense_w4a8_ffn(x.to(cuda), gu.to(cuda), dn.to(cuda))
    torch.cuda.synchronize()
    assert ROUTED_LAUNCHES["w4a8_ffn_mma_kernel"] == before + 1
    assert _rel(out, F.dense_w4a8_ffn_ref(x, gu, dn)) <= 1e-2
    egu, edn = _w(rng, (8, 2048, 2 * 1408)), _w(rng, (8, 1408, 2048))
    ids = torch.from_numpy(np.concatenate(
        [rng.permutation(8)[:6] for _ in range(m)]).astype(np.int32))
    xr = _x(rng, 6 * m, 2048).bfloat16()
    out = _counted("gathered_w4a8_ffn", lambda: F.gathered_w4a8_ffn(
        xr.to(cuda), egu.to(cuda), edn.to(cuda), ids.to(cuda)))
    assert _rel(out, F.gathered_w4a8_ffn_ref(xr, egu, edn, ids)) <= 1e-2


def _summaries(pools, tables, lens, page, shape):
    """Every anchor's planes over the live keys of a _bf_pool (MLA: the
    [ckv | k_pe] latent; GQA: the k pool), on the CPU."""
    from ktransformers_tpu_torch.ops import sparse_attention as SA

    planes = {"smin": torch.full(shape, torch.inf),
              "smax": torch.full(shape, -torch.inf),
              "ssum": torch.zeros(shape), "sfix": torch.zeros(shape)}
    for b, ln in enumerate(lens):
        pos = torch.arange(ln)
        pid = tables[b].long()[pos // page]
        keys = torch.cat([p[pid, pos % page].float() for p in pools], -1)
        SA.update_page_summaries_cfg(planes, keys[None], pid[None],
                                     pos[None], page)
    planes["sdyn"] = planes["sfix"].clone()
    return planes


@pytest.mark.parametrize("retrieval", ["layer", "qhead"])
@pytest.mark.parametrize("anchor", ["quest", "block_mean", "fixed"])
def test_sparse_mla_decode_on_the_card(cuda, anchor, retrieval):
    """The sparse decode (plain PyTorch on both devices) over bf16 pools
    with NaN in every row past a sequence's length: the card's output is
    finite and within 1e-4 of the CPU's (float32 sums in another order),
    over a budget of 3 of 8 pages and of all of them."""
    from ktransformers_tpu_torch.ops import sparse_attention as SA

    rng = np.random.default_rng(70)
    page, pmax, lens = 16, 8, [100, 37, 128]
    (ckv, kpe), tables = _bf_pool(rng, 3, pmax, page, lens, [(64,), (16,)])
    planes = _summaries((ckv, kpe), tables, lens, page, (ckv.shape[0], 80))
    qa = _x(rng, 3, 4, 64)
    qp = _x(rng, 3, 4, 16)
    lengths = torch.tensor(lens, dtype=torch.int32)
    for budget in (3, 8):
        args = (None, None, tables, lengths, page, budget, 0.125, anchor,
                retrieval)
        ref = SA.sparse_mla_decode(qa, qp, ckv, kpe, *args, planes)
        out = SA.sparse_mla_decode(
            qa.to(cuda), qp.to(cuda), ckv.to(cuda), kpe.to(cuda), None, None,
            tables.to(cuda), lengths.to(cuda), page, budget, 0.125, anchor,
            retrieval, {k: v.to(cuda) for k, v in planes.items()})
        assert torch.isfinite(out).all()
        assert _rel(out, ref) <= 1e-4


@pytest.mark.parametrize("retrieval", ["layer", "kvhead"])
@pytest.mark.parametrize("anchor", ["quest", "block_max"])
def test_sparse_gqa_decode_on_the_card(cuda, anchor, retrieval):
    """As test_sparse_mla_decode_on_the_card, on GQA k / v pools (8 query
    heads over 2 KV heads of 64)."""
    from ktransformers_tpu_torch.ops import sparse_attention as SA

    rng = np.random.default_rng(71)
    page, pmax, lens = 16, 8, [90, 128, 17]
    (k, v), tables = _bf_pool(rng, 3, pmax, page, lens, [(2, 64), (2, 64)])
    planes = _summaries((k,), tables, lens, page, (k.shape[0], 2, 64))
    q = _x(rng, 3, 8, 64)
    lengths = torch.tensor(lens, dtype=torch.int32)
    for budget in (3, 8):
        ref = SA.sparse_gqa_decode(q, k, v, None, None, tables, lengths,
                                   page, budget, 0.125, anchor, retrieval,
                                   planes)
        out = SA.sparse_gqa_decode(
            q.to(cuda), k.to(cuda), v.to(cuda), None, None, tables.to(cuda),
            lengths.to(cuda), page, budget, 0.125, anchor, retrieval,
            {key: t.to(cuda) for key, t in planes.items()})
        assert torch.isfinite(out).all()
        assert _rel(out, ref) <= 1e-4
