"""Plain versions of the port's Mixtral-path kernels against the JAX
package's Pallas kernels in interpret mode: gqa_paged_decode and
gqa_paged_prefill (rows 13 and 15 of the kernel table in PERF.md), and
gathered_w4a8_matmul and grouped_w4a8_matmul (rows 7 and 8).

On the CPU every wrapper takes its plain version, so these tests hold the
arithmetic the CUDA kernels repeat (tests/test_torch_cuda.py and
chip_smoke.py hold the kernels to the plain versions on the card). Inputs
come from np.random.default_rng seeds and pass through both packages.

Tolerances, float32:
- paged attention: 1e-5 (rtol = atol). Both sides accumulate in float32;
  the Pallas kernels run an online softmax over page blocks, the plain
  versions one softmax over the gathered rows. Every pool row at or past a
  sequence's live length, and every page no table names, is NaN: neither
  side may let it through. Lengths sit on page boundaries (k * page and
  k * page + 1) to catch an off-by-one between the meanings of
  ``lengths`` (decode: current token included; prefill: the old length);
- W4A8 matmuls: 1e-4 of the largest output. Both sides run the same
  integer dots exactly and the same float32 epilogue and differ only in
  the order of float32 sums.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ktransformers_tpu.ops.pallas import paged_attention as jpa
from ktransformers_tpu.ops.pallas import w4a8_matmul as jwm
from ktransformers_tpu.quant.formats import quantize as j_quantize
from ktransformers_tpu.quant.w4a8 import repack_offset_lo as j_repack
from ktransformers_tpu_torch.convert import qtensor_from_jax
from ktransformers_tpu_torch.ops.cuda import LAUNCHES
from ktransformers_tpu_torch.ops.cuda import paged_attention as PA
from ktransformers_tpu_torch.ops.cuda import w4a8_matmul as MM

B, H, HKV, D, PAGE = 3, 8, 2, 128, 16
SCALE = D ** -0.5
TOL = dict(rtol=1e-5, atol=1e-5)
W4A8_TOL = 1e-4


def _pool(rng, b, pmax, live):
    """Shuffled tables [b, pmax] over k / v pools [b * pmax + 1, PAGE, HKV,
    D] that are NaN except the first live[i] positions of sequence i."""
    num_pages = b * pmax + 1
    tables = (rng.permutation(num_pages - 1)[: b * pmax] + 1).reshape(
        b, pmax).astype(np.int32)
    k = np.full((num_pages, PAGE, HKV, D), np.nan, np.float32)
    v = np.full_like(k, np.nan)
    for i, n in enumerate(live):
        for pos in range(n):
            pid, slot = tables[i, pos // PAGE], pos % PAGE
            k[pid, slot] = rng.standard_normal((HKV, D))
            v[pid, slot] = rng.standard_normal((HKV, D))
    return k, v, tables


def _t(*arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


@pytest.mark.parametrize("window", [0, 20])
@pytest.mark.parametrize("lengths", [[16, 33, 48], [1, 17, 64]])
def test_gqa_paged_decode(lengths, window):
    """lengths include the current token (k * page and k * page + 1);
    with a window only the last ``window`` keys count."""
    rng = np.random.default_rng(sum(lengths) + window)
    pmax = 4
    k, v, tables = _pool(rng, B, pmax, lengths)
    q = rng.standard_normal((B, H, D)).astype(np.float32)
    lens = np.asarray(lengths, np.int32)
    ref = np.asarray(jpa.gqa_paged_decode(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(tables),
        jnp.asarray(lens), SCALE, window=window, interpret=True))
    before = dict(LAUNCHES)
    out = PA.gqa_paged_decode(*_t(q, k, v, tables, lens), SCALE,
                              window=window)
    assert LAUNCHES == before  # the CPU path launches nothing
    np.testing.assert_allclose(out.numpy(), ref, **TOL)


def test_gqa_paged_decode_head_groups():
    """Query head h reads KV head h // (H / Hkv): with the second KV head's
    values far from the first's, each group's output sits on its own."""
    rng = np.random.default_rng(3)
    k, v, tables = _pool(rng, 1, 2, [20])
    live = ~np.isnan(v)
    v[..., 1, :][live[..., 1, :]] += 100.0
    q = rng.standard_normal((1, H, D)).astype(np.float32)
    out = PA.gqa_paged_decode(*_t(q, k, v, tables, np.asarray([20], np.int32)),
                              SCALE).numpy()
    assert (out[0, : H // 2] < 50).all() and (out[0, H // 2 :] > 50).all()


@pytest.mark.parametrize("window", [0, 20])
@pytest.mark.parametrize("olds, valids", [
    ([0, 16, 17], [16, 16, 15]),   # fresh, continued on and off a boundary
    ([32, 0, 1], [16, 9, 16]),     # a padded chunk (rows 9.. are padding)
])
def test_gqa_paged_prefill(olds, valids, window):
    """lengths are the OLD lengths, the chunk already written. Rows past
    ``valid`` are padding: finite, and equal to the reference where they
    see a live key (without a window they see every live key; with one the
    two packages differ on a padding row whose window holds none)."""
    rng = np.random.default_rng(sum(olds) + window)
    s, pmax = 16, 4
    live = [o + v for o, v in zip(olds, valids)]
    k, v, tables = _pool(rng, B, pmax, live)
    q = rng.standard_normal((B, H, s, D)).astype(np.float32)
    old, val = np.asarray(olds, np.int32), np.asarray(valids, np.int32)
    ref = np.asarray(jpa.gqa_paged_prefill(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(tables),
        jnp.asarray(old), jnp.asarray(val), SCALE, window=window,
        interpret=True))
    out = PA.gqa_paged_prefill(*_t(q, k, v, tables, old, val), SCALE,
                               window=window).numpy()
    assert np.isfinite(out).all()
    rows = np.arange(s)[None, :] < val[:, None] if window else np.ones(
        (B, s), bool)
    np.testing.assert_allclose(out.transpose(0, 2, 1, 3)[rows],
                               ref.transpose(0, 2, 1, 3)[rows], **TOL)


def test_gqa_paged_prefill_equals_decode_steps():
    """A chunk's row j equals a decode step at length old + j + 1 (the
    same keys): the two kernels' meanings of lengths agree."""
    rng = np.random.default_rng(9)
    old, s = 17, 8
    k, v, tables = _pool(rng, 1, 4, [old + s])
    q = rng.standard_normal((1, H, s, D)).astype(np.float32)
    pre = PA.gqa_paged_prefill(
        *_t(q, k, v, tables, np.asarray([old], np.int32),
            np.asarray([s], np.int32)), SCALE)
    for j in range(s):
        dec = PA.gqa_paged_decode(
            torch.from_numpy(q[:, :, j].copy()), *_t(k, v, tables),
            torch.tensor([old + j + 1], dtype=torch.int32), SCALE)
        np.testing.assert_allclose(pre[:, :, j].numpy(), dec.numpy(), **TOL)


def test_gqa_wrappers_refuse_bad_shapes():
    rng = np.random.default_rng(1)
    k, v, tables = _pool(rng, 1, 2, [5])
    q = torch.zeros(1, H, D)
    lens = torch.tensor([5], dtype=torch.int32)
    kt, vt, tt = _t(k, v, tables)
    with pytest.raises(ValueError, match="query heads"):
        PA.gqa_paged_decode(torch.zeros(1, 5, D), kt, vt, tt, lens, SCALE)
    with pytest.raises(ValueError, match="int32"):
        PA.gqa_paged_decode(q, kt, vt, tt.long(), lens, SCALE)
    with pytest.raises(ValueError, match="pools"):
        PA.gqa_paged_decode(q, kt, vt[..., :64], tt, lens, SCALE)
    with pytest.raises(ValueError, match="valid"):
        PA.gqa_paged_prefill(q[:, :, None], kt, vt, tt, lens, lens.long(),
                             SCALE)


def _w4a8(rng, shape, group_size):
    w = jnp.asarray(rng.standard_normal(shape).astype(np.float32) * 0.1)
    jq = j_repack(j_quantize(w, "int4_g", group_size=group_size))
    return jq, qtensor_from_jax(jax.device_get(jq), "cpu")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("group_size", [32, 128])
def test_gathered_w4a8_matmul(group_size, dtype):
    """Row r through expert ids[r] (repeated experts, one unused)."""
    rng = np.random.default_rng(group_size)
    jw, tw = _w4a8(rng, (5, 256, 96), group_size)
    assert tw.group_size == group_size
    x = rng.standard_normal((7, 256)).astype(np.float32)
    ids = np.asarray([3, 0, 4, 3, 1, 0, 3], np.int32)
    ref = np.asarray(jwm.gathered_w4a8_matmul(
        jnp.asarray(x, dtype), jw, jnp.asarray(ids), interpret=True
    ).astype(jnp.float32))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    out = MM.gathered_w4a8_matmul(tx, tw, torch.from_numpy(ids))
    assert out.dtype == tx.dtype and out.shape == (7, 96)
    tol = W4A8_TOL if dtype == "float32" else 1e-2
    assert float(np.abs(out.float().numpy() - ref).max()
                 / np.abs(ref).max()) <= tol


@pytest.mark.parametrize("group_size", [32, 128])
def test_grouped_w4a8_matmul(group_size):
    """Rows sorted by expert with an empty expert; the last 5 rows lie past
    sum(group_sizes) and come back zero on both sides."""
    rng = np.random.default_rng(40 + group_size)
    jw, tw = _w4a8(rng, (4, 256, 64), group_size)
    sizes = np.asarray([9, 0, 14, 12], np.int32)
    m = int(sizes.sum()) + 5
    x = rng.standard_normal((m, 256)).astype(np.float32)
    ref = np.asarray(jwm.grouped_w4a8_matmul(
        jnp.asarray(x), jw, jnp.asarray(sizes), interpret=True))
    out = MM.grouped_w4a8_matmul(*_t(x), tw, torch.from_numpy(sizes)).numpy()
    assert float(np.abs(out - ref).max() / np.abs(ref).max()) <= W4A8_TOL
    assert not out[-5:].any() and not ref[-5:].any()


def test_grouped_equals_gathered_rows():
    """The two entries compute one function: sorted rows through the
    grouped entry equal the same rows gathered by their experts."""
    rng = np.random.default_rng(5)
    _, tw = _w4a8(rng, (3, 128, 32), 64)
    sizes = torch.tensor([4, 2, 5], dtype=torch.int32)
    x = torch.from_numpy(rng.standard_normal((11, 128)).astype(np.float32))
    ids = torch.repeat_interleave(torch.arange(3), sizes.long())
    np.testing.assert_array_equal(
        MM.grouped_w4a8_matmul(x, tw, sizes).numpy(),
        MM.gathered_w4a8_matmul(x, tw, ids.to(torch.int32)).numpy())


def test_w4a8_rows_refuse_unrepacked_weights():
    from ktransformers_tpu_torch.quant.formats import quantize

    w = quantize(torch.randn(2, 64, 32), "int4_g", group_size=32)
    with pytest.raises(ValueError, match="offset-lo"):
        MM.gathered_w4a8_matmul(torch.zeros(1, 64), w,
                                torch.zeros(1, dtype=torch.int32))
    _, tw = _w4a8(np.random.default_rng(0), (2, 64, 32), 32)
    with pytest.raises(ValueError, match="group_sizes"):
        MM.grouped_w4a8_matmul(torch.zeros(3, 64), tw,
                               torch.zeros(3, dtype=torch.int32))
