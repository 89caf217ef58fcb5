"""The plain versions of the port's transposed matmuls (rows 16 and 17 of
the kernel table: dx = dy @ W^T on the packed weight, the input gradients
of LoRA SFT) against the JAX package's Pallas kernels in interpret mode
(ops/pallas/quant_matmul_t.py, and its gathered backward in
ops/pallas/vjp.py).

Weights are quantized by the JAX package from a numpy seed and carried
across with convert.qtensor_from_jax ("int4_g offset-lo" is the W4A8
repack with the JAX package's padded scales); dy is a numpy array handed
to both sides in bfloat16, the dtype of the SFT backward.

Tolerance: 1e-5 of the largest |dx|. Both sides round the same operands
to bf16 at the same places (dy * scale for int8 / fp8, dy and the decoded
weight for the others) and sum the products in float32; only the order of
the sums differs (seen: ~1e-7).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ktransformers_tpu.ops.pallas import quant_matmul as jqm
from ktransformers_tpu.ops.pallas import quant_matmul_t as jqt
from ktransformers_tpu.quant import formats as jf
from ktransformers_tpu.quant import w4a8 as jw
from ktransformers_tpu_torch.convert import qtensor_from_jax
from ktransformers_tpu_torch.ops.cuda import LAUNCHES
from ktransformers_tpu_torch.ops.cuda import quant_matmul_t as tqt

from tests.test_torch_model import one_torch_thread  # noqa: F401

KINDS = ("int8", "fp8", "int4", "int4_g", "int4_gz", "int4_g offset-lo",
         "mxfp4", "mxfp8")
TOL = 1e-5


def _weights(kind, shape, seed=0):
    w = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    jq = jf.quantize(jnp.asarray(w * 0.05), kind.split()[0], group_size=128)
    if kind.endswith("offset-lo"):
        jq = jf.pad_scale_sublanes(jw.repack_offset_lo(jq))
    return jq, qtensor_from_jax(jax.device_get(jq), "cpu")


def _dy(shape, seed=1):
    dy = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return (jnp.asarray(dy, jnp.bfloat16),
            torch.from_numpy(dy).to(torch.bfloat16))


def _close(out: torch.Tensor, ref):
    ref = np.asarray(ref, np.float32)
    out = out.numpy()
    assert out.dtype == np.float32 and out.shape == ref.shape
    assert np.isfinite(out).all()
    err = np.abs(out - ref).max() / max(np.abs(ref).max(), 1e-30)
    assert err <= TOL, err


@pytest.mark.parametrize("m, n", [(1, 1824), (9, 1824), (9, 384)])
@pytest.mark.parametrize("kind", KINDS)
def test_quant_matmul_t(kind, m, n):
    # N = 1824 has no multiple-of-128 divisor: the contraction's last
    # block is partial (the fused qkv_a's 3648, halved)
    jq, tq = _weights(kind, (256, n))
    jdy, tdy = _dy((m, n))
    before = dict(LAUNCHES)
    _close(tqt.quant_matmul_t(tdy, tq),
           jqt.quant_matmul_t(jdy, jq, interpret=True))
    assert LAUNCHES == before  # the CPU path launches nothing


def test_quant_matmul_t_leading_axes_and_group_96():
    # DeepSeek-V2-Lite's layer-0 down projection has group 96 (gs / 2 = 48)
    w = np.random.default_rng(2).standard_normal((576, 64)).astype(np.float32)
    jq = jf.quantize(jnp.asarray(w * 0.05), "int4_g", group_size=96)
    jq = jw.repack_offset_lo(jq)
    tq = qtensor_from_jax(jax.device_get(jq), "cpu")
    assert tq.group_size == 96
    jdy, tdy = _dy((2, 3, 64))
    _close(tqt.quant_matmul_t(tdy, tq),
           jqt.quant_matmul_t(jdy, jq, interpret=True))


def _tile_layout_ref(jq, sizes, dy_np):
    """The JAX grouped transposed kernel over the forward's tile layout
    (as ops/pallas/vjp.py:_gmm_bwd runs it)."""
    m = dy_np.shape[0]
    e = sizes.shape[0]
    dest, valid, tile_group, mpad = jqm.grouped_tile_layout(
        m, e, jnp.asarray(sizes), jqm.GROUP_BM)
    dy = jnp.asarray(dy_np, jnp.bfloat16)
    dy_tiles = jnp.zeros((mpad, dy.shape[-1]), dy.dtype).at[dest].set(
        jnp.where(valid[:, None], dy, 0))
    dx_tiles = jqt.grouped_quant_matmul_t(dy_tiles, jq, tile_group,
                                          bm=jqm.GROUP_BM, interpret=True)
    return jnp.where(valid[:, None], dx_tiles[dest], 0.0)


@pytest.mark.parametrize("n", [128, 1824])
@pytest.mark.parametrize("kind", KINDS)
def test_grouped_quant_matmul_t(kind, n):
    # ragged groups with an empty expert; the last 6 rows lie past
    # sum(group_sizes) and must come back zero
    jq, tq = _weights(kind, (4, 256, n))
    sizes = np.asarray([40, 0, 70, 34], np.int32)
    dy = np.random.default_rng(3).standard_normal((150, n)).astype(np.float32)
    out = tqt.grouped_quant_matmul_t(
        torch.from_numpy(dy).to(torch.bfloat16), tq, torch.from_numpy(sizes))
    _close(out, _tile_layout_ref(jq, sizes, dy))
    assert not out[144:].any()


@pytest.mark.parametrize("kind", KINDS)
def test_gathered_quant_matmul_t(kind):
    """Row r through expert ids[r], against the JAX package's gathered
    backward (ops/pallas/vjp.py:_gather_bwd: rows sorted by expert through
    the grouped kernel, then un-sorted; here before its cast to dy's
    dtype)."""
    jq, tq = _weights(kind, (6, 128, 200))
    ids = np.asarray([3, 0, 5, 3, 1, 1, 4], np.int32)  # expert 2 unused
    dy = np.random.default_rng(4).standard_normal((7, 200)).astype(np.float32)
    order = np.argsort(ids, kind="stable")
    dx_sorted = _tile_layout_ref(jq, np.bincount(ids, minlength=6), dy[order])
    ref = np.zeros((7, 128), np.float32)
    ref[order] = np.asarray(dx_sorted)
    out = tqt.gathered_quant_matmul_t(
        torch.from_numpy(dy).to(torch.bfloat16), tq, torch.from_numpy(ids))
    _close(out, ref)


def test_rejects_bad_operands():
    _, tq = _weights("int8", (64, 40))
    with pytest.raises(ValueError):
        tqt.quant_matmul_t(torch.zeros(3, 41), tq)
    with pytest.raises(ValueError):
        tqt.quant_matmul_t(torch.zeros(3, 40, dtype=torch.float16), tq)
    _, t3 = _weights("int8", (2, 64, 40))
    with pytest.raises(ValueError):
        tqt.grouped_quant_matmul_t(torch.zeros(3, 40), t3,
                                   torch.tensor([1, 1, 1]))


@pytest.mark.parametrize("kind", KINDS)
def test_route_wgmma_every_kind(kind):
    """Every kind takes the wgmma kernel at the SFT step's shapes (N =
    3648, 2048, 102400, 2816, and K = 10944 with group 96 for the int4 group
    kinds); N no multiple of 16, or scale groups too small for a stage's
    GMAX scale rows, keep the first version."""
    base = kind.split()[0]
    for n, k, gs in ((3648, 2048, 128), (2048, 2048, 128),
                     (102400, 2048, 128), (2816, 2048, 128),
                     (2048, 10944, 96)):
        rpg = {"int8": k, "fp8": k, "int4": k // 2, "int4_g": gs // 2,
               "int4_gz": gs // 2, "mxfp4": 16, "mxfp8": 32}[base]
        assert tqt.route(base, n, rpg) == "wgmma", (n, k, gs)
    assert tqt.route(base, 40, 64) == "rows"  # N no multiple of 16
    small = 8 if base in ("int4", "int4_g", "int4_gz", "mxfp4") else 16
    assert tqt.route(base, 3648, small) == "rows"


def test_t_rows_per_group_matches_the_weights():
    for kind, want in (("int8", 256), ("fp8", 256), ("int4_g", 64),
                       ("int4_gz", 64), ("mxfp4", 16), ("mxfp8", 32),
                       ("int4", 128)):
        _, tq = _weights(kind, (256, 64))
        assert tqt.t_rows_per_group(tq) == want, kind


@pytest.mark.parametrize("entry, m, want", [
    ("dense", 1, 64), ("dense", 64, 64), ("dense", 65, 128),
    ("dense", 512, 128), ("grouped", 3072, 64), ("gathered", 6, 64)])
def test_tile_rows(entry, m, want):
    """Dense calls of more than 64 rows decode each weight tile once per
    128 dy rows; grouped and gathered calls keep 64-row tiles."""
    assert tqt.tile_rows(entry, m) == want


# (kind, storage rows, N, static tiles, tile rows): the SFT step's dx
# shapes at 512 rows (4 tiles of 128): qkv_a, o_proj, lm_head, shared
# gate_up / down, layer-0 gate_up / down (group 96); the grouped experts'
# transposes over 3072 sorted rows (48 + 64 tiles of 64); the gathered entry
# (6 one-row tiles); M = 1; and small shapes
T_SHAPES = [
    ("int4_g", 1024, 3648, 4, 128), ("int4_g", 1024, 2048, 4, 128),
    ("int4_g", 1024, 102400, 4, 128), ("int4_g", 1024, 5632, 4, 128),
    ("int4_g", 1408, 2048, 4, 128), ("int4_g", 1024, 21888, 4, 128),
    ("int4_g", 5472, 2048, 4, 128), ("int4_g", 1024, 2816, 112, 64),
    ("int4_g", 704, 2048, 112, 64), ("int4_g", 1024, 2816, 6, 64),
    ("int8", 2048, 3648, 4, 128), ("mxfp8", 2048, 3648, 1, 64),
    ("int4_g", 96, 3648, 1, 64), ("int8", 192, 1824, 2, 128),
    ("fp8", 128, 16, 1, 64),
]


def _t_cost(kind, kr, n, ntiles, bm, sms, s):
    blocks = -(-kr // tqt.storage_rows_per_block(kind, bm)) * ntiles
    waves = -(-blocks * s // (sms * tqt.WGMMA_RESIDENT[bm]))
    stages = -(-n // tqt.WGMMA_NC)
    return waves * (-(-stages // s) + tqt.WGMMA_BLOCK_OVERHEAD)


@pytest.mark.parametrize("kind, kr, n, ntiles, bm", T_SHAPES)
def test_t_plan(kind, kr, n, ntiles, bm):
    """The split rule of the wgmma kernel: the splits cover every column of
    the contraction exactly once in whole 64-column stages; each keeps at
    least WGMMA_MIN_STAGES stages where there are several; the count is the
    cheapest in waves x (stages a block + overhead), the smallest of a
    tie."""
    sms = 132
    splits = tqt.t_plan(kind, kr, n, ntiles, bm, sms)
    spans = tqt.t_split_stages(n, splits)
    assert len(spans) == splits and spans[0][0] == 0 and spans[-1][1] == n
    assert all(a[1] == b[0] for a, b in zip(spans, spans[1:]))
    assert all(lo % tqt.WGMMA_NC == 0 for lo, _ in spans)
    stages = -(-n // tqt.WGMMA_NC)
    most = max(1, stages // tqt.WGMMA_MIN_STAGES)
    assert 1 <= splits <= most
    if splits > 1:
        assert all(hi - lo >= tqt.WGMMA_MIN_STAGES * tqt.WGMMA_NC
                   or hi == n for lo, hi in spans)
    costs = [_t_cost(kind, kr, n, ntiles, bm, sms, s)
             for s in range(1, most + 1)]
    assert costs[splits - 1] == min(costs)
    assert costs.index(min(costs)) == splits - 1


def test_t_plan_fills_the_card_at_the_sft_shapes():
    """lm_head, qkv_a and the layer-0 gate_up dx at 512 rows (32 blocks of
    128 x 256 without a split) get at least 128 blocks, one an SM."""
    for kr, n in ((1024, 102400), (1024, 3648), (1024, 21888)):
        splits = tqt.t_plan("int4_g", kr, n, 4, 128, 132)
        assert (kr // tqt.storage_rows_per_block("int4_g", 128)) * 4 \
            * splits >= 128


@pytest.mark.parametrize("bm, cols", [(128, 256), (64, 128)])
def test_block_cols(bm, cols):
    assert tqt.block_cols(bm) == cols
    assert tqt.storage_rows_per_block("int4_g", bm) == cols // 2
    assert tqt.storage_rows_per_block("int8", bm) == cols
