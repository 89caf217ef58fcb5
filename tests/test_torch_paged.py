"""The port's paged-attention plain versions, page writes and cache
conversion against the JAX package.

The plain PyTorch versions of mla_paged_decode / mla_paged_prefill (what
the wrappers run for CPU tensors) are held against the Pallas kernels in
interpret mode on the same numpy inputs, float32, rtol = atol = 2e-5 (both
sides accumulate in float32; the Pallas kernels use an online softmax over
page blocks, the plain versions one softmax over the gathered row). Every
pool row at or past a sequence's live length, and every unused page, is
NaN: neither side may let it through. Lengths sit on page boundaries
(k * page and k * page + 1) to catch an off-by-one between the three
meanings of ``lengths`` (ops/cuda/paged_attention.py).
"""

import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ktransformers_tpu.cache.paged import PagedKVCache as JPagedKVCache
from ktransformers_tpu.models import paged as jpaged
from ktransformers_tpu.ops.pallas import paged_attention as jpa
from ktransformers_tpu_torch.cache.paged import PagedKVCache
from ktransformers_tpu_torch.convert import paged_cache_from_jax
from ktransformers_tpu_torch.models import paged as tpaged
from ktransformers_tpu_torch.models.spec import spec_from_hf_config
from ktransformers_tpu_torch.ops.cuda import paged_attention as PA

from tests.test_torch_model import SMALL, one_torch_thread  # noqa: F401

H, R, DR = 4, 64, 16
TOL = dict(rtol=2e-5, atol=2e-5)
PAGE_CONFIGS = [(8, 4), (16, 8), (128, 2)]


def _pool(rng, b, pmax, page, live):
    """Shuffled tables [b, pmax] over pools [b * pmax + 1, page, .] that are
    NaN except the first live[i] positions of sequence i."""
    num_pages = b * pmax + 1
    perm = rng.permutation(num_pages - 1)[: b * pmax] + 1
    tables = perm.reshape(b, pmax).astype(np.int32)
    ckv = np.full((num_pages, page, R), np.nan, np.float32)
    kpe = np.full((num_pages, page, DR), np.nan, np.float32)
    for i, n in enumerate(live):
        for pos in range(n):
            pid, slot = tables[i, pos // page], pos % page
            ckv[pid, slot] = rng.standard_normal(R)
            kpe[pid, slot] = rng.standard_normal(DR)
    return ckv, kpe, tables


def _t(*arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


@pytest.mark.parametrize("page, pmax", PAGE_CONFIGS)
def test_mla_paged_decode_plain_matches_pallas(page, pmax):
    rng = np.random.default_rng(page)
    lens = [1, page, page + 1, page + 3, pmax * page]
    b = len(lens)
    ckv, kpe, tables = _pool(rng, b, pmax, page, lens)
    qn = rng.standard_normal((b, H, R)).astype(np.float32)
    qp = rng.standard_normal((b, H, DR)).astype(np.float32)
    lengths = np.asarray(lens, np.int32)
    ref = np.asarray(jpa.mla_paged_decode(
        *map(jnp.asarray, (qn, qp, ckv, kpe, tables, lengths)), scale=0.2,
        interpret=True))
    out = PA.mla_paged_decode(*_t(qn, qp, ckv, kpe, tables, lengths), 0.2)
    assert np.isfinite(ref).all()
    np.testing.assert_allclose(out.numpy(), ref, **TOL)


def test_mla_paged_decode_without_a_live_key_is_zero():
    rng = np.random.default_rng(0)
    ckv, kpe, tables = _pool(rng, 2, 4, 8, [0, 5])
    qn, qp = rng.standard_normal((2, H, R)), rng.standard_normal((2, H, DR))
    out = PA.mla_paged_decode(*_t(qn.astype(np.float32),
                                  qp.astype(np.float32), ckv, kpe, tables,
                                  np.asarray([0, 5], np.int32)), 0.2)
    assert torch.all(out[0] == 0) and bool(torch.isfinite(out).all())


@pytest.mark.parametrize("old", ["zero", "mid_page", "page_aligned"])
@pytest.mark.parametrize("page, pmax", PAGE_CONFIGS)
def test_mla_paged_prefill_plain_matches_pallas(page, pmax, old):
    """Two chunks per call: valid < S and valid == S. Rows >= valid are
    padding and compared only for finiteness."""
    rng = np.random.default_rng(page + len(old))
    s = 8
    old_len = {"zero": 0, "mid_page": page // 2 + 1, "page_aligned": page}[old]
    olds, valids = [old_len, old_len], [s - 3, s]
    ckv, kpe, tables = _pool(rng, 2, pmax, page,
                             [o + v for o, v in zip(olds, valids)])
    qn = rng.standard_normal((2, H, s, R)).astype(np.float32)
    qp = rng.standard_normal((2, H, s, DR)).astype(np.float32)
    lengths, valid = np.asarray(olds, np.int32), np.asarray(valids, np.int32)
    ref = np.asarray(jpa.mla_paged_prefill(
        *map(jnp.asarray, (qn, qp, ckv, kpe, tables, lengths, valid)),
        scale=0.2, block_q=16, interpret=True))
    out = PA.mla_paged_prefill(*_t(qn, qp, ckv, kpe, tables, lengths, valid),
                               0.2).numpy()
    assert np.isfinite(out).all() and np.isfinite(ref).all()
    for i, v in enumerate(valids):
        np.testing.assert_allclose(out[i, :, :v], ref[i, :, :v], **TOL)


def test_prefill_of_one_token_equals_decode():
    """The meanings of ``lengths`` side by side: a one-token chunk after
    ``n`` cached tokens (old length n, valid 1) is the decode of that token
    with length n + 1."""
    rng = np.random.default_rng(3)
    page, pmax, lens = 8, 4, [8, 9, 17]  # k * page, k * page + 1
    ckv, kpe, tables = _pool(rng, 3, pmax, page, lens)
    qn = rng.standard_normal((3, H, R)).astype(np.float32)
    qp = rng.standard_normal((3, H, DR)).astype(np.float32)
    lengths = np.asarray(lens, np.int32)
    dec = PA.mla_paged_decode(*_t(qn, qp, ckv, kpe, tables, lengths), 0.2)
    pre = PA.mla_paged_prefill(
        *_t(qn[:, :, None], qp[:, :, None], ckv, kpe, tables, lengths - 1,
            np.ones(3, np.int32)), 0.2)
    np.testing.assert_allclose(pre[:, :, 0].numpy(), dec.numpy(), **TOL)


def test_wrappers_check_shapes_and_types():
    rng = np.random.default_rng(0)
    ckv, kpe, tables = _pool(rng, 1, 2, 8, [3])
    qn = rng.standard_normal((1, H, R)).astype(np.float32)
    qp = rng.standard_normal((1, H, DR)).astype(np.float32)
    lengths = np.asarray([3], np.int32)
    with pytest.raises(ValueError, match="int32"):
        PA.mla_paged_decode(*_t(qn, qp, ckv, kpe, tables.astype(np.int64),
                                lengths), 0.2)
    with pytest.raises(ValueError, match="pools"):
        PA.mla_paged_decode(*_t(qn, qp, ckv[..., :8], kpe, tables, lengths),
                            0.2)
    with pytest.raises(ValueError, match="valid"):
        PA.mla_paged_prefill(*_t(qn[:, :, None], qp[:, :, None], ckv, kpe,
                                 tables, lengths, np.ones(2, np.int32)), 0.2)


@pytest.mark.parametrize("with_valid", [False, True])
def test_write_pages_bit_exact(with_valid):
    """Same scatter as the JAX function, the trash-page redirect included.
    Page 0 takes several padding writes on one slot in no defined order, so
    there only the written slots are compared, each against the candidates."""
    rng = np.random.default_rng(5)
    page, pmax, b, s = 8, 4, 3, 8
    num_pages = b * pmax + 1
    buf = rng.standard_normal((num_pages, page, R)).astype(np.float32)
    new = rng.standard_normal((b, s, R)).astype(np.float32)
    tables = (rng.permutation(num_pages - 1)[: b * pmax] + 1).reshape(
        b, pmax).astype(np.int32)
    lengths = np.asarray([0, 5, 16], np.int32)
    valid = np.asarray([8, 3, 0], np.int32) if with_valid else None
    ref = np.asarray(jpaged._write_pages(
        jnp.asarray(buf), jnp.asarray(new), jnp.asarray(tables),
        jnp.asarray(lengths), page,
        None if valid is None else jnp.asarray(valid)))
    out = tpaged._write_pages(
        torch.from_numpy(buf.copy()), *_t(new, tables, lengths), page,
        None if valid is None else torch.from_numpy(valid)).numpy()
    np.testing.assert_array_equal(out[1:], ref[1:])
    if valid is None:
        np.testing.assert_array_equal(out[0], buf[0])
        return
    # live rows landed in their pages, padding rows on page 0 at pos % page
    assert np.array_equal(out[tables[1, 0], 5:8], new[1, :3])
    written = {}
    for i in range(b):
        for j in range(valid[i], s):
            written.setdefault((lengths[i] + j) % page, []).append(new[i, j])
    for slot in range(page):
        cands = written.get(slot, [buf[0, slot]])
        assert any(np.array_equal(out[0, slot], c) for c in cands)
        assert any(np.array_equal(ref[0, slot], c) for c in cands)


def test_write_pages_clamps_the_table_index():
    """A padded chunk can run past the last table slot; the index is
    clamped before the lookup and the write goes to the trash page."""
    page, pmax = 8, 2
    buf = torch.zeros(3, page, 4)
    new = torch.ones(1, 16, 4)
    tables = torch.tensor([[1, 2]], dtype=torch.int32)
    out = tpaged._write_pages(buf, new, tables,
                              torch.tensor([8], dtype=torch.int32), page,
                              torch.tensor([8], dtype=torch.int32))
    assert torch.all(out[2] == 1) and torch.all(out[1] == 0)
    assert torch.all(out[0] == 1)


def test_paged_cache_from_jax_round_trip():
    from ktransformers_tpu.models.spec import spec_from_hf_config as jspec

    rng = np.random.default_rng(1)
    for dtype, tdtype in ((jnp.float32, torch.float32),
                          (jnp.bfloat16, torch.bfloat16)):
        kv = JPagedKVCache.create(jspec(SMALL), num_pages=6, page_size=8,
                                  dtype=dtype)
        kv.bufs_a[1] = jnp.asarray(
            rng.standard_normal(kv.bufs_a[1].shape), dtype)
        kv.bufs_b[2] = jnp.asarray(
            rng.standard_normal(kv.bufs_b[2].shape), dtype)
        out = paged_cache_from_jax(jax.device_get(kv),
                                   spec_from_hf_config(SMALL), "cpu")
        mine = PagedKVCache.create(spec_from_hf_config(SMALL), 6, 8,
                                   dtype=tdtype, device="cpu")
        assert out.page_size == 8 and out.num_pages == 6
        assert out.bytes_per_page() == mine.bytes_per_page() \
            == kv.bytes_per_page(jspec(SMALL))
        for a, b in zip(out.bufs_a + out.bufs_b, kv.bufs_a + kv.bufs_b):
            assert a.dtype == tdtype
            np.testing.assert_array_equal(
                a.float().numpy(), np.asarray(b.astype(jnp.float32)))
    # page summaries cross where the cache keeps them
    jkv = JPagedKVCache.create(jspec(SMALL), 4, 8, dtype=jnp.float32,
                               summaries=True, anchor="fixed")
    out = paged_cache_from_jax(jax.device_get(jkv),
                               spec_from_hf_config(SMALL), "cpu")
    assert out.ssum is None and out.sdyn is None
    for n in ("smin", "smax", "sfix"):
        for a, b in zip(getattr(out, n), getattr(jkv, n)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_unported_paths_raise():
    """A sparse budget over a cache without summaries raises (sparse decode
    itself is ported, tests/test_torch_sparse_attention.py), as do
    summaries beside hybrid linear-attention slots, which the JAX package
    refuses too. (Routing collection, refused here until it was ported,
    is held in tests/test_torch_expert_placement.py.)"""
    from tests.test_torch_qwen3_next import TINY as QNEXT

    spec = spec_from_hf_config(SMALL)
    with pytest.raises(ValueError, match="hybrid"):
        PagedKVCache.create(spec_from_hf_config(dict(QNEXT)), 4, 8,
                            summaries=True, device="cpu")
    kv = PagedKVCache.create(spec, 4, 8, dtype=torch.float32, device="cpu")
    toks = torch.zeros(1, 1, dtype=torch.int64)
    pt = torch.zeros(1, 2, dtype=torch.int32)
    ln = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="summaries=True"):
        tpaged.forward_paged({}, spec, toks, kv, pt, ln, sparse_budget=2)


def test_params_to_copies_the_whole_tree():
    from ktransformers_tpu_torch.models.init import init_params_synthetic
    from ktransformers_tpu_torch.ops.moe import MoEWeights
    from ktransformers_tpu_torch.quant.formats import QTensor
    from ktransformers_tpu_torch.utils.device_prep import params_to

    spec = spec_from_hf_config(dict(SMALL, num_hidden_layers=2))
    params = init_params_synthetic(spec, seed=0, device="cpu")
    moved = params_to(params, "meta")
    experts = moved["layers"][1]["moe"]["experts"]
    assert isinstance(experts, MoEWeights)
    assert isinstance(experts.gate_up, QTensor)
    assert experts.gate_up.data.device.type == "meta"
    assert experts.gate_up.group_size == \
        params["layers"][1]["moe"]["experts"].gate_up.group_size
    assert moved["embed"].device.type == "meta"
    assert params["embed"].device.type == "cpu"  # the source is untouched


def test_port_imports_no_jax():
    """Neither the port's package nor chip_smoke.py imports jax or the JAX
    package."""
    root = pathlib.Path(__file__).resolve().parent.parent
    files = list((root / "ktransformers_tpu_torch").rglob("*.py"))
    files.append(root / "chip_smoke.py")
    pat = re.compile(
        r"^\s*(?:import|from)\s+(?:jax|ktransformers_tpu)(?:[.\s]|$)", re.M)
    assert len(files) > 20
    names = {f.relative_to(root).as_posix() for f in files}
    assert {"ktransformers_tpu_torch/ops/cuda/quant_matmul.py",
            "ktransformers_tpu_torch/ops/cuda/mla_decode.py",
            "ktransformers_tpu_torch/ops/linear.py",
            "ktransformers_tpu_torch/quant/formats.py",
            "ktransformers_tpu_torch/offload/__init__.py",
            "ktransformers_tpu_torch/offload/host_moe.py",
            "ktransformers_tpu_torch/offload/experts.py",
            "ktransformers_tpu_torch/offload/host_engine.py",
            "ktransformers_tpu_torch/offload/paged_engine.py",
            "ktransformers_tpu_torch/loader/safetensors_io.py",
            "ktransformers_tpu_torch/loader/gptq.py",
            "ktransformers_tpu_torch/loader/providers.py",
            "ktransformers_tpu_torch/placement/spec.py",
            "ktransformers_tpu_torch/placement/library.py",
            "ktransformers_tpu_torch/models/checkpoint.py",
            "ktransformers_tpu_torch/engine/local_chat.py",
            "ktransformers_tpu_torch/serving/server.py",
            "ktransformers_tpu_torch/serving/config.py",
            "ktransformers_tpu_torch/serving/tools.py",
            "ktransformers_tpu_torch/serving/assistants.py",
            "ktransformers_tpu_torch/cli/main.py",
            "ktransformers_tpu_torch/cli/__main__.py",
            "ktransformers_tpu_torch/utils/eval.py",
            "ktransformers_tpu_torch/ops/fuse_shared.py",
            "ktransformers_tpu_torch/utils/expert_placement.py",
            "ktransformers_tpu_torch/parallel/__init__.py",
            "ktransformers_tpu_torch/parallel/mesh.py",
            "ktransformers_tpu_torch/parallel/context.py",
            "ktransformers_tpu_torch/parallel/collectives.py",
            "ktransformers_tpu_torch/parallel/distributed.py",
            "ktransformers_tpu_torch/parallel/ep.py",
            "ktransformers_tpu_torch/parallel/shardings.py"} <= names
    # nor does the package hand a kernel's product to a library call
    lib = re.compile(r"_int_mm|_scaled_mm|_grouped_mm"
                     r"|scaled_dot_product_attention|torch\.compile")
    for f in files:
        text = f.read_text()
        assert not pat.search(text), f
        assert f.name == "chip_smoke.py" or not lib.search(text), f
