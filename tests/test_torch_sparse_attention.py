"""The port's sparse long-context decode (ops/sparse_attention.py, the page
summaries of cache/paged.py and the sparse_* arguments of models/paged.py,
ServeEngine and HostOffloadServeEngine) against the JAX package's: the
counterparts of tests/test_sparse_attention.py, test_anchor_types.py and
test_offload_serving.py::test_offload_sparse_full_budget_matches_dense.

Tolerances: summaries and anchors bit for bit (the same float32 min / max /
sums of the same keys), scores and attention outputs in float32 within
2e-4 of the largest value (another order of sums), greedy tokens exact on
float32 weights. Page selections are compared as sets of live slots:
torch.topk may order equal bounds (the dead slots at NEG_INF) otherwise
than jax.lax.top_k; the inputs give the live bounds a clear margin.

A reference hazard (ROADMAP Queue 3): the JAX sparse decode masks a dead
row's score and multiplies its zero weight by its value, so a NaN left in a
selected page's dead rows reaches its output; the port's never reads such a
value.
The JAX value is recorded; no test that compares with the JAX package
plants NaN.
"""

import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ktransformers_tpu_torch.cache.paged import PagedKVCache
from ktransformers_tpu_torch.convert import (
    paged_cache_from_jax,
    params_from_jax,
)
from ktransformers_tpu_torch.models.paged import forward_paged
from ktransformers_tpu_torch.models.spec import spec_from_hf_config
from ktransformers_tpu_torch.ops import sparse_attention as SA
from ktransformers_tpu_torch.serving import SchedulerConfig, ServeEngine

from tests.test_generate import TINY_DS
from tests.test_serving import TINY_GQA
from tests.test_torch_model import one_torch_thread  # noqa: F401 (fixture)

ANCHORS = SA.ANCHOR_KINDS
TOL = 2e-4
F32 = dict(cache_dtype=torch.float32, compute_dtype=torch.float32,
           device="cpu")
SCHED = dict(max_batch_size=2, prefill_chunk=8, page_size=8,
             max_pages_per_query=8)


def _jsa():
    from ktransformers_tpu.ops import sparse_attention as jsa

    return jsa


def _t(a):
    return torch.from_numpy(np.array(a))


def _i32(values):
    return torch.tensor(values, dtype=torch.int32)


def _close(got, want, tol=TOL):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err <= tol, err


def _live_sets(sel, lengths, page):
    """Sorted live slots of each selection row (leading axes flattened
    per sequence)."""
    sel = np.asarray(sel)
    lens = np.asarray(lengths)
    out = []
    for b in range(sel.shape[0]):
        rows = sel[b].reshape(-1, sel.shape[-1])
        out.append([sorted(int(s) for s in r if s * page < lens[b])
                    for r in rows])
    return out


# -- the functions against JAX ---------------------------------------------


def _mla_case(rng, b=2, npages=8, page=8, h=4, r=16, dr=8,
              lengths=(60, 29)):
    """Pools for b sequences on shuffled page tables (page 0 unused), the
    planes of every anchor built from their live keys in both packages."""
    n = b * npages + 1
    ckv = rng.standard_normal((n, page, r)).astype(np.float32) * 0.05
    kpe = rng.standard_normal((n, page, dr)).astype(np.float32) * 0.05
    tables = (1 + rng.permutation(n - 1)).reshape(b, npages).astype(np.int32)
    pid = np.stack([tables[i, np.arange(npages * page) // page]
                    for i in range(b)])
    pos = np.tile(np.arange(npages * page), (b, 1))
    keys = np.concatenate([ckv, kpe], -1)[pid, pos % page]  # [B, S, Dsum]
    live = pos < np.asarray(lengths)[:, None]
    return ckv, kpe, tables, _planes_both(keys, pid, pos, live, page,
                                          (n, r + dr), rng)


def _planes_both(keys, pid, pos, live, page, shape, rng):
    """(port planes, JAX planes) of every anchor over the live keys; sdyn
    random (set_dynamic_anchors has its own test)."""
    jsa = _jsa()
    sdyn = rng.standard_normal(shape).astype(np.float32) * 0.05
    jp = {"smin": jnp.full(shape, jnp.inf), "smax": jnp.full(shape, -jnp.inf),
          "ssum": jnp.zeros(shape), "sfix": jnp.zeros(shape)}
    tp = {k: _t(v) for k, v in jp.items()}
    k_live = keys[live][None]
    jp = jsa.update_page_summaries_cfg(jp, jnp.asarray(k_live),
                                       jnp.asarray(pid[live][None]),
                                       jnp.asarray(pos[live][None]), page)
    SA.update_page_summaries_cfg(tp, _t(k_live), _t(pid[live][None]),
                                 _t(pos[live][None]), page)
    jp["sdyn"] = jnp.asarray(sdyn)
    tp["sdyn"] = _t(sdyn)
    return tp, jp


def test_update_page_summaries_matches_jax():
    """min / max, the running sum and the first key of a page, bit for bit;
    untouched pages keep their fill; a page's non-first rows never write
    its fixed anchor."""
    rng = np.random.default_rng(0)
    ckv, kpe, tables, (tp, jp) = _mla_case(rng)
    for n in ("smin", "smax", "ssum", "sfix"):
        np.testing.assert_array_equal(tp[n].numpy(), np.asarray(jp[n]))
    assert np.isinf(tp["smin"][0].numpy()).all()  # page 0: no key
    t = tables[0, 3]
    np.testing.assert_array_equal(tp["sfix"][t].numpy(), np.concatenate(
        [ckv[t, 0], kpe[t, 0]]))
    # the plain pair, and a reset of page t
    smin = torch.full((4, 3), torch.inf)
    smax = torch.full((4, 3), -torch.inf)
    k = _t(rng.standard_normal((1, 5, 3)).astype(np.float32))
    SA.update_page_summaries(smin, smax, k, torch.tensor([[1, 1, 2, 2, 2]]))
    jmin, jmax = _jsa().update_page_summaries(
        jnp.full((4, 3), jnp.inf), jnp.full((4, 3), -jnp.inf),
        jnp.asarray(k.numpy()), jnp.asarray([[1, 1, 2, 2, 2]]))
    np.testing.assert_array_equal(smin.numpy(), np.asarray(jmin))
    np.testing.assert_array_equal(smax.numpy(), np.asarray(jmax))


def test_reset_page_summaries():
    spec = spec_from_hf_config(dict(TINY_DS))
    kv = PagedKVCache.create(spec, 6, 8, torch.float32, summaries=True,
                             anchor="block_mean", device="cpu")
    assert kv.sfix is None and kv.sdyn is None
    for li in range(spec.num_layers):
        kv.smin[li].fill_(1.0)
        kv.smax[li].fill_(2.0)
        kv.ssum[li].fill_(3.0)
    assert kv.reset_page_summaries([2, 4]) is kv
    for li in range(spec.num_layers):
        assert torch.isinf(kv.smin[li][[2, 4]]).all()
        assert (kv.smax[li][[2, 4]] == -torch.inf).all()
        assert (kv.ssum[li][[2, 4]] == 0).all()
        assert (kv.smin[li][[0, 1, 3, 5]] == 1).all()
    from ktransformers_tpu.cache.paged import PagedKVCache as JPaged
    from ktransformers_tpu.models.spec import spec_from_hf_config as js

    for anchor in ANCHORS:
        jkv = JPaged.create(js(dict(TINY_GQA)), 5, 8, summaries=True,
                            anchor=anchor, dtype=jnp.float32)
        tkv = PagedKVCache.create(spec_from_hf_config(dict(TINY_GQA)), 5, 8,
                                  torch.float32, summaries=True,
                                  anchor=anchor, device="cpu")
        for n in PagedKVCache.PLANES:
            jl, tl = getattr(jkv, n), getattr(tkv, n)
            assert (jl is None) == (tl is None), (anchor, n)
            for a, b in zip(tl or (), jl or ()):
                np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("anchor", ANCHORS)
def test_anchor_scores_match_jax(anchor):
    rng = np.random.default_rng(1)
    _, _, tables, (tp, jp) = _mla_case(rng)
    q = rng.standard_normal((2, 4, 24)).astype(np.float32)
    lengths = np.asarray([60, 29], np.int32)
    got = SA._anchor_scores(_t(q), tp, _t(tables), anchor, _t(lengths), 8)
    want = _jsa()._anchor_scores(jnp.asarray(q), jp, jnp.asarray(tables),
                                 anchor, jnp.asarray(lengths), 8)
    live = np.arange(8)[None, :] * 8 < lengths[:, None]
    _close(got.numpy()[live[:, None].repeat(4, 1)],
           np.asarray(want)[live[:, None].repeat(4, 1)], 1e-5)


@pytest.mark.parametrize("retrieval", ["layer", "qhead"])
@pytest.mark.parametrize("anchor", ANCHORS)
def test_select_pages_matches_jax(anchor, retrieval):
    """The same live pages at a partial budget (3 of 8 slots), the current
    page always among them; with a SnapKV keep mask too."""
    rng = np.random.default_rng(2)
    _, _, tables, (tp, jp) = _mla_case(rng)
    q = rng.standard_normal((2, 4, 24)).astype(np.float32)
    lengths = np.asarray([60, 29], np.int32)
    keep = np.ones((2, 8), bool)
    keep[:, 1] = False
    for mask in (None, keep):
        got = SA.select_pages(_t(q), tp, _t(tables), _t(lengths), 8, 3,
                              anchor, retrieval,
                              None if mask is None else _t(mask))
        want = _jsa().select_pages(
            jnp.asarray(q), jp, jnp.asarray(tables), jnp.asarray(lengths), 8,
            3, anchor, retrieval, None if mask is None else jnp.asarray(mask))
        assert got.shape == want.shape
        sets = _live_sets(got, lengths, 8)
        assert sets == _live_sets(want, lengths, 8)
        for b, last in enumerate((lengths - 1) // 8):
            assert all(last in s for s in sets[b])


@pytest.mark.parametrize("retrieval", ["layer", "qhead"])
@pytest.mark.parametrize("anchor", ANCHORS)
def test_sparse_mla_decode_matches_jax(anchor, retrieval):
    rng = np.random.default_rng(3)
    ckv, kpe, tables, (tp, jp) = _mla_case(rng)
    qa = rng.standard_normal((2, 4, 16)).astype(np.float32)
    qp = rng.standard_normal((2, 4, 8)).astype(np.float32)
    lengths = np.asarray([60, 29], np.int32)
    got = SA.sparse_mla_decode(_t(qa), _t(qp), _t(ckv), _t(kpe), None, None,
                               _t(tables), _t(lengths), 8, 3, 0.125, anchor,
                               retrieval, tp)
    want = _jsa().sparse_mla_decode(
        jnp.asarray(qa), jnp.asarray(qp), jnp.asarray(ckv), jnp.asarray(kpe),
        None, None, jnp.asarray(tables), jnp.asarray(lengths), 8, 3, 0.125,
        anchor, retrieval, jp)
    _close(got.numpy(), want)


def _gqa_case(rng, b=2, npages=8, page=8, hkv=2, d=8, lengths=(60, 29)):
    n = b * npages + 1
    k = rng.standard_normal((n, page, hkv, d)).astype(np.float32) * 0.3
    v = rng.standard_normal((n, page, hkv, d)).astype(np.float32)
    tables = (1 + rng.permutation(n - 1)).reshape(b, npages).astype(np.int32)
    pid = np.stack([tables[i, np.arange(npages * page) // page]
                    for i in range(b)])
    pos = np.tile(np.arange(npages * page), (b, 1))
    live = pos < np.asarray(lengths)[:, None]
    planes = _planes_both(k[pid, pos % page], pid, pos, live, page,
                          (n, hkv, d), rng)
    return k, v, tables, planes


@pytest.mark.parametrize("retrieval", ["layer", "kvhead"])
@pytest.mark.parametrize("anchor", ANCHORS)
def test_sparse_gqa_decode_matches_jax(anchor, retrieval):
    rng = np.random.default_rng(4)
    k, v, tables, (tp, jp) = _gqa_case(rng)
    q = rng.standard_normal((2, 4, 8)).astype(np.float32)
    lengths = np.asarray([60, 29], np.int32)
    got = SA.sparse_gqa_decode(_t(q), _t(k), _t(v), None, None, _t(tables),
                               _t(lengths), 8, 3, 0.35, anchor, retrieval,
                               tp)
    want = _jsa().sparse_gqa_decode(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), None, None,
        jnp.asarray(tables), jnp.asarray(lengths), 8, 3, 0.35, anchor,
        retrieval, jp)
    _close(got.numpy(), want)
    sel = SA.select_pages_gqa(_t(q), tp, _t(tables), _t(lengths), 8, 3, 2,
                              anchor, retrieval)
    assert sel.shape == ((2, 3) if retrieval == "layer" else (2, 2, 3))


@pytest.mark.parametrize("is_mla", [True, False], ids=["mla", "gqa"])
def test_snapkv_page_scores_and_preselect_match_jax(is_mla):
    rng = np.random.default_rng(5)
    lengths = np.asarray([60, 29], np.int32)
    if is_mla:
        a, bb, tables, _ = _mla_case(rng)
        q = rng.standard_normal((2, 3, 4, 24)).astype(np.float32)
    else:
        a, bb, tables, _ = _gqa_case(rng)
        q = rng.standard_normal((2, 3, 4, 8)).astype(np.float32)
    mass, tok = SA.snapkv_page_scores(_t(q), _t(a), _t(bb), _t(tables),
                                      _t(lengths), 8, 0.125, is_mla)
    jmass, jtok = _jsa().snapkv_page_scores(
        jnp.asarray(q), jnp.asarray(a), jnp.asarray(bb), jnp.asarray(tables),
        jnp.asarray(lengths), 8, 0.125, is_mla)
    _close(mass.numpy(), jmass)
    _close(tok.numpy(), jtok)
    for keep, recent in ((4, 1), (3, 2), (12, 2)):
        got = SA.preselect_pages(mass, _t(lengths), 8, keep, recent)
        want = _jsa().preselect_pages(jmass, jnp.asarray(lengths), 8, keep,
                                      recent)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_set_dynamic_anchors_matches_jax():
    """The anchor of each live page is its most attended key; dead slots
    (a shorter sequence's tail) write nothing."""
    rng = np.random.default_rng(6)
    ckv, kpe, tables, (tp, jp) = _mla_case(rng)
    kcat = np.concatenate([ckv, kpe], -1)
    lengths = np.asarray([60, 29], np.int32)
    mass = rng.random((2, 8, 8)).astype(np.float32)
    before = tp["sdyn"].clone()
    out = SA.set_dynamic_anchors(dict(tp), _t(kcat), _t(tables), _t(mass),
                                 _t(lengths), 8)
    want = _jsa().set_dynamic_anchors(dict(jp), jnp.asarray(kcat),
                                      jnp.asarray(tables), jnp.asarray(mass),
                                      jnp.asarray(lengths), 8)
    np.testing.assert_array_equal(out["sdyn"].numpy(), np.asarray(
        want["sdyn"]))
    dead = tables[1, 4:]  # slots 4.. of a 29-token sequence
    assert torch.equal(out["sdyn"][dead], before[dead])


# -- selection semantics (port only, the JAX tests' cases) ------------------


def _needle_planes(ckv, kpe, page):
    npages = ckv.shape[0]
    shape = (npages, ckv.shape[-1] + kpe.shape[-1])
    planes = {"smin": torch.full(shape, torch.inf),
              "smax": torch.full(shape, -torch.inf),
              "ssum": torch.zeros(shape), "sfix": torch.zeros(shape),
              "sdyn": torch.zeros(shape)}
    kcat = _t(np.concatenate([ckv, kpe], -1)).reshape(1, npages * page, -1)
    pid = torch.arange(npages).repeat_interleave(page)[None]
    return SA.update_page_summaries_cfg(planes, kcat, pid,
                                        torch.arange(npages * page)[None],
                                        page)


def _dense_mla(qa, qp, ckv, kpe, scale=0.125):
    b, h, r = qa.shape
    s = (np.einsum("bhr,pqr->bhpq", qa, ckv)
         + np.einsum("bhd,pqd->bhpq", qp, kpe)).reshape(b, h, -1) * scale
    a = np.exp(s - s.max(-1, keepdims=True))
    a /= a.sum(-1, keepdims=True)
    return np.einsum("bhx,xr->bhr", a, ckv.reshape(-1, r))


@pytest.mark.parametrize("anchor", ANCHORS)
def test_full_budget_equals_dense_mla(anchor):
    rng = np.random.default_rng(7)
    ckv = rng.standard_normal((8, 8, 16)).astype(np.float32) * 0.05
    kpe = rng.standard_normal((8, 8, 8)).astype(np.float32) * 0.05
    planes = _needle_planes(ckv, kpe, 8)
    qa = rng.standard_normal((1, 4, 16)).astype(np.float32)
    qp = rng.standard_normal((1, 4, 8)).astype(np.float32)
    out = SA.sparse_mla_decode(_t(qa), _t(qp), _t(ckv), _t(kpe), None, None,
                               torch.arange(8)[None], torch.tensor([64]), 8,
                               8, 0.125, anchor, planes=planes)
    _close(out.numpy(), _dense_mla(qa, qp, ckv, kpe), 2e-5)


@pytest.mark.parametrize("anchor", ANCHORS)
def test_full_budget_equals_dense_gqa(anchor):
    rng = np.random.default_rng(8)
    k = rng.standard_normal((8, 8, 2, 8)).astype(np.float32) * 0.3
    v = rng.standard_normal((8, 8, 2, 8)).astype(np.float32)
    shape = (8, 2, 8)
    planes = {"smin": torch.full(shape, torch.inf),
              "smax": torch.full(shape, -torch.inf),
              "ssum": torch.zeros(shape), "sfix": torch.zeros(shape),
              "sdyn": torch.zeros(shape)}
    SA.update_page_summaries_cfg(planes, _t(k).reshape(1, 64, 2, 8),
                                 torch.arange(8).repeat_interleave(8)[None],
                                 torch.arange(64)[None], 8)
    q = rng.standard_normal((1, 4, 8)).astype(np.float32)
    qg = q.reshape(1, 2, 2, 8)
    s = np.einsum("bkgd,pqkd->bkgpq", qg, k).reshape(1, 2, 2, -1) * 0.35
    a = np.exp(s - s.max(-1, keepdims=True))
    a /= a.sum(-1, keepdims=True)
    dense = np.einsum("bkgx,xkd->bkgd", a, v.reshape(64, 2, 8)).reshape(
        1, 4, 8)
    for retrieval in ("layer", "kvhead"):
        out = SA.sparse_gqa_decode(_t(q), _t(k), _t(v), None, None,
                                   torch.arange(8)[None], torch.tensor([64]),
                                   8, 8, 0.35, anchor, retrieval, planes)
        _close(out.numpy(), dense, 2e-5)


def test_partial_budget_finds_the_needles():
    """Attention mass planted in pages 2 and 5 of 8: a budget of 3 (the
    needles and the forced newest page) reproduces dense attention (quest);
    each dot-product anchor ranks its kind of needle in its top 2."""
    rng = np.random.default_rng(9)
    ckv = rng.standard_normal((8, 8, 16)).astype(np.float32) * 0.05
    kpe = rng.standard_normal((8, 8, 8)).astype(np.float32) * 0.05
    q1 = rng.standard_normal((1, 1, 16)).astype(np.float32)
    qa = np.broadcast_to(q1, (1, 4, 16)).copy()
    qp = np.broadcast_to(rng.standard_normal((1, 1, 8)).astype(np.float32),
                         (1, 4, 8)).copy()
    needles = ckv.copy(), kpe.copy()
    for pg in (2, 5):
        needles[0][pg, 3] = qa[0, 0] * 8.0
        needles[1][pg, 3] = qp[0, 0] * 8.0
    planes = _needle_planes(*needles, 8)
    out = SA.sparse_mla_decode(_t(qa), _t(qp), _t(needles[0]),
                               _t(needles[1]), None, None,
                               torch.arange(8)[None], torch.tensor([64]), 8,
                               3, 0.125, planes=planes)
    _close(out.numpy(), _dense_mla(qa, qp, *needles), 2e-3)
    q_cat = _t(np.concatenate([qa, qp], -1))
    for anchor in ("block_max", "block_mean", "fixed"):
        c, p = ckv.copy(), kpe.copy()
        if anchor == "fixed":
            c[3, 0], p[3, 0] = qa[0, 0] * 8.0, qp[0, 0] * 8.0
        elif anchor == "block_mean":
            c[3, :], p[3, :] = qa[0, 0] * 4.0, qp[0, 0] * 4.0
        else:
            c[3, 5], p[3, 5] = qa[0, 0] * 8.0, qp[0, 0] * 8.0
        sel = SA.select_pages(q_cat, _needle_planes(c, p, 8),
                              torch.arange(8)[None], torch.tensor([64]), 8, 2,
                              anchor)
        assert 3 in sel[0].tolist(), anchor


def test_snapkv_preselect_and_dynamic_anchors():
    """The observation pass ranks the pages the question attends,
    preselection keeps them and the newest page, and the dynamic anchors
    it derives retrieve the needle page."""
    rng = np.random.default_rng(10)
    ckv = rng.standard_normal((8, 8, 16)).astype(np.float32) * 0.05
    kpe = rng.standard_normal((8, 8, 8)).astype(np.float32) * 0.05
    qw = rng.standard_normal((1, 3, 4, 24)).astype(np.float32)
    ckv[2, 1], kpe[2, 1] = qw[0, 0, 0, :16] * 6.0, qw[0, 0, 0, 16:] * 6.0
    ckv[4, 6], kpe[4, 6] = qw[0, 1, 1, :16] * 6.0, qw[0, 1, 1, 16:] * 6.0
    planes = _needle_planes(ckv, kpe, 8)
    pt, lengths = torch.arange(8)[None], torch.tensor([64])
    mass, tok = SA.snapkv_page_scores(_t(qw), _t(ckv), _t(kpe), pt, lengths,
                                      8, 0.125, True)
    keep = SA.preselect_pages(mass, lengths, 8, keep=4, recent=1)[0]
    assert keep[2] and keep[4] and keep[7] and int(keep.sum()) == 4
    kcat = _t(np.concatenate([ckv, kpe], -1))
    SA.set_dynamic_anchors(planes, kcat, pt, tok, lengths, 8)
    np.testing.assert_array_equal(planes["sdyn"][2].numpy(), np.concatenate(
        [ckv[2, 1], kpe[2, 1]]))
    sel = SA.select_pages(_t(qw[:, 0]), planes, pt, lengths, 8, 3,
                          anchor="dynamic")
    assert 2 in sel[0].tolist()


def test_nan_in_dead_rows_stays_out():
    """NaN planted in rows 10-11 of a selected page whose live
    rows end at 9 (and in a dead page a full budget selects): the port's
    outputs equal those of the clean pools; the JAX package's are NaN
    (recorded)."""
    rng = np.random.default_rng(11)
    ckv, kpe, tables, (tp, jp) = _mla_case(rng, b=1, lengths=(42,))
    qa = rng.standard_normal((1, 4, 16)).astype(np.float32)
    qp = rng.standard_normal((1, 4, 8)).astype(np.float32)
    lengths = np.asarray([42], np.int32)
    page5 = tables[0, 5]  # rows 40, 41 live
    dirty = ckv.copy(), kpe.copy()
    dirty[0][page5, 2:4] = np.nan
    dirty[1][page5, 2:4] = np.nan
    dirty[0][tables[0, 7]] = np.nan  # a dead slot's page
    for retrieval in ("layer", "qhead"):
        clean = SA.sparse_mla_decode(_t(qa), _t(qp), _t(ckv), _t(kpe), None,
                                     None, _t(tables), _t(lengths), 8, 8,
                                     0.125, "quest", retrieval, tp)
        got = SA.sparse_mla_decode(_t(qa), _t(qp), _t(dirty[0]),
                                   _t(dirty[1]), None, None, _t(tables),
                                   _t(lengths), 8, 8, 0.125, "quest",
                                   retrieval, tp)
        assert torch.isfinite(got).all()
        np.testing.assert_array_equal(got.numpy(), clean.numpy())
    jout = _jsa().sparse_mla_decode(
        jnp.asarray(qa), jnp.asarray(qp), jnp.asarray(dirty[0]),
        jnp.asarray(dirty[1]), None, None, jnp.asarray(tables),
        jnp.asarray(lengths), 8, 8, 0.125, "quest", "layer", jp)
    assert np.isnan(np.asarray(jout)).any()
    k, v, gt, (gp, _) = _gqa_case(rng, b=1, lengths=(42,))
    q = rng.standard_normal((1, 4, 8)).astype(np.float32)
    page5 = gt[0, 5]
    vd = v.copy()
    vd[page5, 2:] = np.nan
    for retrieval in ("layer", "kvhead"):
        args = (None, None, _t(gt), _t(lengths), 8, 8, 0.35, "quest",
                retrieval, gp)
        clean = SA.sparse_gqa_decode(_t(q), _t(k), _t(v), *args)
        got = SA.sparse_gqa_decode(_t(q), _t(k), _t(vd), *args)
        np.testing.assert_array_equal(got.numpy(), clean.numpy())


# -- the paged forward and the engines ---------------------------------------


def _models(cfg):
    from ktransformers_tpu.models.init import init_params
    from ktransformers_tpu.models.spec import spec_from_hf_config as js

    jspec = js(dict(cfg))
    jparams = init_params(jspec, seed=0, quant="bf16")
    spec = spec_from_hf_config(dict(cfg))
    return jspec, jparams, spec, params_from_jax(jax.device_get(jparams),
                                                 spec, "cpu")


@pytest.mark.parametrize("budget", [7, 3])
@pytest.mark.parametrize("cfg", [TINY_DS, TINY_GQA], ids=["mla", "gqa"])
def test_forward_paged_sparse_matches_jax(cfg, budget):
    """A 40-token prefill, then a decode step with a budget of every live
    page (7: equals dense) or 3: logits against the JAX forward_paged, the
    summary planes after the prefill within 1e-5 (the keys themselves come
    out of float32 sums in another order), the same pages untouched."""
    from ktransformers_tpu.cache.paged import PagedKVCache as JPaged
    from ktransformers_tpu.models.paged import forward_paged as jfwd

    jspec, jparams, spec, params = _models(cfg)
    toks = np.random.default_rng(0).integers(0, 96, (1, 40))
    pt = (1 + np.arange(7, dtype=np.int32))[None]

    def port(budget, summaries):
        kv = PagedKVCache.create(spec, 8, 8, torch.float32,
                                 summaries=summaries, device="cpu")
        _, kv = forward_paged(params, spec, torch.as_tensor(toks), kv,
                              _t(pt), _i32([0]),
                              compute_dtype=torch.float32)
        planes = None if kv.smin is None else [m.clone() for m in kv.smin]
        logits, _ = forward_paged(params, spec, torch.tensor([[7]]), kv,
                                  _t(pt), _i32([40]),
                                  compute_dtype=torch.float32,
                                  sparse_budget=budget)
        return logits[0, -1].numpy(), planes

    jkv = JPaged.create(jspec, 8, 8, dtype=jnp.float32, summaries=True)
    step = jax.jit(lambda p, t, kv, ln, b: jfwd(
        p, jspec, t, kv, jnp.asarray(pt), ln, compute_dtype=jnp.float32,
        sparse_budget=b), static_argnums=(4,))
    _, jkv = step(jparams, jnp.asarray(toks, jnp.int32), jkv,
                  jnp.asarray([0], jnp.int32), None)
    jl, _ = step(jparams, jnp.asarray([[7]], jnp.int32), jkv,
                 jnp.asarray([40], jnp.int32), budget)
    dense, _ = port(None, False)
    got, planes = port(budget, True)
    for a, b in zip(planes, jkv.smin):
        a, b = a.numpy(), np.asarray(b)
        fin = np.isfinite(b)
        np.testing.assert_array_equal(np.isfinite(a), fin)
        _close(a[fin], b[fin], 1e-5)
    _close(got, np.asarray(jl)[0, -1])
    if budget == 7:
        _close(got, dense, 1e-5)


def _engine(spec, params, budget=None, **kw):
    return ServeEngine(params, spec, SchedulerConfig(**SCHED), num_pages=32,
                       sparse_budget=budget, **kw, **F32)


PROMPTS = [list(range(4, 16)), list(range(30, 40))]


@pytest.mark.parametrize("arch,anchor,retrieval", [
    ("mla", "quest", "layer"), ("mla", "block_mean", "qhead"),
    ("mla", "fixed", "layer"), ("gqa", "block_max", "kvhead"),
    ("gqa", "dynamic", "layer")])
def test_serving_full_budget_equals_dense(arch, anchor, retrieval):
    """ServeEngine(sparse_budget=max_pages_per_query): continuous batching
    gives the dense engine's tokens, while the summaries update and the
    recycled pages' reset run live; the JAX sparse engine's tokens too
    (quest)."""
    cfg = TINY_DS if arch == "mla" else TINY_GQA
    jspec, jparams, spec, params = _models(cfg)
    dense = _engine(spec, params)
    want = [dense.generate_sync(p, max_new_tokens=6) for p in PROMPTS]
    sp = _engine(spec, params, 8, sparse_anchor=anchor,
                 sparse_retrieval=retrieval)
    assert sp.kv.smin is not None
    got = [sp.generate_sync(p, max_new_tokens=6) for p in PROMPTS]
    assert got == want
    assert not sp._stale_summary_pages  # reset before the steps
    if anchor == "quest":
        from ktransformers_tpu.serving.engine import ServeEngine as JEngine
        from ktransformers_tpu.serving.scheduler import (
            SchedulerConfig as JSched,
        )

        je = JEngine(jparams, jspec, JSched(**SCHED), num_pages=32,
                     cache_dtype=jnp.float32, compute_dtype=jnp.float32,
                     sparse_budget=8)
        assert [je.generate_sync(p, max_new_tokens=6)
                for p in PROMPTS] == got


def test_recycled_pages_are_reset():
    """A page freed by a finished query and handed to the next comes back
    with +-inf extremes before the next step writes into it."""
    _, _, spec, params = _models(TINY_DS)
    eng = _engine(spec, params, 8, enable_prefix_cache=False)
    eng.generate_sync(list(range(4, 30)), max_new_tokens=3)
    used = {p for p in range(1, 32)
            if torch.isfinite(eng.kv.smin[0][p]).all()}
    assert used
    seen = []
    real = eng.kv.reset_page_summaries

    def spy(pids):
        seen.extend(pids)
        for p in pids:
            assert p in used or torch.isinf(eng.kv.smin[0][p]).all()
        return real(pids)

    eng.kv.reset_page_summaries = spy
    eng.generate_sync(list(range(40, 60)), max_new_tokens=3)
    assert set(seen) & used  # a recycled page was reset


def test_sparse_fused_mixed_matches_unfused(monkeypatch):
    """Staggered submissions make fused mixed steps (decode rows sparse,
    the chunk dense) whose tokens equal the separate steps'."""
    _, _, spec, params = _models(TINY_DS)

    def run(fused):
        monkeypatch.setenv("KT_FUSED_MIXED", "1" if fused else "0")
        eng = _engine(spec, params, 8, enable_prefix_cache=False)
        q1 = eng.submit(list(range(4, 14)), max_new_tokens=10)
        for _ in range(20):
            eng.step()
            if q1.state == "decode":
                break
        q2 = eng.submit(list(range(20, 37)), max_new_tokens=6)
        while q1.state != "done" or q2.state != "done":
            if not eng.step():
                break
        return (list(q1.output_ids), list(q2.output_ids),
                eng.mixed_steps_fused)

    fused, unfused = run(True), run(False)
    assert fused[:2] == unfused[:2]
    assert fused[2] > 0 and unfused[2] == 0


@pytest.mark.skipif(shutil.which("g++") is None,
                    reason="g++ is not installed: no host expert FFN")
def test_offload_sparse_full_budget_matches_dense(monkeypatch):
    """Offload x sparse: with a budget covering the whole table the
    offloaded sparse engine gives the offloaded dense engine's tokens."""
    from ktransformers_tpu_torch.offload import HostOffloadServeEngine

    from tests.test_torch_offload_serving import _cfg, _draw

    monkeypatch.setenv("KT_W4A8", "0")
    _, jp, spec = _draw()
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, 128, 12).tolist() for _ in range(2)]
    engines = [HostOffloadServeEngine(params_from_jax(jp, spec, "cpu"), spec,
                                      _cfg(), num_pages=48,
                                      transfer_dtype=None,
                                      sparse_budget=budget, **F32)
               for budget in (None, 8)]
    dense, sparse = ([e.generate_sync(p, max_new_tokens=6) for p in prompts]
                     for e in engines)
    assert sparse == dense
    assert engines[1].kv.smin is not None


def test_paged_cache_planes_cross_from_jax():
    """A JAX cache's summary planes after a prefill continue in the port: a
    decode step there equals the port's own run."""
    from ktransformers_tpu.cache.paged import PagedKVCache as JPaged
    from ktransformers_tpu.models.paged import forward_paged as jfwd

    jspec, jparams, spec, params = _models(TINY_DS)
    toks = np.random.default_rng(1).integers(0, 96, (1, 30))
    pt = (1 + np.arange(5, dtype=np.int32))[None]
    jkv = JPaged.create(jspec, 6, 8, dtype=jnp.float32, summaries=True,
                        anchor="block_mean")
    _, jkv = jax.jit(lambda p, t, kv: jfwd(
        p, jspec, t, kv, jnp.asarray(pt), jnp.asarray([0], jnp.int32),
        compute_dtype=jnp.float32))(jparams, jnp.asarray(toks, jnp.int32),
                                    jkv)
    kv = paged_cache_from_jax(jax.device_get(jkv), spec, "cpu")
    assert kv.ssum is not None and kv.sfix is None
    mine = PagedKVCache.create(spec, 6, 8, torch.float32, summaries=True,
                               anchor="block_mean", device="cpu")
    _, mine = forward_paged(params, spec, torch.as_tensor(toks), mine,
                            _t(pt), _i32([0]),
                            compute_dtype=torch.float32)
    outs = []
    for cache in (kv, mine):
        logits, _ = forward_paged(params, spec, torch.tensor([[3]]), cache,
                                  _t(pt), _i32([30]),
                                  compute_dtype=torch.float32,
                                  sparse_budget=2, sparse_anchor="block_mean")
        outs.append(logits.numpy())
    _close(outs[0], outs[1], 1e-5)


def test_sparse_refusals():
    """Kinds the attention does not take, a budget without summaries (or
    without the anchor's plane) and hybrid summaries raise; no quiet
    dense fallback."""
    spec = spec_from_hf_config(dict(TINY_DS))
    gspec = spec_from_hf_config(dict(TINY_GQA))
    with pytest.raises(ValueError, match="kvhead"):
        SA.check_sparse_kinds("quest", "kvhead", "mla")
    with pytest.raises(ValueError, match="qhead"):
        SA.check_sparse_kinds("quest", "qhead", "gqa")
    with pytest.raises(ValueError, match="anchor"):
        SA.check_sparse_kinds("nearest", "layer", "gqa")
    kv = PagedKVCache.create(gspec, 4, 8, torch.float32, summaries=True,
                             device="cpu")
    toks = torch.zeros(1, 1, dtype=torch.int64)
    pt = torch.zeros(1, 2, dtype=torch.int32)
    ln = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="no ssum plane"):
        forward_paged({}, gspec, toks, kv, pt, ln, sparse_budget=2,
                      sparse_anchor="block_mean")
    with pytest.raises(ValueError, match="summaries=True"):
        forward_paged({}, spec, toks, PagedKVCache.create(
            spec, 4, 8, torch.float32, device="cpu"), pt, ln,
            sparse_budget=2)
