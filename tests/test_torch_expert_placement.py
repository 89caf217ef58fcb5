"""The single-device half of parallelism in the port against the JAX
package: fused shared experts (ops/fuse_shared.py), routing statistics and
expert re-placement (utils/expert_placement.py, the ServeEngine's
collect_routing / apply_expert_rebalance), the MoEWeights expert map and
mask, their packed-checkpoint round trip, setup_logging, and the
refusals of parallel/shardings.py.shard_params (a cut scale group, a
per-rank shape no kernel route takes), which need no second rank.

Mirrors tests/test_fuse_shared.py, tests/test_expert_placement.py and
tests/test_dynamic_placement.py: the same seeded numpy inputs go through
the JAX function and the port's. Everything runs in float32 on the CPU
(the port's wrappers take their plain versions).

Tolerances:
- 2e-4 (rtol and atol) for the tiny model's logits, fused against unfused
  and the port against the JAX package, as tests/test_fuse_shared.py holds
  the JAX package against itself: the same codes, float32 sums in another
  order;
- 1e-5 for a MoE call with a permuted or masked expert set against the
  original (the same rows through the same experts; only which slot holds
  an expert moves) and against the JAX package's call;
- exact for counts, masks, maps, token ids and stored tensors.
"""

import dataclasses
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ktransformers_tpu.models.init import init_params as jinit_params
from ktransformers_tpu.models.model import KVCache as JKVCache
from ktransformers_tpu.models.model import forward as jforward
from ktransformers_tpu.models.spec import spec_from_hf_config as jspec
from ktransformers_tpu.ops import moe as jmoe
from ktransformers_tpu.ops.fuse_shared import (
    fuse_shared_experts as jfuse_shared_experts,
)
from ktransformers_tpu.ops.gate import GateConfig as JGateConfig
from ktransformers_tpu.ops.gate import route as jroute
from ktransformers_tpu.quant.formats import quantize as jquantize
from ktransformers_tpu.utils import expert_placement as jplace

from ktransformers_tpu_torch.convert import params_from_jax
from ktransformers_tpu_torch.models import model as tmodel
from ktransformers_tpu_torch.models.spec import spec_from_hf_config as tspec
from ktransformers_tpu_torch.ops.fuse_shared import fuse_shared_experts
from ktransformers_tpu_torch.ops.moe import MoEWeights, moe_forward
from ktransformers_tpu_torch.quant.formats import quantize
from ktransformers_tpu_torch.utils import expert_placement as place

from tests.test_generate import TINY_DS
from tests.test_torch_model import one_torch_thread  # noqa: F401 (fixture)

TOL = 2e-4
MOE_TOL = 1e-5


def _tiny(quant="int4_g", group_size=32):
    """(JAX spec, JAX params, port spec) of the 2-layer TINY_DS."""
    spec = jspec(dict(TINY_DS))
    return (spec, jinit_params(spec, seed=0, quant=quant,
                               moe_quant=quant, group_size=group_size),
            tspec(dict(TINY_DS)))


def _port(jparams, spec_t):
    return params_from_jax(jax.device_get(jparams), spec_t, "cpu")


def _tokens():
    return np.random.default_rng(0).integers(0, 96, (2, 10))


def _port_logits(params, spec, tokens=None):
    tokens = _tokens() if tokens is None else tokens
    cache = tmodel.KVCache.create(spec, tokens.shape[0], 16, torch.float32,
                                  "cpu")
    logits, _ = tmodel.forward(params, spec, torch.from_numpy(tokens), cache,
                               compute_dtype=torch.float32)
    return logits.numpy()


def _jax_logits(params, spec, tokens=None):
    tokens = _tokens() if tokens is None else tokens
    cache = JKVCache.create(spec, tokens.shape[0], 16, dtype=jnp.float32)
    logits, _ = jforward(params, spec, jnp.asarray(tokens, jnp.int32), cache,
                         compute_dtype=jnp.float32)
    return np.asarray(logits)


def _n_fused(params) -> list:
    return [lp["moe"]["experts"].n_shared_fused for lp in params["layers"]
            if "moe" in lp]


def test_fused_shared_experts_exact():
    """Shared experts appended to the routed set: the port's fused model
    equals its unfused one and the JAX package's fused model; the shared
    FFN no longer runs and each token takes top-k + n rows."""
    spec_j, jp, spec_t = _tiny()
    ref = _port_logits(_port(jp, spec_t), spec_t)
    fused = fuse_shared_experts(_port(jp, spec_t), spec_t)
    jfused = jfuse_shared_experts(jp, spec_j)
    assert _n_fused(fused) == [1] == list(_n_fused(jfused))
    w = fused["layers"][1]["moe"]["experts"]
    want = jax.device_get(jfused["layers"][1]["moe"]["experts"])
    for name in ("gate_up", "down"):
        for f in ("data", "scales"):
            np.testing.assert_array_equal(
                getattr(getattr(w, name), f).numpy(),
                np.asarray(getattr(getattr(want, name), f)))
    assert "shared" not in fused["layers"][1]["moe"]
    got = _port_logits(fused, spec_t)
    np.testing.assert_allclose(got, ref, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got, _jax_logits(jfused, spec_j), rtol=TOL,
                               atol=TOL)


def test_fused_shared_rows_and_no_dense_ffn(monkeypatch):
    """On the fused model each MoE call takes k + n_shared_fused ids per
    token (the shared ones last, weight 1) and the dense MLP runs only in
    the dense layer."""
    _, jp, spec_t = _tiny()
    fused = fuse_shared_experts(_port(jp, spec_t), spec_t)
    calls, dense = [], []
    real_moe, real_dense = tmodel.moe_forward, tmodel._dense_mlp

    def moe(x, w, idx, wts, act):
        calls.append((idx.clone(), wts.clone()))
        return real_moe(x, w, idx, wts, act)

    def dense_mlp(p, spec, x):
        dense.append(x.shape)
        return real_dense(p, spec, x)

    monkeypatch.setattr(tmodel, "moe_forward", moe)
    monkeypatch.setattr(tmodel, "_dense_mlp", dense_mlp)
    _port_logits(fused, spec_t)
    k = spec_t.moe.top_k
    (idx, wts), = calls
    assert idx.shape[1] == k + 1
    assert torch.all(idx[:, k] == spec_t.moe.num_experts)
    assert torch.all(wts[:, k] == 1.0)
    assert len(dense) == 1  # layer 0's MLP only


def test_fuse_falls_back_on_kind_mismatch():
    spec_j, jp, spec_t = _tiny(quant="bf16")
    jp = jinit_params(spec_j, seed=0, quant="bf16", moe_quant="int4_g",
                      group_size=32)
    from ktransformers_tpu.quant.formats import dequantize as jdequantize

    for lp in jp["layers"]:
        if "moe" in lp and lp["moe"].get("shared") is not None:
            sh = lp["moe"]["shared"]
            for k in ("gate_up", "down"):
                sh[k] = jquantize(jdequantize(sh[k], jnp.float32), "bf16")
    port = _port(jp, spec_t)
    assert _n_fused(fuse_shared_experts(port, spec_t)) == [0]
    assert list(_n_fused(jfuse_shared_experts(jp, spec_j))) == [0]
    # a layer with an expert map keeps its shared expert
    port = _port(jp, spec_t)
    w = port["layers"][1]["moe"]["experts"]
    port["layers"][1]["moe"]["experts"] = dataclasses.replace(
        w, logical_to_physical=torch.arange(w.num_experts))
    assert _n_fused(fuse_shared_experts(port, spec_t,
                                        requantize=True)) == [0]
    # the explicit requantize opt-in stacks anyway, with the JAX bits (the
    # JAX function fuses jp in place: last)
    fused = fuse_shared_experts(_port(jp, spec_t), spec_t, requantize=True)
    jfused = jfuse_shared_experts(jp, spec_j, requantize=True)
    assert _n_fused(fused) == [1] == list(_n_fused(jfused))
    np.testing.assert_array_equal(
        fused["layers"][1]["moe"]["experts"].gate_up.data.numpy(),
        np.asarray(jfused["layers"][1]["moe"]["experts"].gate_up.data))


def test_stats_collector():
    c, jc = place.ExpertStatsCollector(2, 8), jplace.ExpertStatsCollector(2, 8)
    for coll in (c, jc):
        coll.record(0, np.array([[0, 1], [0, 2]]))
        coll.record(1, np.array([[7, 7]]))
    assert c.counts[0, 0] == 2 and c.counts[1, 7] == 2
    np.testing.assert_array_equal(c.counts, jc.counts)
    np.testing.assert_array_equal(c.frequencies, jc.frequencies)


@pytest.mark.parametrize("strategy",
                         ["frequency", "uniform", "front-loading", "random"])
def test_hot_masks_strategies(strategy):
    freqs = np.array([[0.4, 0.1, 0.3, 0.2], [0.1, 0.1, 0.1, 0.7]])
    m = place.hot_expert_masks(freqs, 2, strategy, seed=3)
    np.testing.assert_array_equal(
        m, jplace.hot_expert_masks(freqs, 2, strategy, seed=3))
    assert m.sum(axis=1).tolist() == [2, 2]
    if strategy == "frequency":
        assert m[0].tolist() == [True, False, True, False] and m[1, 3]
    with pytest.raises(ValueError):
        place.hot_expert_masks(freqs, 2, "nearest")


def test_balanced_l2p_spreads_load():
    freqs = np.array([0.5, 0.3, 0.1, 0.05, 0.02, 0.02, 0.005, 0.005])
    l2p = place.balanced_logical_to_physical(freqs, ep_size=2)
    np.testing.assert_array_equal(
        l2p, jplace.balanced_logical_to_physical(freqs, ep_size=2))
    shard_of = l2p // 4
    assert shard_of[0] != shard_of[1]
    assert (shard_of == 0).sum() == 4


def test_balanced_l2p_reduces_shard_skew():
    rng = np.random.default_rng(0)
    e, ep, k, t = 16, 4, 2, 4096
    hot = rng.integers(0, 4, (t, k))
    cold = rng.integers(4, e, (t, k))
    topk = np.where(rng.random((t, k)) < 0.8, hot, cold)
    freqs = np.bincount(topk.reshape(-1), minlength=e) / topk.size
    l2p = place.balanced_logical_to_physical(freqs, ep)
    np.testing.assert_array_equal(
        l2p, jplace.balanced_logical_to_physical(freqs, ep))
    assert sorted(l2p.tolist()) == list(range(e))
    per = e // ep

    def shard_loads(mapping):
        return np.bincount(mapping[topk.reshape(-1)] // per, minlength=ep)

    bal = shard_loads(l2p)
    assert bal.max() < shard_loads(np.arange(e)).max()
    assert bal.max() <= 1.5 * bal.mean()


def _moe_inputs(rng, e=8, d=32, f=48, k=2, t=5, kind="int8", gs=128):
    gu = rng.standard_normal((e, d, 2 * f)).astype(np.float32) * 0.1
    dn = rng.standard_normal((e, f, d)).astype(np.float32) * 0.1
    x = rng.standard_normal((t, d)).astype(np.float32)
    logits = rng.standard_normal((t, e)).astype(np.float32)
    idx, wts = jroute(jnp.asarray(logits), JGateConfig(num_experts=e,
                                                       top_k=k))
    jw = jmoe.MoEWeights(gate_up=jquantize(jnp.asarray(gu), kind,
                                           group_size=gs),
                         down=jquantize(jnp.asarray(dn), kind, group_size=gs))
    w = MoEWeights(quantize(torch.from_numpy(gu), kind, gs),
                   quantize(torch.from_numpy(dn), kind, gs))
    return (x, np.asarray(idx), np.asarray(wts), jw, w)


def _tmoe(x, w, idx, wts):
    return moe_forward(torch.tensor(x), w, torch.tensor(idx),
                       torch.tensor(wts)).numpy()


@pytest.mark.parametrize("t", [5, 24])  # the gather path and the sorted one
def test_reorder_weights_is_noop_through_forward(rng, t):
    x, idx, wts, jw, w = _moe_inputs(rng, t=t)
    ref = _tmoe(x, w, idx, wts)
    freqs = np.bincount(idx.reshape(-1), minlength=8)
    l2p = place.balanced_logical_to_physical(freqs / freqs.sum(), ep_size=2)
    w2 = place.reorder_expert_weights(w, l2p)
    jw2 = jplace.reorder_expert_weights(jw, l2p)
    np.testing.assert_array_equal(w2.gate_up.data.numpy(),
                                  np.asarray(jw2.gate_up.data))
    out = _tmoe(x, w2, idx, wts)
    np.testing.assert_allclose(out, ref, atol=MOE_TOL)
    want = np.asarray(jmoe.moe_forward(jnp.asarray(x), jw2, jnp.asarray(idx),
                                       jnp.asarray(wts), jmoe.MoEConfig()))
    np.testing.assert_allclose(out, want, atol=MOE_TOL)


@pytest.mark.parametrize("t", [5, 24])
def test_expert_mask_matches_jax(rng, t):
    """A masked expert adds nothing (its rows read expert 0 on the gather
    path and sort past every group on the sorted path), as in the JAX
    package; with a map too."""
    x, idx, wts, jw, w = _moe_inputs(rng, t=t)
    mask = np.array([1, 0, 1, 1, 0, 1, 1, 1], bool)
    l2p = np.asarray(rng.permutation(8), np.int32)
    w_m = dataclasses.replace(w, expert_mask=torch.from_numpy(mask))
    jw_m = dataclasses.replace(jw, expert_mask=jnp.asarray(mask))
    got = _tmoe(x, w_m, idx, wts)
    want = np.asarray(jmoe.moe_forward(jnp.asarray(x), jw_m, jnp.asarray(idx),
                                       jnp.asarray(wts), jmoe.MoEConfig()))
    np.testing.assert_allclose(got, want, atol=MOE_TOL)
    dropped = np.where(mask[idx], wts, 0.0).astype(np.float32)
    np.testing.assert_allclose(got, _tmoe(x, w, idx, dropped), atol=MOE_TOL)
    both = dataclasses.replace(place.reorder_expert_weights(w, l2p),
                               expert_mask=torch.from_numpy(mask[
                                   np.argsort(l2p)]))
    np.testing.assert_allclose(_tmoe(x, both, idx, wts), got, atol=MOE_TOL)


def test_reorder_moves_every_tensor_of_a_repacked_w4a8_set(rng):
    """Codes, scales and zero points of repacked int4_gz experts (and the
    LoRA factors) move together; the W4A8 call is unchanged."""
    from ktransformers_tpu_torch.quant.w4a8 import repack_offset_lo

    x, idx, wts, _, _ = _moe_inputs(rng, t=5)
    gu = torch.from_numpy(rng.standard_normal((8, 32, 96)).astype(
        np.float32) * 0.1)
    dn = torch.from_numpy(rng.standard_normal((8, 48, 32)).astype(
        np.float32) * 0.1)
    w = MoEWeights(repack_offset_lo(quantize(gu, "int4_gz", 16)),
                   repack_offset_lo(quantize(dn, "int4_gz", 16)))
    l2p = np.asarray(rng.permutation(8), np.int32)
    w2 = place.reorder_expert_weights(w, l2p)
    p2l = np.argsort(l2p)
    for name in ("gate_up", "down"):
        a, b = getattr(w, name), getattr(w2, name)
        assert b.act_quant and b.kind == "int4_gz"
        for f in ("data", "scales", "zeros"):
            np.testing.assert_array_equal(getattr(b, f).numpy(),
                                          getattr(a, f).numpy()[p2l])
    np.testing.assert_allclose(_tmoe(x, w2, idx, wts), _tmoe(x, w, idx, wts),
                               atol=MOE_TOL)


def test_reorder_composes(rng):
    e, kdim, n = 8, 32, 16
    gu = rng.standard_normal((e, kdim, 2 * n)).astype(np.float32)
    dn = rng.standard_normal((e, n, kdim)).astype(np.float32)
    base = MoEWeights(quantize(torch.from_numpy(gu), "int4_g", 16),
                      quantize(torch.from_numpy(dn), "int4_g", 16))
    jbase = jmoe.MoEWeights(
        gate_up=jquantize(jnp.asarray(gu), "int4_g", group_size=16),
        down=jquantize(jnp.asarray(dn), "int4_g", group_size=16))
    a = np.asarray(rng.permutation(e), np.int32)
    b = np.asarray(rng.permutation(e), np.int32)
    twice = place.reorder_expert_weights(
        place.reorder_expert_weights(base, a), b)
    direct = place.reorder_expert_weights(base, b)
    jtwice = jplace.reorder_expert_weights(
        jplace.reorder_expert_weights(jbase, a), b)
    np.testing.assert_array_equal(twice.logical_to_physical.numpy(), b)
    np.testing.assert_array_equal(twice.gate_up.data.numpy(),
                                  direct.gate_up.data.numpy())
    np.testing.assert_array_equal(twice.gate_up.data.numpy(),
                                  np.asarray(jtwice.gate_up.data))
    with pytest.raises(ValueError, match="permutation"):
        place.reorder_expert_weights(base, np.zeros(e, np.int32))


def test_rebalanced_model_logits_match_unbalanced():
    """Every MoE layer re-placed (fused shared experts kept at their slots,
    which the JAX package's reorder drops): the logits do not move."""
    _, jp, spec_t = _tiny()
    port = _port(jp, spec_t)
    ref = _port_logits(port, spec_t)
    rng = np.random.default_rng(1)
    for params in (port, fuse_shared_experts(_port(jp, spec_t), spec_t)):
        for lp in params["layers"]:
            if "moe" in lp:
                w = lp["moe"]["experts"]
                l2p = place.balanced_logical_to_physical(
                    rng.random(spec_t.moe.num_experts), 2)
                lp["moe"]["experts"] = place.reorder_expert_weights(w, l2p)
                assert lp["moe"]["experts"].n_shared_fused == \
                    w.n_shared_fused
        np.testing.assert_allclose(_port_logits(params, spec_t), ref,
                                   rtol=TOL, atol=TOL)


def _engines(params, spec, **kw):
    from ktransformers_tpu_torch.serving import SchedulerConfig, ServeEngine

    return ServeEngine(params, spec, SchedulerConfig(
        max_batch_size=4, prefill_chunk=8, page_size=8,
        max_pages_per_query=8), num_pages=64, cache_dtype=torch.float32,
        compute_dtype=torch.float32, device="cpu", **kw)


def test_serving_collects_stats_and_rebalances_exactly():
    """Statistics accumulate over decode steps, counted as the JAX engine
    counts them on the same requests; a rebalance mid-stream (and a second
    one, composed) leaves the outputs equal to an engine that never
    re-places."""
    from ktransformers_tpu.serving.engine import ServeEngine as JEngine
    from ktransformers_tpu.serving.scheduler import (
        SchedulerConfig as JSched,
    )

    spec_j, jp, spec_t = _tiny(quant="bf16")
    jp = jinit_params(spec_j, seed=0, quant="bf16")
    prompts = [list(range(4, 12)), list(range(30, 38))]
    ref = _engines(_port(jp, spec_t), spec_t)
    expected = [ref.generate_sync(p, max_new_tokens=6) for p in prompts]

    eng = _engines(_port(jp, spec_t), spec_t, collect_routing=True)
    assert eng.generate_sync(prompts[0], max_new_tokens=6) == expected[0]
    jeng = JEngine(jp, spec_j, JSched(max_batch_size=4, prefill_chunk=8,
                                      page_size=8, max_pages_per_query=8),
                   num_pages=64, cache_dtype=jnp.float32,
                   compute_dtype=jnp.float32, collect_routing=True)
    assert jeng.generate_sync(prompts[0], max_new_tokens=6) == expected[0]
    assert eng.stats.counts.sum() > 0
    np.testing.assert_array_equal(eng.stats.counts, jeng.stats.counts)

    eng.apply_expert_rebalance(ep_size=2)
    w = eng.params["layers"][1]["moe"]["experts"]
    assert w.logical_to_physical is not None
    assert eng.generate_sync(prompts[1], max_new_tokens=6) == expected[1]
    eng.apply_expert_rebalance(ep_size=2)
    assert eng.generate_sync(prompts[0], max_new_tokens=6) == expected[0]

    with pytest.raises(ValueError, match="collect_routing"):
        ref.apply_expert_rebalance(2)


def test_packed_checkpoint_round_trip_of_map_and_mask(tmp_path):
    """logical_to_physical / expert_mask (and the fused shared count) are
    stored, read back by the port, and read by the JAX package's loader;
    a JAX tree that carries them loads into the port."""
    from ktransformers_tpu.models import checkpoint as jckpt

    from ktransformers_tpu_torch.models import checkpoint as tckpt

    _, jp, spec_t = _tiny(quant="int8")
    port = _port(jp, spec_t)
    w = port["layers"][1]["moe"]["experts"]
    l2p = torch.tensor([2, 0, 3, 1], dtype=torch.int32)
    mask = torch.tensor([True, False, True, True])
    port["layers"][1]["moe"]["experts"] = dataclasses.replace(
        w, logical_to_physical=l2p, expert_mask=mask)
    tckpt.save_params(port, str(tmp_path / "port"))
    back = tckpt.load_params(str(tmp_path / "port"), device="cpu")
    got = back["layers"][1]["moe"]["experts"]
    assert torch.equal(got.logical_to_physical, l2p)
    assert torch.equal(got.expert_mask, mask)
    jback = jckpt.load_params(str(tmp_path / "port"))
    jw = jback["layers"][1]["moe"]["experts"]
    np.testing.assert_array_equal(np.asarray(jw.logical_to_physical),
                                  l2p.numpy())
    np.testing.assert_array_equal(np.asarray(jw.expert_mask), mask.numpy())
    # the JAX package's tree with a map and mask, into the port
    jexp = jp["layers"][1]["moe"]["experts"]
    jp["layers"][1]["moe"]["experts"] = dataclasses.replace(
        jexp, logical_to_physical=jnp.asarray(l2p.numpy()),
        expert_mask=jnp.asarray(mask.numpy()))
    jckpt.save_params(jp, str(tmp_path / "jax"))
    back = tckpt.load_params(str(tmp_path / "jax"), device="cpu")
    got = back["layers"][1]["moe"]["experts"]
    assert torch.equal(got.logical_to_physical, l2p)
    assert torch.equal(got.expert_mask, mask)
    # fused shared experts keep their count through the port's files
    fused = fuse_shared_experts(_port(_tiny(quant="int8")[1], spec_t),
                                spec_t)
    tckpt.save_params(fused, str(tmp_path / "fused"))
    assert _n_fused(tckpt.load_params(str(tmp_path / "fused"),
                                      device="cpu")) == [1]


def test_offloaded_experts_apply_map_and_mask(rng):
    from ktransformers_tpu_torch.offload.experts import offload_moe_weights

    x, idx, wts, _, _ = _moe_inputs(rng, t=5, kind="int4_g", gs=16)
    gu = torch.from_numpy(rng.standard_normal((8, 32, 96)).astype(
        np.float32) * 0.1)
    dn = torch.from_numpy(rng.standard_normal((8, 48, 32)).astype(
        np.float32) * 0.1)
    w = MoEWeights(quantize(gu, "int4_g", 16), quantize(dn, "int4_g", 16))
    w = place.reorder_expert_weights(w, np.asarray(rng.permutation(8)))
    w = dataclasses.replace(w, expert_mask=torch.tensor(
        [1, 1, 0, 1, 1, 1, 0, 1], dtype=torch.bool))
    np.testing.assert_allclose(
        _tmoe(x, offload_moe_weights(w), idx, wts), _tmoe(x, w, idx, wts),
        atol=MOE_TOL)


def _one_rank_mesh(tp=2, ep=1):
    """Rank 0 of a tp x ep mesh, for cuts alone (no process group)."""
    from ktransformers_tpu_torch.parallel.mesh import Mesh

    return Mesh({"dp": 1, "ep": ep, "tp": tp}, {"dp": 0, "ep": 0, "tp": 0},
                {"dp": None, "ep": None, "tp": None}, "cpu")


def test_shard_params_refuses_a_cut_scale_group():
    """A tp = 2 cut of an expert down whose K holds an odd number of scale
    groups (DeepSeek-V2-Lite's 1408 = 11 x 128, here 96 = 3 x 32) raises,
    naming the tensor and its groups; so does a per-channel int4 weight
    (its nibbles packed across all of K); an int8 per-channel weight cuts
    anywhere."""
    from ktransformers_tpu_torch.models.init import init_params_synthetic
    from ktransformers_tpu_torch.parallel.shardings import shard_params

    cfg = dict(TINY_DS, moe_intermediate_size=96, intermediate_size=128)
    spec = tspec(cfg)
    params = init_params_synthetic(spec, seed=0, quant="int8",
                                   moe_quant="int4_g", group_size=32,
                                   dtype=torch.float32, device="cpu")
    with pytest.raises(ValueError, match=r"layers\.1\.moe\.experts\.down"
                       r".*3 groups of 32"):
        shard_params(params, spec, _one_rank_mesh())
    params = init_params_synthetic(spec, seed=0, quant="int8",
                                   moe_quant="int4", dtype=torch.float32,
                                   device="cpu")
    with pytest.raises(ValueError, match=r"experts\.down.*1 groups of 96"):
        shard_params(params, spec, _one_rank_mesh())
    params = init_params_synthetic(spec, seed=0, quant="int8",
                                   dtype=torch.float32, device="cpu")
    local = shard_params(params, spec, _one_rank_mesh())
    assert local["layers"][1]["moe"]["experts"].down.data.shape[-2] == 48


def test_shard_params_refuses_a_shape_no_kernel_route_takes():
    """A W4A8 lm_head whose per-rank width is no multiple of 4 (the W4A8
    kernels' rule) raises at the cut, naming the tensor."""
    from ktransformers_tpu_torch.models.init import init_params_synthetic
    from ktransformers_tpu_torch.parallel.shardings import shard_params

    spec = tspec(dict(TINY_DS, vocab_size=108))
    params = init_params_synthetic(spec, seed=0, quant="int4_g",
                                   group_size=16, dtype=torch.float32,
                                   device="cpu")
    with pytest.raises(ValueError, match="lm_head.*N=54.*multiple of 4"):
        shard_params(params, spec, _one_rank_mesh())
    with pytest.raises(ValueError, match="7 experts over ep"):
        bad = tspec(dict(TINY_DS, n_routed_experts=7))
        shard_params(init_params_synthetic(bad, seed=0, quant="int8",
                                           dtype=torch.float32,
                                           device="cpu"),
                     bad, _one_rank_mesh(tp=1, ep=2))


def test_setup_logging(monkeypatch):
    from ktransformers_tpu_torch.utils.observability import setup_logging

    monkeypatch.setenv("KT_LOG_LEVEL", "warning")
    logger = setup_logging()
    assert logger.name == "ktransformers_tpu_torch"
    assert logger.level == logging.WARNING
    n = len(logger.handlers)
    assert setup_logging("debug").level == logging.DEBUG
    assert len(logger.handlers) == n == 1
