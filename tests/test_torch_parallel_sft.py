"""LoRA SFT over ranks in the port (sft/train.py Trainer(mesh=...),
parallel/collectives.py's gradients, parallel/ep.py under training)
against the JAX package's Trainer over its mesh, mirroring
tests/test_sft.py's distributed test: the dp = 4 ZeRO-1 trainer over 3
steps held to the JAX Trainer(mesh=make_mesh(4, 1, 2)) (the JAX trainer
keeps its weights whole on that mesh, so its tp ranks are replicas) and
to the single device, its moments really cut; a batch whose dp shards
hold unequal numbers of IGNORE_INDEX labels held to the JAX single device
(the global masked mean); attention-LoRA steps at (dp, ep) = (2, 2) with
the psum combine and (1, 2) with the all-to-all, held to the JAX trainer
on the same mesh; and the two refusals beside the JAX package's own
failures on the same trees.

Every LoRA b factor is drawn (not zero, as init_lora leaves it), so that
every factor's gradient is nonzero; the gradients before the first step
are held to the JAX single device's. The model is TINY_DS (layer 0 dense,
layer 1 MoE with a shared expert) with bf16 weights (plain products in
both packages), float32 compute, rank 4.

One spawn of WORLD = 4 gloo CPU ranks (tests/torch_parallel_sft_worker.py,
which imports no JAX and runs one torch thread), a file rendezvous under
tmp_path; the (1, 2) mesh runs as two replicas of 2 ranks. The parent
computes the JAX references on the 8-device virtual CPU mesh of
tests/conftest.py while the ranks run. Every join has a timeout, and a
rank that fails or hangs fails the module's tests.

Tolerances: losses 2e-4 (tests/test_sft.py's); gradients 2e-4 of each
leaf's largest (float32 sums over ranks in another order).
"""

import multiprocessing
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ktransformers_tpu.models.init import init_params as jinit_params
from ktransformers_tpu.models.spec import spec_from_hf_config as jspec
from ktransformers_tpu.parallel.context import parallel_context
from ktransformers_tpu.parallel.mesh import make_mesh as jmake_mesh
from ktransformers_tpu.parallel.shardings import shard_params as jshard
from ktransformers_tpu.sft import lora as jlora
from ktransformers_tpu.sft import train as jtrain

from ktransformers_tpu_torch.convert import params_from_jax
from ktransformers_tpu_torch.models.spec import spec_from_hf_config as tspec
from ktransformers_tpu_torch.parallel.mesh import Mesh
from ktransformers_tpu_torch.parallel.shardings import shard_params
from ktransformers_tpu_torch.sft.train import Trainer

from tests import torch_parallel_sft_worker as worker
from tests.test_generate import TINY_DS
from tests.test_torch_model import one_torch_thread  # noqa: F401 (fixture)

WORLD = 4
JOIN_S = 150
TOL = 2e-4
ATTN = (r".*\.attn\.(q_proj|q_a|q_b|kv_a|o_proj|k_proj|v_proj)",)
CFG = dict(learning_rate=1e-3, remat=False)


def _lora(params, spec, targets=None):
    """init_lora (rank 4, seed 1) with every b factor drawn from a seed."""
    kw = {} if targets is None else dict(target_modules=targets)
    pl = jax.device_get(jlora.init_lora(params, spec,
                                        jlora.LoRAConfig(rank=4, **kw),
                                        seed=1))
    rng = np.random.default_rng(11)

    def draw(path, x):
        name = getattr(path[-1], "key", None)
        if x is not None and name in ("b", "gate_up_b", "down_b"):
            return (rng.standard_normal(x.shape) * 0.05).astype(np.float32)
        return x

    return jax.tree_util.tree_map_with_path(draw, pl)


def _batches():
    rng = np.random.default_rng(0)
    batches = [(rng.integers(0, 90, (4, 16)).astype(np.int32),
                rng.integers(0, 90, (4, 16)).astype(np.int32))
               for _ in range(3)]
    ids = np.random.default_rng(5).integers(0, 90, (4, 16)).astype(np.int32)
    # the dp shards' rows mask 12, 0, 5 and 15 of their 16 labels
    masked = np.arange(16)[None] < np.array([12, 0, 5, 15])[:, None]
    ignore = [(ids, np.where(masked, jtrain.IGNORE_INDEX, ids))] * 2
    return batches, ignore


def _jax_run(pl, spec, batches, mesh=None, impl="psum"):
    """The JAX Trainer's losses, one train_step a batch."""
    cfg = jtrain.TrainConfig(**CFG)
    if mesh is None:
        tr = jtrain.Trainer(pl, spec, cfg)
        return [tr.train_step(i, lab) for i, lab in batches]
    with parallel_context(mesh, ep_impl=impl):
        tr = jtrain.Trainer(pl, spec, cfg, mesh=mesh)
        return [tr.train_step(i, lab) for i, lab in batches]


def _jax_grads(pl, spec, batch):
    """(loss, LoRA gradients by name) on the single device."""
    lora, base = jlora.split_lora(pl)
    ids, labels = (jnp.asarray(b) for b in batch)
    loss, g = jax.jit(jax.value_and_grad(lambda lo: jtrain.loss_fn(
        jlora.merge_lora_params(lo, base), spec, ids, labels,
        jnp.float32)))(lora)
    return float(loss), jlora._flatten_lora(jax.device_get(g))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Start the ranks, compute the references meanwhile, join them; yields
    (rank outputs, references)."""
    tmp = str(tmp_path_factory.mktemp("parallel_sft"))
    spec_j, spec_t = jspec(dict(TINY_DS)), tspec(dict(TINY_DS))
    params = jinit_params(spec_j, seed=0, quant="bf16")
    pl, attn = _lora(params, spec_j), _lora(params, spec_j, ATTN)
    batches, ignore = _batches()
    data = dict(spec=spec_t, lora=params_from_jax(pl, spec_t, "cpu"),
                attn=params_from_jax(attn, spec_t, "cpu"), batches=batches,
                ignore_batches=ignore, ep_batches=batches[:2])
    torch.save(data, os.path.join(tmp, "inputs.pt"))
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=worker.run, args=(r, WORLD, tmp),
                         daemon=True) for r in range(WORLD)]
    for p in procs:
        p.start()
    try:
        ref = dict(
            dp_mesh=_jax_run(pl, spec_j, batches, jmake_mesh(4, 1, 2)),
            dp_single=_jax_run(pl, spec_j, batches),
            ignore_single=_jax_run(pl, spec_j, ignore),
            ep_psum=_jax_run(attn, spec_j, batches[:2], jmake_mesh(2, 2, 1)),
            ep_a2a=_jax_run(attn, spec_j, batches[:2], jmake_mesh(1, 2, 1),
                            "a2a"),
            grads=_jax_grads(pl, spec_j, batches[0]),
            ignore_grads=_jax_grads(pl, spec_j, ignore[0]),
            attn_grads=_jax_grads(attn, spec_j, batches[0]))
    finally:
        for p in procs:
            p.join(JOIN_S)
        hung = [r for r, p in enumerate(procs) if p.is_alive()]
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(5)
    errs = {r: open(os.path.join(tmp, f"err_{r}.txt")).read()
            for r in range(WORLD)
            if os.path.exists(os.path.join(tmp, f"err_{r}.txt"))}
    assert not hung, f"ranks {hung} still running after {JOIN_S} s"
    assert not errs, errs
    assert all(p.exitcode == 0 for p in procs), [p.exitcode for p in procs]
    outs = [torch.load(os.path.join(tmp, f"out_{r}.pt"), weights_only=False)
            for r in range(WORLD)]
    yield outs, ref


def _hold_grads(got: dict, want: dict):
    assert set(got) == set(want) and want
    for name, w in want.items():
        assert np.abs(w).max() > 0, name
        np.testing.assert_allclose(got[name], w, rtol=TOL,
                                   atol=TOL * np.abs(w).max(), err_msg=name)


def test_ranks_agree(runs):
    """Every rank returns the same losses, gradients and leaves: the
    gradients summed over dp, and over ep only where the experts' part
    of dx needs it."""
    outs, _ = runs
    for key, v in outs[0].items():
        if key.endswith(("moments", "collectives")):
            continue
        for r in range(1, WORLD):
            if isinstance(v, dict):
                for name in v:
                    np.testing.assert_array_equal(outs[r][key][name],
                                                  v[name], err_msg=key)
            else:
                assert outs[r][key] == v, key


def test_zero1_trainer_matches_jax_mesh_and_single_device(runs):
    outs, ref = runs
    got = outs[0]["dp/losses"]
    np.testing.assert_allclose(got, ref["dp_mesh"], rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got, ref["dp_single"], rtol=TOL, atol=TOL)
    assert got[-1] < got[0]


def test_zero1_gradients_match_single_device(runs):
    """The gradients summed over dp, clipped on their global norm, are the
    single device's."""
    outs, ref = runs
    loss, grads = ref["grads"]
    np.testing.assert_allclose(outs[0]["dp/loss0"], loss, rtol=TOL)
    _hold_grads(outs[0]["dp/grads0"], grads)


def test_zero1_moments_are_cut(runs):
    """Each rank keeps a quarter of the leading axis of every moment whose
    leading axis divides by 4 (the o_proj a factor [64, 4], every expert
    factor [4, ...]), the whole moment of the others; a collective a step
    gathers the stepped rows."""
    outs, _ = runs
    for out in outs:
        moments = out["dp/moments"]
        cut = [n for n, (m, t) in moments.items() if m[0] * 4 == t[0]]
        assert any("experts" in n for n in cut) and len(cut) >= 4, moments
        for n, (m, t) in moments.items():
            assert m == (t if t[0] % 4 else (t[0] // 4, *t[1:])), n
        # 4 steps (the gradient check, 3 train steps): the count and the
        # gradients summed, the loss returned; 3 all-gathers of the leaves
        assert out["dp/collectives"] == {
            ("all_reduce", "dp", "device"): 3 * 4,
            ("all_gather", "dp", "device"): 3}, out["dp/collectives"]


def test_global_masked_mean_over_unequal_ignored_labels(runs):
    """Rows of 4, 16, 11 and 1 scored labels on the four dp ranks: the loss
    is the global masked mean (the single device's), not the mean of the
    ranks' means."""
    outs, ref = runs
    np.testing.assert_allclose(outs[0]["ignore/losses"],
                               ref["ignore_single"], rtol=TOL, atol=TOL)
    loss, grads = ref["ignore_grads"]
    np.testing.assert_allclose(outs[0]["ignore/loss0"], loss, rtol=TOL)
    _hold_grads(outs[0]["ignore/grads0"], grads)


@pytest.mark.parametrize("tag", ["ep_psum", "ep_a2a"])
def test_attention_lora_under_ep_matches_jax(runs, tag):
    """Attention LoRA under expert parallelism: the losses equal the JAX
    trainer's on the same mesh, the gradients before the first step the
    single device's (neither scaled by ep nor missing the other ranks'
    experts)."""
    outs, ref = runs
    for out in outs:
        np.testing.assert_allclose(out[f"{tag}/losses"], ref[tag], rtol=TOL,
                                   atol=TOL)
        loss, grads = ref["attn_grads"]
        np.testing.assert_allclose(out[f"{tag}/loss0"], loss, rtol=TOL)
        _hold_grads(out[f"{tag}/grads0"], grads)
    coll = outs[0][f"{tag}/collectives"]
    # each step's backward sums the experts' part of dx and of the routing
    # weights over ep: one MoE layer, 3 passes
    assert coll[("all_reduce", "ep", "device")] >= 3 * 2, coll


def _one_rank_mesh(ep=1, tp=1):
    """Rank 0 of an ep x tp mesh, for the cuts alone (no process group)."""
    return Mesh({"dp": 1, "ep": ep, "tp": tp}, {"dp": 0, "ep": 0, "tp": 0},
                {"dp": None, "ep": None, "tp": None}, "cpu")


def test_refusals_match_the_jax_failures():
    """Expert LoRA under ep and any LoRA under tp: the JAX package fails on
    both trees (a TypeError inside its EP shard_map, a ValueError in its
    shard_params), the port refuses them with NotImplementedError naming
    that failure; on a mesh with neither, shard_params keeps the expert
    factors."""
    spec_j, spec_t = jspec(dict(TINY_DS)), tspec(dict(TINY_DS))
    params = jinit_params(spec_j, seed=0, quant="bf16")
    pl, attn = _lora(params, spec_j), _lora(params, spec_j, ATTN)
    batches, _ = _batches()
    with pytest.raises(TypeError, match="rhs group dimension"):
        _jax_run(pl, spec_j, batches[:1], jmake_mesh(1, 2, 1))
    with pytest.raises(ValueError, match="Expected dict"):
        jshard(attn, spec_j, jmake_mesh(1, 1, 2))
    with pytest.raises(NotImplementedError,
                       match="expert LoRA.*rhs group dimension"):
        Trainer(params_from_jax(pl, spec_t, "cpu"), spec_t,
                mesh=_one_rank_mesh(ep=2))
    with pytest.raises(NotImplementedError,
                       match="tensor parallelism.*Expected dict"):
        Trainer(params_from_jax(attn, spec_t, "cpu"), spec_t,
                mesh=_one_rank_mesh(tp=2))
    # a rank of a mesh with neither ep nor tp keeps the expert factors
    local = shard_params(params_from_jax(pl, spec_t, "cpu"), spec_t,
                         _one_rank_mesh())
    assert local["layers"][1]["moe"]["experts"].lora is not None
