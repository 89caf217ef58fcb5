"""Parallelism over process groups in the port (ktransformers_tpu_torch/
parallel/) against the JAX package's sharded runs: expert parallelism
(psum and all-to-all: exact, pipelined, overflow dropped, a prefix of
experts on each shard, a remap), the tiny DeepSeek model under dp / ep /
tp meshes (contiguous forward and a decode step, the a2a path with
pipelined chunks, the paged forward), and that no mesh falls back to the
CPU. Mirrors tests/test_parallel.py (pipeline parallelism is
tests/test_torch_pp.py's, training over ranks
tests/test_torch_parallel_sft.py's).

One spawn of WORLD = 4 gloo CPU ranks (tests/torch_parallel_worker.py,
which imports no JAX and runs one torch thread) does every port check,
rendezvousing through a file under tmp_path (never a port: xdist runs
files side by side); the parent hands it the inputs (numpy and the port's
CPU params) and, while the ranks run, computes the JAX references on the
8-device virtual CPU mesh of tests/conftest.py and the port's
single-device results. Every join has a timeout, and a rank that fails or
hangs fails the module's tests.

Tolerances: as tests/test_parallel.py holds the JAX package, 1e-5 for the
bf16-kind EP call against the single device, 1e-4 for the int8 kind and
the a2a paths (another order of float32 sums), 2e-4 for the model's
logits; the port's sharded runs are held to its own single-device run and
to the JAX sharded run at the same tolerance.
"""

import multiprocessing
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from ktransformers_tpu.cache.paged import PagedKVCache as JPaged
from ktransformers_tpu.models.init import init_params as jinit_params
from ktransformers_tpu.models.model import KVCache as JKVCache
from ktransformers_tpu.models.model import forward as jforward
from ktransformers_tpu.models.paged import forward_paged as jforward_paged
from ktransformers_tpu.models.spec import spec_from_hf_config as jspec
from ktransformers_tpu.ops.gate import GateConfig, route
from ktransformers_tpu.ops.moe import MoEConfig, MoEWeights, moe_forward
from ktransformers_tpu.parallel.context import parallel_context
from ktransformers_tpu.parallel.mesh import make_mesh
from ktransformers_tpu.parallel.shardings import (
    batch_sharding,
    cache_shardings,
    param_shardings,
)
from ktransformers_tpu.quant.formats import quantize
from ktransformers_tpu.utils.expert_placement import (
    balanced_logical_to_physical,
)

from ktransformers_tpu_torch.cache.paged import PagedKVCache
from ktransformers_tpu_torch.convert import params_from_jax
from ktransformers_tpu_torch.models import model as tmodel
from ktransformers_tpu_torch.models.init import init_params_synthetic
from ktransformers_tpu_torch.models.paged import forward_paged
from ktransformers_tpu_torch.ops.moe import moe_forward as tmoe_forward
from ktransformers_tpu_torch.models.spec import spec_from_hf_config as tspec

from tests import torch_parallel_worker as worker
from tests.test_generate import TINY_DS
from tests.test_torch_model import one_torch_thread  # noqa: F401 (fixture)

WORLD = 4
JOIN_S = 120
MESHES = ((1, 2, 2), (2, 2, 1), (2, 1, 2))
# EP cases also held to the JAX package's single-device call (the rest to
# the port's, which the port's MoE tests hold to the JAX package)
JAX_MOE_REFS = ("matches_single", "remap")


def _moe_case(rng, e, d, f, k, t, kind, ep, runs, norm=False, idx=None,
              wts=None, x=None, l2p=None):
    gu = rng.standard_normal((e, d, 2 * f)).astype(np.float32)
    dn = rng.standard_normal((e, f, d)).astype(np.float32)
    scale = 0.1 if d == 32 and idx is not None else 0.05
    gu, dn = gu * scale, dn * scale
    if x is None:
        x = rng.standard_normal((t, d)).astype(np.float32)
    if idx is None:
        logits = rng.standard_normal((t, e)).astype(np.float32)
        i, w = route(jnp.asarray(logits), GateConfig(
            num_experts=e, top_k=k, norm_topk_prob=norm))
        idx, wts = np.asarray(i), np.asarray(w)
    return dict(gu=gu, dn=dn, kind=kind, ep=ep, runs=runs, x=x,
                idx=np.asarray(idx, np.int32),
                wts=np.asarray(wts, np.float32), l2p=l2p)


def _moe_cases():
    rng = np.random.default_rng(0)
    psum = [("psum", {})]
    cases = {
        "matches_single": _moe_case(rng, 16, 64, 96, 4, 32, "bf16", 4, psum,
                                    norm=True),
        "quantized": _moe_case(rng, 8, 64, 64, 2, 8, "int8", 4, psum),
        "prefix": _moe_case(rng, 8, 32, 32, 2, 4, "bf16", 2, psum,
                            x=np.ones((4, 32), np.float32),
                            idx=[[i, i + 4] for i in range(4)],
                            wts=np.full((4, 2), 0.5)),
        "a2a_exact": _moe_case(
            rng, 16, 64, 96, 4, 32, "bf16", 4,
            [("a2a", {"capacity_factor": 8.0}), ("a2a", {})]
            + [("a2a", {"pipeline_chunks": c}) for c in (2, 3, 4)],
            norm=True),
        "overflow": _moe_case(
            rng, 8, 32, 48, 2, 16, "bf16", 2,
            [("a2a", {"capacity_factor": 0.5}),
             ("a2a", {"capacity_factor": 16.0})],
            idx=np.tile([[0, 1]], (16, 1)), wts=np.full((16, 2), 0.5)),
    }
    remap = _moe_case(rng, 16, 64, 96, 4, 32, "int8", 4,
                      psum + [("a2a", {"capacity_factor": 8.0})])
    remap["l2p"] = balanced_logical_to_physical(rng.random(16), ep_size=4)
    assert not np.array_equal(remap["l2p"], np.arange(16))
    cases["remap"] = remap
    return cases


def _jax_moe(case):
    w = MoEWeights(gate_up=quantize(jnp.asarray(case["gu"]), case["kind"]),
                   down=quantize(jnp.asarray(case["dn"]), case["kind"]))
    return w, (jnp.asarray(case[k]) for k in ("x", "idx", "wts"))


def _port_moe(case):
    """The single-device port call of an EP case."""
    w = worker._weights(dict(case, l2p=None))
    return tmoe_forward(torch.tensor(case["x"]), w,
                        torch.tensor(case["idx"]),
                        torch.tensor(case["wts"])).numpy()


def _jax_model(jp, spec, tokens, mesh=None, **ctx):
    cache = JKVCache.create(spec, tokens.shape[0], 16, dtype=jnp.float32)
    fn = jax.jit(lambda p, t, c: jforward(p, spec, t, c,
                                          compute_dtype=jnp.float32))
    if mesh is None:
        return np.asarray(fn(jp, jnp.asarray(tokens), cache)[0])
    put = lambda tree, sh: jax.tree.map(jax.device_put, tree, sh)  # noqa
    p_sh = put(jp, param_shardings(jp, spec, mesh))
    c_sh = put(cache, cache_shardings(cache, spec, mesh))
    tok = jax.device_put(jnp.asarray(tokens), batch_sharding(mesh))
    with mesh, parallel_context(mesh, **ctx):
        return np.asarray(fn(p_sh, tok, c_sh)[0])


def _jax_paged(jp, spec, tokens, tables, mesh=None):
    kv = JPaged.create(spec, num_pages=8, page_size=8, dtype=jnp.float32)
    lengths = jnp.zeros((2,), jnp.int32)
    fn = jax.jit(lambda p, t, k, pt, ln: jforward_paged(
        p, spec, t, k, pt, ln, compute_dtype=jnp.float32))
    args = [jp, jnp.asarray(tokens), kv, jnp.asarray(tables), lengths]
    if mesh is None:
        return np.asarray(fn(*args)[0])
    repl = NamedSharding(mesh, P())
    dp2 = NamedSharding(mesh, P("dp", None))
    args = [jax.tree.map(jax.device_put, jp, param_shardings(jp, spec, mesh)),
            jax.device_put(args[1], dp2),
            jax.tree.map(lambda x: jax.device_put(x, repl)
                         if hasattr(x, "shape") else x, kv),
            jax.device_put(args[3], dp2),
            jax.device_put(lengths, NamedSharding(mesh, P("dp")))]
    with mesh, parallel_context(mesh):
        return np.asarray(fn(*args)[0])


def _port_model(params, spec, tokens, decode):
    cache = tmodel.KVCache.create(spec, 2, 16, torch.float32, "cpu")
    logits, cache = tmodel.forward(params, spec, torch.from_numpy(tokens),
                                   cache, compute_dtype=torch.float32)
    step, _ = tmodel.forward(params, spec, torch.from_numpy(decode), cache,
                             compute_dtype=torch.float32)
    return logits.numpy(), step.numpy()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Start the ranks, compute the references meanwhile, join them; yields
    (rank outputs, references)."""
    tmp = str(tmp_path_factory.mktemp("parallel"))
    rng = np.random.default_rng(0)
    spec_j, spec_t = jspec(dict(TINY_DS)), tspec(dict(TINY_DS))
    jparams = {"bf16": jinit_params(spec_j, seed=0, quant="bf16")}
    data = dict(
        params_int8=init_params_synthetic(spec_t, seed=0, quant="int8",
                                          dtype=torch.float32, device="cpu"),
        moe=_moe_cases(), spec=spec_t,
        tokens=rng.integers(0, 96, (2, 10)),
        decode=np.random.default_rng(1).integers(0, 96, (2, 1)),
        tokens8=np.random.default_rng(0).integers(0, 96, (2, 8)),
        tables=1 + np.arange(4, dtype=np.int32).reshape(2, 2),
        params_bf16=params_from_jax(jax.device_get(jparams["bf16"]), spec_t,
                                    "cpu"))
    torch.save(data, os.path.join(tmp, "inputs.pt"))
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=worker.run, args=(r, WORLD, tmp),
                         daemon=True) for r in range(WORLD)]
    for p in procs:
        p.start()
    try:
        ref = {}
        for name, case in data["moe"].items():
            ref[f"moe/{name}"] = _port_moe(case)
            if name in JAX_MOE_REFS:
                w, (x, idx, wts) = _jax_moe(case)
                ref[f"jax_moe/{name}"] = np.asarray(moe_forward(
                    x, w, idx, wts, MoEConfig()))
        for kind in ("bf16", "int8"):
            ref[f"port/{kind}"], ref[f"port_decode/{kind}"] = _port_model(
                data[f"params_{kind}"], spec_t, data["tokens"],
                data["decode"])
        ref["jax_sharded"] = _jax_model(jparams["bf16"], spec_j,
                                        data["tokens"], make_mesh(2, 2, 2))
        ref["jax_a2a_model"] = _jax_model(
            jparams["bf16"], spec_j, data["tokens8"], make_mesh(1, 4, 2),
            ep_impl="a2a", ep_pipeline_chunks=2)
        ref["port_8"], _ = _port_model(data["params_bf16"], spec_t,
                                       data["tokens8"], data["decode"])
        ref["jax_paged"] = _jax_paged(jparams["bf16"], spec_j,
                                      data["tokens8"], data["tables"],
                                      make_mesh(2, 2, 2))
        kv = PagedKVCache.create(spec_t, 8, 8, dtype=torch.float32,
                                 device="cpu")
        ref["port_paged"] = forward_paged(
            data["params_bf16"], spec_t, torch.from_numpy(data["tokens8"]),
            kv, torch.from_numpy(data["tables"]),
            torch.zeros(2, dtype=torch.int32),
            compute_dtype=torch.float32)[0].numpy()
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


def _close(got, want, tol):
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


def test_ranks_agree(runs):
    """Every rank holds the same (gathered) result of every check."""
    outs, _ = runs
    for key, v in outs[0].items():
        if key.startswith("collectives"):
            continue
        for r in range(1, WORLD):
            np.testing.assert_array_equal(outs[r][key], v, err_msg=key)


def test_moe_forward_ep_matches_single(runs):
    out, ref = runs[0][0], runs[1]
    got = out["matches_single/psum/[]"]
    _close(got, ref["moe/matches_single"], 1e-5)
    _close(got, ref["jax_moe/matches_single"], 1e-5)


def test_moe_forward_ep_quantized(runs):
    out, ref = runs[0][0], runs[1]
    _close(out["quantized/psum/[]"], ref["moe/quantized"], 1e-4)


def test_ep_with_prefix_of_experts_on_each_shard(runs):
    out, ref = runs[0][0], runs[1]
    _close(out["prefix/psum/[]"], ref["moe/prefix"], 1e-5)


def test_ep_with_logical_to_physical_remap(runs):
    """The remap applies to the global ids before the shard localises them,
    on both EP paths."""
    out, ref = runs[0][0], runs[1]
    for key in ("remap/psum/[]", "remap/a2a/[('capacity_factor', 8.0)]"):
        _close(out[key], ref["moe/remap"], 1e-4)
        _close(out[key], ref["jax_moe/remap"], 1e-4)


def test_moe_forward_ep_a2a_exact(runs):
    out, ref = runs[0][0], runs[1]
    got = out["a2a_exact/a2a/[('capacity_factor', 8.0)]"]
    _close(got, ref["moe/a2a_exact"], 1e-4)


@pytest.mark.parametrize("chunks", [2, 3, 4])
def test_moe_forward_ep_a2a_pipelined_exact(runs, chunks):
    """Pipelined chunks change the schedule only: equal to the unchunked
    drop-free call and to the single device."""
    out, ref = runs[0][0], runs[1]
    got = out[f"a2a_exact/a2a/[('pipeline_chunks', {chunks})]"]
    _close(got, out["a2a_exact/a2a/[]"], 1e-5)
    _close(got, ref["moe/a2a_exact"], 1e-4)


def test_moe_forward_ep_a2a_drops_overflow(runs):
    out, ref = runs[0][0], runs[1]
    assert np.isfinite(out["overflow/a2a/[('capacity_factor', 0.5)]"]).all()
    _close(out["overflow/a2a/[('capacity_factor', 16.0)]"],
           ref["moe/overflow"], 1e-4)


@pytest.mark.parametrize("dims", MESHES)
@pytest.mark.parametrize("kind", ["bf16", "int8"])
def test_full_model_sharded_matches_unsharded(runs, dims, kind):
    """dp / ep / tp meshes of 4 ranks: the logits equal the single-device
    port and, on the JAX package's weights (bf16), its (2, 2, 2) sharded
    run; int8 per-channel weights are cut at any row."""
    out, ref = runs[0][0], runs[1]
    got = out[f"model/{kind}/{dims}"]
    _close(got, ref[f"port/{kind}"], 2e-4)
    if kind == "bf16":
        _close(got, ref["jax_sharded"], 2e-4)


@pytest.mark.parametrize("dims", MESHES)
@pytest.mark.parametrize("kind", ["bf16", "int8"])
def test_decode_step_sharded_matches_unsharded(runs, dims, kind):
    out, ref = runs[0][0], runs[1]
    _close(out[f"decode/{kind}/{dims}"], ref[f"port_decode/{kind}"], 2e-4)


def test_full_model_a2a_pipelined_matches_unsharded(runs):
    out, ref = runs[0][0], runs[1]
    got = out["a2a/(1, 2, 2)"]
    _close(got, ref["port_8"], 2e-4)
    _close(got, ref["jax_a2a_model"], 2e-4)


@pytest.mark.parametrize("dims", [(1, 2, 2), (2, 2, 1)])
def test_paged_forward_sharded_matches_unsharded(runs, dims):
    out, ref = runs[0][0], runs[1]
    got = out[f"paged/{dims}"]
    _close(got, ref["port_paged"], 2e-4)
    _close(got, ref["jax_paged"], 2e-4)


def test_collectives_of_each_layer(runs):
    """Under ep x tp the layers sum over tp (o_proj, every MLP) and ep, and
    gather the logits over tp; the a2a path exchanges over ep; CPU tensors
    on gloo take the device path (no host copy)."""
    out = runs[0][0]
    model = out["collectives_model"]
    # 2 layers, a prefill and a decode step, two weight kinds
    assert model[("all_reduce", "tp", "device")] == 2 * 2 * 2 * 2
    assert model[("all_reduce", "ep", "device")] == 1 * 2 * 2
    assert model[("all_gather", "tp", "device")] == 2 * 2
    assert not any(path == "host" for _, _, path in model)
    a2a = out["collectives_a2a"]
    # one MoE layer, two chunks: rows and ids out, results back
    assert a2a[("all_to_all", "ep", "device")] == 3 * 2
    assert a2a[("all_gather", "ep", "device")] == 1
    assert out["collectives_ep"][("all_reduce", "ep", "device")] == 3


def test_single_process_mesh_and_refusals():
    """Without a process group the mesh is 1 x 1 x 1 and its collectives
    return their input; a larger mesh, a multi-process start without a
    named backend and an unknown EP implementation raise."""
    from ktransformers_tpu_torch.parallel import collectives
    from ktransformers_tpu_torch.parallel.context import ParallelContext
    from ktransformers_tpu_torch.parallel.distributed import init_multihost
    from ktransformers_tpu_torch.parallel.mesh import make_mesh as tmesh

    mesh = init_multihost(device="cpu")
    assert mesh.shape == {"dp": 1, "ep": 1, "tp": 1}
    t = torch.arange(6.0).reshape(2, 3)
    assert collectives.all_reduce(t, mesh, "tp") is t
    assert collectives.all_gather(t, mesh, "ep") is t
    assert not mesh.collectives
    with pytest.raises(ValueError, match="needs 2 ranks"):
        tmesh(tp=2, device="cpu")
    with pytest.raises(ValueError, match="backend"):
        init_multihost(ep=2, world_size=2, rank=0)
    with pytest.raises(ValueError, match="ep_impl"):
        ParallelContext(mesh, ep_impl="ring")


def test_no_cpu_fallback(monkeypatch):
    """Without a device the meshes compute on the card: make_mesh and
    make_pp_mesh on cuda, init_multihost on cuda:<rank % device count>.
    With no card each raises rather than fall back to the CPU, and
    init_multihost starts no process group."""
    import torch.distributed as dist

    from ktransformers_tpu_torch.parallel import distributed
    from ktransformers_tpu_torch.parallel.mesh import make_mesh as tmesh
    from ktransformers_tpu_torch.parallel.pp import make_pp_mesh

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (tmesh, make_pp_mesh, distributed.init_multihost):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        distributed.init_multihost(ep=2, backend="gloo",
                                   init_method="file:///nonexistent",
                                   world_size=2, rank=1)
    assert not dist.is_initialized()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    picked = []
    monkeypatch.setattr(torch.cuda, "set_device", picked.append)
    assert tmesh().device == torch.device("cuda")
    assert make_pp_mesh().device == torch.device("cuda")
    assert distributed.init_multihost().device == torch.device("cuda", 0)
    assert picked == [torch.device("cuda", 0)]
