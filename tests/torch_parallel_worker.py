"""One rank of tests/test_torch_parallel.py: imports torch and the port
only (no JAX). ``run(rank, world, tmp)`` reads the parent's inputs from
tmp/inputs.pt, joins a gloo process group through a file rendezvous in
tmp, runs every check below in the same order on every rank (each builds
its own meshes, and new_group wants every rank to make every group),
and writes its outputs (numpy arrays by name) to tmp/out_<rank>.pt, or
its traceback to tmp/err_<rank>.txt.
"""

import traceback

import numpy as np
import torch
import torch.distributed as dist

from ktransformers_tpu_torch.cache.paged import PagedKVCache
from ktransformers_tpu_torch.models.model import KVCache, forward
from ktransformers_tpu_torch.models.paged import forward_paged
from ktransformers_tpu_torch.ops.activations import ActivationConfig
from ktransformers_tpu_torch.ops.moe import MoEWeights
from ktransformers_tpu_torch.parallel.collectives import all_gather
from ktransformers_tpu_torch.parallel.context import parallel_context
from ktransformers_tpu_torch.parallel.distributed import init_multihost
from ktransformers_tpu_torch.parallel.ep import (
    moe_forward_ep,
    moe_forward_ep_a2a,
)
from ktransformers_tpu_torch.parallel.mesh import make_mesh
from ktransformers_tpu_torch.parallel.shardings import (
    batch_sharding,
    cache_shardings,
    rank_spec,
    shard_experts,
    shard_params,
)
from ktransformers_tpu_torch.quant.formats import quantize

ACT = ActivationConfig()
TIMEOUT_S = 60


def _weights(case: dict) -> MoEWeights:
    gu, dn = torch.from_numpy(case["gu"]), torch.from_numpy(case["dn"])
    w = MoEWeights(quantize(gu, case["kind"]), quantize(dn, case["kind"]))
    if case.get("l2p") is not None:
        from ktransformers_tpu_torch.utils.expert_placement import (
            reorder_expert_weights,
        )

        w = reorder_expert_weights(w, case["l2p"])
    return w


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().to(torch.float32).numpy()


def ep_checks(data: dict, out: dict) -> None:
    """The MoE call under EP on meshes of this world: ep = 4 (dp 1) and
    ep = 2 (dp 2)."""
    world = dist.get_world_size()
    meshes = {4: make_mesh(dp=1, ep=world, tp=1, device="cpu"),
              2: make_mesh(dp=world // 2, ep=2, tp=1, device="cpu")}
    for name, case in data["moe"].items():
        mesh = meshes[case["ep"]]
        w = shard_experts(_weights(case), mesh)
        x, idx, wts = (torch.from_numpy(case[k]) for k in ("x", "idx",
                                                          "wts"))
        for impl, kw in case["runs"]:
            if impl == "psum":
                y = moe_forward_ep(x, w, idx, wts, ACT, mesh)
            else:
                y = moe_forward_ep_a2a(x, w, idx, wts, ACT, mesh, **kw)
            out[f"{name}/{impl}/{sorted(kw.items())}"] = _np(y)
    out["collectives_ep"] = dict(meshes[4].collectives)


def _model_run(params, spec, mesh, tokens, impl="psum", chunks=1,
               decode=None):
    """The rank's logits of the tiny model under ``mesh`` gathered over dp
    (a 16-row cache; ``decode`` tokens [B, 1] run one step after)."""
    local = shard_params(params, spec, mesh)
    lspec = rank_spec(spec, mesh)
    rows = batch_sharding(mesh, tokens.shape[0])
    cache = cache_shardings(
        KVCache.create(spec, tokens.shape[0], 16, torch.float32, "cpu"),
        spec, mesh)
    with parallel_context(mesh, ep_impl=impl, ep_pipeline_chunks=chunks):
        logits, cache = forward(local, lspec, tokens[rows], cache,
                                compute_dtype=torch.float32)
        outs = [logits]
        if decode is not None:
            step, _ = forward(local, lspec, decode[rows], cache,
                              compute_dtype=torch.float32)
            outs.append(step)
    return [_np(all_gather(t, mesh, "dp", dim=0)) for t in outs]


def model_checks(data: dict, out: dict) -> None:
    """The tiny model's contiguous forward under dp / ep / tp meshes, the
    a2a path with pipelined chunks, a decode step, and the paged forward."""
    spec = data["spec"]
    tokens = torch.from_numpy(data["tokens"])
    decode = torch.from_numpy(data["decode"])
    for dims in ((1, 2, 2), (2, 2, 1), (2, 1, 2)):
        mesh = make_mesh(*dims, device="cpu")
        for kind in ("bf16", "int8"):
            full, step = _model_run(data[f"params_{kind}"], spec, mesh,
                                    tokens, decode=decode)
            out[f"model/{kind}/{dims}"] = full
            out[f"decode/{kind}/{dims}"] = step
        if dims == (1, 2, 2):
            out["collectives_model"] = dict(mesh.collectives)
    mesh = make_mesh(1, 2, 2, device="cpu")
    (out["a2a/(1, 2, 2)"],) = _model_run(
        data["params_bf16"], spec, mesh, torch.from_numpy(data["tokens8"]),
        impl="a2a", chunks=2)
    out["collectives_a2a"] = dict(mesh.collectives)
    ptok = torch.from_numpy(data["tokens8"])
    tables = torch.from_numpy(data["tables"])
    lengths = torch.zeros(2, dtype=torch.int32)
    for dims in ((1, 2, 2), (2, 2, 1)):
        mesh = make_mesh(*dims, device="cpu")
        local = shard_params(data["params_bf16"], spec, mesh)
        lspec = rank_spec(spec, mesh)
        kv = cache_shardings(PagedKVCache.create(
            spec, 8, 8, dtype=torch.float32, device="cpu"), spec, mesh)
        rows = batch_sharding(mesh, 2)
        with parallel_context(mesh):
            logits, _ = forward_paged(local, lspec, ptok[rows], kv,
                                      tables[rows], lengths[rows],
                                      compute_dtype=torch.float32)
        out[f"paged/{dims}"] = _np(all_gather(logits, mesh, "dp", dim=0))


def run(rank: int, world: int, tmp: str) -> None:
    torch.set_num_threads(1)
    try:
        data = torch.load(f"{tmp}/inputs.pt", weights_only=False)
        init_multihost(dp=1, ep=world, tp=1, backend="gloo",
                       init_method=f"file://{tmp}/rendezvous",
                       world_size=world, rank=rank, device="cpu",
                       timeout_s=TIMEOUT_S)
        out = {}
        ep_checks(data, out)
        model_checks(data, out)
        torch.save(out, f"{tmp}/out_{rank}.pt")
    except BaseException:
        with open(f"{tmp}/err_{rank}.txt", "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
