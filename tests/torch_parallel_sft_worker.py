"""One rank of tests/test_torch_parallel_sft.py: imports torch and the port
only (no JAX). ``run(rank, world, tmp)`` reads the parent's inputs from
tmp/inputs.pt, joins a gloo process group through a file rendezvous in
tmp, runs every check below in the same order on every rank (each builds
its own meshes, and new_group wants every rank to make every group), and
writes its outputs (numpy arrays by name) to tmp/out_<rank>.pt, or its
traceback to tmp/err_<rank>.txt.
"""

import traceback

import numpy as np
import torch
import torch.distributed as dist

from ktransformers_tpu_torch.parallel.distributed import init_multihost
from ktransformers_tpu_torch.parallel.mesh import Mesh, make_mesh
from ktransformers_tpu_torch.sft.lora import lora_leaves
from ktransformers_tpu_torch.sft.train import TrainConfig, Trainer

TIMEOUT_S = 60


def replica_mesh(dp: int, ep: int, device="cpu") -> Mesh:
    """A (dp, ep, 1) mesh on each run of dp * ep consecutive ranks of a
    larger world (make_mesh takes the whole world): the runs repeat the
    same work."""
    world, rank = dist.get_world_size(), dist.get_rank()
    grid = np.arange(world).reshape(-1, dp, ep)
    groups = {"dp": None, "ep": None, "tp": None}
    for axis, dim, size in (("dp", 1, dp), ("ep", 2, ep)):
        if size == 1:
            continue
        for line in np.moveaxis(grid, dim, -1).reshape(-1, size):
            g = dist.new_group([int(r) for r in line])
            if rank in line:
                groups[axis] = g
    local = rank % (dp * ep)
    return Mesh({"dp": dp, "ep": ep, "tp": 1},
                {"dp": local // ep, "ep": local % ep, "tp": 0}, groups,
                device)


def _named(trainer, grads) -> dict:
    return {n: g.detach().numpy().copy()
            for (n, _), g in zip(lora_leaves(trainer.lora), grads)}


def trainer_run(data: dict, out: dict, tag: str, mesh: Mesh, params,
                batches, impl: str = "psum") -> None:
    """Into out[tag/...]: the gradients of the first batch before any step
    (loss_and_grads), the losses of one train_step a batch, the leaves
    after, the rows of the moments this rank keeps, the collectives."""
    cfg = TrainConfig(learning_rate=1e-3, remat=False)
    tr = Trainer(params, data["spec"], cfg, mesh=mesh, ep_impl=impl)
    loss, grads = tr.loss_and_grads(*batches[0])
    out[f"{tag}/loss0"], out[f"{tag}/grads0"] = loss, _named(tr, grads)
    out[f"{tag}/losses"] = [tr.train_step(i, lab) for i, lab in batches]
    out[f"{tag}/leaves"] = {n: t.detach().numpy().copy()
                            for n, t in lora_leaves(tr.lora)}
    out[f"{tag}/moments"] = {n: (tuple(m.shape), tuple(t.shape))
                             for (n, t), m in zip(lora_leaves(tr.lora),
                                                  tr.mu)}
    out[f"{tag}/collectives"] = dict(mesh.collectives)


def run(rank: int, world: int, tmp: str) -> None:
    torch.set_num_threads(1)
    try:
        data = torch.load(f"{tmp}/inputs.pt", weights_only=False)
        init_multihost(dp=world, ep=1, tp=1, backend="gloo",
                       init_method=f"file://{tmp}/rendezvous",
                       world_size=world, rank=rank, device="cpu",
                       timeout_s=TIMEOUT_S)
        out = {}
        dp4 = make_mesh(dp=world, device="cpu")
        trainer_run(data, out, "dp", dp4, data["lora"], data["batches"])
        trainer_run(data, out, "ignore", make_mesh(dp=world, device="cpu"),
                    data["lora"], data["ignore_batches"])
        for tag, (dp, ep), impl in (("ep_psum", (2, 2), "psum"),
                                    ("ep_a2a", (1, 2), "a2a")):
            trainer_run(data, out, tag, replica_mesh(dp, ep), data["attn"],
                        data["ep_batches"], impl)
        torch.save(out, f"{tmp}/out_{rank}.pt")
    except BaseException:
        with open(f"{tmp}/err_{rank}.txt", "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
