"""One rank of tests/test_torch_pp.py: imports torch and the port only (no
JAX). ``run(rank, world, tmp)`` reads the parent's inputs from
tmp/inputs.pt, joins a gloo process group through a file rendezvous in
tmp, runs every check below in the same order on every rank (each builds
its own pp meshes, and new_group wants every rank to make every group),
and writes its outputs (numpy arrays by name) to tmp/out_<rank>.pt, or its
traceback to tmp/err_<rank>.txt.
"""

import datetime
import traceback

import numpy as np
import torch
import torch.distributed as dist

from ktransformers_tpu_torch.parallel.mesh import Mesh
from ktransformers_tpu_torch.parallel.pp import (
    AXIS_PP,
    make_pp_mesh,
    pipeline_apply,
    pipeline_llm_forward,
    place_stages,
    stack_stage_params,
)
from ktransformers_tpu_torch.sft.lora import (
    lora_leaves,
    merge_lora_params,
    split_lora,
)
from ktransformers_tpu_torch.sft.train import logits_nll

TIMEOUT_S = 60


def pp_mesh(stages: int) -> Mesh:
    """The pp axis of ``stages`` ranks: the whole world (make_pp_mesh), or
    each run of ``stages`` consecutive ranks of it, the runs repeating the
    same work. Every rank makes every run's group, as new_group wants."""
    world, rank = dist.get_world_size(), dist.get_rank()
    if stages == world:
        return make_pp_mesh(device="cpu")
    group = None
    for lo in range(0, world, stages):
        g = dist.new_group(list(range(lo, lo + stages)))
        if lo <= rank < lo + stages:
            group = g
    return Mesh({AXIS_PP: stages}, {AXIS_PP: rank % stages},
                {AXIS_PP: group}, "cpu")


def toy_layer(lp, x, extras):
    """tests/test_pp.py's _layer_fn: x + tanh(x @ w1) @ w2 * scale."""
    scale = extras["scale"] if extras else 1.0
    return x + torch.tanh(x @ lp["w1"]) @ lp["w2"] * scale


def toy_layers(case: dict, grad: bool = False) -> list:
    return [{k: torch.from_numpy(v).requires_grad_(grad)
             for k, v in lp.items()} for lp in case["layers"]]


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().to(torch.float32).numpy()


def _grads(mine: list) -> list:
    return [{k: _np(v.grad) for k, v in lp.items()} for lp in mine]


def toy_checks(data: dict, out: dict) -> None:
    """The toy stack forward at each (S, M), its gradient (stage
    parameters and x) under a mean-square loss, and under the sum of
    squares (every stage nonzero)."""
    for (stages, m), case in data["forward"].items():
        mesh = pp_mesh(stages)
        mine = place_stages(stack_stage_params(toy_layers(case), stages),
                            mesh)
        y = pipeline_apply(toy_layer, mine, torch.from_numpy(case["x"]),
                           mesh, extras={"scale": torch.tensor(1.5)})
        out[f"forward/{stages}/{m}"] = _np(y)
    for name in ("grad", "nonzero"):
        case = data[name]
        mesh = pp_mesh(case["stages"])
        mine = place_stages(stack_stage_params(
            toy_layers(case, grad=True), case["stages"]), mesh)
        x = torch.from_numpy(case["x"]).requires_grad_(True)
        y = pipeline_apply(toy_layer, mine, x, mesh)
        if name == "grad":
            loss = ((y - torch.from_numpy(case["tgt"])) ** 2).mean()
        else:
            loss = (y ** 2).sum()
        loss.backward()
        out[f"{name}/stage"] = _grads(mine)
        out[f"{name}/x"] = _np(x.grad)
        out[f"{name}/collectives"] = dict(mesh.collectives)


def llm_checks(data: dict, out: dict) -> None:
    """The Mixtral-shaped model pipelined over pp = 4 (2 microbatches):
    its logits, then with LoRA adapters the loss and this rank's stage's
    LoRA gradients."""
    mesh = make_pp_mesh(device="cpu")
    spec, tokens = data["spec"], torch.from_numpy(data["tokens"])
    logits = pipeline_llm_forward(data["params"], spec, tokens, mesh,
                                  microbatches=2, compute_dtype=torch.float32)
    out["llm/logits"] = _np(logits)
    lora, base = split_lora(data["params_lora"])
    params = merge_lora_params(lora, base)
    logits = pipeline_llm_forward(params, spec, tokens, mesh, microbatches=2,
                                  compute_dtype=torch.float32)
    total, count = logits_nll(logits, torch.from_numpy(data["labels"]))
    loss = total / count
    per = spec.num_layers // 4
    mine = [(n, t) for n, t in lora_leaves(lora)
            if int(n.split("/")[1]) // per == mesh.index("pp")]
    grads = torch.autograd.grad(loss, [t for _, t in mine])
    out["llm/loss"] = float(loss.detach())
    out["llm/grads"] = {n: _np(g) for (n, _), g in zip(mine, grads)}


def run(rank: int, world: int, tmp: str) -> None:
    torch.set_num_threads(1)
    try:
        data = torch.load(f"{tmp}/inputs.pt", weights_only=False)
        dist.init_process_group(
            "gloo", init_method=f"file://{tmp}/rendezvous",
            world_size=world, rank=rank,
            timeout=datetime.timedelta(seconds=TIMEOUT_S))
        out = {}
        toy_checks(data, out)
        llm_checks(data, out)
        torch.save(out, f"{tmp}/out_{rank}.pt")
    except BaseException:
        with open(f"{tmp}/err_{rank}.txt", "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
