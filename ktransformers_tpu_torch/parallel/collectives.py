"""The collectives the parallel layers call, over one axis of a Mesh.

Each takes the tensor where it lies. NCCL groups and every CPU tensor go
to the backend as they are. A gloo group takes CUDA tensors for all-reduce
(and broadcast) only, so for its other ops (all-gather, all-to-all) a
CUDA tensor is copied to host memory, exchanged there and copied back:
that is how ranks that share one card (NCCL refuses two ranks on one
device) run the model's kernels on the card and exchange through the
host. The path is decided by the group's backend, never by a failed
call, and each call is counted in mesh.collectives by (op, axis, path).

Sums are taken in float32 (a bf16 partial is widened first and the sum
rounded back once), so the result does not depend on whether the backend
sums bf16 natively. A size-1 axis returns its input.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ktransformers_tpu_torch.parallel.context import get_parallel_context
from ktransformers_tpu_torch.parallel.mesh import AXIS_TP, Mesh

def _path(op: str, t: torch.Tensor, group) -> str:
    """"host" for a CUDA tensor on a gloo group in an op other than
    all-reduce (gloo's CUDA path), else "device"."""
    if t.is_cuda and dist.get_backend(group) == "gloo" \
            and op != "all_reduce":
        return "host"
    return "device"


def _count(mesh: Mesh, op: str, axis: str, path: str) -> None:
    mesh.collectives[(op, axis, path)] += 1


def all_reduce(t: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """The sum of t over the ranks of ``axis`` (a new tensor, t's dtype)."""
    if mesh.size(axis) == 1:
        return t
    g = mesh.group(axis)
    path = _path("all_reduce", t, g)
    _count(mesh, "all_reduce", axis, path)
    out = t.to(torch.float32, copy=True).contiguous()
    dist.all_reduce(out, group=g)
    return out.to(t.dtype)


def all_gather(t: torch.Tensor, mesh: Mesh, axis: str,
               dim: int = -1) -> torch.Tensor:
    """The ranks' t of ``axis`` concatenated along ``dim``, in rank order."""
    if mesh.size(axis) == 1:
        return t
    g = mesh.group(axis)
    path = _path("all_gather", t, g)
    _count(mesh, "all_gather", axis, path)
    src = (t.cpu() if path == "host" else t).contiguous()
    parts = [torch.empty_like(src) for _ in range(mesh.size(axis))]
    dist.all_gather(parts, src, group=g)
    return torch.cat(parts, dim=dim).to(t.device)


def all_to_all(t: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """t [S, ...] with S = the axis size: slab i goes to rank i of the axis;
    returns [S, ...] whose slab i came from rank i."""
    if mesh.size(axis) == 1:
        return t
    g = mesh.group(axis)
    path = _path("all_to_all", t, g)
    _count(mesh, "all_to_all", axis, path)
    src = (t.cpu() if path == "host" else t).contiguous()
    out = torch.empty_like(src)
    dist.all_to_all_single(out, src, group=g)
    return out.to(t.device)


def tp_all_reduce(y: torch.Tensor) -> torch.Tensor:
    """y summed over the tensor-parallel ranks of the current context (each
    holds a row-parallel product's partial sum), or y without one."""
    ctx = get_parallel_context()
    if ctx is None or ctx.tp_size == 1:
        return y
    return all_reduce(y, ctx.mesh, AXIS_TP)


def tp_all_gather(y: torch.Tensor) -> torch.Tensor:
    """The column-parallel slices of y's last axis gathered over the
    tensor-parallel ranks of the current context, or y without one."""
    ctx = get_parallel_context()
    if ctx is None or ctx.tp_size == 1:
        return y
    return all_gather(y, ctx.mesh, AXIS_TP, dim=-1)
