"""The collectives the parallel layers call, over one axis of a Mesh.

Each takes the tensor where it lies. NCCL groups and every CPU tensor go
to the backend as they are. A gloo group takes CUDA tensors for all-reduce
(and broadcast) only, so for its other ops (all-gather, all-to-all, the
send / receive of ring_shift) a CUDA tensor is copied to host memory,
exchanged there and copied back: that is how ranks that share one card
(NCCL refuses two ranks on one device) run the model's kernels on the card
and exchange through the host. The path is decided by the group's backend,
never by a failed call, and each call is counted in mesh.collectives by
(op, axis, path).

Sums are taken in float32 (a bf16 partial is widened first and the sum
rounded back once), so the result does not depend on whether the backend
sums bf16 natively. A size-1 axis returns its input.

A call on a tensor that needs a gradient (grad mode on) records one, as
jax.grad through the JAX package's shard_map collectives gives it, every
rank of the axis holding the same cotangent of a replicated result:
- all_reduce (the sum of the ranks' partial results): the identity;
- grad_all_reduce (a replicated tensor entering a region whose partial
  results are summed: forward the identity): the all-reduce;
- all_gather: this rank's slice of the cotangent;
- all_to_all: the all-to-all of the cotangent;
- ring_shift (to the next rank of the axis, from the previous one): the
  shift the other way.
Without a gradient each is the plain collective, bit for bit.
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


def _records_grad(t: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and t.requires_grad


def _all_reduce(t: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    g = mesh.group(axis)
    _count(mesh, "all_reduce", axis, _path("all_reduce", t, g))
    out = t.to(torch.float32, copy=True).contiguous()
    dist.all_reduce(out, group=g)
    return out.to(t.dtype)


def _all_gather(t: torch.Tensor, mesh: Mesh, axis: str,
                dim: int) -> torch.Tensor:
    g = mesh.group(axis)
    path = _path("all_gather", t, g)
    _count(mesh, "all_gather", axis, path)
    src = (t.cpu() if path == "host" else t).contiguous()
    parts = [torch.empty_like(src) for _ in range(mesh.size(axis))]
    dist.all_gather(parts, src, group=g)
    return torch.cat(parts, dim=dim).to(t.device)


def _all_to_all(t: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    g = mesh.group(axis)
    path = _path("all_to_all", t, g)
    _count(mesh, "all_to_all", axis, path)
    src = (t.cpu() if path == "host" else t).contiguous()
    out = torch.empty_like(src)
    dist.all_to_all_single(out, src, group=g)
    return out.to(t.device)


def _ring_shift(t: torch.Tensor, mesh: Mesh, axis: str,
                step: int) -> torch.Tensor:
    g = mesh.group(axis)
    n, i = mesh.size(axis), mesh.index(axis)
    path = _path("send_recv", t, g)
    _count(mesh, "send_recv", axis, path)
    src = (t.cpu() if path == "host" else t).contiguous()
    out = torch.empty_like(src)
    # each send paired with its receive in one call: a blocking send on
    # every rank of the ring would wait forever
    works = dist.batch_isend_irecv([
        dist.P2POp(dist.isend, src, dist.get_global_rank(g, (i + step) % n),
                   g),
        dist.P2POp(dist.irecv, out, dist.get_global_rank(g, (i - step) % n),
                   g)])
    for w in works:
        w.wait()
    return out.to(t.device)


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, axis):
        return _all_reduce(t, mesh, axis)

    @staticmethod
    def backward(ctx, dy):
        return dy, None, None


class _GradAllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return t.view_as(t)

    @staticmethod
    def backward(ctx, dy):
        return _all_reduce(dy, ctx.mesh, ctx.axis), None, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, axis, dim):
        ctx.dim, ctx.n = dim, t.shape[dim]
        ctx.start = mesh.index(axis) * ctx.n
        return _all_gather(t, mesh, axis, dim)

    @staticmethod
    def backward(ctx, dy):
        return dy.narrow(ctx.dim, ctx.start, ctx.n), None, None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return _all_to_all(t, mesh, axis)

    @staticmethod
    def backward(ctx, dy):
        return _all_to_all(dy, ctx.mesh, ctx.axis), None, None


class _RingShift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, axis, step):
        ctx.mesh, ctx.axis, ctx.step = mesh, axis, step
        return _ring_shift(t, mesh, axis, step)

    @staticmethod
    def backward(ctx, dy):
        return (_ring_shift(dy, ctx.mesh, ctx.axis, -ctx.step), None, None,
                None)


def all_reduce(t: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """The sum of t over the ranks of ``axis`` (a new tensor, t's dtype)."""
    if mesh.size(axis) == 1:
        return t
    if _records_grad(t):
        return _AllReduce.apply(t, mesh, axis)
    return _all_reduce(t, mesh, axis)


def grad_all_reduce(t: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """t itself, whose gradient is summed over the ranks of ``axis``: the
    entry of a tensor that every rank holds whole into a computation whose
    partial results all_reduce sums (each rank's share of the gradient is
    then partial too)."""
    if mesh.size(axis) == 1 or not _records_grad(t):
        return t
    return _GradAllReduce.apply(t, mesh, axis)


def all_gather(t: torch.Tensor, mesh: Mesh, axis: str,
               dim: int = -1) -> torch.Tensor:
    """The ranks' t of ``axis`` concatenated along ``dim``, in rank order."""
    if mesh.size(axis) == 1:
        return t
    if _records_grad(t):
        return _AllGather.apply(t, mesh, axis, dim)
    return _all_gather(t, mesh, axis, dim)


def all_to_all(t: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """t [S, ...] with S = the axis size: slab i goes to rank i of the axis;
    returns [S, ...] whose slab i came from rank i."""
    if mesh.size(axis) == 1:
        return t
    if _records_grad(t):
        return _AllToAll.apply(t, mesh, axis)
    return _all_to_all(t, mesh, axis)


def ring_shift(t: torch.Tensor, mesh: Mesh, axis: str,
               step: int = 1) -> torch.Tensor:
    """t sent to rank (i + step) mod S of ``axis`` and the t of rank
    (i - step) mod S received, every rank at once (the pipeline's hop,
    parallel/pp.py)."""
    if mesh.size(axis) == 1:
        return t
    if _records_grad(t):
        return _RingShift.apply(t, mesh, axis, step)
    return _ring_shift(t, mesh, axis, step)


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
