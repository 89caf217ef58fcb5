"""Starting the ranks of a multi-process run and building the global mesh
(counterpart of ktransformers_tpu/parallel/distributed.py, which starts
jax.distributed).

One process per rank, each calling

    mesh = init_multihost(dp=1, ep=2, tp=1, backend="nccl",
                          init_method="tcp://host0:29500",
                          world_size=2, rank=r)

The caller names the backend (nccl with one card a rank; gloo for ranks
that share a card or run on the CPU): it is never picked for them. On a
card each rank computes on cuda:<local rank % device count> unless
``device`` says otherwise. Without a world size above 1 no process group
is started and the mesh is 1 x 1 x 1.
"""

from __future__ import annotations

import datetime

import torch
import torch.distributed as dist

from ktransformers_tpu_torch.parallel.mesh import (
    Mesh,
    card_device,
    make_mesh,
)


def init_multihost(dp: int = 1, ep: int | None = None, tp: int = 1,
                   backend: str | None = None,
                   init_method: str | None = None,
                   world_size: int = 1, rank: int = 0,
                   device=None, timeout_s: float = 300.0) -> Mesh:
    """Start torch.distributed (when world_size > 1 and it is not started
    yet) and return this rank's (dp, ep, tp) mesh; ``ep`` None takes the
    ranks dp * tp leaves. ``timeout_s`` bounds the rendezvous and every
    collective."""
    start = world_size > 1 and not dist.is_initialized()
    if start and (backend is None or init_method is None):
        raise ValueError("a multi-process start needs its backend and "
                         "init_method named")
    if device is None:
        r = dist.get_rank() if dist.is_initialized() else rank
        device = card_device(r % max(torch.cuda.device_count(), 1))
    if start:
        dist.init_process_group(
            backend, init_method=init_method, world_size=world_size,
            rank=rank, timeout=datetime.timedelta(seconds=timeout_s))
    n = dist.get_world_size() if dist.is_initialized() else 1
    if ep is None:
        ep = n // (dp * tp)
    if dp * ep * tp != n:
        raise ValueError(f"dp={dp} x ep={ep} x tp={tp} != {n} ranks")
    if torch.device(device).type == "cuda":
        torch.cuda.set_device(device)
    return make_mesh(dp=dp, ep=ep, tp=tp, device=device)
