"""The (dp, ep, tp) grid of ranks (counterpart of
ktransformers_tpu/parallel/mesh.py).

Axes, as in the JAX package:
- ``dp``: data parallel, independent batches;
- ``ep``: expert parallel, the experts split over ranks, their outputs
  summed (or tokens dispatched to them: parallel/ep.py);
- ``tp``: tensor parallel, attention heads and MLP intermediate split over
  ranks (parallel/shardings.py).

World rank r sits at np.arange(dp * ep * tp).reshape(dp, ep, tp), the
JAX package's device order. ``make_mesh`` makes one process group per axis
line with torch.distributed.new_group, on the backend of the default
group: the caller's choice (gloo, or nccl with a card a rank), never
switched. Every rank creates every group, in the same order, as
new_group requires. A size-1 axis has no group and its collectives do
nothing. With no process group started, the only mesh is 1 x 1 x 1.

A rank computes on the card unless the caller names another device: with
no card, ``card_device`` raises rather than fall back to the CPU.
"""

from __future__ import annotations

import collections
import dataclasses

import numpy as np
import torch
import torch.distributed as dist

AXIS_DP = "dp"
AXIS_EP = "ep"
AXIS_TP = "tp"
AXES = (AXIS_DP, AXIS_EP, AXIS_TP)


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    dp: int = 1
    ep: int = 1
    tp: int = 1

    @property
    def num_devices(self) -> int:
        return self.dp * self.ep * self.tp


class Mesh:
    """This rank's place in the grid and its process group on each axis.

    ``shape`` {axis: size}; ``coords`` {axis: this rank's index};
    ``groups`` {axis: ProcessGroup or None}; ``device`` the torch device
    this rank computes on; ``collectives`` counts the calls of
    parallel/collectives.py by (op, axis, path), path "device" (the
    backend took the tensors where they lie) or "host" (a gloo group and
    a CUDA tensor of an op gloo has no CUDA path for: copied through host
    memory)."""

    def __init__(self, shape: dict, coords: dict, groups: dict, device):
        self.shape = dict(shape)
        self.coords = dict(coords)
        self.groups = dict(groups)
        self.device = torch.device(device)
        self.collectives = collections.Counter()

    def size(self, axis: str) -> int:
        return self.shape[axis]

    def index(self, axis: str) -> int:
        return self.coords[axis]

    def group(self, axis: str):
        return self.groups[axis]


def card_device(index: int | None = None) -> torch.device:
    """cuda (cuda:<index> where given): where a rank computes when its
    caller names no device. Raises where there is no card: the port never
    falls back to the CPU unless asked for it."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: a mesh computes on the card "
                           "unless it is given device=\"cpu\"")
    return torch.device("cuda", index) if index is not None \
        else torch.device("cuda")


def make_mesh(dp: int = 1, ep: int = 1, tp: int = 1, device=None) -> Mesh:
    """The mesh of this process: dp * ep * tp must be the world size of the
    started process group (1 without one). ``device``: where this rank
    computes (default: cuda; with no card, card_device raises)."""
    n = dp * ep * tp
    world = dist.get_world_size() if dist.is_initialized() else 1
    if n != world:
        raise ValueError(f"mesh {dp}x{ep}x{tp} needs {n} ranks, the process "
                         f"group has {world}")
    rank = dist.get_rank() if dist.is_initialized() else 0
    if device is None:
        device = card_device()
    shape = {AXIS_DP: dp, AXIS_EP: ep, AXIS_TP: tp}
    grid = np.arange(n).reshape(dp, ep, tp)
    coords = dict(zip(AXES, (int(c) for c in np.argwhere(grid == rank)[0])))
    groups = {}
    for i, axis in enumerate(AXES):
        groups[axis] = None
        if shape[axis] == 1:
            continue
        for line in np.moveaxis(grid, i, -1).reshape(-1, shape[axis]):
            ranks = [int(r) for r in line]
            g = dist.new_group(ranks)
            if rank in ranks:
                groups[axis] = g
    return Mesh(shape, coords, groups, device)
