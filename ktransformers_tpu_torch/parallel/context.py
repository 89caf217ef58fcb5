"""Process-wide parallel context: which mesh the model forward uses
(counterpart of ktransformers_tpu/parallel/context.py).

The model code (models/model.py, models/paged.py) reads it: with a context
whose ep axis has more than one rank, MoE layers go through parallel/ep.py
("psum": every rank computes its experts for every token and the ranks sum;
"a2a": tokens dispatched to the rank that holds their expert, when the
token count divides by ep), and with tp ranks the row-parallel products are
summed and the logits gathered over tp. Without a context (or at size 1)
nothing changes. The JAX context's ``use_ep`` has no counterpart: each rank
here holds only its shard of the experts, so a context with ep ranks always
dispatches over ep.
"""

from __future__ import annotations

import contextlib
import dataclasses

from ktransformers_tpu_torch.parallel.mesh import AXIS_EP, AXIS_TP, Mesh

EP_IMPLS = ("psum", "a2a")


@dataclasses.dataclass
class ParallelContext:
    mesh: Mesh
    # "psum": masked local compute + all-reduce (decode: the weights stay
    # put, the activations are on every rank anyway); "a2a": token dispatch
    # to the expert's rank (large prefill: activation traffic ~T*d)
    ep_impl: str = "psum"
    # > 1: the a2a path splits its capacity axis into this many chunks,
    # each dispatch -> experts -> combine in turn (parallel/ep.py)
    ep_pipeline_chunks: int = 1

    def __post_init__(self):
        if self.ep_impl not in EP_IMPLS:
            raise ValueError(f"ep_impl {self.ep_impl!r}: one of {EP_IMPLS}")
        if self.ep_pipeline_chunks < 1:
            raise ValueError("ep_pipeline_chunks must be at least 1")

    @property
    def ep_size(self) -> int:
        return self.mesh.size(AXIS_EP)

    @property
    def tp_size(self) -> int:
        return self.mesh.size(AXIS_TP)


_CURRENT: ParallelContext | None = None


def set_parallel_context(ctx: ParallelContext | None) -> None:
    global _CURRENT
    _CURRENT = ctx


def get_parallel_context() -> ParallelContext | None:
    return _CURRENT


@contextlib.contextmanager
def parallel_context(mesh: Mesh, ep_impl: str = "psum",
                     ep_pipeline_chunks: int = 1):
    prev = _CURRENT
    set_parallel_context(ParallelContext(
        mesh=mesh, ep_impl=ep_impl, ep_pipeline_chunks=ep_pipeline_chunks))
    try:
        yield
    finally:
        set_parallel_context(prev)
