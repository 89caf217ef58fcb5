"""Continuous-batching serving with host-resident routed experts
(counterpart of ktransformers_tpu/offload/paged_engine.py).

``HostOffloadServeEngine`` is the ServeEngine over the tree of
offload/host_engine.py:offload_params: every model step (forward_paged,
and the fused mixed step forward_paged_mixed) runs unchanged, its MoE
layers computing the routed experts' FFN in C++ on the host through their
HostExperts. Scheduler, page allocator, prefix cache, preemption, spill and
sampling (with penalties) are the ServeEngine's. Each MoE layer's hop ends
in a wait on the card, so the decode pipeline depth is 1, as in the JAX
package; unlike the JAX package, a mixed batch takes the fused mixed step,
whose one pass makes one hop a layer for the decode batch and its prefill
chunks together.

The sparse page budget (``sparse_budget``, ``sparse_anchor``,
``sparse_retrieval``) works as in the ServeEngine: the summary planes
travel with the pools through the same forward_paged, so the offloaded
layers update them and select pages exactly as the resident ones do.
"""

from __future__ import annotations

import torch

from ktransformers_tpu_torch.models.spec import ModelSpec
from ktransformers_tpu_torch.offload.host_engine import offload_params
from ktransformers_tpu_torch.serving.engine import ServeEngine
from ktransformers_tpu_torch.serving.scheduler import SchedulerConfig


class HostOffloadServeEngine(ServeEngine):
    def __init__(self, params, spec: ModelSpec,
                 cfg: SchedulerConfig = SchedulerConfig(),
                 host_layers: dict | None = None,
                 transfer_dtype=torch.bfloat16, **kw):
        params, self.host = offload_params(params, spec, host_layers,
                                           transfer_dtype)
        super().__init__(params, spec, cfg, **kw)
        self.transfer_dtype = transfer_dtype
        # every MoE layer ends in a wait on the card: nothing to pipeline
        self.decode_pipeline_depth = 1
