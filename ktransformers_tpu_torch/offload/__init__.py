"""Routed experts in host memory (counterpart of ktransformers_tpu/offload):
serve MoE models whose experts do not fit the card.

- host_moe.py: the C++ expert FFN on the host (the port's own
  csrc/host_moe.cpp, built with g++ at first use) and its packer;
- host_engine.py: HostExperts, a MoE layer's experts computed on the host
  from inside the resident layer loop (ops/moe.py:moe_forward), and
  HostOffloadGenerator, the resident Generator over such layers;
- paged_engine.py: HostOffloadServeEngine, the same behind the ServeEngine;
- experts.py: experts kept on the host and streamed to the card each call.
"""

from ktransformers_tpu_torch.offload.experts import (
    OffloadedMoEWeights,
    offload_moe_weights,
)
from ktransformers_tpu_torch.offload.host_engine import (
    HostExperts,
    HostOffloadGenerator,
    offload_params,
    split_params_for_offload,
)
from ktransformers_tpu_torch.offload.host_moe import HostMoELayer
from ktransformers_tpu_torch.offload.paged_engine import (
    HostOffloadServeEngine,
)

__all__ = ["HostExperts", "HostMoELayer", "HostOffloadGenerator",
           "HostOffloadServeEngine", "OffloadedMoEWeights",
           "offload_moe_weights", "offload_params",
           "split_params_for_offload"]
