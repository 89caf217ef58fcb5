"""Per-module placement rules (counterpart of ktransformers_tpu/placement):
regex-matched module paths assigned a quant kind and group size, read by
models/loading.build_params. The ``shard`` and ``offload`` keys are parsed
and not acted on, as in the JAX package's build_params."""

from ktransformers_tpu_torch.placement.spec import PlacementRule, PlacementSpec

__all__ = ["PlacementRule", "PlacementSpec"]
