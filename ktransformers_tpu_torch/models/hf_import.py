"""Params from an in-memory HF torch model (counterpart of
ktransformers_tpu/models/hf_import.py): name translation and the MLA
kv_b absorption through models/loading.build_params. The port never
imports ``transformers``: any torch.nn.Module whose parameters carry the
HF names will do."""

from __future__ import annotations

from ktransformers_tpu_torch.loader.providers import TorchModelProvider
from ktransformers_tpu_torch.models.loading import build_params
from ktransformers_tpu_torch.models.spec import ModelSpec


def params_from_hf(model, spec: ModelSpec, quant: str = "bf16",
                   moe_quant: str | None = None, group_size: int = 128,
                   device="cuda"):
    """The params tree of ``model`` on ``device``."""
    return build_params(TorchModelProvider(model), spec, quant=quant,
                        moe_quant=moe_quant, group_size=group_size,
                        device=device)
