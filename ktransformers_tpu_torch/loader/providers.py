"""Weight providers (counterpart of ktransformers_tpu/loader/providers.py):
``get(name)`` over HF-style tensor names. Only the in-memory torch source
is ported; the safetensors and GGUF providers belong to ROADMAP Queue 1
item 5b."""

from __future__ import annotations

import numpy as np
import torch

from ktransformers_tpu_torch.models.loading import WeightProvider


class TorchModelProvider(WeightProvider):
    """The parameters and buffers of any torch.nn.Module under their
    ``named_parameters()`` / ``named_buffers()`` names (an HF model's are
    the HF tensor names), read as float32 numpy arrays."""

    def __init__(self, model: torch.nn.Module):
        self._sd = dict(model.named_parameters())
        self._sd.update(dict(model.named_buffers()))

    def get(self, name: str) -> np.ndarray:
        if name not in self._sd:
            raise KeyError(name)
        return self._sd[name].detach().to("cpu").float().numpy()
