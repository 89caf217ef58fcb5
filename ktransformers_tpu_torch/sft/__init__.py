"""LoRA SFT of quantized MoE models (counterpart of ktransformers_tpu/sft):
adapters beside the frozen quantized base (lora.py), a trainer whose
backward runs the transposed CUDA kernels (train.py, ops/vjp.py), and the
JSON instruction dataset (data.py)."""

from ktransformers_tpu_torch.sft.lora import (
    LoRAConfig,
    init_lora,
    load_lora,
    merge_lora_params,
    save_lora,
    split_lora,
)
from ktransformers_tpu_torch.sft.train import TrainConfig, Trainer

__all__ = [
    "LoRAConfig",
    "init_lora",
    "merge_lora_params",
    "split_lora",
    "save_lora",
    "load_lora",
    "TrainConfig",
    "Trainer",
]
