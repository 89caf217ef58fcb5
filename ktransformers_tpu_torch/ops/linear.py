"""Quantized linear (counterpart of ktransformers_tpu/ops/linear.py).

Offset-lo int4_g weights go to the dense W4A8 kernel
(ops/cuda/w4a8_matmul.py) at every M, as W4A8_DENSE_MAX_M = 2^30 does in
the JAX package; bf16 weights take a plain matmul. int4_g weights must be
repacked first (quant/w4a8.enable_w4a8, which utils/device_prep.py
applies): their plain dequantizing product is the JAX package's
quant_matmul kernel, which is not ported yet.
"""

from __future__ import annotations

import torch

from ktransformers_tpu_torch.ops.cuda.w4a8_matmul import dense_w4a8_matmul
from ktransformers_tpu_torch.quant.formats import QTensor


def qmatmul(x: torch.Tensor, w: QTensor) -> torch.Tensor:
    """x [..., K] @ w (2-D QTensor [K, N]) -> [..., N] in x.dtype."""
    *lead, kdim = x.shape
    if w.kind == "bf16":
        return torch.matmul(x, w.data.to(x.dtype))
    if w.kind != "int4_g":
        raise ValueError(f"qmatmul: kind {w.kind!r} is not ported")
    if not w.act_quant:
        raise ValueError("qmatmul: int4_g weights must be repacked for W4A8 "
                         "first (quant.w4a8.enable_w4a8 / prepare_params)")
    y = dense_w4a8_matmul(x.reshape(-1, kdim).contiguous(), w)
    return y.reshape(*lead, w.out_features)


def linear(x: torch.Tensor, w: QTensor, bias: torch.Tensor | None = None):
    y = qmatmul(x, w)
    if bias is not None:
        y = y + bias.to(y.dtype)
    return y


def plinear(p: dict, key: str, x: torch.Tensor, bias=None):
    """linear() through a params dict. LoRA siblings are not ported and
    raise instead of being skipped."""
    if key + "_lora" in p:
        raise NotImplementedError(f"LoRA adapter {key}_lora is not ported")
    return linear(x, p[key], bias)
