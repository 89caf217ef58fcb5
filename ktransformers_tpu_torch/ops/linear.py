"""Quantized linear (counterpart of ktransformers_tpu/ops/linear.py).

The dispatch the JAX package has with its Pallas hooks installed:
- bf16 weights take a plain matmul;
- offset-lo int4 weights (quant/w4a8.enable_w4a8, which
  utils/device_prep.py applies) go to the dense W4A8 kernel
  (ops/cuda/w4a8_matmul.py) at every M, as W4A8_DENSE_MAX_M = 2^30 does;
- every other kind of ops/cuda/quant_matmul.KINDS (int8, fp8, int4 kinds
  not repacked, mxfp4, mxfp8) goes to quant_matmul, the weight decoded
  inside the kernel;
- int8_g / int8_gz have no kernel in the JAX package either and run its
  plain group contraction.
"""

from __future__ import annotations

import torch

from ktransformers_tpu_torch.ops.cuda.quant_matmul import KINDS, quant_matmul
from ktransformers_tpu_torch.ops.cuda.w4a8_matmul import dense_w4a8_matmul
from ktransformers_tpu_torch.quant.formats import QTensor
from ktransformers_tpu_torch.quant.w4a8 import W4A8_KINDS


def _int8_group_matmul(x: torch.Tensor, w: QTensor) -> torch.Tensor:
    """int8_g / int8_gz: y[n] = sum_g s[g, n] * (x_g @ (q_g - z[g, n]))."""
    g = w.group_size
    k, n = w.data.shape
    *lead, _ = x.shape
    xr = x.reshape(-1, k // g, g).to(torch.float32)
    q = w.data.to(torch.float32).reshape(k // g, g, n)
    part = torch.einsum("tGg,GgN->tGN", xr, q)
    if w.kind.endswith("_gz"):
        part = part - xr.sum(dim=-1)[..., None] * w.zeros[: k // g][None]
    y = (part * w.scales[: k // g][None]).sum(dim=1)
    return y.reshape(*lead, n).to(x.dtype)


def qmatmul(x: torch.Tensor, w: QTensor) -> torch.Tensor:
    """x [..., K] @ w (2-D QTensor [K, N]) -> [..., N] in x.dtype."""
    *lead, kdim = x.shape
    if w.kind == "bf16":
        return torch.matmul(x, w.data.to(x.dtype))
    if w.kind in W4A8_KINDS and w.act_quant:
        y = dense_w4a8_matmul(x.reshape(-1, kdim).contiguous(), w)
        return y.reshape(*lead, w.out_features)
    if w.kind in KINDS:
        return quant_matmul(x, w)
    if w.kind in ("int8_g", "int8_gz"):
        return _int8_group_matmul(x, w)
    raise ValueError(f"qmatmul: unknown kind {w.kind!r}")


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
