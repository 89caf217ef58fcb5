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
A kernel matmul whose input needs a gradient goes through
ops/vjp.QuantMatmulFn (the transposed kernel in the backward), as the JAX
package's hooks call quant_matmul_diff.
"""

from __future__ import annotations

import torch

from ktransformers_tpu_torch.ops.cuda.quant_matmul import KINDS
from ktransformers_tpu_torch.ops.vjp import (
    QuantMatmulFn,
    kernel_matmul,
    needs_grad,
)
from ktransformers_tpu_torch.quant.formats import QTensor


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
    if w.kind == "bf16":
        return torch.matmul(x, w.data.to(x.dtype))
    if w.kind in KINDS:
        if needs_grad(x):
            return QuantMatmulFn.apply(x, w)
        return kernel_matmul(x, w)
    if w.kind in ("int8_g", "int8_gz"):
        return _int8_group_matmul(x, w)
    raise ValueError(f"qmatmul: unknown kind {w.kind!r}")


def linear(x: torch.Tensor, w: QTensor, bias: torch.Tensor | None = None):
    y = qmatmul(x, w)
    if bias is not None:
        y = y + bias.to(y.dtype)
    return y


def plinear(p: dict, key: str, x: torch.Tensor, bias=None):
    """linear() through a params dict, with the optional LoRA sibling
    "<key>_lora" = {"a": [K, r], "b": [r, N]} (alpha / r folded into a)
    added in float32, as ktransformers_tpu/models/model.py:plinear does."""
    y = linear(x, p[key], bias)
    lora = p.get(key + "_lora")
    if lora is not None:
        delta = (x.to(torch.float32) @ lora["a"].to(torch.float32)) \
            @ lora["b"].to(torch.float32)
        y = y + delta.to(y.dtype)
    return y
