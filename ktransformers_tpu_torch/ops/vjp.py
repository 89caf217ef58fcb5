"""Input-gradient rules for the kernel matmuls (counterpart of
ktransformers_tpu/ops/pallas/vjp.py): LoRA SFT differentiates through the
CUDA kernels instead of stopping at them.

Each rule is a ``torch.autograd.Function`` whose forward is a kernel of the
inference path and whose backward runs the transposed kernels of
ops/cuda/quant_matmul_t.py. Only the input gets a gradient: the quantized
base weights (QTensors) are frozen, so they are plain arguments with none.
The two fused FFNs rematerialize their unfused composition in the backward
(the forward matmul again, the GLU in float32 as ``_glu_f32``, then the
transposed matmuls), as the JAX package's rules do: the forward's in-kernel
activation requant and the backward's composition differ by bf16 rounding,
the same approximation class as the rest of the frozen-base path.

``kernel_matmul`` picks the forward kernel of a 2-D weight: the W4A8
kernel for offset-lo int4_g weights (quant/w4a8.py), quant_matmul for
every other kind. The expert rules take their forward kernel from the
caller (ops/moe.py picks it the same way).
"""

from __future__ import annotations

import torch

from ktransformers_tpu_torch.ops.cuda.quant_matmul import quant_matmul
from ktransformers_tpu_torch.ops.cuda.quant_matmul_t import (
    gathered_quant_matmul_t,
    grouped_quant_matmul_t,
    quant_matmul_t,
)
from ktransformers_tpu_torch.ops.cuda.w4a8_ffn import (
    dense_w4a8_ffn,
    grouped_w4a8_ffn,
)
from ktransformers_tpu_torch.ops.cuda.w4a8_matmul import (
    dense_w4a8_matmul,
    grouped_w4a8_matmul,
)
from ktransformers_tpu_torch.quant.formats import QTensor
from ktransformers_tpu_torch.quant.w4a8 import W4A8_KINDS


def is_w4a8(w: QTensor) -> bool:
    """Repacked int4 weights, which the JAX package hands to its W4A8
    kernels."""
    return w.kind in W4A8_KINDS and w.act_quant


def kernel_matmul(x: torch.Tensor, w: QTensor) -> torch.Tensor:
    """x [..., K] @ a 2-D weight through its forward kernel."""
    if not is_w4a8(w):
        return quant_matmul(x, w)
    *lead, kdim = x.shape
    y = dense_w4a8_matmul(x.reshape(-1, kdim).contiguous(), w)
    return y.reshape(*lead, w.out_features)


def needs_grad(x: torch.Tensor) -> bool:
    """Whether a call on x must record a backward."""
    return torch.is_grad_enabled() and x.requires_grad


class QuantMatmulFn(torch.autograd.Function):
    """y = x @ w (row 1 or row 9); dx = dy @ w^T (row 16)."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.w = w
        return kernel_matmul(x, w)

    @staticmethod
    def backward(ctx, dy):
        if not ctx.needs_input_grad[0]:
            return None, None
        return quant_matmul_t(dy, ctx.w).to(dy.dtype), None


class GroupedQuantMatmulFn(torch.autograd.Function):
    """Rows sorted by expert through ``kernel`` (row 8 or row 11); dx per
    row through its expert's transpose (row 17)."""

    @staticmethod
    def forward(ctx, x_sorted, w, group_sizes, kernel):
        ctx.w = w
        ctx.save_for_backward(group_sizes)
        return kernel(x_sorted.contiguous(), w, group_sizes)

    @staticmethod
    def backward(ctx, dy):
        if not ctx.needs_input_grad[0]:
            return None, None, None, None
        (group_sizes,) = ctx.saved_tensors
        dx = grouped_quant_matmul_t(dy.contiguous(), ctx.w, group_sizes)
        return dx.to(dy.dtype), None, None, None


class GatheredQuantMatmulFn(torch.autograd.Function):
    """Row r through expert ids[r] by ``kernel`` (row 7 or row 10); dx
    through the gathered entry of row 17."""

    @staticmethod
    def forward(ctx, x_rows, w, ids, kernel):
        ctx.w = w
        ctx.save_for_backward(ids)
        return kernel(x_rows.contiguous(), w, ids)

    @staticmethod
    def backward(ctx, dy):
        if not ctx.needs_input_grad[0]:
            return None, None, None, None
        (ids,) = ctx.saved_tensors
        dx = gathered_quant_matmul_t(dy.contiguous(), ctx.w, ids)
        return dx.to(dy.dtype), None, None, None


def _glu_f32(h: torch.Tensor, inter: int, act: str) -> torch.Tensor:
    """The GLU of the FFN backward, in float32 (vjp.py:_glu_f32)."""
    g = h[..., :inter].to(torch.float32)
    u = h[..., inter:].to(torch.float32)
    if act == "silu":
        return g * torch.sigmoid(g) * u
    if act == "relu":
        return torch.clamp(g, min=0.0) * u
    if act == "gelu":
        return 0.5 * g * (1.0 + torch.erf(g / 2.0**0.5)) * u
    raise ValueError(act)


def _ffn_backward(h: torch.Tensor, dy: torch.Tensor, inter: int, act: str,
                  down_t, gate_up_t) -> torch.Tensor:
    """dx of y = down(glu(h)) with h the recomputed gate_up output: dy
    through the down transpose, the float32 GLU's own gradient, then the
    gate_up transpose."""
    da = down_t(dy).to(dy.dtype)
    with torch.enable_grad():
        hh = h.detach().requires_grad_(True)
        a = _glu_f32(hh, inter, act).to(h.dtype)
        (dh,) = torch.autograd.grad(a, hh, da)
    return gate_up_t(dh).to(dy.dtype)


class DenseW4A8FFNFn(torch.autograd.Function):
    """The fused dense FFN (row 3) of one 2-D expert; the backward
    recomputes h with row 1 and pulls dy through row 16 twice."""

    @staticmethod
    def forward(ctx, x2, gate_up, down, act):
        ctx.weights = (gate_up, down, act)
        ctx.save_for_backward(x2)
        return dense_w4a8_ffn(x2.contiguous(), gate_up, down, act)

    @staticmethod
    def backward(ctx, dy):
        if not ctx.needs_input_grad[0]:
            return None, None, None, None
        (x2,) = ctx.saved_tensors
        gu, dn, act = ctx.weights
        h = kernel_matmul(x2, gu)
        dx = _ffn_backward(h, dy.contiguous(), gu.out_features // 2, act,
                           lambda t: quant_matmul_t(t, dn),
                           lambda t: quant_matmul_t(t, gu))
        return dx, None, None, None


class GroupedW4A8FFNFn(torch.autograd.Function):
    """The fused FFN over rows sorted by expert (row 4); the backward
    recomputes h with row 8 and pulls dy through row 17 twice."""

    @staticmethod
    def forward(ctx, x_sorted, gate_up, down, group_sizes, act):
        ctx.weights = (gate_up, down, act)
        ctx.save_for_backward(x_sorted, group_sizes)
        return grouped_w4a8_ffn(x_sorted.contiguous(), gate_up, down,
                                group_sizes, act)

    @staticmethod
    def backward(ctx, dy):
        if not ctx.needs_input_grad[0]:
            return None, None, None, None, None
        x_sorted, sizes = ctx.saved_tensors
        gu, dn, act = ctx.weights
        h = grouped_w4a8_matmul(x_sorted.contiguous(), gu, sizes)
        dx = _ffn_backward(h, dy.contiguous(), gu.out_features // 2, act,
                           lambda t: grouped_quant_matmul_t(t, dn, sizes),
                           lambda t: grouped_quant_matmul_t(t, gu, sizes))
        return dx, None, None, None, None
