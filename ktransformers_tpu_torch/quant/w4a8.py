"""W4A8: int4 weights x int8 activations.

Counterpart of ktransformers_tpu/quant/w4a8.py. Every packed byte
b = (lo & 15) | (hi << 4) is repacked as b ^ 0x08 and stored as int8, so
braw = 16*hi + (lo + 8) and u = braw & 15 = lo + 8. With split activations
a := x_lo - x_hi/16 and b := x_hi/16, each int8-quantized per (row, group)
on its own scale:

    a @ u + b @ braw = x_lo*lo + x_hi*hi + 8*sum(x_lo)

so two int8 dots per group and one correction term give the int4 product
without dequantized weights (ops/cuda/w4a8_matmul.py).
"""

from __future__ import annotations

import dataclasses

import torch

from ktransformers_tpu_torch.quant.formats import QTensor, split_x_for_int4

W4A8_KINDS = ("int4", "int4_g", "int4_gz")


def repack_offset_lo(qt: QTensor) -> QTensor:
    """Offset-lo repack of an int4 QTensor, IN PLACE: the bytes are flipped
    where they lie (so resident weight bytes never double) and qt itself
    becomes the repacked tensor (data viewed as int8, act_quant=True).
    Returns qt. A second call finds act_quant set and changes nothing."""
    if qt.act_quant or qt.kind not in W4A8_KINDS:
        return qt
    if qt.data.dtype != torch.uint8:
        raise ValueError(
            f"repack_offset_lo: want uint8 data, got {qt.data.dtype}")
    qt.data.bitwise_xor_(8)
    qt.data = qt.data.view(torch.int8)
    qt.act_quant = True
    return qt


def enable_w4a8(params):
    """Repack every int4-kind QTensor in a params tree (dicts, lists and
    objects with QTensor fields) for the W4A8 kernels, in place (see
    repack_offset_lo). Idempotent: the caller's tree is the repacked one."""

    def visit(node):
        if isinstance(node, QTensor):
            return repack_offset_lo(node)
        if isinstance(node, dict):
            return {k: visit(v) for k, v in node.items()}
        if isinstance(node, list):
            return [visit(v) for v in node]
        if dataclasses.is_dataclass(node) and not isinstance(node, type):
            return dataclasses.replace(
                node,
                **{f.name: visit(getattr(node, f.name))
                   for f in dataclasses.fields(node)},
            )
        return node

    return visit(params)


def _quant_rows(v: torch.Tensor):
    """Int8 quantization over the last axis: (codes int8, scale f32)."""
    amax = torch.clamp(v.abs().amax(dim=-1), min=1e-8)
    s = amax / 127.0
    codes = torch.clamp(torch.round(v / s[..., None]), -127, 127)
    return codes.to(torch.int8), s


def w4a8_prep(x2: torch.Tensor, kdim: int, group_size: int):
    """Quantize activations x2 [M, K] for the W4A8 kernels.

    Returns (qa, qb int8 [M, K/2], sa, sb f32 [M, ng], t f32 [M, ng] =
    8*sum_g(x_lo), xsum f32 [M, ng] = sum_g(x))."""
    m = x2.shape[0]
    gs = group_size or kdim
    ng = kdim // gs
    gs2 = gs // 2
    xl, xh = split_x_for_int4(x2, kdim, group_size)
    xlf = xl.to(torch.float32).reshape(m, ng, gs2)
    xhf = xh.to(torch.float32).reshape(m, ng, gs2)
    qa, sa = _quant_rows(xlf - xhf / 16.0)
    qb, sb = _quant_rows(xhf / 16.0)
    t = 8.0 * xlf.sum(dim=-1)
    xsum = (xlf + xhf).sum(dim=-1)
    return qa.reshape(m, kdim // 2), qb.reshape(m, kdim // 2), sa, sb, t, xsum
