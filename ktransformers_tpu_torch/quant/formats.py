"""Quantized tensor container and the int4_g quantize/dequantize transforms.

Counterpart of ktransformers_tpu/quant/formats.py, limited to the formats
the ported path uses: ``bf16`` (plain) and ``int4_g`` (symmetric int4 with a
float32 scale per group of K rows). Packed bytes are bit-identical to the
JAX package's.

Weights are stored [..., K, N] (in_features, out_features). int4 values are
nibble-packed along K with the *group-split* convention: within each scale
group of ``group_size`` rows, the low nibble holds the first half of the
group's rows and the high nibble the second half (see pack_int4).
"""

from __future__ import annotations

import dataclasses

import torch

INT4_KINDS = ("int4", "int4_g", "int4_gz", "mxfp4")


def pack_int4(q: torch.Tensor, group_size: int = 0) -> torch.Tensor:
    """Pack ints in [-8, 7] along axis -2 (K): [..., K, N] -> uint8
    [..., K/2, N], group-split nibbles (0 = the whole K axis is one group)."""
    *lead, k, n = q.shape
    gs = group_size or k
    if k % gs or gs % 2:
        raise ValueError(f"pack_int4: K={k} not a multiple of even group {gs}")
    q = q.to(torch.int32) & 0xF
    qg = q.reshape(*lead, k // gs, gs, n)
    lo = qg[..., : gs // 2, :]
    hi = qg[..., gs // 2 :, :]
    return (lo | (hi << 4)).to(torch.uint8).reshape(*lead, k // 2, n)


def unpack_int4(packed: torch.Tensor, group_size: int = 0) -> torch.Tensor:
    """Inverse of pack_int4: uint8 [..., K/2, N] -> int8 [..., K, N],
    sign-extended."""
    *lead, k2, n = packed.shape
    k = k2 * 2
    gs = group_size or k
    b = packed.to(torch.int32).reshape(*lead, k // gs, gs // 2, n)
    lo = ((b & 0xF) ^ 8) - 8
    hi = (((b >> 4) & 0xF) ^ 8) - 8
    out = torch.cat([lo, hi], dim=-2)
    return out.reshape(*lead, k, n).to(torch.int8)


def split_x_for_int4(x: torch.Tensor, k: int, group_size: int = 0):
    """Split activation columns to match the group-split packing: returns
    (x_lo, x_hi), each [..., K/2]."""
    *lead, xk = x.shape
    if xk != k:
        raise ValueError(f"split_x_for_int4: x has {xk} columns, want {k}")
    gs = group_size or k
    xg = x.reshape(*lead, k // gs, gs)
    x_lo = xg[..., : gs // 2].reshape(*lead, k // 2)
    x_hi = xg[..., gs // 2 :].reshape(*lead, k // 2)
    return x_lo, x_hi


def effective_group_size(k: int, group_size: int) -> int:
    """Largest even divisor of K that is <= the requested group size,
    preferring multiples of 16 (K=10944 -> 96, not 114)."""
    g0 = min(group_size, k)
    g = g0
    while g >= 16 and (k % g != 0 or g % 16 != 0):
        g -= 1
    if g >= 16:
        return g
    g = g0
    while g > 2 and (k % g != 0 or g % 2 != 0):
        g -= 1
    return max(g, 2)


@dataclasses.dataclass
class QTensor:
    """A (possibly) quantized weight.

    data:   packed storage [..., K/2, N] (int4 kinds) or [..., K, N].
    scales: None (bf16) or float32 [..., K/G, N] per-group scales.
    zeros:  None; kept for layout parity with the JAX container.
    kind:   format tag.
    group_size: rows per scale group (0 = per channel).
    act_quant: int4 data is in the W4A8 offset-lo encoding (byte ^ 0x08,
      stored as int8; quant/w4a8.repack_offset_lo).
    """

    data: torch.Tensor
    scales: torch.Tensor | None
    zeros: torch.Tensor | None = None
    kind: str = "bf16"
    group_size: int = 0
    act_quant: bool = False

    @property
    def out_features(self) -> int:
        return self.data.shape[-1]

    @property
    def in_features(self) -> int:
        k = self.data.shape[-2]
        return k * 2 if self.kind in INT4_KINDS else k

    def to(self, device) -> "QTensor":
        mv = lambda t: None if t is None else t.to(device)  # noqa: E731
        return dataclasses.replace(
            self, data=mv(self.data), scales=mv(self.scales),
            zeros=mv(self.zeros),
        )


def quantize(w: torch.Tensor, kind: str, group_size: int = 128) -> QTensor:
    """Quantize a float weight [..., K, N] (``bf16``/``f32`` or ``int4_g``)."""
    if kind in ("bf16", "f32"):
        dt = torch.bfloat16 if kind == "bf16" else torch.float32
        return QTensor(w.to(dt), None, None, kind="bf16", group_size=0)
    if kind != "int4_g":
        raise ValueError(f"quantize: kind {kind!r} is not ported")
    group_size = effective_group_size(w.shape[-2], group_size)
    wf = w.to(torch.float32)
    *lead, k, n = wf.shape
    g = wf.reshape(*lead, k // group_size, group_size, n)
    absmax = g.abs().amax(dim=-2, keepdim=True)
    scales = torch.clamp(absmax, min=1e-10) / 7.0
    q = torch.clamp(torch.round(g / scales), -7, 7)
    data = pack_int4(q.reshape(*lead, k, n), group_size)
    return QTensor(data, scales.squeeze(-2), None, kind="int4_g",
                   group_size=group_size)


def raw_int4_data(qt: QTensor) -> torch.Tensor:
    """Packed int4 data in the canonical uint8 encoding (undoes the
    offset-lo repack when qt.act_quant is set)."""
    if qt.act_quant:
        return qt.data.view(torch.uint8) ^ 8
    return qt.data


def dequantize(qt: QTensor, dtype=torch.bfloat16) -> torch.Tensor:
    """Dense float tensor [..., K, N]."""
    if qt.kind == "bf16" or qt.scales is None:
        return qt.data.to(dtype)
    if qt.kind != "int4_g":
        raise ValueError(f"dequantize: kind {qt.kind!r} is not ported")
    q = unpack_int4(raw_int4_data(qt), qt.group_size).to(torch.float32)
    *lead, k, n = q.shape
    gs = qt.group_size
    g = q.reshape(*lead, k // gs, gs, n)
    out = g * qt.scales[..., : k // gs, :].unsqueeze(-2)
    return out.reshape(*lead, k, n).to(dtype)
