"""Quantized tensor container and the quantize/dequantize transforms.

Counterpart of ktransformers_tpu/quant/formats.py, every format:

| kind        | storage [..., K(/2), N]     | scales                        |
|-------------|-----------------------------|-------------------------------|
| ``bf16``    | bf16 / f32                  | none                          |
| ``int8``    | int8                        | f32 [..., 1, N] per channel   |
| ``int4``    | uint8, two nibbles a byte   | f32 [..., 1, N] per channel   |
| ``int4_g``  | uint8 packed                | f32 [..., K/G, N] per group   |
| ``int4_gz`` | uint8 packed                | per group f32 + zero points   |
| ``int8_g``  | int8                        | f32 [..., K/G, N] per group   |
| ``fp8``     | float8_e4m3fn               | f32 [..., 1, N] per channel   |
| ``mxfp4``   | uint8 e2m1 nibble codes     | uint8 ue8m0 [..., K/32, N]    |
| ``mxfp8``   | float8_e4m3fn               | uint8 ue8m0 [..., K/32, N]    |

Packed bytes, scales, zero points and exponents are bit-identical to the
JAX package's for the same input. One difference in decoding: a ue8m0
exponent e stands for the exact power of two 2^(e - 127) built from the
float's bits (``ue8m0_to_scale``); e = 0 gives 0.0, which is what the JAX
package's exp2 gives on the CPU too (it flushes 2^-127), while its exp2 of
the other exponents is off the exact power by up to 4e-6.

Weights are stored [..., K, N] (in_features, out_features). int4 values are
nibble-packed along K with the *group-split* convention: within each scale
group of ``group_size`` rows, the low nibble holds the first half of the
group's rows and the high nibble the second half (see pack_int4).
"""

from __future__ import annotations

import dataclasses
import math

import torch

INT_QMAX = {"int8": 127.0, "int4": 7.0, "int4_g": 7.0}
INT4_KINDS = ("int4", "int4_g", "int4_gz", "mxfp4")
GROUP_KINDS = ("int4_g", "int4_gz", "int8_g", "int8_gz", "mxfp4", "mxfp8")
MX_GROUP = 32  # OCP MX block: 32 scalars share one ue8m0 scale

# E2M1 magnitudes by the 3 magnitude bits, and the midpoints between them
E2M1_VALUES = (0.0, 0.5, 1.0, 1.5, 2.0, 3.0, 4.0, 6.0)
_E2M1_MIDPOINTS = (0.25, 0.75, 1.25, 1.75, 2.5, 3.5, 5.0)


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


def unpack_uint4(packed: torch.Tensor, group_size: int = 0) -> torch.Tensor:
    """Like unpack_int4 without sign extension: uint8 codes in [0, 15]
    [..., K, N] (mxfp4 e2m1 codes are sign + magnitude)."""
    *lead, k2, n = packed.shape
    k = k2 * 2
    gs = group_size or k
    b = packed.to(torch.int32).reshape(*lead, k // gs, gs // 2, n)
    out = torch.cat([b & 0xF, (b >> 4) & 0xF], dim=-2)
    return out.reshape(*lead, k, n).to(torch.uint8)


def e2m1_decode(codes: torch.Tensor) -> torch.Tensor:
    """uint8 e2m1 codes [0, 15] -> float32 values (code 8 + m = -value(m))."""
    table = torch.tensor(E2M1_VALUES + tuple(-v for v in E2M1_VALUES),
                         dtype=torch.float32, device=codes.device)
    return table[codes.to(torch.int64)]


def e2m1_encode(v: torch.Tensor) -> torch.Tensor:
    """float -> nearest e2m1 code (uint8 in [0, 15]); |v| > 6 saturates."""
    mag = v.abs()
    code = torch.zeros(v.shape, dtype=torch.int32, device=v.device)
    for m in _E2M1_MIDPOINTS:
        code = code + (mag >= m).to(torch.int32)
    return (code + torch.where(v < 0, 8, 0)).to(torch.uint8)


def ue8m0_scale_exponent(absmax: torch.Tensor, elem_max: float) -> torch.Tensor:
    """Shared power-of-two block scale of the MX formats as a biased uint8
    exponent: E = floor(log2(absmax)) - floor(log2(elem_max)), saturating.
    The floors are taken from the float's own exponent (frexp), so they are
    exact at powers of two."""
    safe = torch.clamp(absmax.to(torch.float32), min=1e-30)
    e = (torch.frexp(safe).exponent - 1) - (math.frexp(elem_max)[1] - 1)
    return torch.clamp(e + 127, 0, 254).to(torch.uint8)


def ue8m0_to_scale(exp_u8: torch.Tensor) -> torch.Tensor:
    """uint8 exponents -> float32 2^(e - 127), from the bits e << 23 (what
    the kernels do): exact for e in 1..254, 0.0 for e = 0, inf for 255."""
    return (exp_u8.to(torch.int32) << 23).view(torch.float32)


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
    scales: None (bf16) | float32 [..., 1, N] per channel | float32
      [..., K/G, N] per group | uint8 ue8m0 exponents [..., K/32, N] (MX
      kinds). The group axis may be longer than K/G (padded rows of the JAX
      package's pad_scale_sublanes); readers slice to true_group_count.
    zeros:  None | per-group zero points in quantized units, shaped like
      scales (``int4_gz``).
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


def true_group_count(qt: QTensor) -> int:
    """Number of real scale groups along K (scales may hold more rows)."""
    k = qt.in_features
    return k // (qt.group_size or k)


def _group_reshape(w: torch.Tensor, group_size: int) -> torch.Tensor:
    """[..., K, N] -> [..., K/G, G, N]"""
    *lead, k, n = w.shape
    if k % group_size:
        raise ValueError(f"K={k} is not a multiple of group {group_size}")
    return w.reshape(*lead, k // group_size, group_size, n)


def quantize(w: torch.Tensor, kind: str, group_size: int = 128) -> QTensor:
    """Quantize a float weight [..., K, N] into the given format."""
    if kind in ("bf16", "f32"):
        dt = torch.bfloat16 if kind == "bf16" else torch.float32
        return QTensor(w.to(dt), None, None, kind="bf16", group_size=0)
    wf = w.to(torch.float32)
    *lead, k, n = wf.shape
    if kind in ("int8", "int4"):
        qmax = INT_QMAX[kind]
        absmax = wf.abs().amax(dim=-2, keepdim=True)
        scales = torch.clamp(absmax, min=1e-10) / qmax
        q = torch.clamp(torch.round(wf / scales), -qmax, qmax)
        data = q.to(torch.int8) if kind == "int8" else pack_int4(q)
        return QTensor(data, scales, None, kind=kind, group_size=0)
    if kind == "fp8":
        # float8_e4m3fn with a per-out-channel scale; largest finite 448
        absmax = wf.abs().amax(dim=-2, keepdim=True)
        scales = torch.clamp(absmax, min=1e-10) / 448.0
        return QTensor((wf / scales).to(torch.float8_e4m3fn), scales, None,
                       kind=kind, group_size=0)
    if kind in ("int4_g", "int4_gz", "int8_g"):
        group_size = effective_group_size(k, group_size)
        g = _group_reshape(wf, group_size)
        if kind == "int4_gz":
            # asymmetric: q = round(w / s) + z in [0, 15], stored as q - 8
            wmin = g.amin(dim=-2, keepdim=True)
            wmax = g.amax(dim=-2, keepdim=True)
            scales = torch.clamp(wmax - wmin, min=1e-10) / 15.0
            zeros = torch.round(-wmin / scales)
            q = torch.clamp(torch.round(g / scales) + zeros, 0, 15) - 8
            return QTensor(pack_int4(q.reshape(*lead, k, n), group_size),
                           scales.squeeze(-2), (zeros - 8).squeeze(-2),
                           kind=kind, group_size=group_size)
        qmax = 7.0 if kind == "int4_g" else 127.0
        absmax = g.abs().amax(dim=-2, keepdim=True)
        scales = torch.clamp(absmax, min=1e-10) / qmax
        q = torch.clamp(torch.round(g / scales), -qmax, qmax).reshape(
            *lead, k, n)
        data = pack_int4(q, group_size) if kind == "int4_g" \
            else q.to(torch.int8)
        return QTensor(data, scales.squeeze(-2), None, kind=kind,
                       group_size=group_size)
    if kind in ("mxfp4", "mxfp8"):
        # OCP MX: e2m1 nibble codes / e4m3fn elements with one ue8m0
        # power-of-two scale per 32-scalar block along K
        group_size = effective_group_size(k, MX_GROUP)
        g = _group_reshape(wf, group_size)
        absmax = g.abs().amax(dim=-2, keepdim=True)
        exp_u8 = ue8m0_scale_exponent(absmax, 6.0 if kind == "mxfp4"
                                      else 448.0)
        v = g / ue8m0_to_scale(exp_u8)
        if kind == "mxfp4":
            data = pack_int4(e2m1_encode(v).reshape(*lead, k, n), group_size)
        else:  # saturating: e4m3fn has no inf
            data = torch.clamp(v, -448.0, 448.0).to(
                torch.float8_e4m3fn).reshape(*lead, k, n)
        return QTensor(data, exp_u8.squeeze(-2), None, kind=kind,
                       group_size=group_size)
    raise ValueError(f"unknown quant kind: {kind}")


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
    if qt.kind in ("int8", "fp8"):
        return (qt.data.to(torch.float32) * qt.scales).to(dtype)
    if qt.kind == "int4":
        q = unpack_int4(raw_int4_data(qt), qt.group_size).to(torch.float32)
        return (q * qt.scales).to(dtype)
    if qt.kind in GROUP_KINDS:
        if qt.kind == "mxfp4":
            q = e2m1_decode(unpack_uint4(qt.data, qt.group_size))
        elif qt.kind.startswith("int4"):
            q = unpack_int4(raw_int4_data(qt), qt.group_size).to(
                torch.float32)
        else:
            q = qt.data.to(torch.float32)
        g = _group_reshape(q, qt.group_size)
        kg = g.shape[-3]  # scales may hold padded rows past the true ng
        scales = qt.scales[..., :kg, :].unsqueeze(-2)
        if qt.kind in ("mxfp4", "mxfp8"):
            scales = ue8m0_to_scale(scales)
        if qt.kind.endswith("_gz"):
            g = g - qt.zeros[..., :kg, :].unsqueeze(-2)
        return (g * scales).reshape(q.shape).to(dtype)
    raise ValueError(qt.kind)
