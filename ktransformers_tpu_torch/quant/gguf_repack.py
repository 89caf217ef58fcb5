"""Lossless GGUF k-quant -> QTensor repack: compute on the ORIGINAL codes
(the port's copy of ktransformers_tpu/quant/gguf_repack.py, returning the
port's QTensor on a given device).

Each ggml block's integer codes and (scale, min) pairs are re-expressed
exactly in the group formats, so the W4A8 kernels compute on the numbers
the GGUF file holds, with no decode -> requantize round trip:

| ggml  | codes                | kind      | group | zero point        |
|-------|----------------------|-----------|-------|-------------------|
| Q8_0  | int8                 | int8_g    | 32    | —                 |
| Q4_0  | q-8 in [-8,7]        | int4_g    | 32    | —                 |
| Q4_1  | q-8                  | int4_gz   | 32    | -8 - m/d          |
| Q5_0  | q-16 in [-16,15]     | int8_g    | 32    | —                 |
| Q5_1  | q-16                 | int8_gz   | 32    | -16 - m/d         |
| Q2_K  | q-8 (q in [0,3])     | int4_gz   | 16    | min/scale - 8     |
| Q3_K  | q in [-4,3]          | int4_g    | 16    | —                 |
| Q4_K  | q-8 (q in [0,15])    | int4_gz   | 32    | min/scale - 8     |
| Q5_K  | q-16 (q in [0,31])   | int8_gz   | 32    | min/scale - 16    |
| Q6_K  | q in [-32,31]        | int8_g    | 16    | —                 |

The only non-exactness is one float division per asymmetric group
(min/scale, re-multiplied by scale in the kernel: ~1 ulp), plus a 1e-12
scale floor guarding degenerate all-zero-scale groups.
"""

from __future__ import annotations

import numpy as np

import torch

from ktransformers_tpu_torch.loader.gguf import (
    _blocks,
    _f16,
    _q_k_scale_min,
)

_SCALE_FLOOR = 1e-12


def _safe(s: np.ndarray) -> np.ndarray:
    return np.where(np.abs(s) < _SCALE_FLOOR, _SCALE_FLOOR, s)


def np_pack_int4(q: np.ndarray, group_size: int) -> np.ndarray:
    """numpy mirror of formats.pack_int4 (group-split nibble layout):
    int codes [-8, 7] along axis -2 -> uint8 [..., K/2, N]."""
    *lead, k, n = q.shape
    gs = group_size or k
    assert k % gs == 0 and gs % 2 == 0, (k, gs)
    q = q.astype(np.int32) & 0xF
    qg = q.reshape(*lead, k // gs, gs, n)
    lo = qg[..., : gs // 2, :]
    hi = qg[..., gs // 2 :, :]
    return (lo | (hi << 4)).astype(np.uint8).reshape(*lead, k // 2, n)


# --- per-type extractors: raw bytes -> (codes int8 [n, block],
#     scales f32 [n, nsub], zeros f32 [n, nsub] | None, group, kind) -------


def _x_q8_0(raw):
    b = _blocks(raw, 34)
    d = _f16(b[:, :2].copy())[:, None]
    q = b[:, 2:].view(np.int8).copy()
    return q, d, None, 32, "int8_g"


def _x_q4_0(raw):
    b = _blocks(raw, 18)
    d = _f16(b[:, :2].copy())[:, None]
    qs = b[:, 2:]
    lo = (qs & 0xF).astype(np.int8) - 8
    hi = (qs >> 4).astype(np.int8) - 8
    return np.concatenate([lo, hi], axis=1), d, None, 32, "int4_g"


def _x_q4_1(raw):
    b = _blocks(raw, 20)
    d = _f16(b[:, 0:2].copy())[:, None]
    m = _f16(b[:, 2:4].copy())[:, None]
    qs = b[:, 4:]
    lo = (qs & 0xF).astype(np.int16)
    hi = (qs >> 4).astype(np.int16)
    q = (np.concatenate([lo, hi], axis=1) - 8).astype(np.int8)
    d = _safe(d)
    return q, d, (-8.0 - m / d).astype(np.float32), 32, "int4_gz"


def _x_q5_0(raw):
    b = _blocks(raw, 22)
    d = _f16(b[:, 0:2].copy())[:, None]
    qh = b[:, 2:6].copy().view(np.uint32)[:, 0]
    qs = b[:, 6:]
    bits = (qh[:, None] >> np.arange(32)[None, :]) & 1
    lo = (qs & 0xF).astype(np.int16)
    hi = (qs >> 4).astype(np.int16)
    q = np.concatenate([lo, hi], axis=1)
    q = ((q | (bits.astype(np.int16) << 4)) - 16).astype(np.int8)
    return q, d, None, 32, "int8_g"


def _x_q5_1(raw):
    b = _blocks(raw, 24)
    d = _f16(b[:, 0:2].copy())[:, None]
    m = _f16(b[:, 2:4].copy())[:, None]
    qh = b[:, 4:8].copy().view(np.uint32)[:, 0]
    qs = b[:, 8:]
    bits = (qh[:, None] >> np.arange(32)[None, :]) & 1
    lo = (qs & 0xF).astype(np.uint16)
    hi = (qs >> 4).astype(np.uint16)
    q = (np.concatenate([lo, hi], axis=1) | (bits.astype(np.uint16) << 4))
    q = (q.astype(np.int16) - 16).astype(np.int8)
    d = _safe(d)
    return q, d, (-16.0 - m / d).astype(np.float32), 32, "int8_gz"


def _x_q4_k(raw):
    b = _blocks(raw, 144)
    d = _f16(b[:, 0:2].copy())[:, None]
    dmin = _f16(b[:, 2:4].copy())[:, None]
    sc, mn = _q_k_scale_min(b[:, 4:16])
    qs = b[:, 16:144].reshape(-1, 4, 32)
    lo = (qs & 0xF).astype(np.int16)
    hi = (qs >> 4).astype(np.int16)
    q = np.stack([lo, hi], axis=2).reshape(-1, 256)
    q = (q - 8).astype(np.int8)
    scales = _safe((d * sc).astype(np.float32))  # [n, 8]
    zeros = ((dmin * mn) / scales - 8.0).astype(np.float32)
    return q, scales, zeros, 32, "int4_gz"


def _x_q5_k(raw):
    b = _blocks(raw, 176)
    d = _f16(b[:, 0:2].copy())[:, None]
    dmin = _f16(b[:, 2:4].copy())[:, None]
    sc, mn = _q_k_scale_min(b[:, 4:16])
    qh = b[:, 16:48]
    qs = b[:, 48:176].reshape(-1, 4, 32)
    lo = (qs & 0xF).astype(np.uint16)
    hi = (qs >> 4).astype(np.uint16)
    q4 = np.stack([lo, hi], axis=2).reshape(-1, 8, 32)
    bits = (qh[:, None, :] >> np.arange(8)[None, :, None]) & 1
    q = (q4 | (bits.astype(np.uint16) << 4)).astype(np.int16) - 16
    q = q.reshape(-1, 256).astype(np.int8)
    scales = _safe((d * sc).astype(np.float32))
    zeros = ((dmin * mn) / scales - 16.0).astype(np.float32)
    return q, scales, zeros, 32, "int8_gz"


def _x_q6_k(raw):
    b = _blocks(raw, 210)
    n = b.shape[0]
    ql = b[:, 0:128].reshape(n, 2, 64)
    qh = b[:, 128:192].reshape(n, 2, 32)
    sc = b[:, 192:208].view(np.int8).astype(np.float32)  # [n, 16]
    d = _f16(b[:, 208:210].copy())[:, None]
    out = np.empty((n, 2, 128), np.int8)
    for half in range(2):
        l = ql[:, half]
        h = qh[:, half]
        q1 = (l[:, :32] & 0xF) | (((h >> 0) & 3) << 4)
        q2 = (l[:, 32:] & 0xF) | (((h >> 2) & 3) << 4)
        q3 = (l[:, :32] >> 4) | (((h >> 4) & 3) << 4)
        q4 = (l[:, 32:] >> 4) | (((h >> 6) & 3) << 4)
        q = np.concatenate([q1, q2, q3, q4], axis=1).astype(np.int16) - 32
        out[:, half] = q.astype(np.int8)
    return out.reshape(n, 256), (sc * d).astype(np.float32), None, 16, "int8_g"


def _x_q2_k(raw):
    b = _blocks(raw, 84)
    n = b.shape[0]
    scales = b[:, 0:16]
    qs = b[:, 16:80].reshape(n, 2, 32)
    d = _f16(b[:, 80:82].copy())[:, None]
    dmin = _f16(b[:, 82:84].copy())[:, None]
    sc = (scales & 0xF).astype(np.float32)
    mn = (scales >> 4).astype(np.float32)
    shifts = np.arange(4) * 2
    q = (qs[:, :, None, :] >> shifts[None, None, :, None]) & 3
    q = (q.reshape(n, 256).astype(np.int16) - 8).astype(np.int8)
    s = _safe((d * sc).astype(np.float32))  # [n, 16]
    zeros = ((dmin * mn) / s - 8.0).astype(np.float32)
    return q, s, zeros, 16, "int4_gz"


def _x_q3_k(raw):
    b = _blocks(raw, 110)
    n = b.shape[0]
    hmask = b[:, 0:32]
    qs = b[:, 32:96].reshape(n, 2, 32)
    scales_raw = b[:, 96:108]
    d = _f16(b[:, 108:110].copy())[:, None]
    a = scales_raw[:, 0:8].astype(np.uint16)
    c = scales_raw[:, 8:12].astype(np.uint16)
    sc = np.empty((n, 16), np.int16)
    for j in range(8):
        sc[:, j] = a[:, j] & 0xF
        sc[:, j + 8] = a[:, j] >> 4
    for j in range(16):
        hi2 = (c[:, j % 4] >> (2 * (j // 4))) & 3
        sc[:, j] |= (hi2 << 4).astype(np.int16)
    sc = (sc - 32).astype(np.float32)
    shifts = np.arange(4) * 2
    q = (qs[:, :, None, :] >> shifts[None, None, :, None]) & 3
    q = q.reshape(n, 256).astype(np.int16)
    bitpos = np.arange(256) // 32
    bytepos = np.arange(256) % 32
    hm = (hmask[:, bytepos] >> bitpos[None, :]) & 1
    q = (q - np.where(hm == 0, 4, 0)).astype(np.int8)
    return q, (sc * d).astype(np.float32), None, 16, "int4_g"


EXTRACTORS = {
    "Q8_0": _x_q8_0,
    "Q4_0": _x_q4_0,
    "Q4_1": _x_q4_1,
    "Q5_0": _x_q5_0,
    "Q5_1": _x_q5_1,
    "Q2_K": _x_q2_k,
    "Q3_K": _x_q3_k,
    "Q4_K": _x_q4_k,
    "Q5_K": _x_q5_k,
    "Q6_K": _x_q6_k,
}


def repack_ggml_exact(raw: np.ndarray, type_name: str, logical_shape,
                      device="cpu"):
    """Repack a ggml-quantized tensor (blocks along the LAST logical axis)
    into the [..., K, N] QTensor layout without requantizing, on
    ``device``.

    logical_shape: the GGUF logical shape (..., out, in); the result swaps
    the last two axes so in==K feeds `x @ w` directly. Returns a QTensor or
    None for unsupported types."""
    from ktransformers_tpu_torch.quant.formats import QTensor

    if type_name not in EXTRACTORS:
        return None
    codes, scales, zeros, group, kind = EXTRACTORS[type_name](
        np.asarray(raw, np.uint8)
    )
    *lead, out_dim, in_dim = logical_shape
    if in_dim % group:
        return None
    q = codes.reshape(*logical_shape)  # (..., out, in)
    s = scales.reshape(*lead, out_dim, in_dim // group)
    q = np.swapaxes(q, -1, -2)  # (..., in=K, out=N)
    s = np.ascontiguousarray(np.swapaxes(s, -1, -2))  # (..., K/G, N)
    z = None
    if zeros is not None:
        z = zeros.reshape(*lead, out_dim, in_dim // group)
        z = np.ascontiguousarray(np.swapaxes(z, -1, -2))
    if kind.startswith("int4"):
        data = np_pack_int4(np.ascontiguousarray(q), group)
    else:
        data = np.ascontiguousarray(q)

    def dev(a):
        return None if a is None else torch.from_numpy(a).to(device)

    return QTensor(data=dev(data), scales=dev(s), zeros=dev(z), kind=kind,
                   group_size=group)
