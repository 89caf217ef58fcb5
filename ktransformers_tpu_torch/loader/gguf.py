"""GGUF container parser + ggml block-quant decoders (pure numpy, mmap):
the port's copy of ktransformers_tpu/loader/gguf.py (which imports no JAX;
the port imports nothing of that package, so it keeps its own).

Written from the GGUF spec (github.com/ggml-org/ggml/blob/master/docs/
gguf.md) and the ggml block format definitions. All decoders are vectorized
numpy over [n_blocks, block_bytes] uint8 views; tests/test_torch_gguf.py
holds each bit-exact against the JAX package's on the scalar packers of
tests/test_gguf.py. Large tensors go through the native OpenMP decoders of
loader/native.py (csrc/ggml_decode.cpp) when they build.

Supported tensor types: F32, F16, BF16, Q4_0, Q4_1, Q5_0, Q5_1, Q8_0,
Q2_K, Q3_K, Q4_K, Q5_K, Q6_K.
"""

from __future__ import annotations

import dataclasses
import mmap
import os
import struct
from typing import Any, BinaryIO

import numpy as np

GGUF_MAGIC = 0x46554747  # "GGUF" little-endian

# metadata value types
_T_U8, _T_I8, _T_U16, _T_I16, _T_U32, _T_I32, _T_F32, _T_BOOL = range(8)
_T_STRING, _T_ARRAY, _T_U64, _T_I64, _T_F64 = 8, 9, 10, 11, 12

_SCALAR_FMT = {
    _T_U8: "<B", _T_I8: "<b", _T_U16: "<H", _T_I16: "<h",
    _T_U32: "<I", _T_I32: "<i", _T_F32: "<f", _T_BOOL: "<?",
    _T_U64: "<Q", _T_I64: "<q", _T_F64: "<d",
}

# ggml tensor type ids -> (name, elements_per_block, bytes_per_block)
GGML_TYPES = {
    0: ("F32", 1, 4),
    1: ("F16", 1, 2),
    2: ("Q4_0", 32, 18),
    3: ("Q4_1", 32, 20),
    6: ("Q5_0", 32, 22),
    7: ("Q5_1", 32, 24),
    8: ("Q8_0", 32, 34),
    10: ("Q2_K", 256, 84),
    11: ("Q3_K", 256, 110),
    12: ("Q4_K", 256, 144),
    13: ("Q5_K", 256, 176),
    14: ("Q6_K", 256, 210),
    16: ("IQ2_XXS", 256, 66),
    17: ("IQ2_XS", 256, 74),
    23: ("IQ4_XS", 256, 136),
    30: ("BF16", 1, 2),
}
GGML_NAMES = {v[0]: k for k, v in GGML_TYPES.items()}


def _read_str(f: BinaryIO) -> str:
    (n,) = struct.unpack("<Q", f.read(8))
    return f.read(n).decode("utf-8", errors="replace")


def _read_value(f: BinaryIO, vtype: int) -> Any:
    if vtype in _SCALAR_FMT:
        fmt = _SCALAR_FMT[vtype]
        return struct.unpack(fmt, f.read(struct.calcsize(fmt)))[0]
    if vtype == _T_STRING:
        return _read_str(f)
    if vtype == _T_ARRAY:
        (etype,) = struct.unpack("<I", f.read(4))
        (count,) = struct.unpack("<Q", f.read(8))
        return [_read_value(f, etype) for _ in range(count)]
    raise ValueError(f"unknown gguf metadata type {vtype}")


@dataclasses.dataclass
class GGUFTensorInfo:
    name: str
    shape: tuple[int, ...]  # numpy order (row-major, reversed from gguf)
    ggml_type: int
    offset: int  # absolute offset within the file

    @property
    def type_name(self) -> str:
        return GGML_TYPES[self.ggml_type][0]

    @property
    def n_elements(self) -> int:
        n = 1
        for d in self.shape:
            n *= d
        return n

    @property
    def nbytes(self) -> int:
        _, per_block, block_bytes = GGML_TYPES[self.ggml_type]
        return self.n_elements // per_block * block_bytes


class GGUFFile:
    """One mmap'd .gguf file (multi-file models use one GGUFFile per shard,
    see GGUFDir below)."""

    def __init__(self, path: str):
        self.path = path
        self.fields: dict[str, Any] = {}
        self.tensors: dict[str, GGUFTensorInfo] = {}
        with open(path, "rb") as f:
            magic, version = struct.unpack("<II", f.read(8))
            if magic != GGUF_MAGIC:
                raise ValueError(f"{path}: not a GGUF file")
            if version < 2:
                raise ValueError(f"{path}: GGUF v{version} unsupported")
            n_tensors, n_kv = struct.unpack("<QQ", f.read(16))
            for _ in range(n_kv):
                key = _read_str(f)
                (vtype,) = struct.unpack("<I", f.read(4))
                self.fields[key] = _read_value(f, vtype)
            infos = []
            for _ in range(n_tensors):
                name = _read_str(f)
                (n_dims,) = struct.unpack("<I", f.read(4))
                dims = struct.unpack(f"<{n_dims}Q", f.read(8 * n_dims))
                ggml_type, = struct.unpack("<I", f.read(4))
                offset, = struct.unpack("<Q", f.read(8))
                infos.append((name, dims, ggml_type, offset))
            align = int(self.fields.get("general.alignment", 32))
            data_start = (f.tell() + align - 1) // align * align
        self._data_start = data_start
        self._file = open(path, "rb")
        self._mmap = mmap.mmap(self._file.fileno(), 0, access=mmap.ACCESS_READ)
        for name, dims, ggml_type, offset in infos:
            if ggml_type not in GGML_TYPES:
                continue  # skip exotic IQ types we don't decode yet
            self.tensors[name] = GGUFTensorInfo(
                name=name,
                shape=tuple(reversed(dims)),
                ggml_type=ggml_type,
                offset=data_start + offset,
            )

    def close(self):
        self._mmap.close()
        self._file.close()

    def raw(self, name: str) -> np.ndarray:
        """uint8 view of a tensor's packed bytes (zero copy)."""
        info = self.tensors[name]
        return np.frombuffer(
            self._mmap, np.uint8, count=info.nbytes, offset=info.offset
        )

    def load(self, name: str, dtype=np.float32) -> np.ndarray:
        """Dequantize tensor to a dense numpy array in its logical shape."""
        info = self.tensors[name]
        out = decode_ggml(self.raw(name), info.ggml_type)
        return out.reshape(info.shape).astype(dtype, copy=False)

    @property
    def architecture(self) -> str:
        return self.fields.get("general.architecture", "")


# ---------------------------------------------------------------------------
# block decoders
# ---------------------------------------------------------------------------


def _f16(b: np.ndarray) -> np.ndarray:
    """[n, 2] uint8 (contiguous) -> [n] float32 via float16."""
    return b.view(np.float16).astype(np.float32).reshape(-1)


def _blocks(raw: np.ndarray, block_bytes: int) -> np.ndarray:
    assert raw.size % block_bytes == 0, (raw.size, block_bytes)
    return raw.reshape(-1, block_bytes)


def _dec_q8_0(raw):
    b = _blocks(raw, 34)
    d = _f16(b[:, :2].copy())
    q = b[:, 2:].view(np.int8).astype(np.float32)
    return (q * d[:, None]).reshape(-1)


def _dec_q4_0(raw):
    b = _blocks(raw, 18)
    d = _f16(b[:, :2].copy())
    qs = b[:, 2:]
    lo = (qs & 0xF).astype(np.int8) - 8
    hi = (qs >> 4).astype(np.int8) - 8
    q = np.concatenate([lo, hi], axis=1).astype(np.float32)  # [n, 32]
    return (q * d[:, None]).reshape(-1)


def _dec_q4_1(raw):
    b = _blocks(raw, 20)
    d = _f16(b[:, 0:2].copy())
    m = _f16(b[:, 2:4].copy())
    qs = b[:, 4:]
    lo = (qs & 0xF).astype(np.float32)
    hi = (qs >> 4).astype(np.float32)
    q = np.concatenate([lo, hi], axis=1)
    return (q * d[:, None] + m[:, None]).reshape(-1)


def _dec_q5_0(raw):
    b = _blocks(raw, 22)
    d = _f16(b[:, 0:2].copy())
    qh = b[:, 2:6].copy().view(np.uint32)[:, 0]  # [n]
    qs = b[:, 6:]
    bits = (qh[:, None] >> np.arange(32)[None, :]) & 1  # [n, 32]
    lo = (qs & 0xF).astype(np.int16)
    hi = (qs >> 4).astype(np.int16)
    q = np.concatenate([lo, hi], axis=1)
    q = (q | (bits.astype(np.int16) << 4)) - 16
    return (q.astype(np.float32) * d[:, None]).reshape(-1)


def _dec_q5_1(raw):
    b = _blocks(raw, 24)
    d = _f16(b[:, 0:2].copy())
    m = _f16(b[:, 2:4].copy())
    qh = b[:, 4:8].copy().view(np.uint32)[:, 0]
    qs = b[:, 8:]
    bits = (qh[:, None] >> np.arange(32)[None, :]) & 1
    lo = (qs & 0xF).astype(np.uint16)
    hi = (qs >> 4).astype(np.uint16)
    q = np.concatenate([lo, hi], axis=1) | (bits.astype(np.uint16) << 4)
    return (q.astype(np.float32) * d[:, None] + m[:, None]).reshape(-1)


def _q_k_scale_min(scales: np.ndarray):
    """Unpack the 12-byte 6-bit scale/min pairs of Q4_K/Q5_K.

    scales: [n, 12] uint8 -> (sc [n, 8], m [n, 8]) float32.
    Layout (ggml get_scale_min_k4): j < 4: sc = s[j] & 63, m = s[j+4] & 63;
    j >= 4: sc = (s[j+4] & 0xF) | ((s[j-4] >> 6) << 4),
            m  = (s[j+4] >> 4)  | ((s[j]   >> 6) << 4).
    """
    s = scales.astype(np.uint16)
    sc = np.empty(s.shape[:1] + (8,), np.uint16)
    mn = np.empty_like(sc)
    for j in range(4):
        sc[:, j] = s[:, j] & 63
        mn[:, j] = s[:, j + 4] & 63
    for j in range(4, 8):
        sc[:, j] = (s[:, j + 4] & 0xF) | ((s[:, j - 4] >> 6) << 4)
        mn[:, j] = (s[:, j + 4] >> 4) | ((s[:, j] >> 6) << 4)
    return sc.astype(np.float32), mn.astype(np.float32)


def _dec_q4_k(raw):
    b = _blocks(raw, 144)
    d = _f16(b[:, 0:2].copy())[:, None]
    dmin = _f16(b[:, 2:4].copy())[:, None]
    sc, mn = _q_k_scale_min(b[:, 4:16])
    qs = b[:, 16:144]  # [n, 128]
    n = b.shape[0]
    # chunk c (32 bytes) holds sub-blocks 2c (low nibbles) and 2c+1 (high).
    qs = qs.reshape(n, 4, 32)
    lo = (qs & 0xF).astype(np.float32)
    hi = (qs >> 4).astype(np.float32)
    q = np.stack([lo, hi], axis=2).reshape(n, 8, 32)  # [n, sub, 32]
    scale = (d * sc)[:, :, None]
    minv = (dmin * mn)[:, :, None]
    return (q * scale - minv).reshape(-1)


def _dec_q5_k(raw):
    b = _blocks(raw, 176)
    d = _f16(b[:, 0:2].copy())[:, None]
    dmin = _f16(b[:, 2:4].copy())[:, None]
    sc, mn = _q_k_scale_min(b[:, 4:16])
    qh = b[:, 16:48]  # [n, 32]
    qs = b[:, 48:176]  # [n, 128]
    n = b.shape[0]
    qs = qs.reshape(n, 4, 32)
    lo = (qs & 0xF).astype(np.uint16)
    hi = (qs >> 4).astype(np.uint16)
    q4 = np.stack([lo, hi], axis=2).reshape(n, 8, 32)
    # high bit: sub-block j uses bit j of qh byte l.
    bits = (qh[:, None, :] >> np.arange(8)[None, :, None]) & 1  # [n, 8, 32]
    q = q4 | (bits.astype(np.uint16) << 4)
    scale = (d * sc)[:, :, None]
    minv = (dmin * mn)[:, :, None]
    return (q.astype(np.float32) * scale - minv).reshape(-1)


def _dec_q6_k(raw):
    b = _blocks(raw, 210)
    n = b.shape[0]
    ql = b[:, 0:128]
    qh = b[:, 128:192]
    scales = b[:, 192:208].view(np.int8).astype(np.float32)  # [n, 16]
    d = _f16(b[:, 208:210].copy())[:, None]
    # two 128-element halves
    ql = ql.reshape(n, 2, 64)
    qh = qh.reshape(n, 2, 32)
    out = np.empty((n, 2, 128), np.float32)
    for half in range(2):
        l = ql[:, half]  # [n, 64]
        h = qh[:, half]  # [n, 32]
        q1 = (l[:, :32] & 0xF) | (((h >> 0) & 3) << 4)
        q2 = (l[:, 32:] & 0xF) | (((h >> 2) & 3) << 4)
        q3 = (l[:, :32] >> 4) | (((h >> 4) & 3) << 4)
        q4 = (l[:, 32:] >> 4) | (((h >> 6) & 3) << 4)
        q = np.concatenate([q1, q2, q3, q4], axis=1).astype(np.int16) - 32
        out[:, half] = q.astype(np.float32)
    out = out.reshape(n, 256)
    scale = np.repeat(scales, 16, axis=1)  # [n, 256]
    return (out * scale * d).reshape(-1)


def _dec_q2_k(raw):
    b = _blocks(raw, 84)
    n = b.shape[0]
    scales = b[:, 0:16]  # [n, 16] : low4 scale, high4 min (per 16 elems)
    qs = b[:, 16:80]
    d = _f16(b[:, 80:82].copy())[:, None]
    dmin = _f16(b[:, 82:84].copy())[:, None]
    sc = (scales & 0xF).astype(np.float32)
    mn = (scales >> 4).astype(np.float32)
    qs = qs.reshape(n, 2, 32)  # two 128-elem halves, 32 bytes each
    shifts = np.arange(4) * 2
    q = (qs[:, :, None, :] >> shifts[None, None, :, None]) & 3  # [n,2,4,32]
    q = q.reshape(n, 256).astype(np.float32)
    scale16 = np.repeat(d * sc, 16, axis=1)  # [n, 256]
    min16 = np.repeat(dmin * mn, 16, axis=1)
    return (q * scale16 - min16).reshape(-1)


def _dec_q3_k(raw):
    b = _blocks(raw, 110)
    n = b.shape[0]
    hmask = b[:, 0:32]
    qs = b[:, 32:96]
    scales_raw = b[:, 96:108]
    d = _f16(b[:, 108:110].copy())[:, None]
    # 12 bytes -> 16 6-bit scales (ggml kmask unpack), signed offset 32
    a = scales_raw[:, 0:8].astype(np.uint16)  # low 4 bits of sc 0..15
    c = scales_raw[:, 8:12].astype(np.uint16)  # high 2 bits, 4 per byte
    sc = np.empty((n, 16), np.int16)
    for j in range(8):
        sc[:, j] = a[:, j] & 0xF
        sc[:, j + 8] = a[:, j] >> 4
    for j in range(16):
        hi2 = (c[:, j % 4] >> (2 * (j // 4))) & 3
        sc[:, j] |= (hi2 << 4).astype(np.int16)
    sc = (sc - 32).astype(np.float32)
    qs = qs.reshape(n, 2, 32)
    shifts = np.arange(4) * 2
    q = (qs[:, :, None, :] >> shifts[None, None, :, None]) & 3  # [n,2,4,32]
    q = q.reshape(n, 256).astype(np.int16)
    # high-bit mask: value idx v uses bit (v // 32) of hmask byte (v % 32)
    bitpos = np.arange(256) // 32
    bytepos = np.arange(256) % 32
    hm = (hmask[:, bytepos] >> bitpos[None, :]) & 1  # [n, 256]
    q = q - np.where(hm == 0, 4, 0)
    scale16 = np.repeat(sc, 16, axis=1)
    return (q.astype(np.float32) * scale16 * d).reshape(-1)


_DECODERS = {
    "F32": lambda raw: raw.copy().view(np.float32),
    "F16": lambda raw: raw.copy().view(np.float16).astype(np.float32),
    "BF16": lambda raw: (
        raw.copy().view(np.uint16).astype(np.uint32) << 16
    ).view(np.float32),
    "Q8_0": _dec_q8_0,
    "Q4_0": _dec_q4_0,
    "Q4_1": _dec_q4_1,
    "Q5_0": _dec_q5_0,
    "Q5_1": _dec_q5_1,
    "Q2_K": _dec_q2_k,
    "Q3_K": _dec_q3_k,
    "Q4_K": _dec_q4_k,
    "Q5_K": _dec_q5_k,
    "Q6_K": _dec_q6_k,
}


NATIVE_MIN_BYTES = 1 << 20  # use the C++ decoders above 1 MiB


def decode_ggml(
    raw: np.ndarray, ggml_type: int, use_native: bool | None = None
) -> np.ndarray:
    """Decode packed ggml bytes to flat float32.

    Large tensors go through the native OpenMP decoders
    (csrc/ggml_decode.cpp) when built; numpy is the reference fallback."""
    name = GGML_TYPES[ggml_type][0]
    if name not in _DECODERS:
        raise NotImplementedError(f"ggml type {name} not supported")
    raw = np.asarray(raw, np.uint8)
    if use_native or (use_native is None and raw.size >= NATIVE_MIN_BYTES):
        from ktransformers_tpu_torch.loader import native

        out = native.decode(raw, name)
        if out is not None:
            return out
    return _DECODERS[name](raw)


class GGUFDir:
    """Multi-file GGUF model directory (…-00001-of-000XX.gguf shards)."""

    def __init__(self, path: str):
        if os.path.isfile(path):
            files = [path]
        else:
            files = sorted(
                os.path.join(path, f)
                for f in os.listdir(path)
                if f.endswith(".gguf")
            )
        if not files:
            raise FileNotFoundError(f"no .gguf files under {path}")
        self.files = [GGUFFile(f) for f in files]
        self.fields = {}
        self.tensor_file: dict[str, GGUFFile] = {}
        for gf in self.files:
            self.fields.update(gf.fields)
            for name in gf.tensors:
                self.tensor_file[name] = gf

    def tensors(self):
        return list(self.tensor_file)

    def info(self, name: str) -> GGUFTensorInfo:
        return self.tensor_file[name].tensors[name]

    def load(self, name: str, dtype=np.float32) -> np.ndarray:
        return self.tensor_file[name].load(name, dtype)

    def close(self):
        for gf in self.files:
            gf.close()
