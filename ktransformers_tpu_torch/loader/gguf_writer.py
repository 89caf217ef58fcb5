"""Minimal GGUF writer (F32 / F16 tensors, pre-packed ggml blocks and
metadata): the port's copy of ktransformers_tpu/loader/gguf_writer.py, the
same bytes (tests/test_torch_gguf.py), written tensor by tensor so that a
file of gigabytes never sits in memory whole. Used by the tests and by
chip_smoke.py to fabricate checkpoints from a seed.
"""

from __future__ import annotations

import struct

import numpy as np

from ktransformers_tpu_torch.loader.gguf import GGML_NAMES


def _w_str(s: str) -> bytes:
    b = s.encode()
    return struct.pack("<Q", len(b)) + b


def _w_value(v) -> bytes:
    if isinstance(v, bool):
        return struct.pack("<I", 7) + struct.pack("<?", v)
    if isinstance(v, int):
        return struct.pack("<I", 5) + struct.pack("<i", v)
    if isinstance(v, float):
        return struct.pack("<I", 6) + struct.pack("<f", v)
    if isinstance(v, str):
        return struct.pack("<I", 8) + _w_str(v)
    if isinstance(v, (list, tuple)):
        if all(isinstance(x, str) for x in v):
            out = struct.pack("<I", 9) + struct.pack("<IQ", 8, len(v))
            for x in v:
                out += _w_str(x)
            return out
        if all(isinstance(x, int) for x in v):
            out = struct.pack("<I", 9) + struct.pack("<IQ", 5, len(v))
            for x in v:
                out += struct.pack("<i", x)
            return out
        if all(isinstance(x, float) for x in v):
            out = struct.pack("<I", 9) + struct.pack("<IQ", 6, len(v))
            for x in v:
                out += struct.pack("<f", x)
            return out
    raise TypeError(f"unsupported gguf metadata value {v!r}")


def write_gguf(path: str, metadata: dict, tensors: dict):
    """tensors: name -> np.ndarray (float32/float16) written in numpy
    (row-major) shape, or (raw_uint8_bytes, ggml_type_name, logical_shape)
    for pre-packed quantized blocks; dims are reversed into ggml order."""
    align = int(metadata.get("general.alignment", 32))
    header = struct.pack("<IIQQ", 0x46554747, 3, len(tensors), len(metadata))
    kv = b""
    for k, v in metadata.items():
        kv += _w_str(k) + _w_value(v)

    infos = b""
    arrays = []
    offset = 0
    for name, arr in tensors.items():
        if isinstance(arr, tuple):
            raw, tname, shape = arr
            arr = np.ascontiguousarray(np.asarray(raw, np.uint8))
            dims = tuple(reversed(shape))
        else:
            arr = np.ascontiguousarray(arr)
            tname = {"float32": "F32", "float16": "F16"}[str(arr.dtype)]
            dims = tuple(reversed(arr.shape))
        infos += _w_str(name)
        infos += struct.pack("<I", len(dims))
        infos += struct.pack(f"<{len(dims)}Q", *dims)
        infos += struct.pack("<IQ", GGML_NAMES[tname], offset)
        pad = (-arr.nbytes) % align
        arrays.append((arr, pad))
        offset += arr.nbytes + pad

    body = header + kv + infos
    pad = (-len(body)) % align
    with open(path, "wb") as f:
        f.write(body + b"\x00" * pad)
        for arr, pad in arrays:
            f.write(memoryview(arr.reshape(-1).view(np.uint8)))
            f.write(b"\x00" * pad)


def random_blocks(rng: np.random.Generator, type_name: str, shape,
                  std: float):
    """Random ggml blocks of a tensor of logical ``shape`` (..., out, in;
    blocks run along ``in``) whose values have about ``std`` standard
    deviation and mean 0: (raw uint8, type_name, shape), a write_gguf
    entry. Q4_K: random 6-bit sub-block scales and mins, 4-bit codes, d =
    std / 259 and dmin = 7.5 d (value = d sc q - dmin mn); Q6_K: random
    6-bit codes and int8 sub-block scales in [-64, 64), d = std / 685
    (value = d sc (q - 32)); Q4_1: 4-bit codes, d = std / 4.6, m = -7.5 d
    (value = d q + m); Q8_0: int8 codes in [-127, 127], d = std / 73.6.
    Used to fabricate checkpoints from a seed."""
    n = int(np.prod(shape))
    if type_name in ("Q4_1", "Q8_0"):
        if n % 32 or shape[-1] % 32:
            raise ValueError(f"{type_name}: {shape} is not whole 32-blocks")
        nb = n // 32
        if type_name == "Q4_1":
            b = rng.integers(0, 256, (nb, 20), dtype=np.uint8)
            d = np.float16(std / 4.6)
            b[:, 0:2] = np.frombuffer(d.tobytes(), np.uint8)
            b[:, 2:4] = np.frombuffer(np.float16(-7.5 * float(d)).tobytes(),
                                      np.uint8)
        else:
            b = np.empty((nb, 34), np.uint8)
            b[:, 2:] = rng.integers(-127, 128, (nb, 32)).astype(
                np.int8).view(np.uint8)
            b[:, 0:2] = np.frombuffer(np.float16(std / 73.6).tobytes(),
                                      np.uint8)
        return b.reshape(-1), type_name, tuple(shape)
    if type_name == "Q4_K":
        nb = n // 256
        b = rng.integers(0, 256, (nb, 144), dtype=np.uint8)
        d = np.float16(std / 259.0)
        b[:, 0:2] = np.frombuffer(d.tobytes(), np.uint8)
        b[:, 2:4] = np.frombuffer(np.float16(7.5 * float(d)).tobytes(),
                                  np.uint8)
    elif type_name == "Q6_K":
        nb = n // 256
        b = rng.integers(0, 256, (nb, 210), dtype=np.uint8)
        b[:, 192:208] = rng.integers(-64, 64, (nb, 16)).astype(
            np.int8).view(np.uint8)
        b[:, 208:210] = np.frombuffer(np.float16(std / 685.0).tobytes(),
                                      np.uint8)
    else:
        raise ValueError(f"random_blocks: {type_name} is not made here")
    if nb * 256 != n or shape[-1] % 256:
        raise ValueError(f"{type_name}: {shape} is not whole 256-blocks")
    return b.reshape(-1), type_name, tuple(shape)
