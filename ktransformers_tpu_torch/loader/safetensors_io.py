"""Read and write the safetensors file format with the standard library,
numpy and torch (the ``safetensors`` package is not needed).

The format: an 8-byte little-endian header length n, n bytes of JSON
({name: {"dtype", "shape", "data_offsets": [begin, end]}, optional
"__metadata__": {str: str}}), then the raw little-endian bytes of every
tensor, offsets counted from the end of the header.

``SafetensorsFile`` memory-maps a file and hands out torch tensors (BF16 as
torch.bfloat16, F8_E4M3 as torch.float8_e4m3fn); ``numpy_view`` gives the
numpy array of the same bits (bfloat16 as uint16, float8 as uint8, since
numpy has neither). ``save_file`` writes a dict of torch tensors or numpy
arrays.
"""

from __future__ import annotations

import json
import mmap
import struct

import numpy as np
import torch

DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
    "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32,
    "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8,
    "U16": torch.uint16, "BOOL": torch.bool, "F8_E4M3": torch.float8_e4m3fn,
}
CODES = {v: k for k, v in DTYPES.items()}
_NP_CODES = {
    "float64": "F64", "float32": "F32", "float16": "F16", "int64": "I64",
    "int32": "I32", "int16": "I16", "int8": "I8", "uint8": "U8",
    "uint16": "U16", "bool": "BOOL", "bfloat16": "BF16",
    "float8_e4m3fn": "F8_E4M3",
}
# the storage numpy gives a dtype it has no type for
_NP_BITS = {torch.bfloat16: torch.int16, torch.float8_e4m3fn: torch.uint8,
            torch.uint16: torch.int16}


class SafetensorsFile:
    """One .safetensors file, memory-mapped. ``get(name)`` returns a torch
    tensor on the CPU that owns a copy of its bytes (the map can close)."""

    def __init__(self, path: str):
        self.path = path
        with open(path, "rb") as fh:
            head = fh.read(8)
            if len(head) != 8:
                raise ValueError(f"{path}: not a safetensors file")
            (n,) = struct.unpack("<Q", head)
            header = json.loads(fh.read(n))
            self._map = mmap.mmap(fh.fileno(), 0, access=mmap.ACCESS_READ)
        self.metadata = header.pop("__metadata__", None) or {}
        self.header = header
        self._base = 8 + n
        for name, meta in header.items():
            if meta["dtype"] not in DTYPES:
                raise ValueError(
                    f"{path}: {name} has dtype {meta['dtype']}, which this "
                    f"reader does not take ({sorted(DTYPES)})")

    def keys(self) -> list[str]:
        return list(self.header)

    def __contains__(self, name: str) -> bool:
        return name in self.header

    def get(self, name: str) -> torch.Tensor:
        meta = self.header[name]
        begin, end = meta["data_offsets"]
        dt = DTYPES[meta["dtype"]]
        raw = np.frombuffer(self._map, dtype=np.uint8, count=end - begin,
                            offset=self._base + begin).copy()
        return torch.from_numpy(raw).view(dt).reshape(meta["shape"])

    def close(self) -> None:
        self._map.close()


def numpy_view(t: torch.Tensor) -> np.ndarray:
    """The numpy array of a CPU tensor's bits: bfloat16 as uint16, float8
    as uint8, uint16 as uint16."""
    bits = _NP_BITS.get(t.dtype)
    if bits is None:
        return t.numpy()
    arr = t.view(bits).numpy()
    return arr.view(np.uint16) if bits is torch.int16 else arr


def load_file(path: str) -> dict[str, torch.Tensor]:
    f = SafetensorsFile(path)
    try:
        return {k: f.get(k) for k in f.keys()}
    finally:
        f.close()


def _raw(x) -> tuple[str, list[int], bytes]:
    if isinstance(x, torch.Tensor):
        t = x.detach().to("cpu").contiguous()
        if t.dtype not in CODES:
            raise ValueError(f"save_file: dtype {t.dtype} has no code")
        return (CODES[t.dtype], list(t.shape),
                t.reshape(-1).view(torch.uint8).numpy().tobytes())
    a = np.ascontiguousarray(x)
    code = _NP_CODES.get(a.dtype.name)
    if code is None:
        raise ValueError(f"save_file: dtype {a.dtype} has no code")
    return code, list(a.shape), a.tobytes()


def save_file(tensors: dict, path: str, metadata: dict | None = None) -> None:
    """Write torch tensors or numpy arrays (numpy's ml_dtypes bfloat16 /
    float8_e4m3fn too) by name; the header lists them in name order."""
    header, blobs, offset = {}, [], 0
    if metadata:
        header["__metadata__"] = {str(k): str(v) for k, v in metadata.items()}
    for name in sorted(tensors):
        code, shape, raw = _raw(tensors[name])
        header[name] = {"dtype": code, "shape": shape,
                        "data_offsets": [offset, offset + len(raw)]}
        blobs.append(raw)
        offset += len(raw)
    text = json.dumps(header, separators=(",", ":")).encode()
    text += b" " * (-len(text) % 8)
    with open(path, "wb") as fh:
        fh.write(struct.pack("<Q", len(text)))
        fh.write(text)
        for raw in blobs:
            fh.write(raw)
