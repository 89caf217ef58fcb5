"""ctypes binding for the native host data path: the port's own copy of
the JAX package's csrc/ggml_decode.cpp, in ktransformers_tpu_torch/csrc/.

Built with g++ (OpenMP, -O3) at first use into
ktransformers_tpu_torch/csrc/build/libggml_decode.so, rebuilt when the
source is newer; the same contract as ktransformers_tpu/loader/native.py:
``available``, ``decode`` and ``pack_int4_group_split`` return None (and
loader/gguf.py takes its numpy decoders) where the toolchain is missing.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

_CSRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "csrc")
_SRC = os.path.join(_CSRC, "ggml_decode.cpp")
_SO = os.path.join(_CSRC, "build", "libggml_decode.so")
CXXFLAGS = ["-O3", "-march=native", "-fPIC", "-fopenmp", "-std=c++17",
            "-Wall", "-shared"]

_lock = threading.Lock()
_lib = None
_tried = False

_DECODERS = {
    "Q8_0": ("decode_q8_0", 34, 32),
    "Q4_0": ("decode_q4_0", 18, 32),
    "Q2_K": ("decode_q2_k", 84, 256),
    "Q3_K": ("decode_q3_k", 110, 256),
    "Q4_K": ("decode_q4_k", 144, 256),
    "Q5_K": ("decode_q5_k", 176, 256),
    "Q6_K": ("decode_q6_k", 210, 256),
}


def build() -> bool:
    """Compile csrc/ggml_decode.cpp with g++ (written under a temporary
    name and renamed into place); True when the library exists after."""
    if os.path.exists(_SO) and os.path.getmtime(_SO) >= os.path.getmtime(
            _SRC):
        return True
    os.makedirs(os.path.dirname(_SO), exist_ok=True)
    tmp = f"{_SO}.{os.getpid()}.tmp"
    try:
        subprocess.run(["g++", *CXXFLAGS, "-o", tmp, _SRC], check=True,
                       capture_output=True, timeout=300)
        os.replace(tmp, _SO)
    except (OSError, subprocess.SubprocessError):
        return False
    return os.path.exists(_SO)


def get_lib():
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if not build():
            return None
        lib = ctypes.CDLL(_SO)
        u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
        f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
        for fname, _, _ in _DECODERS.values():
            fn = getattr(lib, fname)
            fn.argtypes = [u8p, f32p, ctypes.c_int64]
            fn.restype = None
        lib.pack_int4_group_split.argtypes = [
            f32p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, u8p, f32p,
        ]
        lib.pack_int4_group_split.restype = None
        lib.native_num_threads.restype = ctypes.c_int
        _lib = lib
        return _lib


def available() -> bool:
    return get_lib() is not None


def decode(raw: np.ndarray, type_name: str) -> np.ndarray | None:
    """Native block decode; returns None if unsupported/unavailable."""
    lib = get_lib()
    if lib is None or type_name not in _DECODERS:
        return None
    fname, block_bytes, per_block = _DECODERS[type_name]
    raw = np.ascontiguousarray(raw, np.uint8)
    n_blocks = raw.size // block_bytes
    out = np.empty(n_blocks * per_block, np.float32)
    getattr(lib, fname)(raw, out, n_blocks)
    return out


def pack_int4_group_split(
    w: np.ndarray, group_size: int
) -> tuple[np.ndarray, np.ndarray] | None:
    """float32 [K, N] -> (packed uint8 [K/2, N], scales f32 [K/gs, N])."""
    lib = get_lib()
    if lib is None:
        return None
    w = np.ascontiguousarray(w, np.float32)
    k, n = w.shape
    assert k % group_size == 0 and group_size % 2 == 0
    packed = np.empty((k // 2, n), np.uint8)
    scales = np.empty((k // group_size, n), np.float32)
    lib.pack_int4_group_split(w, k, n, group_size, packed, scales)
    return packed, scales
