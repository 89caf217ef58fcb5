"""Build the CUDA sources under ktransformers_tpu_torch/csrc with nvcc and
load them through ctypes.

Each ``csrc/<name>.cu`` becomes ``csrc/build/lib<name>.so`` (plain C
interface, no PyTorch headers, so a build takes seconds). ``build_all``
starts one nvcc per source at once. A library is rebuilt when any source
or header in csrc/ is newer than it. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "csrc")
BUILD = os.path.join(CSRC, "build")
SOURCES = ("w4a8_matmul", "w4a8_ffn", "mla_decode")
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]

_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL] = {}

P = ctypes.c_void_p
I = ctypes.c_int
F = ctypes.c_float

# argtypes of every exported function, so ctypes never truncates a pointer
SIGNATURES = {
    "w4a8_matmul": {
        "kt_w4a8_rows": [P] * 10 + [I] * 7 + [P, P],
        "kt_w4a8_prep": [P, I, I, I, I] + [P] * 6,
    },
    "w4a8_ffn": {
        "kt_w4a8_ffn_up": [P] * 10 + [I] * 8 + [P] * 6,
        "kt_w4a8_ffn_down": [P] * 10 + [I] * 7 + [P, P],
    },
    "mla_decode": {
        "kt_mla_decode_fused": [P] * 8 + [I, I, I, F, F, I] + [P] * 4,
    },
}


def nvcc_path() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (PATH or /usr/local/cuda/bin)")
    return path


def _lib_path(name: str) -> str:
    return os.path.join(BUILD, f"lib{name}.so")


def _stale(name: str) -> bool:
    out = _lib_path(name)
    if not os.path.exists(out):
        return True
    t = os.path.getmtime(out)
    return any(
        os.path.getmtime(os.path.join(CSRC, f)) > t
        for f in os.listdir(CSRC)
        if f.endswith((".cu", ".cuh"))
    )


def _nvcc_cmd(name: str, out: str) -> list[str]:
    return [
        nvcc_path(), *ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
        "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-I", CSRC,
        "-o", out, os.path.join(CSRC, f"{name}.cu"),
    ]


def build_all(names=SOURCES) -> dict[str, str]:
    """Compile every stale source in parallel; returns {name: compiler
    log}. Raises RuntimeError with the log when a build fails. Each
    library is written under a temporary name and renamed into place, so
    another process never loads a half-written one."""
    os.makedirs(BUILD, exist_ok=True)
    tmp = {n: f"{_lib_path(n)}.{os.getpid()}.tmp" for n in names}
    procs = {
        n: subprocess.Popen(_nvcc_cmd(n, tmp[n]), stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
        for n in names if _stale(n)
    }
    logs, failed = {}, []
    for n, p in procs.items():
        logs[n] = p.communicate()[0]
        if p.returncode != 0:
            failed.append(n)
        else:
            os.replace(tmp[n], _lib_path(n))
    if failed:
        raise RuntimeError(
            "nvcc failed for " + ", ".join(failed) + ":\n"
            + "\n".join(logs[n] for n in failed)
        )
    return logs


def lib(name: str) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu, building it first if needed."""
    with _LOCK:
        if name not in _LIBS:
            if _stale(name):
                build_all((name,))
            cdll = ctypes.CDLL(_lib_path(name))
            for fn, argtypes in SIGNATURES[name].items():
                f = getattr(cdll, fn)
                f.argtypes = argtypes
                f.restype = ctypes.c_int
            _LIBS[name] = cdll
        return _LIBS[name]


def check(err: int, what: str) -> None:
    """Raise when a launch returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError {err}")
