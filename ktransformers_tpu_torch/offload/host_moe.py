"""ctypes binding and packers for the host-resident routed-expert FFN
(counterpart of ktransformers_tpu/offload/host_moe.py).

The C++ is the port's own copy, ktransformers_tpu_torch/csrc/host_moe.cpp,
with the JAX package's arithmetic: on the same arrays the two libraries
give the same float32 bits. It is built with g++ (csrc/Makefile's flags:
-O3 -march=native -fopenmp) at first use into
ktransformers_tpu_torch/csrc/build/libhost_moe.so, rebuilt when the source
is newer. A failed build raises: nothing here falls back to another path.

Host layout (independent of the card's formats):
  gate_up  [E, 2N, K/2] uint8   row n = gate_n, row N+n = up_n; byte j
                                 packs codes for k=2j (lo) / k=2j+1 (hi),
                                 code = q+8 with q in [-8, 7]
  gu_scales[E, 2N, K/gs] f32
  down     [E, K, N/2]  uint8   rows over the model dim
  dn_scales[E, K, N/gs] f32

The C++ computes each (token, slot) pair's expert in float32 from these
codes, gate_up -> act(gate) * up -> down, and sums the pairs with their
combine weights. ctypes releases the GIL for the call, so another Python
thread keeps running while the host computes. Its OpenMP team has
``threads`` threads a call (HostMoELayer's, by default
torch.get_num_threads() when the layer is made); each output row is
computed by one thread, so the count changes no bit of the result.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
import weakref

import torch

from ktransformers_tpu_torch.ops.activations import ActivationConfig
from ktransformers_tpu_torch.quant.formats import (
    QTensor,
    raw_int4_data,
    unpack_int4,
)

_CSRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "csrc")
_SRC = os.path.join(_CSRC, "host_moe.cpp")
_SO = os.path.join(_CSRC, "build", "libhost_moe.so")
CXXFLAGS = ["-O3", "-march=native", "-fPIC", "-fopenmp", "-std=c++17",
            "-Wall", "-shared"]

# the C++'s activation codes; the JAX binding sends every other kind to
# silu without a word (its host_moe.py:160), the port refuses them
_ACT_CODES = {"silu": 0}

_lock = threading.Lock()
_lib = None


def build() -> str:
    """Compile csrc/host_moe.cpp with g++ into csrc/build (written under a
    temporary name and renamed into place, so concurrent builds never
    load a half-written library); returns the library's path. Raises
    RuntimeError with the compiler's output when the build fails."""
    if os.path.exists(_SO) and os.path.getmtime(_SO) >= os.path.getmtime(
            _SRC):
        return _SO
    os.makedirs(os.path.dirname(_SO), exist_ok=True)
    tmp = f"{_SO}.{os.getpid()}.{threading.get_ident()}.tmp"
    try:
        proc = subprocess.run(["g++", *CXXFLAGS, "-o", tmp, _SRC],
                              capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.SubprocessError) as e:
        raise RuntimeError(f"building {_SO} failed: {e}") from e
    if proc.returncode != 0:
        raise RuntimeError(f"building {_SO} failed:\n{proc.stderr[-4000:]}")
    os.replace(tmp, _SO)
    return _SO


def get_lib() -> ctypes.CDLL:
    """The loaded library (built first where needed); raises where it
    cannot be built or loaded."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(build())
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.kt_hostmoe_create.restype = P
        lib.kt_hostmoe_create.argtypes = [I, I, I, I, I, P, P, P, P, I]
        lib.kt_hostmoe_destroy.restype = None
        lib.kt_hostmoe_destroy.argtypes = [P]
        lib.kt_hostmoe_forward.restype = None
        lib.kt_hostmoe_forward.argtypes = [P, I, I, P, P, P, P, I]
        lib.kt_hostmoe_max_threads.restype = I
        lib.kt_hostmoe_max_threads.argtypes = []
        _lib = lib
        return _lib


def openmp_max_threads() -> int:
    """OpenMP's default team size in this process (omp_get_max_threads)."""
    return int(get_lib().kt_hostmoe_max_threads())


def activation_code(act: ActivationConfig) -> int:
    """The C++'s code of a GLU activation; raises for what it does not
    compute (ReLU, gelu, swigluoai, a swiglu_limit clamp) rather than run
    it as silu."""
    if act.swiglu_limit is not None:
        raise ValueError(
            f"host expert FFN: a swiglu_limit clamp ({act.swiglu_limit}) is "
            "not computed by csrc/host_moe.cpp")
    if act.kind not in _ACT_CODES:
        raise ValueError(
            f"host expert FFN: activation {act.kind!r} is not computed by "
            "csrc/host_moe.cpp (silu only; its gelu is the tanh form, the "
            "model's the exact one)")
    return _ACT_CODES[act.kind]


def pack_host_from_qtensor(qt: QTensor) -> tuple[torch.Tensor, torch.Tensor]:
    """An int4_g QTensor [E, K/2, N] (group-split nibbles, as stored, or
    already repacked for W4A8) on any device -> (host codes uint8
    [E, N, K/2], host scales float32 [E, N, K/gs]) on the CPU. Lossless:
    the same integer codes and group scales, re-laid-out. The unpack,
    transpose and nibble repack run where qt lies (on the card for a
    card's weights) and the result is copied to the host once."""
    if qt.kind != "int4_g":
        raise ValueError(f"host expert FFN takes int4_g experts, not "
                         f"{qt.kind}")
    if qt.data.dim() != 3:
        raise ValueError(f"want expert weights [E, K/2, N], got "
                         f"{tuple(qt.data.shape)}")
    k = qt.in_features
    codes = unpack_int4(raw_int4_data(qt), qt.group_size)  # [E, K, N]
    c = (codes.transpose(1, 2).to(torch.int16) + 8).to(torch.uint8)
    c = c.reshape(*c.shape[:2], k // 2, 2)  # [E, N, K/2, 2]
    packed = (c[..., 0] | (c[..., 1] << 4)).contiguous()
    ng = k // (qt.group_size or k)
    scales = qt.scales[..., :ng, :].to(torch.float32).transpose(1, 2)
    return packed.cpu().contiguous(), scales.cpu().contiguous()


def _check_host(t: torch.Tensor, dtype: torch.dtype, what: str) -> None:
    if t.device.type != "cpu" or t.dtype != dtype or not t.is_contiguous():
        raise ValueError(f"{what}: want a contiguous CPU {dtype} tensor, got "
                         f"{t.dtype} on {t.device}")


class HostMoELayer:
    """One MoE layer's routed experts, resident in host RAM (CPU torch
    tensors in the host layout). The C++ borrows their pointers: the layer
    keeps every tensor alive while its handle lives, and frees the handle
    when the layer is collected."""

    def __init__(self, gate_up: torch.Tensor, gu_scales: torch.Tensor,
                 down: torch.Tensor, dn_scales: torch.Tensor,
                 activation: ActivationConfig = ActivationConfig(),
                 threads: int | None = None):
        act = activation_code(activation)
        for t, dt, what in ((gate_up, torch.uint8, "gate_up"),
                            (gu_scales, torch.float32, "gu_scales"),
                            (down, torch.uint8, "down"),
                            (dn_scales, torch.float32, "dn_scales")):
            _check_host(t, dt, what)
        e, twon, k2 = gate_up.shape
        self.E, self.N, self.K = e, twon // 2, k2 * 2
        if (tuple(down.shape) != (e, self.K, self.N // 2)
                or gu_scales.shape[:2] != (e, twon)
                or dn_scales.shape[:2] != (e, self.K)
                or self.K % gu_scales.shape[2]
                or self.N % dn_scales.shape[2]):
            raise ValueError("host expert layout shapes disagree: gate_up "
                             f"{tuple(gate_up.shape)}, down "
                             f"{tuple(down.shape)}, scales "
                             f"{tuple(gu_scales.shape)} / "
                             f"{tuple(dn_scales.shape)}")
        gs_gu = self.K // gu_scales.shape[2]
        gs_dn = self.N // dn_scales.shape[2]
        self.tensors = (gate_up, gu_scales, down, dn_scales)
        self.threads = threads or torch.get_num_threads()
        lib = get_lib()
        self._lib = lib
        self._h = lib.kt_hostmoe_create(
            self.E, self.K, self.N, gs_gu, gs_dn,
            *(t.data_ptr() for t in self.tensors), act)
        weakref.finalize(self, lib.kt_hostmoe_destroy, self._h)

    @classmethod
    def from_qtensors(cls, gate_up_qt: QTensor, down_qt: QTensor,
                      activation: ActivationConfig = ActivationConfig(),
                      threads: int | None = None) -> "HostMoELayer":
        """From the port's int4_g expert QTensors on any device: gate_up
        [E, K(/2), 2N], down [E, N(/2), K] (MoEWeights' layout)."""
        activation_code(activation)  # refuse before any copy
        gu, gus = pack_host_from_qtensor(gate_up_qt)  # [E, 2N, K/2]
        dn, dns = pack_host_from_qtensor(down_qt)  # [E, K, N/2]
        return cls(gu, gus, dn, dns, activation, threads)

    def forward(self, x: torch.Tensor, ids: torch.Tensor,
                weights: torch.Tensor,
                out: torch.Tensor | None = None) -> torch.Tensor:
        """x [T, K] float32, ids [T, k] int32 (an id outside [0, E), or a
        weight of 0, skips the pair), weights [T, k] float32, all
        contiguous on the CPU -> the combined expert output [T, K] float32,
        written into ``out`` where given (a pinned staging buffer)."""
        t, k = ids.shape
        _check_host(x, torch.float32, "x")
        _check_host(ids, torch.int32, "ids")
        _check_host(weights, torch.float32, "weights")
        if x.shape != (t, self.K) or weights.shape != (t, k):
            raise ValueError(f"host expert FFN: x {tuple(x.shape)}, ids "
                             f"{tuple(ids.shape)}, weights "
                             f"{tuple(weights.shape)} for K = {self.K}")
        if out is None:
            out = torch.empty(t, self.K, dtype=torch.float32)
        _check_host(out, torch.float32, "out")
        if out.shape != (t, self.K):
            raise ValueError(f"out {tuple(out.shape)}, want {(t, self.K)}")
        self._lib.kt_hostmoe_forward(
            self._h, t, k, x.data_ptr(), ids.data_ptr(), weights.data_ptr(),
            out.data_ptr(), self.threads)
        return out

    @property
    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in self.tensors)
