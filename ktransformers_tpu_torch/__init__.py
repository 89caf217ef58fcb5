"""PyTorch + CUDA port of ktransformers_tpu for NVIDIA Hopper (H100).

The JAX package ``ktransformers_tpu`` stays the reference; this package
mirrors its module names. Plain tensor code is PyTorch; every Pallas TPU
kernel on the ported path is a hand-written CUDA C++ kernel for sm_90a
(``csrc/``), built with nvcc at first use and bound through ctypes
(``ops/cuda/``). Each kernel wrapper takes its plain-PyTorch version only
for tensors that lie on the CPU.

Entry points default to ``device="cuda"``; pass ``device="cpu"`` to run
the plain versions.
"""

__version__ = "0.1.0"
