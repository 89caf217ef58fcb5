"""Hand-written CUDA kernels for Hopper (sm_90a) and their wrappers.

Every wrapper launches its kernel for CUDA tensors (or raises) and takes
its plain-PyTorch version, which lives beside it, only for CPU tensors.
``LAUNCHES`` counts, per TPU kernel replaced, the wrapper calls that
launched on the card; a call of an FFN wrapper is two kernel launches.
"""

from __future__ import annotations

KERNELS = (
    "w4a8_prep",
    "dense_w4a8_matmul",
    "gathered_w4a8_ffn",
    "dense_w4a8_ffn",
    "grouped_w4a8_ffn",
    "mla_decode_fused",
)

LAUNCHES = {name: 0 for name in KERNELS}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0
