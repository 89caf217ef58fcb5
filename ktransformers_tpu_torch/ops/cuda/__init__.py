"""Hand-written CUDA kernels for Hopper (sm_90a) and their wrappers.

Every wrapper launches its kernel for CUDA tensors (or raises) and takes
its plain-PyTorch version, which lives beside it, only for CPU tensors.
``KERNELS`` names the eighteen kernels: the activation prep, the five of the
W4A8 single-user generation path, the two MLA paged-attention kernels of
the serving path, the three quant_matmul entries every other weight format
runs through, the unfused MLA decode attention, the gathered and grouped
W4A8 matmuls (experts too wide for the fused FFN, Mixtral's), the two
GQA paged-attention kernels and the two transposed matmuls of the LoRA SFT
backward (dense, and per-row experts: grouped or gathered). ``LAUNCHES``
counts, per TPU kernel replaced, the wrapper calls that launched on the
card; a call of an FFN wrapper is two kernel launches. Sixteen wrappers
route a call to the first version of their kernel or to a redesigned one
(``route`` in ops/cuda/quant_matmul.py, quant_matmul_t.py, w4a8_matmul.py
and mla_decode.py, ``attention_route`` in mla_decode.py, ``ffn_route`` in
w4a8_ffn.py, ``decode_route``, ``prefill_route``, ``gqa_decode_route`` and
``gqa_prefill_route`` in paged_attention.py); ``ROUTED_KERNELS`` names
each redesigned kernel with the wrappers that route to it, and
``ROUTED_LAUNCHES`` counts, per redesigned kernel, the wrapper calls that
took it (an FFN call takes two: its gate_up kernel, w4a8_ffn_mma_kernel or
w4a8_ffn_gemv_kernel, and w4a8_mma_kernel or w4a8_gemv_kernel for the
down). A W4A8 kernel's calls on weights with zero points count under its
instantiation with the zero term, ``<zp>`` after its name. The W4A8 GEMVs and, below their crossovers, the W4A8 tensor-core
kernels quantize x themselves (``folds`` / ``gemv_folds`` in
w4a8_matmul.py, ``ffn_folds`` in w4a8_ffn.py): such a call makes no
w4a8_prep launch, so ``LAUNCHES["w4a8_prep"]`` counts the calls that still
do.
"""

from __future__ import annotations

KERNELS = (
    "w4a8_prep",
    "dense_w4a8_matmul",
    "gathered_w4a8_ffn",
    "dense_w4a8_ffn",
    "grouped_w4a8_ffn",
    "mla_decode_fused",
    "mla_paged_decode",
    "mla_paged_prefill",
    "quant_matmul",
    "gathered_quant_matmul",
    "grouped_quant_matmul",
    "mla_decode_attention",
    "gathered_w4a8_matmul",
    "grouped_w4a8_matmul",
    "gqa_paged_decode",
    "gqa_paged_prefill",
    "quant_matmul_t",
    "grouped_quant_matmul_t",
)

LAUNCHES = {name: 0 for name in KERNELS}

# the redesigned kernels and the wrappers that route calls to them
ROUTED_KERNELS = {
    "quant_mma_kernel": ("quant_matmul", "grouped_quant_matmul"),
    "w4a8_mma_kernel": ("dense_w4a8_matmul", "grouped_w4a8_matmul",
                        "dense_w4a8_ffn", "grouped_w4a8_ffn"),
    "quant_gemv_kernel": ("quant_matmul", "gathered_quant_matmul"),
    "quant_wgmma_t_kernel": ("quant_matmul_t", "grouped_quant_matmul_t"),
    "w4a8_gemv_kernel": ("dense_w4a8_matmul", "gathered_w4a8_matmul",
                         "gathered_w4a8_ffn", "dense_w4a8_ffn"),
    "w4a8_ffn_mma_kernel": ("dense_w4a8_ffn", "grouped_w4a8_ffn"),
    "mla_decode_split_kernel": ("mla_decode_fused",),
    "mla_prefill_mma_kernel": ("mla_paged_prefill",),
    "mla_paged_decode_split_kernel": ("mla_paged_decode",),
    "gqa_prefill_mma_kernel": ("gqa_paged_prefill",),
    "w4a8_ffn_gemv_kernel": ("gathered_w4a8_ffn", "dense_w4a8_ffn"),
    "gqa_decode_split_kernel": ("gqa_paged_decode",),
    # the split decode without its current-token block (bf16 row 6)
    "mla_decode_split_kernel<false>": ("mla_decode_attention",),
    # the W4A8 kernels' instantiations with the zero term (int4_gz weights)
    "w4a8_gemv_kernel<zp>": ("dense_w4a8_matmul", "gathered_w4a8_matmul",
                             "gathered_w4a8_ffn", "dense_w4a8_ffn"),
    "w4a8_mma_kernel<zp>": ("dense_w4a8_matmul", "grouped_w4a8_matmul",
                            "dense_w4a8_ffn", "grouped_w4a8_ffn"),
    "w4a8_ffn_gemv_kernel<zp>": ("gathered_w4a8_ffn", "dense_w4a8_ffn"),
    "w4a8_ffn_mma_kernel<zp>": ("dense_w4a8_ffn", "grouped_w4a8_ffn"),
    # the activation prep of a group past 512 (per-channel int4), a block a
    # (row, group), and of a per-channel down group (the FFN's split route)
    "w4a8_prep_block_kernel": ("w4a8_prep", "gathered_w4a8_ffn",
                               "dense_w4a8_ffn", "grouped_w4a8_ffn"),
}
ROUTED_LAUNCHES = {name: 0 for name in ROUTED_KERNELS}


def reset_launches() -> None:
    for counts in (LAUNCHES, ROUTED_LAUNCHES):
        for name in counts:
            counts[name] = 0
