"""Synthetic parameters at real model scale (counterpart of
ktransformers_tpu/models/init.py:init_params_synthetic).

Quantized weights of every format are drawn directly as random packed
codes with constant scales, on the device, from one seeded torch.Generator, so a multi-GB
model initialises in seconds. The bits differ from the JAX package's
(another generator); tests carry JAX weights across with convert.py.
"""

from __future__ import annotations

import math

import torch

from ktransformers_tpu_torch.models.spec import ModelSpec
from ktransformers_tpu_torch.ops.moe import MoEWeights
from ktransformers_tpu_torch.quant.formats import QTensor, effective_group_size


class _Draw:
    def __init__(self, seed: int, device, dtype):
        self.device = torch.device(device)
        self.gen = torch.Generator(device=self.device)
        self.gen.manual_seed(seed)
        self.dtype = dtype

    def normal(self, shape, scale):
        return torch.randn(shape, generator=self.gen, device=self.device,
                           dtype=torch.float32) * scale

    def _bytes(self, shape, lo=0, hi=256, dtype=torch.uint8):
        return torch.randint(lo, hi, shape, generator=self.gen,
                             device=self.device, dtype=dtype)

    def _int4(self, shape):
        """Packed int4 codes [..., K/2, N], each nibble uniform in [-7, 7].
        Zero mean: codes in [-8, 7] (mean -1/2) give every layer's output a
        common component which, summed over 32 layers, swamps the prompt, so
        that every prompt decodes to one token."""
        r = self._bytes(shape, 0, 225).to(torch.int16)
        lo, hi = r % 15 - 7, r // 15 - 7
        return ((lo & 0xF) | ((hi & 0xF) << 4)).to(torch.uint8)

    def _e4m3(self, shape):
        """Random float8_e4m3fn codes without the two NaN bytes."""
        b = self._bytes(shape)
        b = torch.where((b & 0x7F) == 0x7F, b - 1, b)
        return b.view(torch.float8_e4m3fn)

    def q(self, shape, kind: str, group_size: int) -> QTensor:
        """Random codes of ``kind`` for a weight [..., K, N], every code
        valid, with constant scales that keep activations of order one."""
        *lead, k, n = shape
        if kind == "bf16":
            return QTensor(self.normal(shape, 1.0 / math.sqrt(k)).to(self.dtype),
                           None, None, kind="bf16", group_size=0)
        std = 1.0 / math.sqrt(k)

        def full(rows, value, dtype=torch.float32):
            return torch.full((*lead, rows, n), value, dtype=dtype,
                              device=self.device)

        if kind in ("int8", "fp8", "int4"):
            if kind == "int8":
                data, s = self._bytes(shape, -127, 128, torch.int8), std / 127
            elif kind == "fp8":
                data, s = self._e4m3(shape), std / 128
            else:
                data, s = self._int4((*lead, k // 2, n)), std / 7
            return QTensor(data, full(1, s), None, kind=kind, group_size=0)
        if kind in ("int4_g", "int4_gz", "int8_g"):
            g = effective_group_size(k, group_size)
            zeros = None
            if kind == "int8_g":
                data, s = self._bytes(shape, -127, 128, torch.int8), std / 127
            else:
                data, s = self._int4((*lead, k // 2, n)), std / 7
            if kind == "int4_gz":  # zero points in [-8, 7]
                zeros = self._bytes((*lead, k // g, n), -8, 8,
                                    torch.int8).to(torch.float32)
            return QTensor(data, full(k // g, s), zeros, kind=kind,
                           group_size=g)
        if kind in ("mxfp4", "mxfp8"):
            # ue8m0 exponents within one step of the power of two that
            # gives the weights a standard deviation near 1 / sqrt(K)
            g = effective_group_size(k, 32)
            if kind == "mxfp4":
                data, spread = self._bytes((*lead, k // 2, n)), 3.0
            else:
                data, spread = self._e4m3(shape), 128.0
            e0 = 127 + round(math.log2(std / spread))
            exps = self._bytes((*lead, k // g, n), e0 - 1, e0 + 2)
            return QTensor(data, exps, None, kind=kind, group_size=g)
        raise ValueError(f"init: unknown quant kind {kind!r}")


def init_params_synthetic(spec: ModelSpec, seed: int = 0,
                          quant: str = "int4_g", moe_quant: str | None = None,
                          group_size: int = 128, dtype=torch.bfloat16,
                          device="cuda"):
    """Random params for ``spec``: ``quant`` for attention (MLA with q_proj
    or q_a / q_b, GQA's q / k / v / o projections, q_proj twice as wide
    with gated output, or a GatedDeltaNet layer's in_proj_qkvz and
    out_proj), dense MLP, shared experts and lm_head, ``moe_quant`` for
    routed experts; a GatedDeltaNet layer's in_proj_ba in bf16 whatever
    ``dtype``, as the JAX package keeps it; a zero router correction bias
    where the gate has one; GQA q / k / v biases (std 0.01), unit q / k
    norms and the shared expert's gate row where the spec has them, under
    the JAX package's keys."""
    moe_quant = moe_quant or quant
    rd = _Draw(seed, device, dtype)
    a = spec.attention
    d = spec.hidden_size
    ones = lambda n: torch.ones(n, dtype=torch.float32, device=rd.device)  # noqa: E731
    layers = []
    for li in range(spec.num_layers):
        h = a.num_heads
        if spec.layer_kind(li) == "linear":
            la = spec.linear_attn
            attn = {
                "in_proj_qkvz": rd.q((d, 2 * la.key_dim + 2 * la.value_dim),
                                     quant, group_size),
                "in_proj_ba": QTensor(
                    rd.normal((d, 2 * la.num_v_heads),
                              1.0 / math.sqrt(d)).to(torch.bfloat16),
                    None, None, kind="bf16", group_size=0),
                "conv_w": rd.normal((la.conv_dim, la.conv_kernel), 0.3),
                "dt_bias": rd.normal((la.num_v_heads,), 0.5),
                "A_log": rd.normal((la.num_v_heads,), 0.5),
                "norm_w": ones(la.head_v_dim),
                "out_proj": rd.q((la.value_dim, d), quant, group_size),
            }
        elif a.kind == "mla":
            nope, dr, r, v = (a.qk_nope_head_dim, a.qk_rope_head_dim,
                              a.kv_lora_rank, a.v_head_dim)
            if a.q_lora_rank:
                qr = a.q_lora_rank
                attn = {
                    "q_a": rd.q((d, qr), quant, group_size),
                    "q_a_norm": ones(qr),
                    "q_b": rd.q((qr, h * (nope + dr)), quant, group_size),
                }
            else:
                attn = {"q_proj": rd.q((d, h * (nope + dr)), quant,
                                       group_size)}
            attn.update({
                "kv_a": rd.q((d, r + dr), quant, group_size),
                "kv_a_norm": ones(r),
                "w_uk": rd.normal((h, nope, r), 1.0 / math.sqrt(nope)),
                "w_uv": rd.normal((h, r, v), 1.0 / math.sqrt(r)),
                "o_proj": rd.q((h * v, d), quant, group_size),
            })
        else:
            hkv, hd = a.num_kv_heads, a.head_dim
            attn = {
                "q_proj": rd.q((d, h * hd * (2 if a.gated_output else 1)),
                               quant, group_size),
                "k_proj": rd.q((d, hkv * hd), quant, group_size),
                "v_proj": rd.q((d, hkv * hd), quant, group_size),
                "o_proj": rd.q((h * hd, d), quant, group_size),
            }
            if a.attention_bias:  # the JAX package's keys and scale
                attn["q_bias"] = rd.normal((h * hd,), 0.01)
                attn["k_bias"] = rd.normal((hkv * hd,), 0.01)
                attn["v_bias"] = rd.normal((hkv * hd,), 0.01)
            if a.qk_norm:
                attn["q_norm"] = ones(hd)
                attn["k_norm"] = ones(hd)
        lp = {
            "input_norm": ones(d),
            "post_attn_norm": ones(d),
            "attn": attn,
        }
        if spec.moe is not None and spec.moe.is_moe_layer(li):
            m = spec.moe
            f = m.moe_intermediate_size
            moe = {
                "router_w": rd.normal((m.num_experts, d), 1.0 / math.sqrt(d)),
                "experts": MoEWeights(
                    gate_up=rd.q((m.num_experts, d, 2 * f), moe_quant,
                                 group_size),
                    down=rd.q((m.num_experts, f, d), moe_quant, group_size),
                ),
            }
            if m.gate.has_correction_bias:  # zeros, as in the JAX package
                moe["router_bias_corr"] = torch.zeros(
                    m.num_experts, dtype=torch.float32, device=rd.device)
            if m.shared_expert_intermediate_size:
                fs = m.shared_expert_intermediate_size
                moe["shared"] = {
                    "gate_up": rd.q((d, 2 * fs), quant, group_size),
                    "down": rd.q((fs, d), quant, group_size),
                }
                if m.shared_expert_gate:
                    moe["shared_gate"] = rd.normal((1, d), 1.0 / math.sqrt(d))
            lp["moe"] = moe
        else:
            f = spec.intermediate_size
            lp["mlp"] = {
                "gate_up": rd.q((d, 2 * f), quant, group_size),
                "down": rd.q((f, d), quant, group_size),
            }
        layers.append(lp)
    params = {
        "embed": rd.normal((spec.vocab_size, d), 0.02),
        "final_norm": ones(d),
        "layers": layers,
    }
    if not spec.tie_word_embeddings:
        params["lm_head"] = rd.q((d, spec.vocab_size), quant, group_size)
    return params
