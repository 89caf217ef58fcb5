"""Synthetic parameters at real model scale (counterpart of
ktransformers_tpu/models/init.py:init_params_synthetic).

Quantized weights are drawn directly as random packed codes with constant
scales, on the device, from one seeded torch.Generator, so a multi-GB
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

    def q(self, shape, kind: str, group_size: int) -> QTensor:
        *lead, k, n = shape
        if kind == "bf16":
            return QTensor(self.normal(shape, 1.0 / math.sqrt(k)).to(self.dtype),
                           None, None, kind="bf16", group_size=0)
        if kind != "int4_g":
            raise ValueError(f"init: quant kind {kind!r} is not ported")
        g = effective_group_size(k, group_size)
        data = torch.randint(0, 256, (*lead, k // 2, n), generator=self.gen,
                             device=self.device, dtype=torch.uint8)
        scales = torch.full((*lead, k // g, n), 1.0 / math.sqrt(k) / 7.0,
                            dtype=torch.float32, device=self.device)
        return QTensor(data, scales, None, kind="int4_g", group_size=g)


def init_params_synthetic(spec: ModelSpec, seed: int = 0,
                          quant: str = "int4_g", moe_quant: str | None = None,
                          group_size: int = 128, dtype=torch.bfloat16,
                          device="cuda"):
    """Random params for ``spec``: ``quant`` for attention, dense MLP,
    shared experts and lm_head, ``moe_quant`` for routed experts."""
    moe_quant = moe_quant or quant
    rd = _Draw(seed, device, dtype)
    a = spec.attention
    d = spec.hidden_size
    ones = lambda n: torch.ones(n, dtype=torch.float32, device=rd.device)  # noqa: E731
    layers = []
    for li in range(spec.num_layers):
        nope, dr, r, v = (a.qk_nope_head_dim, a.qk_rope_head_dim,
                          a.kv_lora_rank, a.v_head_dim)
        h = a.num_heads
        lp = {
            "input_norm": ones(d),
            "post_attn_norm": ones(d),
            "attn": {
                "q_proj": rd.q((d, h * (nope + dr)), quant, group_size),
                "kv_a": rd.q((d, r + dr), quant, group_size),
                "kv_a_norm": ones(r),
                "w_uk": rd.normal((h, nope, r), 1.0 / math.sqrt(nope)),
                "w_uv": rd.normal((h, r, v), 1.0 / math.sqrt(r)),
                "o_proj": rd.q((h * v, d), quant, group_size),
            },
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
            if m.shared_expert_intermediate_size:
                fs = m.shared_expert_intermediate_size
                moe["shared"] = {
                    "gate_up": rd.q((d, 2 * fs), quant, group_size),
                    "down": rd.q((fs, d), quant, group_size),
                }
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
