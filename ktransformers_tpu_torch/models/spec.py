"""ModelSpec: static architecture record and the HF config translator
(counterpart of ktransformers_tpu/models/spec.py), limited to the
``deepseek_v2`` family this port runs. Config values the port does not
handle raise instead of being ignored."""

from __future__ import annotations

import dataclasses
from typing import Any

from ktransformers_tpu_torch.ops.activations import ActivationConfig
from ktransformers_tpu_torch.ops.gate import GateConfig
from ktransformers_tpu_torch.ops.rope import RopeConfig


@dataclasses.dataclass(frozen=True)
class AttentionSpec:
    kind: str  # "mla"
    num_heads: int
    num_kv_heads: int
    head_dim: int  # qk_nope + qk_rope
    q_lora_rank: int | None = None
    kv_lora_rank: int = 0
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0
    softmax_scale: float | None = None  # None = head_dim**-0.5 (x yarn mscale)


@dataclasses.dataclass(frozen=True)
class MoESpec:
    num_experts: int
    top_k: int
    moe_intermediate_size: int
    gate: GateConfig = None  # type: ignore[assignment]
    shared_expert_intermediate_size: int = 0
    first_k_dense: int = 0
    moe_layer_freq: int = 1

    def is_moe_layer(self, layer_idx: int) -> bool:
        return (layer_idx >= self.first_k_dense
                and layer_idx % self.moe_layer_freq == 0)


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    model_type: str
    vocab_size: int
    hidden_size: int
    num_layers: int
    intermediate_size: int  # dense-MLP layers
    rms_norm_eps: float
    attention: AttentionSpec
    rope: RopeConfig
    activation: ActivationConfig = ActivationConfig()
    moe: MoESpec | None = None
    tie_word_embeddings: bool = False
    max_position: int = 4096


def _rope_from_hf(cfg: dict, dim: int) -> RopeConfig:
    scaling = cfg.get("rope_scaling") or {}
    stype = scaling.get("type") or scaling.get("rope_type")
    if stype not in (None, "yarn", "linear"):
        raise ValueError(f"rope_scaling type {stype!r} is not ported")
    return RopeConfig(
        dim=dim,
        base=float(cfg.get("rope_theta", 10000.0)),
        max_position=int(cfg.get("max_position_embeddings", 4096)),
        scaling_type=stype,
        scaling_factor=float(scaling.get("factor", 1.0)),
        original_max_position=int(
            scaling.get("original_max_position_embeddings", 4096)
        ),
        beta_fast=float(scaling.get("beta_fast", 32.0)),
        beta_slow=float(scaling.get("beta_slow", 1.0)),
        mscale=float(scaling.get("mscale", 1.0)),
        mscale_all_dim=float(scaling.get("mscale_all_dim", 0.0)),
        interleaved=True,
    )


_GROUP_METHODS = {"greedy": "none", "group_limited_greedy": "group_max"}


def _deepseek_v2_spec(cfg: dict) -> ModelSpec:
    if cfg.get("q_lora_rank"):
        raise ValueError("q_lora_rank (q_a/q_b projections) is not ported")
    if cfg.get("attention_bias"):
        raise ValueError("attention_bias is not ported")
    if cfg.get("tie_word_embeddings"):
        raise ValueError("tie_word_embeddings is not ported")
    scoring = cfg.get("scoring_func", "softmax")
    if scoring != "softmax":
        raise ValueError(f"scoring_func {scoring!r} is not ported")
    topk_method = cfg.get("topk_method", "greedy")
    if topk_method not in _GROUP_METHODS:
        raise ValueError(f"topk_method {topk_method!r} is not ported")
    if cfg.get("hidden_act", "silu") != "silu":
        raise ValueError(f"hidden_act {cfg['hidden_act']!r} is not ported")
    qk_rope = int(cfg["qk_rope_head_dim"])
    qk_nope = int(cfg["qk_nope_head_dim"])
    attn = AttentionSpec(
        kind="mla",
        num_heads=int(cfg["num_attention_heads"]),
        num_kv_heads=int(cfg["num_attention_heads"]),
        head_dim=qk_nope + qk_rope,
        q_lora_rank=None,
        kv_lora_rank=int(cfg["kv_lora_rank"]),
        qk_nope_head_dim=qk_nope,
        qk_rope_head_dim=qk_rope,
        v_head_dim=int(cfg["v_head_dim"]),
    )
    gate = GateConfig(
        num_experts=int(cfg["n_routed_experts"]),
        top_k=int(cfg["num_experts_per_tok"]),
        scoring="softmax",
        group_method=_GROUP_METHODS[topk_method],
        n_group=int(cfg.get("n_group", 1) or 1),
        topk_group=int(cfg.get("topk_group", 1) or 1),
        norm_topk_prob=bool(cfg.get("norm_topk_prob", False)),
        routed_scaling_factor=float(cfg.get("routed_scaling_factor", 1.0)),
    )
    moe = MoESpec(
        num_experts=int(cfg["n_routed_experts"]),
        top_k=int(cfg["num_experts_per_tok"]),
        moe_intermediate_size=int(cfg["moe_intermediate_size"]),
        gate=gate,
        shared_expert_intermediate_size=int(cfg.get("n_shared_experts") or 0)
        * int(cfg["moe_intermediate_size"]),
        first_k_dense=int(cfg.get("first_k_dense_replace", 0)),
        moe_layer_freq=int(cfg.get("moe_layer_freq", 1)),
    )
    return ModelSpec(
        model_type="deepseek_v2",
        vocab_size=int(cfg["vocab_size"]),
        hidden_size=int(cfg["hidden_size"]),
        num_layers=int(cfg["num_hidden_layers"]),
        intermediate_size=int(cfg["intermediate_size"]),
        rms_norm_eps=float(cfg.get("rms_norm_eps", 1e-6)),
        attention=attn,
        rope=_rope_from_hf(cfg, qk_rope),
        moe=moe,
        max_position=int(cfg.get("max_position_embeddings", 4096)),
    )


def spec_from_hf_config(cfg: Any) -> ModelSpec:
    """Build a ModelSpec from an HF config object or dict."""
    if not isinstance(cfg, dict):
        cfg = cfg.to_dict()
    mt = cfg.get("model_type")
    if mt != "deepseek_v2":
        raise ValueError(
            f"unsupported model_type {mt!r}; this port supports deepseek_v2"
        )
    return _deepseek_v2_spec(cfg)


# DeepSeek-V2-Lite (deepseek-ai/DeepSeek-V2-Lite config.json), the
# configuration bench.py drives.
DEEPSEEK_V2_LITE = dict(
    model_type="deepseek_v2",
    vocab_size=102400,
    hidden_size=2048,
    intermediate_size=10944,
    moe_intermediate_size=1408,
    num_hidden_layers=27,
    num_attention_heads=16,
    num_key_value_heads=16,
    n_shared_experts=2,
    n_routed_experts=64,
    num_experts_per_tok=6,
    first_k_dense_replace=1,
    moe_layer_freq=1,
    topk_method="greedy",
    norm_topk_prob=False,
    routed_scaling_factor=1.0,
    scoring_func="softmax",
    kv_lora_rank=512,
    q_lora_rank=None,
    qk_rope_head_dim=64,
    qk_nope_head_dim=128,
    v_head_dim=128,
    max_position_embeddings=2048,
    rms_norm_eps=1e-6,
    rope_theta=10000.0,
)
