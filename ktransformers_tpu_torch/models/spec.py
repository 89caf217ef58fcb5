"""ModelSpec: static architecture record and the HF config translator
(counterpart of ktransformers_tpu/models/spec.py), limited to the families
this port runs: ``deepseek_v2`` / ``deepseek_v3`` / ``kimi_k2`` (MLA
attention), ``mixtral``, ``qwen2_moe`` / ``qwen3_moe``, the dense
``llama`` / ``qwen2`` / ``qwen3`` and ``glm4_moe`` (GQA attention; q / k / v
biases, per-head q / k RMSNorm, partial rotary and tied embeddings where
the config sets them), ``smallthinker`` (per-layer NoPE and sliding-window
layouts, the early router, ReLU-GLU experts) and ``qwen3_next`` (hybrid
GatedDeltaNet / gated full-attention layers). Config values the port does
not handle raise instead of being ignored."""

from __future__ import annotations

import dataclasses
from typing import Any

from ktransformers_tpu_torch.ops.activations import ActivationConfig
from ktransformers_tpu_torch.ops.gate import GateConfig
from ktransformers_tpu_torch.ops.linear_attention import LinearAttentionSpec
from ktransformers_tpu_torch.ops.rope import RopeConfig, yarn_get_mscale


@dataclasses.dataclass(frozen=True)
class AttentionSpec:
    kind: str  # "mla" | "gqa"
    num_heads: int
    num_kv_heads: int
    head_dim: int  # gqa head dim; for mla qk_nope + qk_rope
    # mla only:
    q_lora_rank: int | None = None
    kv_lora_rank: int = 0
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0
    attention_bias: bool = False  # q / k / v projection biases (gqa)
    qk_norm: bool = False  # per-head RMSNorm of q and k before rope (qwen3)
    partial_rotary_dim: int = 0  # 0 = rope over the whole head (glm4: half)
    softmax_scale: float | None = None  # None = head_dim**-0.5 (x yarn mscale)
    gated_output: bool = False  # qwen3-next: q_proj emits [q | gate] per
    # head and the output is multiplied by sigmoid(gate) before o_proj
    sliding_window: int = 0  # smallthinker: window of swa_layout layers

    @property
    def rotary_dim(self) -> int:
        """The leading dims of each head that rope rotates."""
        if self.kind == "mla":
            return self.qk_rope_head_dim
        return self.partial_rotary_dim or self.head_dim


@dataclasses.dataclass(frozen=True)
class MoESpec:
    num_experts: int
    top_k: int
    moe_intermediate_size: int
    gate: GateConfig = None  # type: ignore[assignment]
    shared_expert_intermediate_size: int = 0
    shared_expert_gate: bool = False  # qwen2-moe: sigmoid gate on shared out
    first_k_dense: int = 0
    moe_layer_freq: int = 1
    # deepseek checks layer_idx % freq == 0, qwen (layer_idx + 1) % step
    moe_layer_offset: int = 0
    mlp_only_layers: tuple[int, ...] = ()  # qwen explicit dense layers
    # smallthinker: the router reads the layer input (the residual before
    # the attention norm) instead of the post-attention hidden state
    early_router: bool = False

    def is_moe_layer(self, layer_idx: int) -> bool:
        if layer_idx in self.mlp_only_layers:
            return False
        return (layer_idx >= self.first_k_dense
                and (layer_idx + self.moe_layer_offset)
                % self.moe_layer_freq == 0)


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
    # hybrid models (qwen3-next): per-layer kind "full" | "linear", None =
    # all full attention; linear_attn holds the GatedDeltaNet dims
    layer_kinds: tuple | None = None
    linear_attn: LinearAttentionSpec | None = None
    # smallthinker's per-layer layouts: rope on / off, sliding window on /
    # off (its size in attention.sliding_window)
    rope_layout: tuple | None = None
    swa_layout: tuple | None = None

    def layer_uses_rope(self, li: int) -> bool:
        return self.rope_layout is None or bool(self.rope_layout[li])

    def layer_window(self, li: int) -> int:
        """0 = full attention, else the sliding window's size."""
        if self.swa_layout is None or not self.swa_layout[li]:
            return 0
        return self.attention.sliding_window

    def layer_kind(self, li: int) -> str:
        return "full" if self.layer_kinds is None else self.layer_kinds[li]

    @property
    def hybrid(self) -> bool:
        """Whether some layer is linear attention (state per slot, not
        pages)."""
        return self.layer_kinds is not None and "linear" in self.layer_kinds


def _rope_from_hf(cfg: dict, dim: int, interleaved: bool) -> RopeConfig:
    """The rope of an HF config. Llama-3.1's ``rope_type: llama3`` follows
    HF (transformers' _compute_llama3_parameters): its factor and
    original_max_position_embeddings, and its high / low_freq_factor as
    beta_fast / beta_slow, which are the same quantity (rotations over the
    original context above which a frequency is kept, below which it is
    divided by the factor). The JAX package's translator drops this
    scaling (ROADMAP Queue 3)."""
    scaling = cfg.get("rope_scaling") or {}
    stype = scaling.get("type") or scaling.get("rope_type")
    if stype not in (None, "yarn", "linear", "llama3"):
        raise ValueError(f"rope_scaling type {stype!r} is not ported")
    if stype == "llama3":
        return RopeConfig(
            dim=dim,
            base=float(cfg.get("rope_theta", 10000.0)),
            max_position=int(cfg.get("max_position_embeddings", 4096)),
            scaling_type=stype,
            scaling_factor=float(scaling["factor"]),
            original_max_position=int(
                scaling["original_max_position_embeddings"]),
            beta_fast=float(scaling["high_freq_factor"]),
            beta_slow=float(scaling["low_freq_factor"]),
            interleaved=interleaved,
        )
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
        interleaved=interleaved,
    )


_GROUP_METHODS = {"greedy": "none", "group_limited_greedy": "group_max",
                  "noaux_tc": "group_top2sum"}


def _v3_softmax_scale(cfg: dict, qk_head_dim: int) -> float | None:
    """HF DeepseekV3Attention's softmax scale (transformers 4.57.6,
    modeling_deepseek_v3.py:371-377): qk_head_dim^-0.5, times m_all^2 with
    m_all = yarn_get_mscale(factor, mscale_all_dim) where rope_scaling sets
    mscale_all_dim. The JAX package multiplies by (m / m_all)^2 instead
    (its ops/rope.py:rope_attention_scale), which is 1 at DeepSeek-V3's
    published values; the port follows HF. None without rope_scaling (the
    default rule then gives qk_head_dim^-0.5)."""
    scaling = cfg.get("rope_scaling")
    if not scaling:
        return None
    scale = qk_head_dim ** -0.5
    m_all = float(scaling.get("mscale_all_dim", 0) or 0)
    if m_all:
        scale *= yarn_get_mscale(float(scaling["factor"]), m_all) ** 2
    return scale


def _deepseek_spec(cfg: dict, model_type: str) -> ModelSpec:
    """DeepSeek-V2 / V3 (and Kimi-K2, a V3): MLA attention, optionally
    with the q_a -> q_a_norm -> q_b query projection (q_lora_rank), and a
    softmax or sigmoid router, greedy or group-limited, with the V3
    correction bias under noaux_tc. V3's defaults: sigmoid scoring,
    noaux_tc, norm_topk_prob."""
    v3 = model_type == "deepseek_v3"
    if cfg.get("attention_bias"):
        raise ValueError("attention_bias is not ported")
    if cfg.get("tie_word_embeddings"):
        raise ValueError("tie_word_embeddings is not ported")
    scoring = cfg.get("scoring_func", "softmax")
    if scoring not in ("softmax", "sigmoid"):
        raise ValueError(f"scoring_func {scoring!r} is not ported")
    topk_method = cfg.get("topk_method", "noaux_tc" if v3 else "greedy")
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
        q_lora_rank=cfg.get("q_lora_rank"),
        kv_lora_rank=int(cfg["kv_lora_rank"]),
        qk_nope_head_dim=qk_nope,
        qk_rope_head_dim=qk_rope,
        v_head_dim=int(cfg["v_head_dim"]),
        softmax_scale=_v3_softmax_scale(cfg, qk_nope + qk_rope) if v3
        else None,
    )
    gate = GateConfig(
        num_experts=int(cfg["n_routed_experts"]),
        top_k=int(cfg["num_experts_per_tok"]),
        scoring="sigmoid" if scoring == "sigmoid" or v3 else "softmax",
        group_method=_GROUP_METHODS[topk_method],
        n_group=int(cfg.get("n_group", 1) or 1),
        topk_group=int(cfg.get("topk_group", 1) or 1),
        norm_topk_prob=bool(cfg.get("norm_topk_prob", v3)),
        routed_scaling_factor=float(cfg.get("routed_scaling_factor", 1.0)),
        has_correction_bias=topk_method == "noaux_tc",
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
        model_type=model_type,
        vocab_size=int(cfg["vocab_size"]),
        hidden_size=int(cfg["hidden_size"]),
        num_layers=int(cfg["num_hidden_layers"]),
        intermediate_size=int(cfg["intermediate_size"]),
        rms_norm_eps=float(cfg.get("rms_norm_eps", 1e-6)),
        attention=attn,
        rope=_rope_from_hf(cfg, qk_rope, interleaved=True),
        moe=moe,
        max_position=int(cfg.get("max_position_embeddings", 4096)),
    )


def _gqa_attn(cfg: dict, qk_norm: bool = False) -> AttentionSpec:
    """GQA attention: projection biases where the config sets
    attention_bias (always for qwen2 / qwen2_moe, as in the JAX package),
    the per-head q / k RMSNorm where the family applies it (``qk_norm``),
    rope over the leading partial_rotary_factor of each head, the output
    gated per head where the config sets gated_output (Qwen3-Next's
    translator sets it). A Qwen / Mistral sliding window in use and a
    config that asks for a q / k norm its family does not apply raise."""
    heads = int(cfg["num_attention_heads"])
    head_dim = int(cfg.get("head_dim") or cfg["hidden_size"] // heads)
    prf = float(cfg.get("partial_rotary_factor", 1.0) or 1.0)
    # qwen configs carry a window that applies only with use_sliding_window
    if cfg.get("sliding_window") and cfg.get("use_sliding_window", True):
        raise ValueError(
            "sliding_window of a Qwen / Mistral config is not ported: the "
            "JAX package reads a window only from SmallThinker's "
            "sliding_window_layout")
    for knob in ("qk_norm", "use_qk_norm"):
        if cfg.get(knob) and not qk_norm:
            raise ValueError(f"{knob} is not ported for "
                             f"{cfg.get('model_type')}")
    return AttentionSpec(
        kind="gqa",
        num_heads=heads,
        num_kv_heads=int(cfg.get("num_key_value_heads", heads)),
        head_dim=head_dim,
        attention_bias=bool(cfg.get("attention_bias", False))
        or cfg.get("model_type") in ("qwen2", "qwen2_moe"),
        qk_norm=qk_norm,
        partial_rotary_dim=int(head_dim * prf) if prf < 1.0 else 0,
        gated_output=bool(cfg.get("gated_output", False)),
    )


def _mixtral_spec(cfg: dict) -> ModelSpec:
    """Mixtral: GQA attention, rotate-half rope over the whole head, every
    layer MoE with softmax over all experts, top-k, renormalized (softmax
    + norm_topk_prob), no shared experts."""
    if cfg.get("hidden_act", "silu") != "silu":
        raise ValueError(f"hidden_act {cfg['hidden_act']!r} is not ported")
    attn = _gqa_attn(cfg)
    gate = GateConfig(
        num_experts=int(cfg["num_local_experts"]),
        top_k=int(cfg["num_experts_per_tok"]),
        scoring="softmax",
        norm_topk_prob=True,
    )
    moe = MoESpec(
        num_experts=int(cfg["num_local_experts"]),
        top_k=int(cfg["num_experts_per_tok"]),
        moe_intermediate_size=int(cfg["intermediate_size"]),
        gate=gate,
    )
    return ModelSpec(
        model_type="mixtral",
        vocab_size=int(cfg["vocab_size"]),
        hidden_size=int(cfg["hidden_size"]),
        num_layers=int(cfg["num_hidden_layers"]),
        intermediate_size=int(cfg["intermediate_size"]),
        rms_norm_eps=float(cfg.get("rms_norm_eps", 1e-5)),
        attention=attn,
        rope=_rope_from_hf(cfg, attn.rotary_dim, interleaved=False),
        moe=moe,
        tie_word_embeddings=bool(cfg.get("tie_word_embeddings", False)),
        max_position=int(cfg.get("max_position_embeddings", 4096)),
    )


def _qwen_moe_spec(cfg: dict, model_type: str) -> ModelSpec:
    """Qwen2-MoE / Qwen3-MoE: GQA attention (Qwen2 with q / k / v biases,
    Qwen3 with the per-head q / k RMSNorm), rotate-half rope over the
    whole head, softmax top-k routing (renormalized where norm_topk_prob),
    an MoE layer where (layer + 1) % decoder_sparse_step == 0 outside
    mlp_only_layers; Qwen2's shared expert scaled by sigmoid(x @
    shared_gate.T), Qwen3 without a shared expert."""
    q3 = model_type == "qwen3_moe"
    if cfg.get("hidden_act", "silu") != "silu":
        raise ValueError(f"hidden_act {cfg['hidden_act']!r} is not ported")
    attn = _gqa_attn(cfg, qk_norm=q3)
    gate = GateConfig(
        num_experts=int(cfg["num_experts"]),
        top_k=int(cfg["num_experts_per_tok"]),
        scoring="softmax",
        norm_topk_prob=bool(cfg.get("norm_topk_prob", False)),
    )
    moe = MoESpec(
        num_experts=int(cfg["num_experts"]),
        top_k=int(cfg["num_experts_per_tok"]),
        moe_intermediate_size=int(cfg["moe_intermediate_size"]),
        gate=gate,
        shared_expert_intermediate_size=0 if q3 else int(
            cfg.get("shared_expert_intermediate_size", 0)),
        shared_expert_gate=not q3,
        moe_layer_freq=int(cfg.get("decoder_sparse_step", 1)),
        moe_layer_offset=1,
        mlp_only_layers=tuple(cfg.get("mlp_only_layers", []) or []),
    )
    return ModelSpec(
        model_type=model_type,
        vocab_size=int(cfg["vocab_size"]),
        hidden_size=int(cfg["hidden_size"]),
        num_layers=int(cfg["num_hidden_layers"]),
        intermediate_size=int(cfg["intermediate_size"]),
        rms_norm_eps=float(cfg.get("rms_norm_eps", 1e-6)),
        attention=attn,
        rope=_rope_from_hf(cfg, attn.rotary_dim, interleaved=False),
        moe=moe,
        tie_word_embeddings=bool(cfg.get("tie_word_embeddings", False)),
        max_position=int(cfg.get("max_position_embeddings", 4096)),
    )


def _dense_spec(cfg: dict, model_type: str) -> ModelSpec:
    """Llama and the dense Qwen2 / Qwen3: GQA attention (Qwen2 with q / k /
    v biases, Qwen3 with the per-head q / k RMSNorm), rotate-half rope,
    every layer a dense GLU MLP, tied embeddings where the config sets
    them."""
    if cfg.get("hidden_act", "silu") != "silu":
        raise ValueError(f"hidden_act {cfg['hidden_act']!r} is not ported")
    if cfg.get("mlp_bias"):
        raise ValueError("mlp_bias is not ported")
    attn = _gqa_attn(cfg, qk_norm=model_type == "qwen3")
    return ModelSpec(
        model_type=model_type,
        vocab_size=int(cfg["vocab_size"]),
        hidden_size=int(cfg["hidden_size"]),
        num_layers=int(cfg["num_hidden_layers"]),
        intermediate_size=int(cfg["intermediate_size"]),
        rms_norm_eps=float(cfg.get("rms_norm_eps", 1e-6)),
        attention=attn,
        rope=_rope_from_hf(cfg, attn.rotary_dim, interleaved=False),
        moe=None,
        tie_word_embeddings=bool(cfg.get("tie_word_embeddings", False)),
        max_position=int(cfg.get("max_position_embeddings", 4096)),
    )


def _glm4_moe_spec(cfg: dict) -> ModelSpec:
    """GLM4-MoE (GLM-4.5 / 4.5-Air): GQA attention with rope over the
    leading partial_rotary_factor of each head, the optional per-head q / k
    RMSNorm (use_qk_norm) and projection biases as attention_bias sets
    them; DeepSeek-V3's router (sigmoid scores, the correction bias,
    groups ranked by their top-2 sum, norm_topk_prob, routed_scaling_factor);
    first_k_dense_replace dense layers; n_shared_experts x
    moe_intermediate_size of ungated shared expert."""
    if cfg.get("hidden_act", "silu") != "silu":
        raise ValueError(f"hidden_act {cfg['hidden_act']!r} is not ported")
    gate = GateConfig(
        num_experts=int(cfg["n_routed_experts"]),
        top_k=int(cfg["num_experts_per_tok"]),
        scoring="sigmoid",
        group_method="group_top2sum",
        n_group=int(cfg.get("n_group", 1) or 1),
        topk_group=int(cfg.get("topk_group", 1) or 1),
        norm_topk_prob=bool(cfg.get("norm_topk_prob", True)),
        routed_scaling_factor=float(cfg.get("routed_scaling_factor", 1.0)),
        has_correction_bias=True,
    )
    moe = MoESpec(
        num_experts=int(cfg["n_routed_experts"]),
        top_k=int(cfg["num_experts_per_tok"]),
        moe_intermediate_size=int(cfg["moe_intermediate_size"]),
        gate=gate,
        shared_expert_intermediate_size=int(cfg.get("n_shared_experts") or 0)
        * int(cfg["moe_intermediate_size"]),
        first_k_dense=int(cfg.get("first_k_dense_replace", 1)),
    )
    attn = _gqa_attn(cfg, qk_norm=bool(cfg.get("use_qk_norm", False)))
    return ModelSpec(
        model_type="glm4_moe",
        vocab_size=int(cfg["vocab_size"]),
        hidden_size=int(cfg["hidden_size"]),
        num_layers=int(cfg["num_hidden_layers"]),
        intermediate_size=int(cfg["intermediate_size"]),
        rms_norm_eps=float(cfg.get("rms_norm_eps", 1e-5)),
        attention=attn,
        rope=_rope_from_hf(cfg, attn.rotary_dim, interleaved=False),
        moe=moe,
        tie_word_embeddings=bool(cfg.get("tie_word_embeddings", False)),
        max_position=int(cfg.get("max_position_embeddings", 4096)),
    )


def _qwen3_next_spec(cfg: dict) -> ModelSpec:
    """Qwen3-Next: hybrid GatedDeltaNet layers (layer_types
    "linear_attention") and gated full attention (q_proj emits [q | gate]
    per head, per-head q / k norm, rope over the leading
    partial_rotary_factor, 0.25 by default, of each head), Qwen2-MoE-style
    experts with a gated shared expert; the JAX package's
    _qwen3_next_spec."""
    base = _qwen_moe_spec(cfg, "qwen3_moe")
    head_dim = int(cfg.get("head_dim")
                   or cfg["hidden_size"] // cfg["num_attention_heads"])
    prf = float(cfg.get("partial_rotary_factor", 0.25))
    attn = dataclasses.replace(
        base.attention, qk_norm=True, gated_output=True,
        attention_bias=bool(cfg.get("attention_bias", False)),
        partial_rotary_dim=int(head_dim * prf) if prf < 1.0 else 0,
        num_kv_heads=int(cfg["num_key_value_heads"]), head_dim=head_dim)
    kinds = tuple("linear" if t == "linear_attention" else "full"
                  for t in cfg["layer_types"])
    moe = dataclasses.replace(
        base.moe, shared_expert_intermediate_size=int(
            cfg.get("shared_expert_intermediate_size", 0)),
        shared_expert_gate=True)
    rot = int(head_dim * prf) if prf < 1.0 else head_dim
    return dataclasses.replace(
        base, model_type="qwen3_next", attention=attn, moe=moe,
        rope=_rope_from_hf(cfg, rot, interleaved=False), layer_kinds=kinds,
        linear_attn=LinearAttentionSpec(
            num_v_heads=int(cfg["linear_num_value_heads"]),
            num_k_heads=int(cfg["linear_num_key_heads"]),
            head_k_dim=int(cfg["linear_key_head_dim"]),
            head_v_dim=int(cfg["linear_value_head_dim"]),
            conv_kernel=int(cfg.get("linear_conv_kernel_dim", 4))))


def _smallthinker_spec(cfg: dict) -> ModelSpec:
    """SmallThinker (4B / 21B MoE): GQA attention with per-layer rope on /
    off (rope_layout) and sliding window on / off (sliding_window_layout),
    ReLU-GLU experts behind an early router (fed the layer input), sigmoid
    top-k without renormalization or softmax top-k renormalized; the JAX
    package's _smallthinker_spec. Secondary experts raise."""
    if cfg.get("moe_enable_secondary_experts"):
        raise NotImplementedError(
            "smallthinker secondary experts are not supported (nor in the "
            "JAX package)")
    n_layers = int(cfg["num_hidden_layers"])
    e = int(cfg["moe_num_primary_experts"])
    softmax = cfg.get("moe_primary_router_apply_softmax", True)
    gate = GateConfig(
        num_experts=e, top_k=int(cfg["moe_num_active_primary_experts"]),
        scoring="softmax" if softmax else "sigmoid",
        norm_topk_prob=bool(softmax))
    moe_layout = list(cfg.get("moe_layer_layout") or [1] * n_layers)
    moe = MoESpec(
        num_experts=e, top_k=gate.top_k,
        moe_intermediate_size=int(cfg["moe_ffn_hidden_size"]), gate=gate,
        mlp_only_layers=tuple(li for li in range(n_layers)
                              if not moe_layout[li]),
        early_router=bool(cfg.get("moe_enable_early_router", True)))
    head_dim = int(cfg.get("head_dim")
                   or cfg["hidden_size"] // cfg["num_attention_heads"])
    attn = AttentionSpec(
        kind="gqa", num_heads=int(cfg["num_attention_heads"]),
        num_kv_heads=int(cfg["num_key_value_heads"]), head_dim=head_dim,
        sliding_window=int(cfg.get("sliding_window_size", 0)))
    rope_layout = cfg.get("rope_layout")
    swa_layout = cfg.get("sliding_window_layout")
    return ModelSpec(
        model_type="smallthinker",
        vocab_size=int(cfg["vocab_size"]),
        hidden_size=int(cfg["hidden_size"]),
        num_layers=n_layers,
        intermediate_size=int(cfg.get("dense_ffn_hidden_size",
                                      cfg.get("moe_ffn_hidden_size"))),
        rms_norm_eps=float(cfg.get("rms_norm_eps", 1e-6)),
        attention=attn,
        rope=_rope_from_hf(cfg, head_dim, interleaved=False),
        activation=ActivationConfig(kind="relu"),
        moe=moe,
        tie_word_embeddings=bool(cfg.get("tie_word_embeddings", False)),
        max_position=int(cfg.get("max_position_embeddings", 4096)),
        rope_layout=None if rope_layout is None else tuple(rope_layout),
        swa_layout=None if swa_layout is None else tuple(swa_layout),
    )


_TRANSLATORS = {
    "deepseek_v2": lambda c: _deepseek_spec(c, "deepseek_v2"),
    "deepseek_v3": lambda c: _deepseek_spec(c, "deepseek_v3"),
    "kimi_k2": lambda c: _deepseek_spec(c, "deepseek_v3"),
    "mixtral": _mixtral_spec,
    "qwen2_moe": lambda c: _qwen_moe_spec(c, "qwen2_moe"),
    "qwen3_moe": lambda c: _qwen_moe_spec(c, "qwen3_moe"),
    "llama": lambda c: _dense_spec(c, "llama"),
    "qwen2": lambda c: _dense_spec(c, "qwen2"),
    "qwen3": lambda c: _dense_spec(c, "qwen3"),
    "glm4_moe": _glm4_moe_spec,
    "qwen3_next": _qwen3_next_spec,
    "smallthinker": _smallthinker_spec,
}

# GGUF files of these architectures stay out until their loader is held
# against real files (ROADMAP Queue 1 item 5b): llama.cpp's converter
# permutes a llama file's attn_q / attn_k rows for its interleaved rope
_GGUF_REFUSED = ("llama", "qwen2", "qwen3", "glm4_moe")


def spec_from_hf_config(cfg: Any) -> ModelSpec:
    """Build a ModelSpec from an HF config object or dict."""
    if not isinstance(cfg, dict):
        cfg = cfg.to_dict()
    mt = cfg.get("model_type")
    if mt not in _TRANSLATORS:
        raise ValueError(f"unsupported model_type {mt!r}; this port "
                         f"supports {sorted(_TRANSLATORS)}")
    return _TRANSLATORS[mt](cfg)


# -- GGUF metadata -> ModelSpec ---------------------------------------------

_GGUF_ARCH_TO_HF = {
    "deepseek2": "deepseek_v2",
    "deepseek3": "deepseek_v3",
    "qwen2moe": "qwen2_moe",
    "qwen3moe": "qwen3_moe",
    "llama": "llama",
    "qwen2": "qwen2",
    "qwen3": "qwen3",
    "glm4moe": "glm4_moe",
}


def spec_from_gguf_fields(fields: dict) -> ModelSpec:
    """Build a ModelSpec from GGUF metadata (llama.cpp key conventions),
    so a bare .gguf file is runnable without the HF config.json: the
    JAX package's models/spec.py:spec_from_gguf_fields. An architecture
    whose HF translator the port lacks (_TRANSLATORS) raises."""
    arch = fields.get("general.architecture")
    if arch not in _GGUF_ARCH_TO_HF:
        raise ValueError(
            f"unsupported gguf architecture {arch!r}; provide --config"
        )
    mt = _GGUF_ARCH_TO_HF[arch]
    if mt in _GGUF_REFUSED:
        raise NotImplementedError(
            f"gguf architecture {arch!r} ({mt}): GGUF files of this "
            "architecture are not ported (ROADMAP Queue 1 item 5b: the "
            "attn_q / attn_k row permutation of llama.cpp's converter)")
    if mt not in _TRANSLATORS:
        raise NotImplementedError(
            f"gguf architecture {arch!r} ({mt}): the port has no {mt} "
            "translator")
    g = lambda key, default=None: fields.get(f"{arch}.{key}", default)

    heads = int(g("attention.head_count"))
    cfg: dict = {
        "model_type": mt,
        "vocab_size": int(g("vocab_size", 0))
        or len(fields.get("tokenizer.ggml.tokens", [])),
        "hidden_size": int(g("embedding_length")),
        "intermediate_size": int(g("feed_forward_length")),
        "num_hidden_layers": int(g("block_count")),
        "num_attention_heads": heads,
        "num_key_value_heads": int(g("attention.head_count_kv", heads)),
        "rms_norm_eps": float(g("attention.layer_norm_rms_epsilon", 1e-6)),
        "rope_theta": float(g("rope.freq_base", 10000.0)),
        "max_position_embeddings": int(g("context_length", 4096)),
        "tie_word_embeddings": False,
    }
    if g("rope.dimension_count") and heads:
        cfg["head_dim"] = (
            int(g("attention.key_length"))
            if g("attention.key_length")
            else None
        )
    if g("rope.scaling.type") == "yarn":
        cfg["rope_scaling"] = {
            "type": "yarn",
            "factor": float(g("rope.scaling.factor", 1.0)),
            "original_max_position_embeddings": int(
                g("rope.scaling.original_context_length", 4096)
            ),
        }
    if g("expert_count"):
        cfg.update(
            n_routed_experts=int(g("expert_count")),
            num_experts=int(g("expert_count")),
            num_experts_per_tok=int(g("expert_used_count", 2)),
            moe_intermediate_size=int(
                g("expert_feed_forward_length", g("feed_forward_length"))
            ),
            n_shared_experts=int(g("expert_shared_count", 0)),
            shared_expert_intermediate_size=int(
                g("expert_shared_feed_forward_length", 0)
            )
            or int(g("expert_shared_count", 0))
            * int(g("expert_feed_forward_length", 0)),
            routed_scaling_factor=float(g("expert_weights_scale", 1.0)),
            norm_topk_prob=bool(g("expert_weights_norm", False)),
            first_k_dense_replace=int(g("leading_dense_block_count", 0)),
        )
        if g("expert_gating_func") == 2 or mt == "deepseek_v3":
            cfg["scoring_func"] = "sigmoid"
            cfg["topk_method"] = "noaux_tc"
        if mt == "deepseek_v2":
            cfg["topk_method"] = "greedy"
    if mt in ("deepseek_v2", "deepseek_v3"):
        cfg.update(
            kv_lora_rank=int(g("attention.kv_lora_rank")),
            q_lora_rank=int(g("attention.q_lora_rank", 0)) or None,
            qk_rope_head_dim=int(g("rope.dimension_count")),
            qk_nope_head_dim=int(g("attention.key_length"))
            - int(g("rope.dimension_count")),
            v_head_dim=int(g("attention.value_length")),
        )
    return spec_from_hf_config(cfg)


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


# DeepSeek-V3 (deepseek-ai/DeepSeek-V3 config.json, the JAX package's
# models/registry.py _DS_V3); DeepSeek-R1 has the same architecture.
DEEPSEEK_V3 = dict(
    model_type="deepseek_v3", vocab_size=129280, hidden_size=7168,
    intermediate_size=18432, moe_intermediate_size=2048,
    num_hidden_layers=61, num_attention_heads=128, num_key_value_heads=128,
    n_shared_experts=1, n_routed_experts=256, num_experts_per_tok=8,
    n_group=8, topk_group=4, first_k_dense_replace=3, norm_topk_prob=True,
    routed_scaling_factor=2.5, scoring_func="sigmoid",
    topk_method="noaux_tc", kv_lora_rank=512, q_lora_rank=1536,
    qk_rope_head_dim=64, qk_nope_head_dim=128, v_head_dim=128,
    rms_norm_eps=1e-6, rope_theta=10000.0, max_position_embeddings=163840,
    rope_scaling=dict(type="yarn", factor=40.0, beta_fast=32, beta_slow=1,
                      mscale=1.0, mscale_all_dim=1.0,
                      original_max_position_embeddings=4096),
)


# Mixtral-8x7B (mistralai/Mixtral-8x7B-Instruct-v0.1 config.json, as the
# JAX package's model registry lists it).
MIXTRAL_8X7B = dict(
    model_type="mixtral",
    vocab_size=32000,
    hidden_size=4096,
    intermediate_size=14336,
    num_hidden_layers=32,
    num_attention_heads=32,
    num_key_value_heads=8,
    num_local_experts=8,
    num_experts_per_tok=2,
    rms_norm_eps=1e-5,
    rope_theta=1000000.0,
    max_position_embeddings=32768,
)

