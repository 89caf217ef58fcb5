"""Model registry: named presets of the model zoo (counterpart of
ktransformers_tpu/models/registry.py, every catalog entry copied).

Each entry carries the public HF config values spec_from_hf_config reads,
with the weight bytes of a quantized copy and whether it fits one NVIDIA
H100 80GB HBM3 card. The byte arithmetic reads the config itself; every
preset's ``spec()`` translates, and a model type the port does not know
raises. No download: ``hf_id`` names the upstream checkpoint for
provenance.
"""

from __future__ import annotations

import dataclasses

from ktransformers_tpu_torch.models.spec import (
    DEEPSEEK_V3,
    ModelSpec,
    spec_from_hf_config,
)

H100_HBM_GB = 80.0  # one NVIDIA H100 80GB HBM3

# bytes per weight of each QTensor kind (quant/formats.py): int4 kinds are
# nibble-packed (0.5 B) + group scales; int8 1 B + scales; the mx kinds one
# ue8m0 scale byte per 32-group
_BYTES_PER_PARAM = {
    "bf16": 2.0,
    "fp8": 1.0 + 2 / 128,
    "int8": 1.0 + 2 / 128,
    "int8_g": 1.0 + 2 / 128,
    "int8_gz": 1.0 + 4 / 128,
    "int4": 0.5 + 2 / 128,
    "int4_g": 0.5 + 2 / 128,
    "int4_gz": 0.5 + 4 / 128,
    "mxfp4": 0.5 + 1 / 32,
    "mxfp8": 1.0 + 1 / 32,
}

_PORTED = ("deepseek_v2", "deepseek_v3", "kimi_k2", "mixtral", "qwen2_moe",
           "qwen3_moe", "llama", "qwen2", "qwen3", "glm4_moe",
           "smallthinker", "qwen3_next")


@dataclasses.dataclass(frozen=True)
class ModelEntry:
    name: str  # registry key
    hf_id: str  # upstream checkpoint this preset mirrors
    config: dict  # HF config.json subset consumed by spec_from_hf_config
    total_params_b: float  # public headline size (for display only)
    active_params_b: float  # activated per token (MoE) or == total
    quant: str = "int8"  # recommended dense / attention kind
    moe_quant: str = "int4_g"  # recommended routed-expert kind
    notes: str = ""

    def spec(self) -> ModelSpec:
        mt = self.config.get("model_type")
        if mt not in _PORTED:
            raise ValueError(
                f"{self.name}: model_type {mt!r} is not ported")
        return spec_from_hf_config(dict(self.config))


def _moe_shape(cfg: dict):
    """(experts, top_k, expert inter, shared inter, first dense layers,
    layer freq, layer offset, dense-only layers) of an MoE config, None for
    a dense model: the JAX package's MoESpec fields, per family."""
    mt = cfg["model_type"]
    n = int(cfg["num_hidden_layers"])
    if mt in ("deepseek_v2", "deepseek_v3", "kimi_k2", "glm4_moe"):
        inter = int(cfg["moe_intermediate_size"])
        return (int(cfg["n_routed_experts"]), int(cfg["num_experts_per_tok"]),
                inter, int(cfg.get("n_shared_experts") or 0) * inter,
                int(cfg.get("first_k_dense_replace",
                            1 if mt == "glm4_moe" else 0)),
                int(cfg.get("moe_layer_freq", 1)), 0, ())
    if mt == "mixtral":
        return (int(cfg["num_local_experts"]), int(cfg["num_experts_per_tok"]),
                int(cfg["intermediate_size"]), 0, 0, 1, 0, ())
    if mt in ("qwen2_moe", "qwen3_moe", "qwen3_next"):
        shared = 0 if mt == "qwen3_moe" else int(
            cfg.get("shared_expert_intermediate_size", 0))
        return (int(cfg["num_experts"]), int(cfg["num_experts_per_tok"]),
                int(cfg["moe_intermediate_size"]), shared, 0,
                int(cfg.get("decoder_sparse_step", 1)), 1,
                tuple(cfg.get("mlp_only_layers", []) or []))
    if mt == "smallthinker":
        layout = list(cfg.get("moe_layer_layout") or [1] * n)
        return (int(cfg["moe_num_primary_experts"]),
                int(cfg["moe_num_active_primary_experts"]),
                int(cfg["moe_ffn_hidden_size"]), 0, 0, 1, 0,
                tuple(li for li in range(n) if not layout[li]))
    return None


def _counts(cfg: dict) -> dict:
    """Parameter counts by role, as the JAX package's registry counts them
    from its spec (models/init.py's allocation)."""
    mt = cfg["model_type"]
    h = int(cfg["hidden_size"])
    heads = int(cfg["num_attention_heads"])
    n_layers = int(cfg["num_hidden_layers"])
    tie = bool(cfg.get("tie_word_embeddings", False))
    counts = {"embed": int(cfg["vocab_size"]) * h * (1 if tie else 2)}
    if mt in ("deepseek_v2", "deepseek_v3", "kimi_k2"):
        nope, dr = int(cfg["qk_nope_head_dim"]), int(cfg["qk_rope_head_dim"])
        r, v, ql = int(cfg["kv_lora_rank"]), int(cfg["v_head_dim"]), \
            cfg.get("q_lora_rank")
        attn = (h * ql + ql * heads * (nope + dr) if ql
                else h * heads * (nope + dr))
        attn += h * (r + dr) + r * heads * (nope + v) + heads * v * h
    else:
        hd = int(cfg.get("head_dim") or h // heads)
        hkv = int(cfg.get("num_key_value_heads", heads))
        gated = 2 if mt == "qwen3_next" else 1
        attn = h * heads * hd * gated + 2 * h * hkv * hd + heads * hd * h
    if mt == "smallthinker":
        inter = int(cfg.get("dense_ffn_hidden_size",
                            cfg.get("moe_ffn_hidden_size")))
    else:
        inter = int(cfg["intermediate_size"])
    moe = _moe_shape(cfg)
    n_moe = 0
    if moe is not None:
        e, k, f, fs, first, freq, off, dense_only = moe
        n_moe = sum(1 for li in range(n_layers)
                    if li >= first and (li - off) % freq == 0
                    and li not in dense_only)
    counts["attn"] = attn * n_layers
    counts["dense_mlp"] = (n_layers - n_moe) * 3 * h * inter
    if moe is not None:
        counts["experts"] = n_moe * e * 3 * h * f
        counts["shared"] = n_moe * 3 * h * fs
        counts["router"] = n_moe * e * h
        counts["active_experts"] = n_moe * k * 3 * h * f
    return counts


def estimate_bytes(config: dict, quant: str, moe_quant: str) -> dict:
    """Weight bytes by role and the per-token active read set (the decode
    bandwidth bound) at the given kinds, for the HF config of any family of
    the catalog (the JAX package's estimate_bytes reads its spec); the fit
    on one H100."""
    c = _counts(config)
    bq, bm = _BYTES_PER_PARAM[quant], _BYTES_PER_PARAM[moe_quant]
    resident = {
        "embed_gb": c["embed"] * 2 / 1e9,  # embeddings stay bf16
        "attn_gb": c["attn"] * bq / 1e9,
        "dense_mlp_gb": c["dense_mlp"] * bq / 1e9,
        "experts_gb": c.get("experts", 0) * bm / 1e9,
        "shared_gb": (c.get("shared", 0) + c.get("router", 0)) * bq / 1e9,
    }
    total = sum(resident.values())
    active = (total - resident["experts_gb"]
              - resident["embed_gb"] / 2  # lm_head read; embed lookup ~free
              + c.get("active_experts", 0) * bm / 1e9)
    return {
        **{k: round(v, 2) for k, v in resident.items()},
        "total_gb": round(total, 2),
        "active_gb_per_token": round(active, 3),
        "fits_h100": total < H100_HBM_GB * 0.85,  # room for KV and work
        "min_h100_cards": max(1, int(-(-total // (H100_HBM_GB * 0.85)))),
    }


# -- catalog -------------------------------------------------------------
# Public config values from each model's HF config.json, as the JAX
# package's registry lists them.

_DS_V3 = DEEPSEEK_V3

REGISTRY: dict[str, ModelEntry] = {}


def _add(entry: ModelEntry) -> None:
    REGISTRY[entry.name] = entry


_add(ModelEntry(
    "deepseek-v2-lite", "deepseek-ai/DeepSeek-V2-Lite",
    dict(model_type="deepseek_v2", vocab_size=102400, hidden_size=2048,
         intermediate_size=10944, moe_intermediate_size=1408,
         num_hidden_layers=27, num_attention_heads=16,
         num_key_value_heads=16, n_shared_experts=2, n_routed_experts=64,
         num_experts_per_tok=6, first_k_dense_replace=1, moe_layer_freq=1,
         topk_method="greedy", norm_topk_prob=False,
         routed_scaling_factor=1.0, scoring_func="softmax",
         kv_lora_rank=512, q_lora_rank=None, qk_rope_head_dim=64,
         qk_nope_head_dim=128, v_head_dim=128, rms_norm_eps=1e-6,
         rope_theta=10000.0, max_position_embeddings=163840),
    15.7, 2.4, notes="bench.py model; single-card resident"))

_add(ModelEntry(
    "deepseek-v2", "deepseek-ai/DeepSeek-V2",
    dict(model_type="deepseek_v2", vocab_size=102400, hidden_size=5120,
         intermediate_size=12288, moe_intermediate_size=1536,
         num_hidden_layers=60, num_attention_heads=128,
         num_key_value_heads=128, n_shared_experts=2, n_routed_experts=160,
         num_experts_per_tok=6, n_group=8, topk_group=3,
         first_k_dense_replace=1, moe_layer_freq=1,
         topk_method="group_limited_greedy", norm_topk_prob=False,
         routed_scaling_factor=16.0, scoring_func="softmax",
         kv_lora_rank=512, q_lora_rank=1536, qk_rope_head_dim=64,
         qk_nope_head_dim=128, v_head_dim=128, rms_norm_eps=1e-6,
         rope_theta=10000.0, max_position_embeddings=163840),
    236.0, 21.0, notes="host offload or multi-card expert parallelism"))

_add(ModelEntry("deepseek-v3", "deepseek-ai/DeepSeek-V3", _DS_V3,
                671.0, 37.0,
                notes="the reference's headline model; host offload"))
_add(ModelEntry("deepseek-r1", "deepseek-ai/DeepSeek-R1", _DS_V3,
                671.0, 37.0, notes="V3 architecture"))

_add(ModelEntry(
    "kimi-k2", "moonshotai/Kimi-K2-Instruct",
    dict(_DS_V3, vocab_size=163840, num_attention_heads=64,
         num_key_value_heads=64, n_routed_experts=384, n_group=1,
         topk_group=1, first_k_dense_replace=1),
    1026.0, 32.0, notes="1T-class; reference K2 group-128 int4 target"))

_add(ModelEntry(
    "qwen3-235b-a22b", "Qwen/Qwen3-235B-A22B",
    dict(model_type="qwen3_moe", vocab_size=151936, hidden_size=4096,
         intermediate_size=12288, moe_intermediate_size=1536,
         num_hidden_layers=94, num_attention_heads=64,
         num_key_value_heads=4, head_dim=128, num_experts=128,
         num_experts_per_tok=8, decoder_sparse_step=1, norm_topk_prob=True,
         rms_norm_eps=1e-6, rope_theta=1000000.0,
         max_position_embeddings=40960),
    235.0, 22.0))

_add(ModelEntry(
    "qwen3-30b-a3b", "Qwen/Qwen3-30B-A3B",
    dict(model_type="qwen3_moe", vocab_size=151936, hidden_size=2048,
         intermediate_size=6144, moe_intermediate_size=768,
         num_hidden_layers=48, num_attention_heads=32,
         num_key_value_heads=4, head_dim=128, num_experts=128,
         num_experts_per_tok=8, decoder_sparse_step=1, norm_topk_prob=True,
         rms_norm_eps=1e-6, rope_theta=1000000.0,
         max_position_embeddings=40960),
    30.5, 3.3, notes="single-card resident at int4"))

_add(ModelEntry(
    "qwen2-57b-a14b", "Qwen/Qwen2-57B-A14B-Instruct",
    dict(model_type="qwen2_moe", vocab_size=151936, hidden_size=3584,
         intermediate_size=18944, moe_intermediate_size=2560,
         shared_expert_intermediate_size=20480, num_hidden_layers=28,
         num_attention_heads=28, num_key_value_heads=4, num_experts=64,
         num_experts_per_tok=8, decoder_sparse_step=1, norm_topk_prob=False,
         rms_norm_eps=1e-6, rope_theta=1000000.0,
         max_position_embeddings=32768),
    57.4, 14.2))

_add(ModelEntry(
    "mixtral-8x7b", "mistralai/Mixtral-8x7B-Instruct-v0.1",
    dict(model_type="mixtral", vocab_size=32000, hidden_size=4096,
         intermediate_size=14336, num_hidden_layers=32,
         num_attention_heads=32, num_key_value_heads=8,
         num_local_experts=8, num_experts_per_tok=2, rms_norm_eps=1e-5,
         rope_theta=1000000.0, max_position_embeddings=32768),
    46.7, 12.9))

_add(ModelEntry(
    "llama-3.1-8b", "meta-llama/Llama-3.1-8B-Instruct",
    dict(model_type="llama", vocab_size=128256, hidden_size=4096,
         intermediate_size=14336, num_hidden_layers=32,
         num_attention_heads=32, num_key_value_heads=8, rms_norm_eps=1e-5,
         rope_theta=500000.0, max_position_embeddings=131072,
         rope_scaling=dict(rope_type="llama3", factor=8.0,
                           low_freq_factor=1.0, high_freq_factor=4.0,
                           original_max_position_embeddings=8192)),
    8.0, 8.0, quant="int8", moe_quant="int8", notes="dense"))

_add(ModelEntry(
    "qwen3-next-80b-a3b", "Qwen/Qwen3-Next-80B-A3B-Instruct",
    dict(model_type="qwen3_next", vocab_size=151936, hidden_size=2048,
         intermediate_size=5120, moe_intermediate_size=512,
         shared_expert_intermediate_size=512, num_hidden_layers=48,
         num_attention_heads=16, num_key_value_heads=2, head_dim=256,
         linear_num_value_heads=32, linear_num_key_heads=16,
         linear_key_head_dim=128, linear_value_head_dim=128,
         linear_conv_kernel_dim=4, num_experts=512, num_experts_per_tok=10,
         norm_topk_prob=True, decoder_sparse_step=1, rms_norm_eps=1e-6,
         rope_theta=10000000.0, max_position_embeddings=262144,
         # 3 GatedDeltaNet layers per full-attention layer
         # (full_attention_interval=4)
         layer_types=[
             "full_attention" if i % 4 == 3 else "linear_attention"
             for i in range(48)
         ]),
    80.0, 3.0, notes="hybrid GatedDeltaNet linear attention"))

_add(ModelEntry(
    "glm-4.5-air", "zai-org/GLM-4.5-Air",
    dict(model_type="glm4_moe", vocab_size=151552, hidden_size=4096,
         intermediate_size=10944, moe_intermediate_size=1408,
         num_hidden_layers=46, num_attention_heads=96,
         num_key_value_heads=8, head_dim=128, partial_rotary_factor=0.5,
         use_qk_norm=True, n_routed_experts=128, num_experts_per_tok=8,
         n_shared_experts=1, n_group=1, topk_group=1, norm_topk_prob=True,
         routed_scaling_factor=1.0, first_k_dense_replace=1,
         rms_norm_eps=1e-5, rope_theta=1000000.0,
         max_position_embeddings=131072),
    106.0, 12.0))

_add(ModelEntry(
    "smallthinker-21b", "PowerInfer/SmallThinker-21BA3B-Instruct",
    dict(model_type="smallthinker", vocab_size=151936, hidden_size=2560,
         num_hidden_layers=52, num_attention_heads=28,
         num_key_value_heads=4, head_dim=128, rope_theta=1.5e6,
         rms_norm_eps=1e-6, sliding_window_size=4096,
         # NoPE every 4th layer / SWA on rope layers (the public config's
         # rope_layout / sliding_window_layout pattern)
         rope_layout=[0 if i % 4 == 3 else 1 for i in range(52)],
         sliding_window_layout=[0 if i % 4 == 3 else 1 for i in range(52)],
         moe_num_primary_experts=64, moe_num_active_primary_experts=6,
         moe_ffn_hidden_size=768, dense_ffn_hidden_size=768,
         moe_enable_early_router=True,
         moe_primary_router_apply_softmax=False,
         moe_enable_secondary_experts=False,
         max_position_embeddings=16384),
    21.5, 3.0))


def list_models() -> list[dict]:
    out = []
    for e in REGISTRY.values():
        est = estimate_bytes(e.config, e.quant, e.moe_quant)
        out.append({
            "name": e.name,
            "hf_id": e.hf_id,
            "params_b": e.total_params_b,
            "active_b": e.active_params_b,
            "quant": f"{e.quant}/{e.moe_quant}",
            "total_gb": est["total_gb"],
            "fits_h100": est["fits_h100"],
            "min_h100_cards": est["min_h100_cards"],
            "ported": e.config.get("model_type") in _PORTED,
            "notes": e.notes,
        })
    return out


def show_model(name: str) -> dict:
    """One entry's architecture, bytes and advice. Raises for a family
    the port cannot translate yet (ModelEntry.spec)."""
    e = REGISTRY[name]
    spec = e.spec()
    est = estimate_bytes(e.config, e.quant, e.moe_quant)
    rec: dict = {"quant": e.quant, "moe_quant": e.moe_quant}
    if not est["fits_h100"]:
        host_gb = est["experts_gb"]
        device_gb = round(est["total_gb"] - host_gb, 2)
        rec["offload"] = (
            f"needs >= {est['min_h100_cards']} H100 cards resident: serve it "
            "with its routed experts in host memory "
            "(ktransformers_tpu_torch.offload: HostOffloadGenerator / "
            f"HostOffloadServeEngine): ~{host_gb} GB of experts on the host, "
            f"~{device_gb} GB of the rest on the card; or expert "
            "parallelism across cards (ktransformers_tpu_torch.parallel: "
            "init_multihost, shard_params, parallel_context)")
        rec["host_gb"] = host_gb
        rec["device_gb"] = device_gb
    return {
        "name": e.name,
        "hf_id": e.hf_id,
        "model_type": spec.model_type,
        "layers": spec.num_layers,
        "hidden": spec.hidden_size,
        "attention": spec.attention.kind,
        "experts": spec.moe.num_experts if spec.moe else 0,
        "top_k": spec.moe.top_k if spec.moe else 0,
        "estimate": est,
        "recommended": rec,
        "notes": e.notes,
    }
