"""The port's model registry against the JAX package's: every preset
listed with the same config, the same weight bytes by role at every quant
kind, the DeepSeek / Kimi / Qwen-MoE / Mixtral presets translated to specs, and the
families the port cannot translate yet refused with the ROADMAP item."""

import pytest

from ktransformers_tpu.models import registry as jreg
from ktransformers_tpu_torch.models import registry as treg

BYTE_FIELDS = ("embed_gb", "attn_gb", "dense_mlp_gb", "experts_gb",
               "shared_gb", "total_gb", "active_gb_per_token")
PORTED = ("deepseek-v2-lite", "deepseek-v2", "deepseek-v3", "deepseek-r1",
          "kimi-k2", "qwen3-235b-a22b", "qwen3-30b-a3b", "qwen2-57b-a14b",
          "mixtral-8x7b")


def test_every_preset_lists():
    assert list(treg.REGISTRY) == list(jreg.REGISTRY)
    for name, e in jreg.REGISTRY.items():
        t = treg.REGISTRY[name]
        assert (t.hf_id, t.config, t.total_params_b, t.active_params_b,
                t.quant, t.moe_quant) == (e.hf_id, e.config, e.total_params_b,
                                          e.active_params_b, e.quant,
                                          e.moe_quant)
    rows = treg.list_models()
    assert [r["name"] for r in rows] == list(jreg.REGISTRY)
    for r in rows:
        assert r["total_gb"] > 0 and r["min_h100_cards"] >= 1
        assert r["ported"] == (r["name"] in PORTED)


@pytest.mark.parametrize("name", list(jreg.REGISTRY))
@pytest.mark.parametrize("kinds", [None, ("int8", "int4_g"),
                                   ("bf16", "bf16"), ("fp8", "mxfp4"),
                                   ("int4_gz", "int8_gz")])
def test_estimate_bytes_matches_jax(name, kinds):
    """The byte fields equal the JAX package's (from its spec) at the
    preset's kinds and others; the fit is the H100's own (80 GB)."""
    e = jreg.REGISTRY[name]
    quant, moe_quant = kinds or (e.quant, e.moe_quant)
    j = jreg.estimate_bytes(e.spec(), quant, moe_quant)
    t = treg.estimate_bytes(treg.REGISTRY[name].config, quant, moe_quant)
    for f in BYTE_FIELDS:
        assert t[f] == j[f], f
    assert t["fits_h100"] == (t["total_gb"] < 80.0 * 0.85)
    cards, budget = t["min_h100_cards"], 80.0 * 0.85
    assert cards >= 1 and (cards - 1) * budget <= t["total_gb"] + 0.005
    assert t["total_gb"] <= cards * budget + 0.005


@pytest.mark.parametrize("name", PORTED)
def test_ported_presets_translate(name):
    spec = treg.REGISTRY[name].spec()
    shown = treg.show_model(name)
    assert shown["layers"] == spec.num_layers
    assert shown["experts"] == spec.moe.num_experts
    assert shown["estimate"] == treg.estimate_bytes(
        treg.REGISTRY[name].config, shown["recommended"]["quant"],
        shown["recommended"]["moe_quant"])
    if name.startswith(("deepseek", "kimi")):
        assert spec.attention.kind == "mla"
    if name in ("deepseek-v3", "deepseek-r1", "kimi-k2"):
        assert spec.attention.q_lora_rank == 1536
        assert spec.moe.gate.has_correction_bias
        assert "offload" in shown["recommended"]


@pytest.mark.parametrize("name", [n for n in jreg.REGISTRY
                                  if n not in PORTED])
def test_other_families_raise_naming_item_6(name):
    with pytest.raises(ValueError, match="item 6"):
        treg.REGISTRY[name].spec()
    with pytest.raises(ValueError, match="item 6"):
        treg.show_model(name)
    # they still list and estimate
    assert treg.estimate_bytes(treg.REGISTRY[name].config, "int8",
                               "int4_g")["total_gb"] > 0
