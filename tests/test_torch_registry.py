"""The port's model registry against the JAX package's: every preset
listed with the same config, the same weight bytes by role at every quant
kind, the DeepSeek / Kimi / Qwen-MoE / Mixtral / Llama / GLM presets
translated to specs (llama-3.1-8b's and glm-4.5-air's equal to the JAX
package's field by field but for the llama3 rope scaling, which the port
takes from HF; smallthinker-21b's and qwen3-next-80b-a3b's equal to it
field by field), and a model type the port does not know refused."""

import dataclasses

import pytest

from ktransformers_tpu.models import registry as jreg
from ktransformers_tpu_torch.models import registry as treg

BYTE_FIELDS = ("embed_gb", "attn_gb", "dense_mlp_gb", "experts_gb",
               "shared_gb", "total_gb", "active_gb_per_token")
PORTED = ("deepseek-v2-lite", "deepseek-v2", "deepseek-v3", "deepseek-r1",
          "kimi-k2", "qwen3-235b-a22b", "qwen3-30b-a3b", "qwen2-57b-a14b",
          "mixtral-8x7b", "llama-3.1-8b", "glm-4.5-air", "smallthinker-21b",
          "qwen3-next-80b-a3b")


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
    assert shown["experts"] == (spec.moe.num_experts if spec.moe else 0)
    assert shown["estimate"] == treg.estimate_bytes(
        treg.REGISTRY[name].config, shown["recommended"]["quant"],
        shown["recommended"]["moe_quant"])
    if name.startswith(("deepseek", "kimi")):
        assert spec.attention.kind == "mla"
    if name in ("deepseek-v3", "deepseek-r1", "kimi-k2"):
        assert spec.attention.q_lora_rank == 1536
        assert spec.moe.gate.has_correction_bias
        rec, est = shown["recommended"], shown["estimate"]
        assert "HostOffloadServeEngine" in rec["offload"]
        assert "init_multihost" in rec["offload"]
        assert rec["host_gb"] == est["experts_gb"]
        assert abs(rec["host_gb"] + rec["device_gb"]
                   - est["total_gb"]) <= 0.011
        assert rec["device_gb"] < 80
    if name in ("smallthinker-21b", "qwen3-next-80b-a3b"):
        from ktransformers_tpu.models.spec import spec_from_hf_config

        jspec = spec_from_hf_config(dict(jreg.REGISTRY[name].config))
        for path, tv, jv in _fields(spec, jspec):
            assert tv == jv, path


@pytest.mark.parametrize("name", ["unknown_model_type"])
def test_other_families_raise_naming_item_6(name, monkeypatch):
    """Every preset translates; an entry of a model type the port does not
    know raises, naming the type, and still lists and estimates."""
    e = dataclasses.replace(treg.REGISTRY["qwen3-30b-a3b"], name=name,
                            config=dict(treg.REGISTRY["qwen3-30b-a3b"].config,
                                        model_type=name))
    monkeypatch.setitem(treg.REGISTRY, name, e)
    with pytest.raises(ValueError, match=f"{name!r} is not ported"):
        treg.REGISTRY[name].spec()
    with pytest.raises(ValueError, match=f"{name!r} is not ported"):
        treg.show_model(name)
    assert treg.estimate_bytes(e.config, "int8", "int4_g")["total_gb"] > 0


def _fields(t, j, path=""):
    """(path, port value, JAX value) of every field of the port's spec
    dataclass t, recursively, against the JAX spec's attribute of that
    name."""
    for f in dataclasses.fields(t):
        tv, jv = getattr(t, f.name), getattr(j, f.name)
        if dataclasses.is_dataclass(tv):
            yield from _fields(tv, jv, path + f.name + ".")
        else:
            yield path + f.name, tv, jv


@pytest.mark.parametrize("name, differ", [
    # HF's llama3 rope: its type, and high_freq_factor 4 in beta_fast
    # (the JAX translator drops the scaling: no type, YaRN's default 32)
    ("llama-3.1-8b", {"rope.scaling_type": ("llama3", None),
                      "rope.beta_fast": (4.0, 32.0)}),
    ("glm-4.5-air", {}),
])
def test_dense_and_glm_specs_match_jax(name, differ):
    """The registry's Llama-3.1-8B and GLM-4.5-Air specs equal the JAX
    registry's field by field, apart from the named rope difference;
    GLM's partial rotary (64 of 128), q / k norm, G = 96 / 8 and sigmoid
    group router, Llama's dense layers; both estimates as the JAX
    package's."""
    t, j = treg.REGISTRY[name].spec(), jreg.REGISTRY[name].spec()
    got = {p: (tv, jv) for p, tv, jv in _fields(t, j) if tv != jv}
    assert got == differ
    a = t.attention
    if name == "glm-4.5-air":
        assert (a.rotary_dim, t.rope.dim, a.qk_norm) == (64, 64, True)
        assert a.num_heads // a.num_kv_heads == 12
        assert t.moe.gate.group_method == "group_top2sum"
        assert t.moe.gate.has_correction_bias and t.moe.first_k_dense == 1
        assert t.moe.shared_expert_intermediate_size == 1408
    else:
        assert t.moe is None and a.rotary_dim == t.rope.dim == 128
        assert t.rope.scaling_factor == 8.0 and t.rope.beta_slow == 1.0
    e = treg.REGISTRY[name]
    est = treg.estimate_bytes(e.config, e.quant, e.moe_quant)
    jest = jreg.estimate_bytes(j, e.quant, e.moe_quant)
    assert {f: est[f] for f in BYTE_FIELDS} == {f: jest[f]
                                                for f in BYTE_FIELDS}
