"""The port's HF import against HuggingFace torch and against the JAX
package: the invariant "logits match HF torch", held by the port itself.

Tiny random HF models (transformers 4.57.6, float32, eager attention; the
configs and seeds of tests/test_models_parity.py) go through the port's
params_from_hf(quant="f32", device="cpu") and its forward(): the logits
must match HF's within 2e-3 of the largest logit, with equal argmax at the
last position. YaRN rope_scaling is held the same way, on DeepSeek-V3's
published values (where the JAX package's softmax scale misses: its
rope_attention_scale gives (m / m_all)^2 = 1, HF's DeepseekV3Attention
m_all^2, ROADMAP Queue 3) and on DeepSeek-V2-Lite's (mscale =
mscale_all_dim = 0.707, where both rules give 1). Qwen2-MoE and Qwen3-MoE
are held the same way, their biases, q / k norms and shared-expert gate
drawn away from HF's constant init.

build_params itself is held bit-exact: the port's tree against the JAX
package's build_params carried across with convert.params_from_jax, for
int4_g, int8 and bf16 weights, every QTensor field and every vector equal.
"""

import dataclasses

import numpy as np
import pytest
import torch

from ktransformers_tpu_torch.models.hf_import import params_from_hf
from ktransformers_tpu_torch.models.model import KVCache, forward
from ktransformers_tpu_torch.models.spec import spec_from_hf_config
from ktransformers_tpu_torch.quant.formats import QTensor

from tests.test_torch_model import one_torch_thread  # noqa: F401

ATOL = 2e-3  # of the largest HF logit
V3_YARN = dict(type="yarn", factor=40.0, beta_fast=32, beta_slow=1,
               mscale=1.0, mscale_all_dim=1.0,
               original_max_position_embeddings=16)
V2_LITE_YARN = dict(V3_YARN, mscale=0.707, mscale_all_dim=0.707)


def _logits(spec, params, tokens, max_len):
    cache = KVCache.create(spec, tokens.shape[0], max_len, torch.float32,
                           "cpu")
    with torch.no_grad():
        out, _ = forward(params, spec, torch.from_numpy(tokens), cache,
                         compute_dtype=torch.float32)
    return out.numpy()


def _rel(out, ref) -> float:
    return float(np.abs(out - ref).max() / (np.abs(ref).max() + 1e-6))


def _run_parity(hf_model, cfg, prompt_len=12, batch=2, spec=None):
    hf_model = hf_model.eval().float()
    spec = spec or spec_from_hf_config(cfg)
    params = params_from_hf(hf_model, spec, quant="f32", device="cpu")
    tokens = np.random.default_rng(0).integers(0, cfg.vocab_size,
                                               size=(batch, prompt_len))
    with torch.no_grad():
        ref = hf_model(torch.from_numpy(tokens)).logits.numpy()
    out = _logits(spec, params, tokens, prompt_len + 8)
    assert out.shape == ref.shape
    err = _rel(out, ref)
    assert err < ATOL, f"max rel logit err {err}"
    np.testing.assert_array_equal(out[:, -1].argmax(-1), ref[:, -1].argmax(-1))
    return spec, params, tokens, ref


def _v2_lite_model(rope_scaling=None, seed=0):
    from transformers import DeepseekV2Config, DeepseekV2ForCausalLM

    cfg = DeepseekV2Config(
        vocab_size=128, hidden_size=64, intermediate_size=128,
        moe_intermediate_size=48, num_hidden_layers=3, num_attention_heads=4,
        num_key_value_heads=4, n_shared_experts=2, n_routed_experts=8,
        num_experts_per_tok=2, first_k_dense_replace=1, moe_layer_freq=1,
        routed_scaling_factor=1.0, topk_method="greedy",
        norm_topk_prob=False, kv_lora_rank=32, q_lora_rank=None,
        qk_rope_head_dim=16, qk_nope_head_dim=32, v_head_dim=32,
        head_dim=16, max_position_embeddings=64, rope_scaling=rope_scaling,
        attn_implementation="eager")
    torch.manual_seed(seed)
    return DeepseekV2ForCausalLM(cfg), cfg


def _v3_model(rope_scaling=None):
    from transformers import DeepseekV3Config, DeepseekV3ForCausalLM

    cfg = DeepseekV3Config(
        vocab_size=128, hidden_size=64, intermediate_size=128,
        moe_intermediate_size=48, num_hidden_layers=3, num_attention_heads=4,
        num_key_value_heads=4, n_shared_experts=1, n_routed_experts=16,
        num_experts_per_tok=4, n_group=4, topk_group=2,
        first_k_dense_replace=1, norm_topk_prob=True,
        routed_scaling_factor=2.5, kv_lora_rank=32, q_lora_rank=48,
        qk_rope_head_dim=16, qk_nope_head_dim=32, v_head_dim=32,
        max_position_embeddings=64, rope_scaling=rope_scaling,
        attn_implementation="eager")
    torch.manual_seed(1)
    model = DeepseekV3ForCausalLM(cfg)
    with torch.no_grad():
        for layer in model.model.layers[cfg.first_k_dense_replace:]:
            layer.mlp.gate.e_score_correction_bias.uniform_(-0.1, 0.1)
    return model, cfg


def _mixtral_model():
    from transformers import MixtralConfig, MixtralForCausalLM

    cfg = MixtralConfig(
        vocab_size=128, hidden_size=64, intermediate_size=96,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        num_local_experts=4, num_experts_per_tok=2,
        max_position_embeddings=64, attn_implementation="eager")
    torch.manual_seed(4)
    return MixtralForCausalLM(cfg), cfg


def _qwen_moe_model(family: str):
    """A tiny HF Qwen2-MoE / Qwen3-MoE (the configs and seeds of
    tests/test_models_parity.py) with its q / k / v biases, q / k norms,
    layer norms and shared-expert gate drawn: HF initialises them to
    constants, which would leave a missing bias or a norm applied twice
    unseen."""
    from transformers import (
        Qwen2MoeConfig,
        Qwen2MoeForCausalLM,
        Qwen3MoeConfig,
        Qwen3MoeForCausalLM,
    )

    kw = dict(vocab_size=128, hidden_size=64, intermediate_size=128,
              moe_intermediate_size=32, num_hidden_layers=2,
              num_attention_heads=4, num_key_value_heads=2, num_experts=8,
              num_experts_per_tok=2, decoder_sparse_step=1,
              max_position_embeddings=64, attn_implementation="eager")
    if family == "qwen2_moe":
        cfg = Qwen2MoeConfig(shared_expert_intermediate_size=64,
                             norm_topk_prob=False, **kw)
        torch.manual_seed(2)
        model = Qwen2MoeForCausalLM(cfg)
    else:
        cfg = Qwen3MoeConfig(head_dim=16, norm_topk_prob=True, **kw)
        torch.manual_seed(3)
        model = Qwen3MoeForCausalLM(cfg)
    gen = torch.Generator().manual_seed(5)
    with torch.no_grad():
        for name, prm in model.named_parameters():
            if name.endswith(("_proj.bias", "shared_expert_gate.weight")):
                prm.copy_(torch.randn(prm.shape, generator=gen) * 0.1)
            elif name.endswith("norm.weight"):
                prm.copy_(1 + 0.1 * torch.randn(prm.shape, generator=gen))
    return model, cfg


@pytest.mark.parametrize("family", ["qwen2_moe", "qwen3_moe"])
def test_qwen_moe_parity(family):
    """Qwen2-MoE (q / k / v biases, the shared expert's sigmoid gate,
    softmax top-2 unnormalized) and Qwen3-MoE (per-head q / k RMSNorm,
    head_dim 16 of hidden 64, top-2 renormalized) within 2e-3 of HF's
    logits, the same argmax; HF's own config dict gives the JAX package's
    spec field by field."""
    from ktransformers_tpu.models.spec import spec_from_hf_config as jspec

    model, cfg = _qwen_moe_model(family)
    spec, params, _, _ = _run_parity(model, cfg)
    attn = params["layers"][0]["attn"]
    if family == "qwen2_moe":
        assert {"q_bias", "k_bias", "v_bias"} <= set(attn)
        assert params["layers"][0]["moe"]["shared_gate"].shape == (1, 64)
    else:
        assert attn["q_norm"].shape == attn["k_norm"].shape == (16,)
    j = jspec(cfg.to_dict())
    for sub, jsub in ((spec, j), (spec.attention, j.attention),
                      (spec.moe, j.moe), (spec.rope, j.rope)):
        for f in dataclasses.fields(sub):
            if not dataclasses.is_dataclass(getattr(sub, f.name)):
                assert getattr(sub, f.name) == getattr(jsub, f.name), f.name


def test_deepseek_v2_lite_parity():
    _run_parity(*_v2_lite_model())


def test_deepseek_v3_parity():
    """q_lora (q_a -> q_a_norm -> q_b), sigmoid noaux_tc router over 4
    groups with a random correction bias."""
    spec, params, _, _ = _run_parity(*_v3_model())
    assert spec.attention.q_lora_rank == 48
    assert spec.moe.gate.group_method == "group_top2sum"
    assert params["layers"][1]["moe"]["router_bias_corr"].abs().max() > 0


def test_mixtral_parity():
    _run_parity(*_mixtral_model())


def test_deepseek_v3_yarn_parity():
    """DeepSeek-V3's published rope_scaling (factor 40, mscale =
    mscale_all_dim = 1, original context 16 so that the tiny prompt spans
    the YaRN ramp): the port's spec scale m_all^2 * 48^-0.5 matches HF;
    the JAX package's rule (softmax_scale None here) misses by more than
    the tolerance."""
    from ktransformers_tpu_torch.ops.rope import yarn_get_mscale

    model, cfg = _v3_model(V3_YARN)
    spec, params, tokens, ref = _run_parity(model, cfg)
    m_all = yarn_get_mscale(40.0, 1.0)
    assert spec.attention.softmax_scale == pytest.approx(
        48 ** -0.5 * m_all ** 2, rel=1e-12)
    jax_rule = dataclasses.replace(
        spec, attention=dataclasses.replace(spec.attention,
                                            softmax_scale=None))
    assert _rel(_logits(jax_rule, params, tokens, 20), ref) > 5e-3


def test_deepseek_v2_lite_yarn_parity():
    """DeepSeek-V2-Lite's published mscale = mscale_all_dim = 0.707: HF's
    DeepseekV2Attention applies no factor, the port (the JAX rule) gives
    (m / m_all)^2 = 1."""
    spec, _, _, _ = _run_parity(*_v2_lite_model(V2_LITE_YARN))
    assert spec.attention.softmax_scale is None


def test_incremental_decode_matches_prefill():
    """prefill(6) then 4 single-token steps equal one 10-token forward,
    on bf16 weights carried from HF (float32 compute)."""
    from transformers import DeepseekV2Config, DeepseekV2ForCausalLM

    cfg = DeepseekV2Config(
        vocab_size=64, hidden_size=32, intermediate_size=64,
        moe_intermediate_size=32, num_hidden_layers=2, num_attention_heads=2,
        num_key_value_heads=2, n_shared_experts=1, n_routed_experts=4,
        num_experts_per_tok=2, first_k_dense_replace=1, topk_method="greedy",
        kv_lora_rank=16, q_lora_rank=None, qk_rope_head_dim=8,
        qk_nope_head_dim=16, v_head_dim=16, head_dim=8,
        max_position_embeddings=64, attn_implementation="eager")
    torch.manual_seed(6)
    model = DeepseekV2ForCausalLM(cfg).eval().float()
    spec = spec_from_hf_config(cfg)
    params = params_from_hf(model, spec, quant="bf16", device="cpu")
    tokens = torch.from_numpy(np.random.default_rng(1).integers(
        0, 64, size=(1, 10)))
    f32 = dict(compute_dtype=torch.float32)
    with torch.no_grad():
        full, _ = forward(params, spec, tokens,
                          KVCache.create(spec, 1, 16, torch.float32, "cpu"),
                          **f32)
        cache = KVCache.create(spec, 1, 16, torch.float32, "cpu")
        out, cache = forward(params, spec, tokens[:, :6], cache, **f32)
        outs = [out]
        for i in range(6, 10):
            out, cache = forward(params, spec, tokens[:, i : i + 1], cache,
                                 **f32)
            outs.append(out)
    np.testing.assert_allclose(torch.cat(outs, 1).numpy(), full.numpy(),
                               rtol=1e-4, atol=1e-4)


def _assert_same_tree(t, j, path="params"):
    """Port tree t equal to j, the JAX tree carried across, leaf by leaf:
    the same keys, QTensor kinds, group sizes and bits."""
    if isinstance(t, QTensor):
        assert isinstance(j, QTensor), path
        assert (t.kind, t.group_size, t.act_quant) == \
            (j.kind, j.group_size, j.act_quant), path
        for f in ("data", "scales", "zeros"):
            a, b = getattr(t, f), getattr(j, f)
            assert (a is None) == (b is None), f"{path}.{f}"
            if a is not None:
                assert a.dtype == b.dtype and torch.equal(a, b), f"{path}.{f}"
    elif isinstance(t, dict):
        assert set(t) == set(j), (path, sorted(t), sorted(j))
        for k in t:
            _assert_same_tree(t[k], j[k], f"{path}.{k}")
    elif isinstance(t, list):
        assert len(t) == len(j), path
        for i, (a, b) in enumerate(zip(t, j)):
            _assert_same_tree(a, b, f"{path}[{i}]")
    elif dataclasses.is_dataclass(t):
        for f in ("gate_up", "down"):
            _assert_same_tree(getattr(t, f), getattr(j, f), f"{path}.{f}")
    elif t is None:
        assert j is None, path
    else:
        assert t.dtype == j.dtype and torch.equal(t, j), path


@pytest.mark.parametrize("family", ["v2_lite", "v3", "mixtral", "qwen2_moe",
                                    "qwen3_moe"])
@pytest.mark.parametrize("quant", ["int4_g", "int8", "bf16"])
def test_build_params_bit_exact_with_jax(family, quant):
    """The port's build_params (through params_from_hf) against the JAX
    package's build_params + convert.params_from_jax: bit-exact codes,
    scales and vectors; experts int4_g except for bf16."""
    import jax

    from ktransformers_tpu.models.hf_import import (
        params_from_hf as j_params_from_hf,
    )
    from ktransformers_tpu.models.spec import (
        spec_from_hf_config as j_spec_from_hf_config,
    )
    from ktransformers_tpu_torch.convert import params_from_jax

    model, cfg = {"v2_lite": _v2_lite_model, "v3": _v3_model,
                  "mixtral": _mixtral_model,
                  "qwen2_moe": lambda: _qwen_moe_model("qwen2_moe"),
                  "qwen3_moe": lambda: _qwen_moe_model("qwen3_moe")}[family]()
    model = model.eval().float()
    spec = spec_from_hf_config(cfg)
    moe_quant = "bf16" if quant == "bf16" else "int4_g"
    port = params_from_hf(model, spec, quant=quant, moe_quant=moe_quant,
                          group_size=32, device="cpu")
    ref = j_params_from_hf(model, j_spec_from_hf_config(cfg), quant=quant,
                           moe_quant=moe_quant, group_size=32)
    _assert_same_tree(port, params_from_jax(jax.device_get(ref), spec, "cpu"))


def test_build_params_partial_tree_and_refusals():
    """layer_indices with include_head=False builds those layers only, as
    the JAX package does; a placement that gives every module int8
    builds the int8 tree, and
    exact_gguf with a provider that has no get_exact (no GGUF codes to
    carry over) builds the tree it builds without, as in the JAX
    package."""
    from ktransformers_tpu_torch.loader.providers import TorchModelProvider
    from ktransformers_tpu_torch.models.loading import build_params
    from ktransformers_tpu_torch.placement import PlacementSpec

    model, cfg = _v3_model()
    spec = spec_from_hf_config(cfg)
    prov = TorchModelProvider(model)
    part = build_params(prov, spec, quant="int8", layer_indices=[2],
                        include_head=False, device="cpu")
    full = build_params(prov, spec, quant="int8", device="cpu")
    assert part["embed"] is None and part["final_norm"] is None
    assert "lm_head" not in part and len(part["layers"]) == 1
    _assert_same_tree(part["layers"][0], full["layers"][2])
    all_int8 = PlacementSpec.from_dict(
        [{"match": {"name": ".*"}, "assign": {"quant": "int8"}}])
    _assert_same_tree(build_params(prov, spec, device="cpu",
                                   placement=all_int8), full)
    _assert_same_tree(build_params(prov, spec, quant="int8", device="cpu",
                                   exact_gguf=True), full)
    assert prov.maybe("no.such.weight") is None
    with pytest.raises(KeyError):
        prov.get("no.such.weight")


def test_import_from_plain_module_tree():
    """chip_smoke.py's HF-import phase at narrow widths: HF-named tensors
    drawn from a seed, held by a plain nn.Module tree (no transformers),
    through TorchModelProvider -> build_params(int4_g) -> prepare_params ->
    Generator on the CPU; the imported codes equal quantize() of the drawn
    tensors."""
    import chip_smoke
    from ktransformers_tpu_torch.engine.generate import (
        GenerateConfig,
        Generator,
    )
    from ktransformers_tpu_torch.loader.providers import TorchModelProvider
    from ktransformers_tpu_torch.models.loading import build_params
    from ktransformers_tpu_torch.models.spec import DEEPSEEK_V2_LITE
    from ktransformers_tpu_torch.quant.formats import quantize

    cfg = dict(DEEPSEEK_V2_LITE, vocab_size=256, hidden_size=128,
               intermediate_size=256, moe_intermediate_size=64,
               num_hidden_layers=2, num_attention_heads=2,
               num_key_value_heads=2, n_routed_experts=4,
               num_experts_per_tok=2, kv_lora_rank=32, qk_rope_head_dim=16,
               qk_nope_head_dim=16, v_head_dim=16)
    spec = spec_from_hf_config(cfg)
    tensors = chip_smoke.hf_tensors(spec, seed=3)
    module = chip_smoke.hf_module(tensors)
    names = dict(module.named_parameters())
    assert set(names) == set(tensors)
    params = build_params(TorchModelProvider(module), spec, quant="int4_g",
                          device="cpu")
    w = tensors["model.layers.1.mlp.experts.3.down_proj.weight"]
    want = quantize(w.T.contiguous(), "int4_g")
    got = params["layers"][1]["moe"]["experts"].down
    assert torch.equal(got.data[3], want.data)
    assert torch.equal(got.scales[3], want.scales)
    gen = Generator(params, spec, max_len=32, device="cpu",
                    cache_dtype=torch.float32, compute_dtype=torch.float32)
    out = gen.generate([[5, 7, 11, 13]], GenerateConfig(max_new_tokens=3,
                                                        prefill_chunk=4))
    assert len(out[0]) == 3
