"""The port's loaders, placement rules, packed checkpoints, CLI and
perplexity against the JAX package and the safetensors package.

- loader/safetensors_io.py against safetensors' own reader and writer, bit
  for bit, for every dtype a checkpoint uses;
- SafetensorsProvider (an indexed directory, FP8 blockwise weights) and
  the GPTQ / AWQ import against the JAX package's, bit for bit; a GPTQ
  DeepSeek-V2 checkpoint end to end against its float dequant: logits
  within the 5e-2 of the largest logit the port's W4A8 tests use, greedy
  tokens equal where the float model's top two logits are further apart
  than the two models' largest logit difference;
- the 19 placement rules equal to the JAX YAML files, resolved alike on
  every module path of a tiny DeepSeek and a tiny Mixtral, and
  build_params(placement=...) bit-equal to the JAX build carried across;
- packed directories across the packages in both directions, bit for bit,
  and the streamed conversion's resume;
- the CLI in process: convert of a tiny HF directory gives the JAX CLI's
  packed tensors and its greedy tokens; doctor, models, placements, tune
  (H100 figures), bench (refused), serve --offload (its engine class);
- perplexity within 1e-4 of the JAX package's on float32 weights.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from safetensors import safe_open
from safetensors.torch import save_file as st_save_file

from ktransformers_tpu.loader import gptq as j_gptq
from ktransformers_tpu.loader.providers import (
    SafetensorsProvider as JSafetensorsProvider,
)
from ktransformers_tpu.loader.providers import (
    TorchModelProvider as JTorchModelProvider,
)
from ktransformers_tpu.models import checkpoint as j_checkpoint
from ktransformers_tpu.models.init import init_params as j_init_params
from ktransformers_tpu.models.loading import build_params as j_build_params
from ktransformers_tpu.models.spec import spec_from_hf_config as j_spec
from ktransformers_tpu.placement import library as j_library

from ktransformers_tpu_torch.cli.main import main
from ktransformers_tpu_torch.convert import params_from_jax
from ktransformers_tpu_torch.engine.generate import GenerateConfig, Generator
from ktransformers_tpu_torch.engine.local_chat import load_model
from ktransformers_tpu_torch.loader import gptq
from ktransformers_tpu_torch.loader.providers import (
    SafetensorsProvider,
    TorchModelProvider,
)
from ktransformers_tpu_torch.loader.safetensors_io import (
    SafetensorsFile,
    save_file,
)
from ktransformers_tpu_torch.models import checkpoint
from ktransformers_tpu_torch.models.loading import WeightProvider, build_params
from ktransformers_tpu_torch.models.model import KVCache, forward
from ktransformers_tpu_torch.models.spec import spec_from_hf_config
from ktransformers_tpu_torch.placement import library
from ktransformers_tpu_torch.placement.spec import PlacementSpec
from ktransformers_tpu_torch.quant.formats import dequantize
from ktransformers_tpu_torch.utils.device_prep import prepare_params

from tests.test_cli_checkpoint import _make_hf_dir
from tests.test_generate import TINY_DS
from tests.test_gptq_import import _pack_awq, _pack_rows_lsb, _rand_qzs
from tests.test_torch_hf_import import _assert_same_tree
from tests.test_torch_model import LOGIT_TOL, one_torch_thread  # noqa: F401

DTYPES = (torch.float64, torch.float32, torch.float16, torch.bfloat16,
          torch.int64, torch.int32, torch.int16, torch.int8, torch.uint8,
          torch.uint16, torch.bool, torch.float8_e4m3fn)


def bits(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().reshape(-1).view(torch.uint8)


def _draw(dtype, shape, g):
    x = torch.randn(shape, generator=g) * 40
    if dtype == torch.bool:
        return x > 0
    if dtype.is_floating_point:
        return x.to(dtype)
    lo = 0 if dtype in (torch.uint8, torch.uint16) else -100
    return torch.randint(lo, 100, shape, generator=g).to(dtype)


def _tiny_ds_model(layers=2, seed=0):
    from transformers import DeepseekV2Config, DeepseekV2ForCausalLM

    cfg = DeepseekV2Config(
        vocab_size=96, hidden_size=32, intermediate_size=64,
        moe_intermediate_size=32, num_hidden_layers=layers,
        num_attention_heads=2, num_key_value_heads=2, n_shared_experts=1,
        n_routed_experts=4, num_experts_per_tok=2, first_k_dense_replace=1,
        moe_layer_freq=1, routed_scaling_factor=1.0, topk_method="greedy",
        norm_topk_prob=False, kv_lora_rank=16, q_lora_rank=None,
        qk_rope_head_dim=8, qk_nope_head_dim=16, v_head_dim=16,
        max_position_embeddings=64, attn_implementation="eager")
    torch.manual_seed(seed)
    return DeepseekV2ForCausalLM(cfg).eval().float(), cfg.to_dict()


# -- safetensors ------------------------------------------------------------


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_safetensors_reader_matches_package(tmp_path, dtype):
    g = torch.Generator().manual_seed(1)
    tensors = {"a.weight": _draw(dtype, (3, 5), g),
               "b": _draw(dtype, (7,), g), "scalar": _draw(dtype, (), g)}
    path = str(tmp_path / "x.safetensors")
    st_save_file(tensors, path, metadata={"format": "pt"})
    f = SafetensorsFile(path)
    assert sorted(f.keys()) == sorted(tensors) and f.metadata == {
        "format": "pt"}
    with safe_open(path, framework="pt") as h:
        for k in tensors:
            ref = h.get_tensor(k)
            got = f.get(k)
            assert got.dtype == ref.dtype and got.shape == ref.shape, k
            assert torch.equal(bits(got), bits(ref)), k


def test_safetensors_writer_read_by_package(tmp_path):
    g = torch.Generator().manual_seed(2)
    tensors = {f"t{i}": _draw(dt, (4, 3), g) for i, dt in enumerate(DTYPES)}
    tensors["np_f32"] = np.arange(6, dtype=np.float32).reshape(2, 3)
    tensors["np_bool"] = np.array([True, False])
    tensors["np_bf16"] = np.asarray(jnp.arange(4, dtype=jnp.bfloat16))
    path = str(tmp_path / "w.safetensors")
    save_file(tensors, path, metadata={"k": "v"})
    with safe_open(path, framework="pt") as h:
        assert sorted(h.keys()) == sorted(tensors)
        assert h.metadata() == {"k": "v"}
        for k, v in tensors.items():
            got = h.get_tensor(k)
            if isinstance(v, np.ndarray):
                want = torch.from_numpy(np.array(v).view(np.uint8))
                assert torch.equal(bits(got), want.reshape(-1)), k
            else:
                assert got.dtype == v.dtype and torch.equal(bits(got),
                                                            bits(v)), k


def _as_f32_bits(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a, np.float32)).view(np.uint32)


def test_safetensors_provider_matches_jax(tmp_path):
    """An indexed two-file directory of F32 / F16 / BF16 tensors, the same
    directory without its index, and one file: the JAX provider's values
    bit for bit (BF16 widened to float32)."""
    g = torch.Generator().manual_seed(3)
    parts = [
        {"model.embed_tokens.weight": torch.randn(6, 4, generator=g),
         "model.norm.weight": torch.randn(4, generator=g).half()},
        {"lm_head.weight": torch.randn(6, 4, generator=g).bfloat16(),
         "model.layers.0.mlp.down_proj.weight":
             torch.randn(4, 8, generator=g).bfloat16()},
    ]
    d = tmp_path / "ckpt"
    d.mkdir()
    weight_map = {}
    for i, part in enumerate(parts):
        name = f"model-0000{i + 1}-of-00002.safetensors"
        st_save_file(part, str(d / name))
        weight_map.update({k: name for k in part})
    (d / "model.safetensors.index.json").write_text(
        json.dumps({"metadata": {}, "weight_map": weight_map}))
    for path in (str(d), str(d / "model-00002-of-00002.safetensors")):
        t, j = SafetensorsProvider(path), JSafetensorsProvider(path)
        assert sorted(t.keys()) == sorted(j.keys())
        for k in t.keys():
            assert np.array_equal(_as_f32_bits(t.get(k)),
                                  _as_f32_bits(j.get(k))), k
        assert t.maybe("no.such") is None
    os.remove(d / "model.safetensors.index.json")
    assert sorted(SafetensorsProvider(str(d)).keys()) == sorted(weight_map)


def test_safetensors_provider_fp8_blockwise(tmp_path):
    """DeepSeek-V3's FP8 format (weight codes + weight_scale_inv per 128 x
    128 block, a ragged last block): the JAX provider's dequant bit for
    bit with the codes stored as U8 (the only form the JAX provider
    reads); the same codes stored as F8_E4M3 give the same bits."""
    rng = np.random.default_rng(0)
    w = rng.standard_normal((200, 300)).astype(np.float32) * 0.05
    scale = (rng.random((2, 3)).astype(np.float32) + 0.5) / 448.0
    s_full = np.repeat(np.repeat(scale, 128, 0), 128, 1)[:200, :300]
    codes = torch.from_numpy(w / s_full).to(torch.float8_e4m3fn)
    u8 = tmp_path / "u8"
    u8.mkdir()
    save_file({"x.weight": codes.view(torch.uint8),
               "x.weight_scale_inv": torch.from_numpy(scale)},
              str(u8 / "model.safetensors"))
    f8 = tmp_path / "f8"
    f8.mkdir()
    st_save_file({"x.weight": codes,
                  "x.weight_scale_inv": torch.from_numpy(scale)},
                 str(f8 / "model.safetensors"))
    got = SafetensorsProvider(str(u8)).get("x.weight")
    ref = JSafetensorsProvider(str(u8)).get("x.weight")
    assert got.dtype == np.float32 and np.array_equal(_as_f32_bits(got),
                                                      _as_f32_bits(ref))
    assert np.array_equal(
        _as_f32_bits(SafetensorsProvider(str(f8)).get("x.weight")),
        _as_f32_bits(got))


# -- GPTQ / AWQ ---------------------------------------------------------------


def _same_qtensor(t, j):
    assert (t.kind, t.group_size) == (j.kind, j.group_size)
    for f in ("data", "scales", "zeros"):
        a, b = getattr(t, f), np.asarray(getattr(j, f))
        assert a.numpy().dtype == b.dtype and np.array_equal(a.numpy(), b), f


@pytest.mark.parametrize("fmt", ["gptq_v1", "gptq_v2", "awq"])
def test_gptq_awq_match_jax(rng, fmt):
    k, n, gs = 64, 32, 16
    q, z, s, _ = _rand_qzs(rng, k, n, gs)
    if fmt == "awq":
        args = (_pack_awq(q, 1), _pack_awq(z, 1), s.astype(np.float16))
        _same_qtensor(gptq.awq_to_qtensor(*args),
                      j_gptq.awq_to_qtensor(*args))
        return
    v2 = fmt == "gptq_v2"
    zs = z if v2 else (z - 1) & 0xF
    args = (_pack_rows_lsb(q, 0), _pack_rows_lsb(zs, 1),
            s.astype(np.float16), np.arange(k, dtype=np.int32) // gs)
    _same_qtensor(gptq.gptq_to_qtensor(*args, v2=v2),
                  j_gptq.gptq_to_qtensor(*args, v2=v2))
    back = dequantize(gptq.gptq_to_qtensor(*args, v2=v2), torch.float32)
    ref = (q.astype(np.float32) - np.repeat(z, gs, 0)) \
        * np.repeat(s.astype(np.float16).astype(np.float32), gs, 0)
    np.testing.assert_allclose(back.numpy(), ref, rtol=1e-6, atol=1e-7)


def test_gptq_desc_act_refused(rng):
    k, n, gs = 32, 16, 8
    q, z, s, _ = _rand_qzs(rng, k, n, gs)
    g_idx = np.arange(k, dtype=np.int32)[::-1] // gs
    args = (_pack_rows_lsb(q, 0), _pack_rows_lsb(z, 1), s, g_idx)
    with pytest.raises(NotImplementedError, match="desc_act"):
        gptq.gptq_to_qtensor(*args)
    with pytest.raises(NotImplementedError):
        j_gptq.gptq_to_qtensor(*args)


def _gptq_quantize(w: np.ndarray, gs: int):
    """Asymmetric 4-bit GPTQ v1 tensors of w [N, K] (no error feedback),
    and their float dequant [N, K]."""
    wt = w.T.astype(np.float32)  # [K, N]
    k, n = wt.shape
    g = wt.reshape(k // gs, gs, n)
    lo, hi = g.min(1), g.max(1)
    scale = np.maximum(hi - lo, 1e-6) / 15.0
    scale16 = scale.astype(np.float16)
    s = scale16.astype(np.float32)
    z = np.clip(np.round(-lo / s), 0, 15).astype(np.uint8)
    q = np.clip(np.round(g / s[:, None]) + z[:, None], 0, 15).astype(np.uint8)
    deq = ((q.astype(np.float32) - z[:, None]) * s[:, None]).reshape(k, n)
    tensors = {"qweight": _pack_rows_lsb(q.reshape(k, n), 0),
               "qzeros": _pack_rows_lsb((z - 1) & 0xF, 1),
               "scales": scale16,
               "g_idx": np.arange(k, dtype=np.int32) // gs}
    return tensors, deq.T


class DictProvider(WeightProvider):
    def __init__(self, d):
        self.d = d

    def get(self, name):
        if name not in self.d:
            raise KeyError(name)
        return self.d[name]


def test_quantized_provider_end_to_end(tmp_path):
    """A GPTQ checkpoint of a tiny DeepSeek-V2 (every linear of the decoder
    layers packed at group 16) loads with its codes carried into int4_gz
    and runs the W4A8 path; its float dequant is the reference."""
    model, cfg = _tiny_ds_model()
    sd = {k: v.detach().numpy() for k, v in model.named_parameters()}
    files, floats = {}, {}
    for name, w in sd.items():
        if name.startswith("model.layers.") and name.endswith("proj.weight"):
            packed, deq = _gptq_quantize(w, 16)
            stem = name[: -len(".weight")]
            files.update({f"{stem}.{k}": v for k, v in packed.items()})
            floats[name] = deq
        else:
            files[name] = w
            floats[name] = w
    d = tmp_path / "gptq"
    d.mkdir()
    save_file(files, str(d / "model.safetensors"))
    (d / "config.json").write_text(json.dumps(dict(
        cfg, quantization_config={"quant_method": "gptq", "bits": 4,
                                  "group_size": 16})))
    spec, params = load_model(str(d), quant="f32", moe_quant="f32",
                              device="cpu")
    lp = params["layers"][1]
    assert lp["attn"]["q_proj"].kind == "int4_gz"
    assert lp["moe"]["experts"].gate_up.kind == "int4_gz"
    assert lp["moe"]["experts"].gate_up.data.shape[0] == 4
    assert lp["moe"]["shared"]["gate_up"].kind == "int4_gz"
    assert params["lm_head"].kind == "bf16"  # plain tensors at quant
    np.testing.assert_array_equal(
        dequantize(lp["attn"]["q_proj"], torch.float32).numpy(),
        floats["model.layers.1.self_attn.q_proj.weight"].T)
    ref = build_params(DictProvider(floats), spec, quant="f32", device="cpu")

    def logits(p, ids):
        p = prepare_params(p, spec)
        cache = KVCache.create(spec, 1, 64, torch.float32, "cpu")
        out, _ = forward(p, spec, torch.tensor([ids]), cache,
                         compute_dtype=torch.float32)
        return out[0]

    prompt = list(range(3, 19))
    gen = Generator(ref, spec, max_len=64, device="cpu",
                    cache_dtype=torch.float32, compute_dtype=torch.float32)
    toks = gen.generate([prompt], GenerateConfig(max_new_tokens=8))[0]
    seq = prompt + toks[:-1]
    a, b = logits(params, seq), logits(ref, seq)
    diff = float((a - b).abs().max())
    assert diff <= LOGIT_TOL * float(b.abs().max()), diff
    top2 = b.topk(2, dim=-1).values
    tie = (top2[:, 0] - top2[:, 1]) <= 2 * diff
    same = a.argmax(-1) == b.argmax(-1)
    assert bool((same | tie).all())
    assert bool(same[len(prompt) - 1:].sum() >= 1)


# -- placement ----------------------------------------------------------------


def _module_paths(spec_cfg) -> list[str]:
    """Every prefix of every leaf path of the JAX init_params tree, dotted
    ("layers.1.moe.experts", "layers.1.moe.experts.gate_up", ...)."""
    tree = j_init_params(j_spec(dict(spec_cfg)), seed=0, quant="int8")
    paths = set()
    for kp, _ in jax.tree_util.tree_flatten_with_path(tree)[0]:
        parts = [str(getattr(k, "key", getattr(k, "name",
                                                getattr(k, "idx", k))))
                 for k in kp]
        for i in range(1, len(parts) + 1):
            paths.add(".".join(parts[:i]))
    return sorted(paths)


TINY_MIXTRAL = dict(
    model_type="mixtral", vocab_size=64, hidden_size=32,
    intermediate_size=64, num_hidden_layers=2, num_attention_heads=4,
    num_key_value_heads=2, num_local_experts=4, num_experts_per_tok=2,
    max_position_embeddings=64, rms_norm_eps=1e-5, rope_theta=1e6)
PATHS = None


@pytest.mark.parametrize("name", library.available_placements())
def test_placement_rule_matches_jax(name):
    global PATHS
    if PATHS is None:
        PATHS = _module_paths(TINY_DS) + _module_paths(TINY_MIXTRAL)
    assert library.available_placements() == j_library.available_placements()
    with open(os.path.join(library.RULES_DIR, name + ".json")) as f:
        ours = json.load(f)
    with open(os.path.join(j_library.RULES_DIR, name + ".yaml")) as f:
        assert ours == yaml.safe_load(f)
    base = name.removesuffix("-8chip")
    for mesh in (None, 8):
        t = library.load_placement(base, mesh)
        j = j_library.load_placement(base, mesh)
        for path in PATHS + ["lm_head", "embed", "final_norm"]:
            rt, rj = t.resolve(path), j.resolve(path)
            assert (rt.pattern, rt.quant, rt.group_size, rt.shard,
                    rt.offload, rt.extra) == (
                rj.pattern, rj.quant, rj.group_size, rj.shard, rj.offload,
                rj.extra), (name, path)
            assert t.quant_for(path) == j.quant_for(path)


def test_placement_files_and_text(tmp_path):
    """A user's YAML file, YAML text and a JSON file resolve as the JAX
    package's YAML does; YAML without PyYAML names the JSON alternative."""
    text = ('- match: {name: "layers\\\\.\\\\d+\\\\.moe\\\\.experts.*"}\n'
            '  assign: {quant: int4_gz, group_size: 32, offload: host}\n'
            '- match: {name: ".*"}\n  assign: {quant: int8, foo: 1}\n')
    yf = tmp_path / "rules.yaml"
    yf.write_text(text)
    jf = tmp_path / "rules.json"
    jf.write_text(json.dumps(yaml.safe_load(text)))
    from ktransformers_tpu.placement.spec import PlacementSpec as JSpec

    ref = JSpec.from_yaml(str(yf))
    for spec in (library.load_placement(str(yf)),
                 library.load_placement(str(jf)),
                 PlacementSpec.from_yaml(text)):
        for path in ("layers.3.moe.experts", "layers.3.attn.q_proj", "x"):
            assert spec.resolve(path) == type(spec.resolve(path))(
                **vars(ref.resolve(path)))
    from ktransformers_tpu.placement.spec import (
        default_moe_placement as j_default,
    )

    from ktransformers_tpu_torch.placement.spec import default_moe_placement

    for kinds in (("int4_g", "int8"), ("int4_gz", "fp8")):
        t, j = default_moe_placement(*kinds), j_default(*kinds)
        for path in ("layers.2.moe.experts", "embed", "layers.0.mlp",
                     "layers.1.attn.post_attn_norm", "lm_head"):
            assert t.quant_for(path) == j.quant_for(path), path
    import sys

    saved = sys.modules.get("yaml")
    sys.modules["yaml"] = None
    try:
        with pytest.raises(ImportError, match="JSON"):
            library.load_placement(str(yf))
        assert library.load_placement("deepseek-v2-lite").rules
    finally:
        sys.modules["yaml"] = saved


@pytest.mark.parametrize("rules", ["deepseek-v2-lite", "mixed"])
def test_build_params_placement_matches_jax(rules):
    model, cfg = _tiny_ds_model()
    if rules == "mixed":
        entries = [
            {"match": {"name": r"layers\.\d+\.moe\.experts.*"},
             "assign": {"quant": "int4_g", "group_size": 16}},
            {"match": {"name": r"layers\.\d+\.moe\.shared.*"},
             "assign": {"quant": "int4_gz", "group_size": 16}},
            {"match": {"name": r"layers\.\d+\.attn\.kv_a"},
             "assign": {"quant": "int8"}},
            {"match": {"name": r"layers\.\d+\.attn\..*"},
             "assign": {"quant": "int8_g", "group_size": 16}},
            {"match": {"name": r"layers\.\d+\.mlp.*"},
             "assign": {"quant": "mxfp4"}},
            {"match": {"name": ".*"}, "assign": {"quant": "int8"}},
        ]
        from ktransformers_tpu.placement.spec import PlacementSpec as JSpec

        t_pl, j_pl = PlacementSpec.from_dict(entries), JSpec.from_dict(entries)
    else:
        t_pl = library.load_placement(rules)
        j_pl = j_library.load_placement(rules)
    spec = spec_from_hf_config(cfg)
    port = build_params(TorchModelProvider(model), spec, placement=t_pl,
                        device="cpu")
    ref = j_build_params(JTorchModelProvider(model), j_spec(cfg),
                         placement=j_pl)
    _assert_same_tree(port, params_from_jax(jax.device_get(ref), spec, "cpu"))


# -- packed checkpoints --------------------------------------------------------

KINDS = [("int8", "int4_g"), ("int4_gz", "int8_g"), ("bf16", "mxfp4")]


def _jax_leaves(tree):
    return {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("quant,moe_quant", KINDS)
def test_checkpoint_jax_to_port(tmp_path, quant, moe_quant):
    jtree = j_init_params(j_spec(dict(TINY_DS)), seed=0, quant=quant,
                          moe_quant=moe_quant, group_size=16)
    j_checkpoint.save_params(jtree, str(tmp_path))
    spec = spec_from_hf_config(dict(TINY_DS))
    _assert_same_tree(checkpoint.load_params(str(tmp_path), device="cpu"),
                      params_from_jax(jax.device_get(jtree), spec, "cpu"))


@pytest.mark.parametrize("quant,moe_quant", KINDS)
def test_checkpoint_port_to_jax(tmp_path, quant, moe_quant):
    jtree = j_init_params(j_spec(dict(TINY_DS)), seed=1, quant=quant,
                          moe_quant=moe_quant, group_size=16)
    spec = spec_from_hf_config(dict(TINY_DS))
    checkpoint.save_params(params_from_jax(jax.device_get(jtree), spec,
                                           "cpu"), str(tmp_path))
    got = _jax_leaves(j_checkpoint.load_params(str(tmp_path)))
    want = _jax_leaves(jtree)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype and np.array_equal(
            got[k].view(np.uint8), v.view(np.uint8)), k
    prepared = prepare_params(checkpoint.load_params(str(tmp_path), spec,
                                                     "cpu"), spec)
    if moe_quant.startswith("int4"):
        with pytest.raises(ValueError, match="prepared"):
            checkpoint.save_params(prepared, str(tmp_path / "again"))


def test_stream_convert_resume_across_packages(tmp_path):
    """stream_convert interrupted after layer 0 resumes with the rest; the
    result equals build_params, and the JAX package's stream_load reads it
    as its own build_params."""
    model, cfg = _tiny_ds_model(layers=3)
    prov = TorchModelProvider(model)
    spec = spec_from_hf_config(cfg)
    out = str(tmp_path / "packed")

    class Stop(Exception):
        pass

    def interrupt(msg):
        if msg.startswith("layer 1/"):
            raise Stop

    with pytest.raises(Stop):
        checkpoint.stream_convert(prov, spec, out, quant="int8",
                                  moe_quant="int4_g", progress=interrupt)
    assert {"head", "layer_0000"} <= set(os.listdir(out))
    resumed = []
    checkpoint.stream_convert(prov, spec, out, quant="int8",
                              moe_quant="int4_g", progress=resumed.append)
    assert resumed == ["layer 2/3", "layer 3/3"]
    ref = build_params(prov, spec, quant="int8", moe_quant="int4_g",
                       device="cpu")
    _assert_same_tree(checkpoint.stream_load(out, spec, "cpu"), ref)
    jref = j_build_params(JTorchModelProvider(model), j_spec(cfg),
                          quant="int8", moe_quant="int4_g")
    _assert_same_tree(
        params_from_jax(jax.device_get(j_checkpoint.stream_load(out)), spec,
                        "cpu"), ref)
    _assert_same_tree(params_from_jax(jax.device_get(jref), spec, "cpu"),
                      ref)


# -- CLI ----------------------------------------------------------------------


def _jax_cli(args):
    from click.testing import CliRunner

    from ktransformers_tpu.cli.main import cli

    r = CliRunner().invoke(cli, args, catch_exceptions=False)
    assert r.exit_code == 0, r.output
    return r.output


def test_cli_convert_matches_jax(tmp_path, capsys):
    """convert of one HF directory by both CLIs: the same tensors and
    manifest; each package's Generator on its own directory and on the
    other's gives the same greedy tokens."""
    from ktransformers_tpu.engine.generate import (
        GenerateConfig as JGenerateConfig,
    )
    from ktransformers_tpu.engine.generate import Generator as JGenerator
    from ktransformers_tpu.engine.local_chat import (
        load_model as j_load_model,
    )

    hf = _make_hf_dir(tmp_path)
    out_t, out_j = str(tmp_path / "port"), str(tmp_path / "jax")
    assert main(["convert", hf, out_t, "--quant", "int8", "--moe-quant",
                 "int4_g"]) == 0
    assert "packed params written" in capsys.readouterr().out
    _jax_cli(["convert", hf, out_j, "--quant", "int8", "--moe-quant",
              "int4_g"])
    for name in ("manifest.json", "config.json"):
        with open(os.path.join(out_t, name)) as a, \
                open(os.path.join(out_j, name)) as b:
            assert json.load(a) == json.load(b), name
    ft = SafetensorsFile(os.path.join(out_t, "params.safetensors"))
    fj = SafetensorsFile(os.path.join(out_j, "params.safetensors"))
    assert sorted(ft.keys()) == sorted(fj.keys())
    for k in ft.keys():
        assert torch.equal(bits(ft.get(k)), bits(fj.get(k))), k
    prompt = list(range(2, 12))
    toks = []
    for d in (out_t, out_j):
        spec, params = load_model(d, device="cpu")
        gen = Generator(params, spec, max_len=64, device="cpu",
                        cache_dtype=torch.float32,
                        compute_dtype=torch.float32)
        toks.append(gen.generate([prompt],
                                 GenerateConfig(max_new_tokens=6))[0])
        jspec, jparams = j_load_model(d)
        jgen = JGenerator(jparams, jspec, max_len=64, batch=1,
                          cache_dtype=jnp.float32, compute_dtype=jnp.float32)
        toks.append(jgen.generate([prompt],
                                  JGenerateConfig(max_new_tokens=6))[0])
    assert all(t == toks[0] for t in toks) and len(toks[0]) == 6


def test_cli_stream_convert_and_quant(tmp_path, capsys):
    hf = _make_hf_dir(tmp_path)
    out_s, out_q = str(tmp_path / "stream"), str(tmp_path / "q")
    assert main(["convert", hf, out_s, "--stream"]) == 0
    assert main(["quant", hf, out_q]) == 0
    report = capsys.readouterr().out
    kinds = json.loads(report[report.index("{"):])["kinds"]
    assert set(kinds) >= {"int8", "int4_g", "float32"}
    _, a = load_model(out_s, device="cpu")
    _, b = load_model(out_q, device="cpu")
    _assert_same_tree(a, b)


def test_cli_doctor_models_placements(capsys):
    assert main(["doctor", "--device", "cpu"]) == 0
    info = json.loads(capsys.readouterr().out)
    assert info["matmul_smoke"] == "ok" and info["device"] == "cpu"
    assert info["kernel_smoke"]["kernel"] == "quant_matmul"
    assert info["optional_packages"]["safetensors"]  # installed here
    assert main(["models", "list"]) == 0
    out = capsys.readouterr().out
    assert "deepseek-v2-lite" in out and "H100s" in out
    assert main(["models", "show", "deepseek-v2-lite"]) == 0
    assert json.loads(capsys.readouterr().out)["layers"] == 27
    assert main(["models", "show", "no-such-model"]) == 1
    assert "unknown model" in capsys.readouterr().err
    assert main(["placements"]) == 0
    assert capsys.readouterr().out.split() == library.available_placements()
    assert main(["placements", "mixtral-8x7b"]) == 0
    with open(os.path.join(library.RULES_DIR, "mixtral-8x7b.json")) as f:
        assert json.loads(capsys.readouterr().out) == json.load(f)
    assert main(["placements", "nope"]) == 1


def test_cli_tune_plans_with_h100_figures(tmp_path, capsys):
    sc = str(tmp_path / "server.json")
    assert main(["tune", "--device", "cpu", "--model", "deepseek-v2-lite",
                 "--emit-server-config", sc]) == 0
    text = capsys.readouterr().out
    plan = json.loads(text)
    assert "v5e" not in text.lower() and "819" not in text
    assert "3.35 TB/s" in plan["figures"] and "H100" in plan["card"]
    assert plan["mode"] == "resident"
    from ktransformers_tpu_torch.serving.config import ServerConfig

    assert ServerConfig.from_file(sc).num_pages == plan["serve"]["num_pages"]
    assert main(["tune", "--device", "cpu", "--model", "deepseek-v3"]) == 0
    assert "offload" in json.loads(capsys.readouterr().out)["mode"]


def test_cli_refusals(tmp_path, monkeypatch, capsys):
    with pytest.raises(NotImplementedError, match="item 2"):
        main(["bench"])
    hf = _make_hf_dir(tmp_path)
    import io

    # "user: AB" holds codepoints past the tiny vocabulary of 96
    monkeypatch.setattr("sys.stdin", io.StringIO("AB\n"))
    assert main(["chat", hf, "--device", "cpu", "--max-len", "64"]) == 1
    assert "vocabulary of 96" in capsys.readouterr().err
    # a draft model is taken (tests/test_torch_speculative.py runs it); a
    # sparse kind that does not exist is refused when the config is made
    cfg = tmp_path / "server.json"
    cfg.write_text(json.dumps({"sparse_budget": 4, "sparse_anchor": "x"}))
    with pytest.raises(ValueError, match="sparse_anchor"):
        main(["serve", hf, "--config-file", str(cfg), "--device", "cpu"])
    assert main(["serve", "--device", "cpu"]) == 1


def test_cli_serve_builds_the_engine(tmp_path, monkeypatch):
    """serve hands server.serve the engine it built: the
    HostOffloadServeEngine with --offload, the ServeEngine without; no
    server is started here."""
    from ktransformers_tpu_torch.offload.paged_engine import (
        HostOffloadServeEngine,
    )
    from ktransformers_tpu_torch.serving import server
    from ktransformers_tpu_torch.serving.engine import ServeEngine

    hf = _make_hf_dir(tmp_path)
    packed = str(tmp_path / "packed")
    assert main(["convert", hf, packed]) == 0
    seen = []
    monkeypatch.setattr(server, "serve",
                        lambda engine, tok, **kw: seen.append((engine, kw)))
    assert main(["serve", packed, "--offload", "--device", "cpu",
                 "--port", "0", "--num-pages", "64", "--api-key", "k"]) == 0
    assert main(["serve", packed, "--device", "cpu", "--no-web",
                 "--max-batch-size", "3", "--num-pages", "64"]) == 0
    (off, kw_off), (dev, kw_dev) = seen
    assert type(off) is HostOffloadServeEngine
    assert off.decode_pipeline_depth == 1 and off._thread is None
    assert kw_off["port"] == 0 and kw_off["api_key"] == "k"
    assert type(dev) is ServeEngine and dev.cfg.max_batch_size == 3
    assert kw_dev["mount_web"] is False and dev._thread is None


# -- perplexity -----------------------------------------------------------------


def test_perplexity_matches_jax(capsys, tmp_path):
    from ktransformers_tpu.utils.eval import perplexity as j_perplexity

    from ktransformers_tpu_torch.utils.eval import perplexity

    model, cfg = _tiny_ds_model()
    spec = spec_from_hf_config(cfg)
    ids = [int(x) for x in np.random.default_rng(4).integers(0, 96, 24)]
    port = build_params(TorchModelProvider(model), spec, quant="f32",
                        device="cpu")
    jref = j_build_params(JTorchModelProvider(model), j_spec(cfg),
                          quant="f32")
    t = perplexity(port, spec, ids, chunk=5, compute_dtype=torch.float32,
                   device="cpu")
    j = j_perplexity(jref, j_spec(cfg), ids, chunk=5,
                     compute_dtype=jnp.float32)
    assert abs(t - j) <= 1e-4 * j, (t, j)
    hf = _make_hf_dir(tmp_path)
    text = tmp_path / "text.txt"
    text.write_text("ABC DEF 0123 GHI JKL")
    assert main(["eval-ppl", hf, str(text), "--device", "cpu", "--quant",
                 "int8", "--chunk", "8"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["tokens"] == 20 and out["perplexity"] > 1
