"""The port's GGUF reader, writer, decoders and spec translation against the
JAX package's (ktransformers_tpu/loader/gguf.py, gguf_writer.py, native.py,
models/spec.py:spec_from_gguf_fields).

Bit-exact throughout: the container's fields, tensor infos and bytes; each
decoder on the scalar packers of tests/test_gguf.py (and on random blocks
for the types those have no packer for); the native decoders (the port's
own csrc/ggml_decode.cpp, built with g++) against the numpy ones; the
ModelSpec of each architecture the port translates; GGUFProvider.get of
every tensor name."""

import dataclasses

import numpy as np
import pytest

from ktransformers_tpu_torch.loader import gguf as tg
from ktransformers_tpu_torch.loader import native as tnative
from ktransformers_tpu_torch.loader.gguf_writer import random_blocks
from ktransformers_tpu_torch.loader.gguf_writer import write_gguf as t_write
from tests.test_gguf import (
    pack_q2_k,
    pack_q3_k,
    pack_q4_0,
    pack_q4_k,
    pack_q5_k,
    pack_q6_k,
    pack_q8_0,
)

PACKED = [
    ("Q8_0", lambda rng: pack_q8_0(rng.standard_normal(256).astype(
        np.float32))),
    ("Q4_0", lambda rng: pack_q4_0(rng.standard_normal(256).astype(
        np.float32))),
    ("Q2_K", lambda rng: pack_q2_k(rng, 4)[0]),
    ("Q3_K", lambda rng: pack_q3_k(rng, 4)[0]),
    ("Q4_K", lambda rng: pack_q4_k(rng, 4)[0]),
    ("Q5_K", lambda rng: pack_q5_k(rng, 4)[0]),
    ("Q6_K", lambda rng: pack_q6_k(rng, 4)[0]),
]
# block bytes of the types the packers of tests/test_gguf.py do not make
RANDOM = {"Q4_1": 20, "Q5_0": 22, "Q5_1": 24}


def _jgguf():
    from ktransformers_tpu.loader import gguf as jg

    return jg


@pytest.mark.parametrize("tname, maker", PACKED)
def test_decoders_bit_exact(rng, tname, maker):
    jg = _jgguf()
    raw = np.asarray(maker(rng), np.uint8)
    t = tg.decode_ggml(raw, tg.GGML_NAMES[tname], use_native=False)
    j = jg.decode_ggml(raw, jg.GGML_NAMES[tname], use_native=False)
    np.testing.assert_array_equal(t, j)


@pytest.mark.parametrize("tname", sorted(RANDOM))
def test_decoders_bit_exact_on_random_blocks(rng, tname):
    """Q4_1, Q5_0, Q5_1 on random bytes with finite f16 scales."""
    jg = _jgguf()
    b = rng.integers(0, 256, (8, RANDOM[tname]), dtype=np.uint8)
    for lo in (0, 2) if tname != "Q5_0" else (0,):
        b[:, lo:lo + 2] = np.frombuffer(np.float16(
            rng.uniform(0.01, 0.1)).tobytes(), np.uint8)
    raw = b.reshape(-1)
    t = tg.decode_ggml(raw, tg.GGML_NAMES[tname])
    np.testing.assert_array_equal(t, jg.decode_ggml(raw,
                                                    jg.GGML_NAMES[tname]))
    assert np.isfinite(t).all()


def test_f16_bf16_and_type_tables(rng):
    jg = _jgguf()
    assert tg.GGML_TYPES == jg.GGML_TYPES and tg.GGML_NAMES == jg.GGML_NAMES
    for name in ("F16", "BF16", "F32"):
        raw = rng.integers(0, 256, 64, dtype=np.uint8)
        if name != "F32":
            raw[1::2] &= 0x3F  # finite
        else:
            raw[3::4] &= 0x3F
        np.testing.assert_array_equal(
            tg.decode_ggml(raw, tg.GGML_NAMES[name]),
            jg.decode_ggml(raw, jg.GGML_NAMES[name]))


@pytest.mark.parametrize("tname, maker", PACKED)
def test_native_matches_numpy(rng, tname, maker):
    """The port's native decoders (its own csrc/ggml_decode.cpp, built with
    g++ at first use) against its numpy ones."""
    if not tnative.available():
        pytest.skip("g++ unavailable")
    raw = np.asarray(maker(rng), np.uint8)
    ref = tg._DECODERS[tname](raw)
    np.testing.assert_allclose(tnative.decode(raw, tname), ref, rtol=1e-6,
                               atol=1e-6)


def test_native_pack_int4_matches_numpy_quantize(rng):
    """pack_int4_group_split keeps the JAX module's contract: the int4_g
    codes and scales of the port's quantize."""
    import torch

    from ktransformers_tpu_torch.quant.formats import quantize

    if not tnative.available():
        pytest.skip("g++ unavailable")
    w = rng.standard_normal((256, 64)).astype(np.float32) * 0.1
    packed, scales = tnative.pack_int4_group_split(w, 128)
    qt = quantize(torch.from_numpy(w), "int4_g", group_size=128)
    np.testing.assert_allclose(scales, qt.scales.numpy(), rtol=1e-5,
                               atol=1e-8)
    np.testing.assert_array_equal(packed, qt.data.numpy())


def _tensors(rng):
    return {
        "a.f32": rng.standard_normal((8, 64)).astype(np.float32),
        "b.f16": rng.standard_normal((3, 5, 32)).astype(np.float16),
        "c.q4k": random_blocks(rng, "Q4_K", (4, 512), 0.05),
        "d.q6k": random_blocks(rng, "Q6_K", (2, 3, 256), 0.05),
        "e.q8": (pack_q8_0(rng.standard_normal(64).astype(np.float32)),
                 "Q8_0", (2, 32)),
    }


METADATA = {
    "general.architecture": "deepseek2", "deepseek2.block_count": 27,
    "deepseek2.rope.freq_base": 10000.0, "general.name": "tiny",
    "tokenizer.ggml.tokens": ["<s>", "</s>", "a"],
    "deepseek2.list.ints": [1, 2, 3], "deepseek2.list.floats": [0.5, 1.5],
    "deepseek2.flag": True,
}


def test_container_round_trip(tmp_path, rng):
    """The port's writer writes the JAX writer's bytes; both readers read
    them back to the same fields, infos and tensors."""
    from ktransformers_tpu.loader.gguf_writer import write_gguf as j_write

    jg = _jgguf()
    tensors = _tensors(rng)
    t_write(str(tmp_path / "t.gguf"), METADATA, tensors)
    j_write(str(tmp_path / "j.gguf"), METADATA, tensors)
    assert (tmp_path / "t.gguf").read_bytes() == \
        (tmp_path / "j.gguf").read_bytes()
    tf, jf = tg.GGUFFile(str(tmp_path / "t.gguf")), jg.GGUFFile(
        str(tmp_path / "j.gguf"))
    assert tf.fields == jf.fields and tf.architecture == "deepseek2"
    assert tf.fields["tokenizer.ggml.tokens"] == ["<s>", "</s>", "a"]
    for name, info in tf.tensors.items():
        assert dataclasses.asdict(info) == dataclasses.asdict(
            jf.tensors[name])
        np.testing.assert_array_equal(tf.raw(name), jf.raw(name))
        np.testing.assert_array_equal(tf.load(name), jf.load(name))
    np.testing.assert_array_equal(tf.load("a.f32"), tensors["a.f32"])
    np.testing.assert_array_equal(tf.load("b.f16"),
                                  tensors["b.f16"].astype(np.float32))
    assert tf.tensors["c.q4k"].shape == (4, 512)
    tf.close()
    jf.close()
    d = tg.GGUFDir(str(tmp_path))
    assert sorted(d.tensors()) == sorted(tensors) and len(d.files) == 2


def _fields(arch: str, **extra):
    f = {
        "general.architecture": arch, f"{arch}.block_count": 27,
        f"{arch}.embedding_length": 2048,
        f"{arch}.feed_forward_length": 10944,
        f"{arch}.attention.head_count": 16,
        f"{arch}.attention.head_count_kv": 16,
        f"{arch}.attention.layer_norm_rms_epsilon": 1e-6,
        f"{arch}.rope.freq_base": 10000.0, f"{arch}.context_length": 163840,
        f"{arch}.vocab_size": 102400, f"{arch}.expert_count": 64,
        f"{arch}.expert_used_count": 6,
        f"{arch}.expert_feed_forward_length": 1408,
        f"{arch}.expert_shared_count": 2,
        f"{arch}.expert_weights_scale": 1.0,
        f"{arch}.leading_dense_block_count": 1,
        f"{arch}.attention.kv_lora_rank": 512,
        f"{arch}.attention.q_lora_rank": 0,
        f"{arch}.rope.dimension_count": 64,
        f"{arch}.attention.key_length": 192,
        f"{arch}.attention.value_length": 128,
    }
    f.update({f"{arch}.{k}": v for k, v in extra.items()})
    return f


V3_EXTRA = {"attention.q_lora_rank": 1536, "expert_count": 256,
            "expert_used_count": 8, "expert_shared_count": 1,
            "expert_feed_forward_length": 2048, "expert_weights_scale": 2.5,
            "expert_weights_norm": True, "expert_gating_func": 2,
            "leading_dense_block_count": 3, "rope.scaling.type": "yarn",
            "rope.scaling.factor": 40.0,
            "rope.scaling.original_context_length": 4096}


@pytest.mark.parametrize("arch, extra", [
    ("deepseek2", {}),                    # DeepSeek-V2-Lite
    ("deepseek2", {"expert_shared_feed_forward_length": 2816}),
    ("deepseek3", V3_EXTRA),
])
def test_spec_from_gguf_fields_matches_jax(arch, extra):
    """Field by field the JAX package's spec, but V3's softmax_scale (the
    port follows HF's m_all^2 rule there: tests/test_torch_deepseek_v3.py);
    that one the port's HF translator sets on both paths."""
    from ktransformers_tpu.models.spec import spec_from_gguf_fields as jspec

    from ktransformers_tpu_torch.models.spec import spec_from_gguf_fields

    fields = _fields(arch, **extra)
    t, j = spec_from_gguf_fields(fields), jspec(fields)
    skip = {"attention.softmax_scale"} if arch == "deepseek3" else set()
    _same_fields(t, j, "", skip)
    if skip:
        assert j.attention.softmax_scale is None
    assert t.moe.shared_expert_intermediate_size == 2816 or \
        arch == "deepseek3"


def _same_fields(t, j, path, skip):
    """Every field of the port's spec dataclass t (recursively) equals the
    JAX spec's attribute of that name (the JAX specs carry more fields,
    of families the port does not run)."""
    for f in dataclasses.fields(t):
        name = path + f.name
        if name in skip:
            continue
        tv, jv = getattr(t, f.name), getattr(j, f.name)
        if dataclasses.is_dataclass(tv):
            _same_fields(tv, jv, name + ".", skip)
        else:
            assert tv == jv, name


@pytest.mark.parametrize("arch", ["llama", "qwen2moe", "qwen3moe", "qwen2",
                                  "qwen3", "glm4moe"])
def test_spec_from_gguf_fields_names_what_is_missing(arch):
    """GGUF files of the dense and GLM architectures (llama, qwen2, qwen3,
    glm4moe), whose HF translators the port has, raise naming ROADMAP item
    5b (llama.cpp permutes a llama file's attn_q / attn_k rows, which
    neither package undoes); qwen2moe and qwen3moe, ported, give the JAX
    package's spec field by field; an unknown one asks for a config."""
    from ktransformers_tpu.models.spec import spec_from_gguf_fields as jspec

    from ktransformers_tpu_torch.models.spec import spec_from_gguf_fields

    if arch in ("qwen2moe", "qwen3moe"):
        t = spec_from_gguf_fields(_fields(arch))
        _same_fields(t, jspec(_fields(arch)), "", set())
        assert t.model_type == {"qwen2moe": "qwen2_moe",
                                "qwen3moe": "qwen3_moe"}[arch]
    else:
        with pytest.raises(NotImplementedError, match="item 5b"):
            spec_from_gguf_fields(_fields(arch))
    with pytest.raises(ValueError, match="provide --config"):
        spec_from_gguf_fields({"general.architecture": "mamba"})


def test_provider_get_matches_jax(tmp_path, rng):
    """GGUFProvider.get over HF names (a dense and an MoE layer, stacked
    experts, the tied lm_head) equals the JAX provider's."""
    from ktransformers_tpu.loader.providers import GGUFProvider as JP

    from ktransformers_tpu_torch.loader.providers import GGUFProvider

    tensors = {
        "token_embd.weight": rng.standard_normal((96, 256)).astype(
            np.float16),
        "output_norm.weight": np.ones(256, np.float32),
        "blk.0.attn_norm.weight": rng.standard_normal(256).astype(
            np.float32),
        "blk.0.ffn_gate.weight": random_blocks(rng, "Q4_K", (64, 256), .05),
        "blk.0.ffn_up.weight": random_blocks(rng, "Q4_K", (64, 256), .05),
        "blk.0.attn_kv_b.weight": random_blocks(rng, "Q6_K", (32, 256), .05),
        "blk.1.ffn_gate_exps.weight": random_blocks(rng, "Q4_K",
                                                    (4, 32, 256), .05),
        "blk.1.ffn_up_exps.weight": random_blocks(rng, "Q4_K", (4, 32, 256),
                                                  .05),
        "blk.1.ffn_down_exps.weight": random_blocks(rng, "Q6_K",
                                                    (4, 256, 256), .05),
        "blk.1.ffn_gate_inp.weight": rng.standard_normal((4, 256)).astype(
            np.float32),
    }
    t_write(str(tmp_path / "m.gguf"), {"general.architecture": "deepseek2"},
            tensors)
    tp, jp = GGUFProvider(str(tmp_path / "m.gguf")), JP(
        str(tmp_path / "m.gguf"))
    assert tp.fields() == jp.fields()
    for name in ("model.embed_tokens.weight", "model.norm.weight",
                 "lm_head.weight", "model.layers.0.input_layernorm.weight",
                 "model.layers.0.mlp.gate_proj.weight",
                 "model.layers.0.self_attn.kv_b_proj.weight",
                 "model.layers.1.mlp.experts.gate_up_proj",
                 "model.layers.1.mlp.experts.down_proj",
                 "model.layers.1.mlp.gate.weight"):
        np.testing.assert_array_equal(tp.get(name), jp.get(name))
    for name in ("model.layers.0.mlp.down_proj.weight", "nothing"):
        with pytest.raises(KeyError):
            tp.get(name)
        assert tp.maybe(name) is None


def _qwen_gguf(path: str, arch: str, rng) -> None:
    """A 2-layer Qwen2-MoE / Qwen3-MoE GGUF file at widths the k-quants
    take (hidden 256, 4 query heads of 64 over 2 KV heads, 4 experts top-2
    of inter 256, a shared expert of 256): Q4_K matmuls and lm_head, F32
    norms, router, Qwen2's q / k / v biases and shared-expert gate (one
    row of hidden values, as llama.cpp writes it), Qwen3's q / k norms,
    F16 embedding."""
    from ktransformers_tpu_torch.loader.gguf_writer import (
        random_blocks,
        write_gguf,
    )

    d, hd, h, hkv, e, f = 256, 64, 4, 2, 4, 256

    def q4k(*shape):
        return random_blocks(rng, "Q4_K", shape, shape[-1] ** -0.5)

    def vec(n, scale=0.1, base=0.0):
        return (base + scale * rng.standard_normal(n)).astype(np.float32)

    fields = {"general.architecture": arch, f"{arch}.block_count": 2,
              f"{arch}.embedding_length": d,
              f"{arch}.feed_forward_length": 512,
              f"{arch}.attention.head_count": h,
              f"{arch}.attention.head_count_kv": hkv,
              f"{arch}.attention.layer_norm_rms_epsilon": 1e-6,
              f"{arch}.rope.freq_base": 1e6, f"{arch}.context_length": 256,
              f"{arch}.vocab_size": 64, f"{arch}.expert_count": e,
              f"{arch}.expert_used_count": 2,
              f"{arch}.expert_feed_forward_length": f,
              f"{arch}.rope.dimension_count": hd,
              f"{arch}.attention.key_length": hd}
    if arch == "qwen2moe":
        fields[f"{arch}.expert_shared_feed_forward_length"] = f
    t = {"token_embd.weight": rng.standard_normal((64, d)).astype(
             np.float16),
         "output_norm.weight": vec(d, base=1.0), "output.weight": q4k(64, d)}
    for li in range(2):
        b = f"blk.{li}."
        t.update({
            b + "attn_norm.weight": vec(d, base=1.0),
            b + "ffn_norm.weight": vec(d, base=1.0),
            b + "attn_q.weight": q4k(h * hd, d),
            b + "attn_k.weight": q4k(hkv * hd, d),
            b + "attn_v.weight": q4k(hkv * hd, d),
            b + "attn_output.weight": q4k(d, h * hd),
            b + "ffn_gate_inp.weight": vec((e, d), d ** -0.5),
            b + "ffn_gate_exps.weight": q4k(e, f, d),
            b + "ffn_up_exps.weight": q4k(e, f, d),
            b + "ffn_down_exps.weight": q4k(e, d, f),
        })
        if arch == "qwen2moe":
            t.update({b + "attn_q.bias": vec(h * hd),
                      b + "attn_k.bias": vec(hkv * hd),
                      b + "attn_v.bias": vec(hkv * hd),
                      b + "ffn_gate_shexp.weight": q4k(f, d),
                      b + "ffn_up_shexp.weight": q4k(f, d),
                      b + "ffn_down_shexp.weight": q4k(d, f),
                      b + "ffn_gate_inp_shexp.weight": vec(d, d ** -0.5)})
        else:
            t.update({b + "attn_q_norm.weight": vec(hd, base=1.0),
                      b + "attn_k_norm.weight": vec(hd, base=1.0)})
    write_gguf(path, fields, t)


@pytest.mark.parametrize("arch", ["qwen2moe", "qwen3moe"])
def test_qwen_gguf_exact_build_matches_jax(tmp_path, rng, arch):
    """A Qwen GGUF file through both packages' GGUFProvider +
    build_params(exact_gguf=True): the spec field by field, every tensor
    the same bits (Q4_K -> int4_gz group 32; biases, norms, router as
    F32), but the shared-expert gate, which the port holds as HF's [1,
    hidden] where the JAX package keeps the file's one row; the port's
    W4A8 forward then runs (the JAX package's would broadcast that row
    against the shared expert's output)."""
    import jax
    import torch

    from ktransformers_tpu.loader.providers import GGUFProvider as JP
    from ktransformers_tpu.models.loading import build_params as jbuild
    from ktransformers_tpu.models.spec import spec_from_gguf_fields as jspec

    from tests.test_torch_hf_import import _assert_same_tree

    from ktransformers_tpu_torch.convert import params_from_jax
    from ktransformers_tpu_torch.engine.generate import (
        GenerateConfig,
        Generator,
    )
    from ktransformers_tpu_torch.loader.providers import GGUFProvider
    from ktransformers_tpu_torch.models.loading import build_params
    from ktransformers_tpu_torch.models.spec import spec_from_gguf_fields
    from ktransformers_tpu_torch.utils.device_prep import prepare_params

    path = str(tmp_path / f"{arch}.gguf")
    _qwen_gguf(path, arch, rng)
    prov = GGUFProvider(path)
    spec = spec_from_gguf_fields(prov.fields())
    params = build_params(prov, spec, quant="int8", exact_gguf=True,
                          device="cpu")
    jp = JP(path)
    js = jspec(jp.fields())
    _same_fields(spec, js, "", set())
    ref = params_from_jax(jax.device_get(
        jbuild(jp, js, quant="int8", exact_gguf=True)), spec, "cpu")
    if arch == "qwen2moe":
        for lp, jlp in zip(params["layers"], ref["layers"]):
            gate, jgate = lp["moe"]["shared_gate"], jlp["moe"].pop(
                "shared_gate")
            assert gate.shape == (1, 256) and jgate.shape == (256,)
            assert torch.equal(gate[0], jgate)
            jlp["moe"]["shared_gate"] = gate
        assert {"q_bias", "k_bias", "v_bias"} <= set(params["layers"][0]
                                                     ["attn"])
    else:
        assert params["layers"][0]["attn"]["q_norm"].shape == (64,)
    _assert_same_tree(params, ref)
    assert params["layers"][0]["attn"]["q_proj"].kind == "int4_gz"
    prepare_params(params, spec)
    gen = Generator(params, spec, max_len=32, device="cpu",
                    cache_dtype=torch.float32, compute_dtype=torch.float32)
    out = gen.generate([[1, 5, 9, 2, 7]], GenerateConfig(max_new_tokens=3))
    assert len(out[0]) == 3 and all(0 <= t < 64 for t in out[0])
