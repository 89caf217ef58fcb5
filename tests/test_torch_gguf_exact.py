"""GGUF checkpoints into the port: the lossless repack, a tiny DeepSeek-V2
GGUF file through both packages' build_params(exact_gguf=True) and forward,
and an HF DeepSeek-V2 exported to GGUF against HF's logits.

- repack_ggml_exact: port = JAX package bit-exact for every ggml type it
  takes (codes, block scales, zero points, group, kind);
- a 2-layer DeepSeek-V2 (layer 0 dense, layer 1 MoE) written with the
  port's write_gguf: every matmul weight in Q4_K (int4_gz, group 32), the
  routed experts' down in Q6_K (int8_g, group 16: no W4A8 kernel in either
  package, the plain products), the embedding in F16, norms and router in
  F32; both packages build it with exact_gguf=True to the same tensors,
  prepare it with W4A8 on, and run prefill + decode steps: each step within
  LOGIT_TOL, greedy tokens equal except at a near-tie, under the routing
  rule of tests/test_torch_deepseek_v3.py (a step past LOGIT_TOL must
  follow a token the port sent to other experts);
- the HF model of tests/test_loaders.py exported by its _export_gguf (F32
  tensors), built by the port with quant="f32": logits within 2e-3 of HF's
  (test_gguf_roundtrip_logits's bound for the JAX package).
"""

import copy
import dataclasses

import numpy as np
import pytest
import torch

from ktransformers_tpu_torch.loader.gguf_writer import random_blocks
from ktransformers_tpu_torch.loader.gguf_writer import write_gguf
from ktransformers_tpu_torch.loader.providers import GGUFProvider
from ktransformers_tpu_torch.models import model as tmodel
from ktransformers_tpu_torch.models.loading import build_params
from ktransformers_tpu_torch.models.spec import spec_from_gguf_fields
from ktransformers_tpu_torch.quant.gguf_repack import EXTRACTORS
from ktransformers_tpu_torch.quant.gguf_repack import repack_ggml_exact
from ktransformers_tpu_torch.utils.device_prep import prepare_params
from tests.test_gguf import (
    pack_q2_k,
    pack_q3_k,
    pack_q4_0,
    pack_q4_k,
    pack_q5_k,
    pack_q6_k,
    pack_q8_0,
)
from tests.test_torch_model import LOGIT_TOL, jax_interpret_hooks
from tests.test_torch_model import one_torch_thread  # noqa: F401

NEAR_TIE = 5e-2
BLOCK_BYTES = {"Q4_1": (20, 32), "Q5_0": (22, 32), "Q5_1": (24, 32)}


def _blocks(rng, tname, n_blocks):
    """Raw blocks of one ggml type: the packers of tests/test_gguf.py, or
    random bytes with finite f16 scales for those they do not make."""
    k_quants = {"Q2_K": pack_q2_k, "Q3_K": pack_q3_k, "Q4_K": pack_q4_k,
                "Q5_K": pack_q5_k, "Q6_K": pack_q6_k}
    if tname in k_quants:
        return np.asarray(k_quants[tname](rng, n_blocks)[0], np.uint8)
    if tname in ("Q8_0", "Q4_0"):
        pack = pack_q8_0 if tname == "Q8_0" else pack_q4_0
        return np.asarray(pack(rng.standard_normal(32 * n_blocks).astype(
            np.float32)), np.uint8)
    nbytes, _ = BLOCK_BYTES[tname]
    b = rng.integers(0, 256, (n_blocks, nbytes), dtype=np.uint8)
    for lo in (0, 2) if tname != "Q5_0" else (0,):
        b[:, lo:lo + 2] = np.frombuffer(np.float16(0.05).tobytes(), np.uint8)
    return b.reshape(-1)


@pytest.mark.parametrize("tname", sorted(EXTRACTORS))
@pytest.mark.parametrize("shape", [(4, 256), (2, 2, 512)])
def test_repack_bit_exact(rng, tname, shape):
    """The port's repack of every ggml type equals the JAX package's: the
    same codes, scales, zero points, kind and group."""
    import jax

    from ktransformers_tpu.quant.gguf_repack import repack_ggml_exact as jr

    from ktransformers_tpu_torch.convert import qtensor_from_jax

    per = 256 if tname.endswith("_K") else 32
    raw = _blocks(rng, tname, int(np.prod(shape)) // per)
    t = repack_ggml_exact(raw, tname, shape)
    j = qtensor_from_jax(jax.device_get(jr(raw, tname, shape)), "cpu")
    assert (t.kind, t.group_size) == (j.kind, j.group_size)
    assert t.data.dtype == j.data.dtype and torch.equal(t.data, j.data)
    assert torch.equal(t.scales, j.scales)
    assert (t.zeros is None) == (j.zeros is None)
    if t.zeros is not None:
        assert torch.equal(t.zeros, j.zeros)
    assert t.in_features == shape[-1] and t.out_features == shape[-2]


# ------------------------------------------------ a tiny DeepSeek-V2 GGUF

ARCH = "deepseek2"
V2 = dict(vocab=512, hidden=256, inter=256, moe_inter=256, heads=2,
          kv_lora=256, rope=32, nope=64, v=128, experts=8, top_k=2)
FIELDS = {
    "general.architecture": ARCH, f"{ARCH}.block_count": 2,
    f"{ARCH}.embedding_length": V2["hidden"],
    f"{ARCH}.feed_forward_length": V2["inter"],
    f"{ARCH}.attention.head_count": V2["heads"],
    f"{ARCH}.attention.head_count_kv": V2["heads"],
    f"{ARCH}.attention.layer_norm_rms_epsilon": 1e-6,
    f"{ARCH}.rope.freq_base": 10000.0, f"{ARCH}.context_length": 256,
    f"{ARCH}.vocab_size": V2["vocab"], f"{ARCH}.expert_count": V2["experts"],
    f"{ARCH}.expert_used_count": V2["top_k"],
    f"{ARCH}.expert_feed_forward_length": V2["moe_inter"],
    f"{ARCH}.expert_shared_count": 1, f"{ARCH}.expert_weights_scale": 1.0,
    f"{ARCH}.leading_dense_block_count": 1,
    f"{ARCH}.attention.kv_lora_rank": V2["kv_lora"],
    f"{ARCH}.attention.q_lora_rank": 0,
    f"{ARCH}.rope.dimension_count": V2["rope"],
    f"{ARCH}.attention.key_length": V2["nope"] + V2["rope"],
    f"{ARCH}.attention.value_length": V2["v"],
}
PROMPT_LEN, DECODE_STEPS, MAX_LEN = 8, 2, 32


def _write_tiny_v2(path: str, seed: int = 5):
    """The 2-layer model's GGUF file: Q4_K matmuls (blocks of std
    1/sqrt(in)), one Q6_K routed down, F16 embedding (std 1), F32 norms
    (ones) and router (std 1/sqrt(hidden))."""
    rng = np.random.default_rng(seed)
    d, h = V2["hidden"], V2["heads"]

    def q4k(*shape):
        return random_blocks(rng, "Q4_K", shape, shape[-1] ** -0.5)

    def ones(n):
        return np.ones(n, np.float32)

    t = {"token_embd.weight": rng.standard_normal(
             (V2["vocab"], d)).astype(np.float16),
         "output_norm.weight": ones(d), "output.weight": q4k(V2["vocab"], d)}
    for li in range(2):
        b = f"blk.{li}."
        t.update({
            b + "attn_norm.weight": ones(d), b + "ffn_norm.weight": ones(d),
            b + "attn_q.weight": q4k(h * (V2["nope"] + V2["rope"]), d),
            b + "attn_kv_a_mqa.weight": q4k(V2["kv_lora"] + V2["rope"], d),
            b + "attn_kv_a_norm.weight": ones(V2["kv_lora"]),
            b + "attn_kv_b.weight": q4k(h * (V2["nope"] + V2["v"]),
                                        V2["kv_lora"]),
            b + "attn_output.weight": q4k(d, h * V2["v"]),
        })
    t.update({"blk.0.ffn_gate.weight": q4k(V2["inter"], d),
              "blk.0.ffn_up.weight": q4k(V2["inter"], d),
              "blk.0.ffn_down.weight": q4k(d, V2["inter"])})
    e, mi = V2["experts"], V2["moe_inter"]
    t.update({
        "blk.1.ffn_gate_inp.weight": (rng.standard_normal((e, d)) * d ** -0.5
                                      ).astype(np.float32),
        "blk.1.ffn_gate_exps.weight": q4k(e, mi, d),
        "blk.1.ffn_up_exps.weight": q4k(e, mi, d),
        "blk.1.ffn_down_exps.weight": random_blocks(rng, "Q6_K", (e, d, mi),
                                                    mi ** -0.5),
        "blk.1.ffn_gate_shexp.weight": q4k(mi, d),
        "blk.1.ffn_up_shexp.weight": q4k(mi, d),
        "blk.1.ffn_down_shexp.weight": q4k(d, mi),
    })
    write_gguf(path, FIELDS, t)


@pytest.fixture(scope="module")
def tiny_v2(tmp_path_factory):
    """Both packages' exact builds of the tiny file: (port spec, port
    params, JAX spec, JAX params), unprepared."""
    from ktransformers_tpu.loader.providers import GGUFProvider as JP
    from ktransformers_tpu.models.loading import build_params as jbuild
    from ktransformers_tpu.models.spec import spec_from_gguf_fields as jspec

    path = str(tmp_path_factory.mktemp("gguf") / "tiny_v2.gguf")
    _write_tiny_v2(path)
    prov = GGUFProvider(path)
    spec = spec_from_gguf_fields(prov.fields())
    params = build_params(prov, spec, quant="int8", exact_gguf=True,
                          device="cpu")
    jp = JP(path)
    js = jspec(jp.fields())
    jparams = jbuild(jp, js, quant="int8", exact_gguf=True)
    return spec, params, js, jparams


def test_exact_build_matches_jax(tiny_v2):
    """build_params(exact_gguf=True) carries the file's codes over as the
    JAX package does: int4_gz group 32 from Q4_K, int8_g group 16 from
    Q6_K, the same bytes and scales, the dense tensors equal."""
    import jax

    from tests.test_torch_hf_import import _assert_same_tree

    from ktransformers_tpu_torch.convert import params_from_jax

    spec, params, _, jparams = tiny_v2
    _assert_same_tree(params, params_from_jax(jax.device_get(jparams), spec,
                                              "cpu"))
    attn = params["layers"][0]["attn"]
    assert attn["kv_a"].kind == "int4_gz" and attn["kv_a"].group_size == 32
    ex = params["layers"][1]["moe"]["experts"]
    assert ex.gate_up.kind == "int4_gz" and ex.down.kind == "int8_g"
    assert ex.down.group_size == 16
    assert params["layers"][0]["mlp"]["gate_up"].out_features == 2 * V2[
        "inter"]


def _tokens():
    return np.random.default_rng(9).integers(
        0, V2["vocab"], (1, PROMPT_LEN)).astype(np.int32)


def test_forward_w4a8_matches_jax(tiny_v2):
    """Both packages prepare the exact build with W4A8 on (the int4_gz
    weights repacked for the W4A8 kernels: the JAX package's Pallas kernels
    in interpret mode, the port's plain versions) and run a prefill and
    greedy decode steps: each step within LOGIT_TOL, or, past it, after a
    token the port sent to other experts (the routing rule of
    tests/test_torch_deepseek_v3.py); greedy tokens equal except at a
    near-tie of the reference."""
    import jax
    import jax.numpy as jnp

    from ktransformers_tpu.models import model as jmodel
    from ktransformers_tpu.ops.rope import precompute_rope_tables
    from ktransformers_tpu.utils.device_prep import prepare_params as jprep

    from ktransformers_tpu.ops import moe as jmoe
    from ktransformers_tpu.ops.pallas import PALLAS_KINDS

    spec, params, js, jparams = tiny_v2
    params = copy.deepcopy(params)
    tokens = _tokens()

    def gated(fn):  # the expert matmul hooks as ops/pallas.enable() gates
        return lambda x, w, arg: fn(x, w, arg) if w.kind in PALLAS_KINDS \
            else None

    with jax_interpret_hooks() as calls:
        jmoe.set_pallas_gather(gated(jmoe._PALLAS_GATHER))
        jmoe.set_pallas_gmm(gated(jmoe._PALLAS_GMM))
        # prepare_params donates the arrays it repacks: a copy
        jp = jprep(jax.tree.map(lambda v: jnp.array(v, copy=True), jparams),
                   True, js)
        rope = precompute_rope_tables(js.rope)
        jidx, jroute = [], jmodel.route

        def jrec(logits, gate, bias=None):
            idx, w = jroute(logits, gate, bias)
            jidx.append(np.asarray(idx))
            return idx, w

        jmodel.route = jrec
        try:
            cache = jmodel.KVCache.create(js, 1, MAX_LEN, dtype=jnp.float32)
            ref, ref_toks = [], []
            tok = jnp.asarray(tokens)
            for _ in range(DECODE_STEPS + 1):
                logits, cache = jmodel.forward(
                    jp, js, tok, cache, rope_tables=rope,
                    compute_dtype=jnp.float32)
                ref.append(np.asarray(logits[:, -1]))
                ref_toks.append(int(np.argmax(ref[-1][0])))
                tok = jnp.asarray([[ref_toks[-1]]], jnp.int32)
        finally:
            jmodel.route = jroute
    assert calls.get("qmatmul", 0) > 0 and calls.get("mla_fused", 0) > 0

    prepare_params(params, spec)
    assert params["layers"][1]["moe"]["experts"].gate_up.act_quant
    tidx, troute = [], tmodel.route

    def trec(logits, gate, bias=None):
        idx, w = troute(logits, gate, bias)
        tidx.append(idx.numpy().copy())
        return idx, w

    tmodel.route = trec
    try:
        cache = tmodel.KVCache.create(spec, 1, MAX_LEN, torch.float32, "cpu")
        out, toks = [], []
        tok = torch.as_tensor(tokens)
        with torch.no_grad():
            for step in range(DECODE_STEPS + 1):
                logits, cache = tmodel.forward(params, spec, tok, cache,
                                               compute_dtype=torch.float32)
                out.append(logits[:, -1].numpy())
                toks.append(int(np.argmax(out[-1][0])))
                # feed the reference's token, so both decode the same text
                tok = torch.tensor([[ref_toks[step]]])
    finally:
        tmodel.route = troute
    assert len(tidx) == len(jidx) == DECODE_STEPS + 1
    rerouted = [any(set(a) != set(b) for a, b in zip(x, y))
                for x, y in zip(tidx, jidx)]
    for step, (a, b) in enumerate(zip(out, ref)):
        err = float(np.abs(a - b).max() / np.abs(b).max())
        if err > LOGIT_TOL:
            assert any(rerouted[:step + 1]), (step, err)
        top2 = np.sort(b[0])[-2:]
        if (top2[1] - top2[0]) / np.abs(b[0]).max() >= NEAR_TIE and \
                not any(rerouted[:step + 1]):
            assert toks[step] == ref_toks[step], step


def test_hf_export_through_gguf_matches_hf(tmp_path):
    """tests/test_loaders.py's HF DeepSeek-V2 exported to GGUF (F32) and
    built by the port with quant="f32": its forward within 2e-3 of HF's
    logits, as test_gguf_roundtrip_logits holds the JAX package."""
    from tests.test_loaders import _export_gguf, _tiny_ds_model

    from ktransformers_tpu_torch.models.spec import spec_from_hf_config

    model, cfg = _tiny_ds_model()
    path = str(tmp_path / "tiny.gguf")
    _export_gguf(model, cfg, path)
    spec = spec_from_hf_config(cfg)
    params = build_params(GGUFProvider(path), spec, quant="f32",
                          device="cpu")
    tokens = np.random.default_rng(3).integers(0, 96, size=(1, 9))
    with torch.no_grad():
        ref = model(torch.from_numpy(tokens)).logits.numpy()
        cache = tmodel.KVCache.create(spec, 1, 16, torch.float32, "cpu")
        logits, _ = tmodel.forward(params, spec, torch.from_numpy(tokens),
                                   cache, compute_dtype=torch.float32)
    np.testing.assert_allclose(logits.numpy(), ref, rtol=2e-3,
                               atol=2e-3 * np.abs(ref).max())


def test_spec_of_the_tiny_file(tiny_v2):
    spec, _, js, _ = tiny_v2
    assert spec.model_type == "deepseek_v2" and spec.num_layers == 2
    assert spec.moe.num_experts == V2["experts"]
    assert spec.moe.shared_expert_intermediate_size == V2["moe_inter"]
    assert dataclasses.asdict(spec.rope) == dataclasses.asdict(js.rope)
