"""The port's LoRA SFT path (ktransformers_tpu_torch/sft, ops/vjp.py, the
LoRA-aware model and MoE) against the JAX package's (ktransformers_tpu/sft).

The model is the JAX package's 2-layer TINY_DS (layer 0 dense, layer 1 MoE
with a shared expert) with int8 weights, built by its init_params and
carried across with convert.params_from_jax. Where the JAX side trains, its
kernels are the Pallas ones in interpret mode behind their custom_vjp
wrappers (the hooks ops/pallas.enable() installs); the port runs the plain
versions of its kernels on the CPU. Both compute in float32.

Tolerances:
- init_lora's a factors, the dataset batches and adapter files: exact;
- loss_fn and the losses of 3 Trainer steps: 1e-5 relative (seen: ~1e-7);
- the LoRA leaves after 3 steps: each leaf's update (after - before) within
  1e-2 of the JAX update's norm (seen: at most 4.3e-3). Adam divides each
  gradient element by its own running magnitude, so an element whose
  gradient is rounding noise moves by up to the learning rate on either
  side; the norm of the update is what a real difference would move;
- MoE with expert LoRA, W4A8 weights: 1e-3 of the largest output (the
  int8 activation codes of the two sides may land one step apart).
"""

import contextlib
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ktransformers_tpu.models.init import init_params as jinit_params
from ktransformers_tpu.models.spec import spec_from_hf_config as jspec
from ktransformers_tpu.sft import data as jdata
from ktransformers_tpu.sft import lora as jlora
from ktransformers_tpu.sft import train as jtrain
from ktransformers_tpu_torch.convert import params_from_jax, qtensor_from_jax
from ktransformers_tpu_torch.engine.generate import GenerateConfig, Generator
from ktransformers_tpu_torch.models.spec import spec_from_hf_config as tspec
from ktransformers_tpu_torch.ops import moe as tmoe
from ktransformers_tpu_torch.serving import SchedulerConfig, ServeEngine
from ktransformers_tpu_torch.sft import data as tdata
from ktransformers_tpu_torch.sft import lora as tlora
from ktransformers_tpu_torch.sft import train as ttrain

from tests.test_generate import TINY_DS
from tests.test_torch_model import jax_interpret_hooks
from tests.test_torch_model import one_torch_thread  # noqa: F401

TARGETS = tlora.LoRAConfig().target_modules + (r".*\.moe\.shared",
                                               r".*\.mlp")


@contextlib.contextmanager
def jax_diff_hooks():
    """The JAX package's matmul hooks as ops/pallas.enable() installs them
    (the custom_vjp wrappers of ops/pallas/vjp.py), kernels in interpret
    mode; restored after."""
    from ktransformers_tpu.ops import linear, moe
    from ktransformers_tpu.ops.pallas import vjp as V

    old = (linear._PALLAS_QMATMUL, moe._PALLAS_GATHER, moe._PALLAS_GMM,
           V._INTERPRET)
    V._INTERPRET = True
    linear.set_pallas_qmatmul(V.quant_matmul_diff)
    moe.set_pallas_gather(V.gathered_quant_matmul_diff)
    moe.set_pallas_gmm(V.grouped_quant_matmul_diff)
    try:
        yield
    finally:
        linear.set_pallas_qmatmul(old[0])
        moe.set_pallas_gather(old[1])
        moe.set_pallas_gmm(old[2])
        V._INTERPRET = old[3]


def _models():
    """(JAX spec, JAX int8 params, port spec)."""
    spec = jspec(dict(TINY_DS))
    spec_t = tspec(dict(TINY_DS))
    return spec, jinit_params(spec, seed=0, quant="int8"), spec_t


def _port(jparams, spec_t):
    return params_from_jax(jax.device_get(jparams), spec_t, "cpu")


def _jax_flat(params) -> dict:
    return {k: np.asarray(v) for k, v in jlora._flatten_lora(
        jax.device_get(params)).items()}


def _port_flat(params) -> dict:
    return {k: v.detach().numpy() for k, v in tlora.lora_leaves(params)}


def _batch():
    ids = np.random.default_rng(0).integers(0, 90, (2, 16))
    labels = np.where(np.arange(16)[None] < 4, ttrain.IGNORE_INDEX, ids)
    return ids, labels


def test_init_lora_matches_jax_bit_for_bit():
    spec_j, jp, spec_t = _models()
    cfg_j = jlora.LoRAConfig(rank=4, target_modules=TARGETS)
    cfg_t = tlora.LoRAConfig(rank=4, target_modules=TARGETS)
    want = _jax_flat(jlora.init_lora(jp, spec_j, cfg_j, seed=7))
    got = _port_flat(tlora.init_lora(_port(jp, spec_t), spec_t, cfg_t,
                                     seed=7))
    assert set(got) == set(want)
    assert "layers/1/moe/experts/lora/down_a" in got
    assert "layers/1/moe/shared/gate_up_lora/a" in got
    assert "layers/0/mlp/down_lora/b" in got
    for name, v in want.items():
        assert got[name].dtype == v.dtype and np.array_equal(got[name], v), \
            name


def test_split_merge():
    _, jp, spec_t = _models()
    params = tlora.init_lora(_port(jp, spec_t), spec_t,
                             tlora.LoRAConfig(rank=4), seed=1)
    lora, base = tlora.split_lora(params)
    leaves = [t for _, t in tlora.lora_leaves(lora)]
    assert leaves and all(t.requires_grad and t.is_floating_point()
                          for t in leaves)
    assert lora["layers"][0]["attn"]["o_proj"] is None
    # same structure, None holes (as the JAX package's split_lora)
    assert base["layers"][0]["attn"]["o_proj_lora"] == {"a": None, "b": None}
    assert not any(base["layers"][1]["moe"]["experts"].lora.values())
    assert base["layers"][0]["attn"]["o_proj"].data.dtype == torch.int8
    merged = tlora.merge_lora_params(lora, base)
    assert merged["layers"][0]["attn"]["o_proj"] is \
        params["layers"][0]["attn"]["o_proj"]
    for (n1, a), (n2, b) in zip(tlora.lora_leaves(merged),
                                tlora.lora_leaves(params)):
        assert n1 == n2 and a.data_ptr() == b.data_ptr()
    # the caller's leaves are not made trainable
    assert not params["layers"][0]["attn"]["o_proj_lora"]["a"].requires_grad


class _Tok:
    eos_token_id = 1

    def encode(self, text):
        return [2 + ord(c) % 50 for c in text]


def test_load_sft_dataset_matches_jax(tmp_path):
    recs = [
        {"instruction": "say hi", "input": "now", "output": "hello there"},
        {"prompt": "2+2?", "response": "4"},
        {"messages": [{"role": "user", "content": "a"},
                      {"role": "assistant", "content": "b"}]},
        {"instruction": "x" * 40, "output": "y"},  # cut at seq_len
        {"prompt": "left over", "response": "dropped"},
    ]
    path = tmp_path / "data.json"
    path.write_text(json.dumps(recs))
    want = list(jdata.load_sft_dataset(str(path), _Tok(), seq_len=24,
                                       batch_size=2))
    got = list(tdata.load_sft_dataset(str(path), _Tok(), seq_len=24,
                                      batch_size=2))
    assert len(got) == len(want) == 2
    for (gi, gl), (wi, wl) in zip(got, want):
        assert gi.dtype == wi.dtype and np.array_equal(gi, wi)
        assert np.array_equal(gl, wl)
    assert ttrain.IGNORE_INDEX == jtrain.IGNORE_INDEX


def test_adapter_files_cross_packages(tmp_path):
    spec_j, jp, spec_t = _models()
    cfg = dict(rank=4)
    jl = jlora.init_lora(jp, spec_j, jlora.LoRAConfig(**cfg), seed=2)
    # non-zero b factors, so a file that dropped them would show
    jl = jax.tree_util.tree_map_with_path(
        lambda p, x: x + 0.5 if jlora._is_lora_path(p)
        and str(p[-1]).endswith(("'b']", "_b']")) else x, jl)
    jpath, tpath = str(tmp_path / "j.safetensors"), str(tmp_path / "t.st")
    jlora.save_lora(jl, jpath)
    fresh_t = tlora.init_lora(_port(jp, spec_t), spec_t,
                              tlora.LoRAConfig(**cfg), seed=99)
    got = _port_flat(tlora.load_lora(fresh_t, jpath))
    want = _jax_flat(jl)
    assert set(got) == set(want)
    assert all(np.array_equal(got[k], want[k]) for k in want)
    assert any(np.any(want[k] != 0) for k in want if k.endswith("b"))
    # and back: the port's file into a fresh JAX tree
    tlora.save_lora(tlora.load_lora(fresh_t, jpath), tpath)
    back = _jax_flat(jlora.load_lora(
        jlora.init_lora(jp, spec_j, jlora.LoRAConfig(**cfg), seed=5), tpath))
    assert all(np.array_equal(back[k], want[k]) for k in want)


def test_loss_fn_matches_jax():
    spec_j, jp, spec_t = _models()
    ids, labels = _batch()
    with jax_diff_hooks():
        want = float(jtrain.loss_fn(jp, spec_j, jnp.asarray(ids),
                                    jnp.asarray(labels), jnp.float32))
    got = float(ttrain.loss_fn(_port(jp, spec_t), spec_t,
                               torch.as_tensor(ids), torch.as_tensor(labels),
                               torch.float32))
    np.testing.assert_allclose(got, want, rtol=1e-5)
    # every label masked: the mean over no tokens is 0, not NaN
    masked = np.full_like(labels, ttrain.IGNORE_INDEX)
    assert float(ttrain.loss_fn(_port(jp, spec_t), spec_t,
                                torch.as_tensor(ids),
                                torch.as_tensor(masked), torch.float32)) == 0


def test_trainer_matches_jax_over_three_steps():
    spec_j, jp, spec_t = _models()
    ids, labels = _batch()
    cfg = dict(learning_rate=5e-3, remat=True)
    with jax_diff_hooks():
        jt = jtrain.Trainer(jlora.init_lora(jp, spec_j,
                                            jlora.LoRAConfig(rank=4), seed=1),
                            spec_j, jtrain.TrainConfig(**cfg))
        want = [jt.train_step(ids, labels) for _ in range(3)]
        jafter = _jax_flat(jt.params)
    start = tlora.init_lora(_port(jp, spec_t), spec_t,
                            tlora.LoRAConfig(rank=4), seed=1)
    before = _port_flat(start)
    tt = ttrain.Trainer(start, spec_t, ttrain.TrainConfig(**cfg),
                        device="cpu")
    got = [tt.train_step(ids, labels) for _ in range(3)]
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert got[-1] < got[0]
    after = _port_flat(tt.params)
    for name, b in before.items():
        dj, dt = jafter[name] - b, after[name] - b
        assert np.linalg.norm(dj) > 0, name
        assert np.linalg.norm(dt - dj) <= 1e-2 * np.linalg.norm(dj), name
    # the caller's adapter and the base are unchanged
    assert all(np.array_equal(v, before[k])
               for k, v in _port_flat(start).items())
    assert tt.params["layers"][0]["attn"]["o_proj"] is \
        start["layers"][0]["attn"]["o_proj"]


def test_trained_adapter_serves(tmp_path):
    """Train, save the adapter, load it onto a fresh adapter of the same
    config in a ServeEngine: its greedy tokens equal the Generator's on the
    trainer's params and differ from the base model's (the port's
    tests/test_sft.py::test_lora_adapter_export_to_serving)."""
    _, jp, spec = _models()
    base = _port(jp, spec)
    tr = ttrain.Trainer(
        tlora.init_lora(base, spec, tlora.LoRAConfig(rank=4), seed=3), spec,
        ttrain.TrainConfig(learning_rate=5e-2), device="cpu")
    ids = np.random.default_rng(0).integers(2, 90, (2, 24))
    for _ in range(3):
        tr.train_step(ids, ids)
    path = str(tmp_path / "adapter.safetensors")
    tlora.save_lora(tr.params, path)

    f32 = dict(cache_dtype=torch.float32, compute_dtype=torch.float32,
               device="cpu")
    prompt = list(range(5, 15))
    cfg = GenerateConfig(max_new_tokens=6)
    expected = Generator(tr.params, spec, max_len=64, **f32).generate(
        [prompt], cfg)[0]
    serving = tlora.load_lora(
        tlora.init_lora(base, spec, tlora.LoRAConfig(rank=4), seed=99), path)
    eng = ServeEngine(serving, spec,
                      SchedulerConfig(max_batch_size=2, prefill_chunk=8,
                                      page_size=8, max_pages_per_query=8),
                      num_pages=32, **f32)
    got = eng.generate_sync(prompt, max_new_tokens=6)
    assert got == expected
    base_out = Generator(base, spec, max_len=64, **f32).generate(
        [prompt], cfg)[0]
    assert got != base_out  # the adapter changes what is served


def _w4a8_experts(lora: bool):
    """JAX and port MoEWeights: 4 experts, hidden 256, inter 128, int4_g
    repacked for W4A8 (the fused FFN kernels take them), with random
    LoRA factors when asked."""
    from ktransformers_tpu.ops.moe import MoEWeights as JMoE
    from ktransformers_tpu.quant import formats as jf
    from ktransformers_tpu.quant import w4a8 as jw

    rng = np.random.default_rng(11)

    def q(shape):
        w = rng.standard_normal(shape).astype(np.float32) * 0.05
        return jf.pad_scale_sublanes(jw.repack_offset_lo(
            jf.quantize(jnp.asarray(w), "int4_g", group_size=128)))

    jw_ = JMoE(gate_up=q((4, 256, 256)), down=q((4, 128, 256)))
    factors = None
    if lora:
        shapes = dict(gate_up_a=(4, 256, 4), gate_up_b=(4, 4, 256),
                      down_a=(4, 128, 4), down_b=(4, 4, 256))
        factors = {k: rng.standard_normal(s).astype(np.float32) * 0.1
                   for k, s in shapes.items()}
        jw_ = dataclasses.replace(jw_, lora={k: jnp.asarray(v)
                                             for k, v in factors.items()})
    tw = tmoe.MoEWeights(
        qtensor_from_jax(jax.device_get(jw_.gate_up), "cpu"),
        qtensor_from_jax(jax.device_get(jw_.down), "cpu"),
        None if factors is None
        else {k: torch.from_numpy(v) for k, v in factors.items()})
    return jw_, tw


@pytest.mark.parametrize("tokens", [4, 16])  # gather path, grouped path
def test_expert_lora_bypasses_fused_ffn(tokens, monkeypatch):
    from ktransformers_tpu.ops import moe as jmoe
    from ktransformers_tpu.ops.activations import ActivationConfig as JAct

    calls = []
    for name in ("gathered_w4a8_ffn", "grouped_w4a8_ffn"):
        fn = getattr(tmoe, name)
        monkeypatch.setattr(tmoe, name, lambda *a, _f=fn, _n=name, **k: (
            calls.append(_n), _f(*a, **k))[1])
    rng = np.random.default_rng(12)
    x = rng.standard_normal((tokens, 256)).astype(np.float32)
    idx = np.stack([rng.permutation(4)[:2] for _ in range(tokens)])
    wts = rng.random((tokens, 2)).astype(np.float32)
    targs = (torch.from_numpy(x), None, torch.from_numpy(idx),
             torch.from_numpy(wts))

    _, plain = _w4a8_experts(lora=False)
    tmoe.moe_forward(targs[0], plain, *targs[2:])
    assert len(calls) == 1  # without adapters the fused FFN runs

    jw_, tw = _w4a8_experts(lora=True)
    got = tmoe.moe_forward(targs[0], tw, *targs[2:])
    assert len(calls) == 1  # with them it does not
    with jax_interpret_hooks():
        want = np.asarray(jmoe.moe_forward(
            jnp.asarray(x), jw_, jnp.asarray(idx), jnp.asarray(wts),
            jmoe.MoEConfig(activation=JAct())))
    err = np.abs(got.numpy() - want).max() / np.abs(want).max()
    assert err <= 1e-3, err


def test_convert_carries_expert_lora_and_refuses_ep():
    spec_j, jp, spec_t = _models()
    jl = jlora.init_lora(jp, spec_j, jlora.LoRAConfig(rank=4), seed=1)
    tp = _port(jl, spec_t)
    lora = tp["layers"][1]["moe"]["experts"].lora
    want = jax.device_get(jl["layers"][1]["moe"]["experts"].lora)
    assert set(lora) == set(want)
    assert all(np.array_equal(lora[k].numpy(), np.asarray(want[k]))
               for k in want)
    assert "o_proj_lora" in tp["layers"][1]["attn"]
    # the expert map and mask (expert parallelism) cross as they are
    ex = jl["layers"][1]["moe"]["experts"]
    for field, value in (("logical_to_physical", jnp.arange(4)[::-1]),
                         ("expert_mask", jnp.asarray([1, 0, 1, 1], bool))):
        other = dict(jl)
        other["layers"] = [jl["layers"][0], dict(jl["layers"][1], moe=dict(
            jl["layers"][1]["moe"],
            experts=dataclasses.replace(ex, **{field: value})))]
        got = getattr(_port(other, spec_t)["layers"][1]["moe"]["experts"],
                      field)
        np.testing.assert_array_equal(got.numpy(), np.asarray(value))


def test_lora_guards():
    from ktransformers_tpu_torch.models.model import mla_qkv_proj
    from ktransformers_tpu_torch.utils.device_prep import (
        fuse_qkv_projections,
    )

    _, jp, spec = _models()
    with_lora = tlora.init_lora(_port(jp, spec), spec,
                                tlora.LoRAConfig(rank=4), seed=1)
    fuse_qkv_projections(with_lora, spec)  # a part carries an adapter
    assert "qkv_a" not in with_lora["layers"][0]["attn"]
    fused = _port(jp, spec)
    fuse_qkv_projections(fused, spec)
    attn = dict(fused["layers"][0]["attn"],
                q_proj_lora=with_lora["layers"][0]["attn"]["q_proj_lora"])
    with pytest.raises(ValueError, match="q_proj_lora"):
        mla_qkv_proj(attn, spec, torch.zeros(1, 2, 32))
    # LoRA under tensor parallelism (the JAX package fails on it too)
    from ktransformers_tpu_torch.parallel.mesh import Mesh

    tp2 = Mesh({"dp": 1, "ep": 1, "tp": 2}, {"dp": 0, "ep": 0, "tp": 0},
               {"dp": None, "ep": None, "tp": None}, "cpu")
    with pytest.raises(NotImplementedError, match="tensor parallelism"):
        ttrain.Trainer(with_lora, spec, mesh=tp2, device="cpu")
