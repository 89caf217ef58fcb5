"""Pipeline parallelism in the port (ktransformers_tpu_torch/parallel/pp.py)
against the JAX package's (ktransformers_tpu/parallel/pp.py), mirroring
tests/test_pp.py at its sizes and tolerances: the GPipe schedule's forward
at (S, M) = (4, 8), (2, 5), (4, 4) against the JAX pipeline and the plain
sequential stack (2e-6), its gradient against the sequential stack's
(1e-5 / 1e-6; the input's too), every stage's parameters reached by the
gradient, and the Mixtral-shaped decoder stack pipelined over pp = 4 with
2 microbatches against the JAX pipelined forward and forward() (2e-5).
Beyond tests/test_pp.py: the LoRA gradients of that stack through the
pipeline against the port's single-device ones and jax.grad of the JAX
pipelined forward on the same adapters (drawn in the JAX package, crossed
by convert.params_from_jax), the exchanges the schedule makes, and the
two refusals of stack_stage_params.

One spawn of WORLD = 4 gloo CPU ranks (tests/torch_pp_worker.py, which
imports no JAX and runs one torch thread) does every port check,
rendezvousing through a file under tmp_path; the S = 2 case runs as two
pipelines of 2 ranks (torch_pp_worker.pp_mesh). The parent computes the JAX references on the
8-device virtual CPU mesh of tests/conftest.py while the ranks run. Every
join has a timeout, and a rank that fails or hangs fails the module's
tests.
"""

import multiprocessing
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ktransformers_tpu.models.init import init_params_synthetic
from ktransformers_tpu.models.model import KVCache as JKVCache
from ktransformers_tpu.models.model import forward as jforward
from ktransformers_tpu.models.spec import spec_from_hf_config as jspec
from ktransformers_tpu.parallel import pp as jpp
from ktransformers_tpu.sft import lora as jlora

from ktransformers_tpu_torch.convert import params_from_jax
from ktransformers_tpu_torch.models import model as tmodel
from ktransformers_tpu_torch.models.spec import spec_from_hf_config as tspec
from ktransformers_tpu_torch.parallel import pp as tpp
from ktransformers_tpu_torch.sft.lora import (
    lora_leaves,
    merge_lora_params,
    split_lora,
)
from ktransformers_tpu_torch.sft.train import IGNORE_INDEX, logits_nll

from tests import test_pp as jtests
from tests import torch_pp_worker as worker
from tests.test_torch_model import one_torch_thread  # noqa: F401 (fixture)

WORLD = 4
JOIN_S = 120
FORWARD_CASES = ((4, 8), (2, 5), (4, 4))
MIXTRAL = dict(
    model_type="mixtral", vocab_size=128, hidden_size=64,
    intermediate_size=96, num_hidden_layers=4, num_attention_heads=4,
    num_key_value_heads=2, num_local_experts=4, num_experts_per_tok=2,
    max_position_embeddings=64, rms_norm_eps=1e-6, rope_theta=10000.0)
# the LoRA gradients through the pipeline against the single device: the
# same float32 products on each microbatch, summed in another order
LLM_GRAD_TOL = 1e-5


def _toy(rng, n_layers, d, f):
    """tests/test_pp.py's layers as numpy (the same draws)."""
    return [{k: np.asarray(v) for k, v in lp.items()}
            for lp in jtests._toy_layers(rng, n_layers, d, f)]


def _jlayers(layers):
    return [{k: jnp.asarray(v) for k, v in lp.items()} for lp in layers]


def _forward_case(stages, m):
    rng = np.random.default_rng(0)
    layers = _toy(rng, 8, 16, 32)
    x = rng.standard_normal((m, 4, 16)).astype(np.float32)
    return dict(layers=layers, x=x)


def _grad_case(seed, stages, n_layers, m, mb, d, f, tgt=True):
    rng = np.random.default_rng(seed)
    case = dict(stages=stages, layers=_toy(rng, n_layers, d, f),
                x=rng.standard_normal((m, mb, d)).astype(np.float32))
    if tgt:
        case["tgt"] = rng.standard_normal((m, mb, d)).astype(np.float32)
    return case


def _jax_forward(case, stages):
    mesh = jtests._pp_mesh(stages)
    layers = _jlayers(case["layers"])
    x = jnp.asarray(case["x"])
    extras = {"scale": jnp.float32(1.5)}
    got = jpp.pipeline_apply(jtests._layer_fn, jpp.place_stages(
        jpp.stack_stage_params(layers, stages), mesh), x, mesh,
        extras=extras)
    return np.asarray(got), np.asarray(jtests._sequential(layers, x, extras))


def _jax_grads(case, loss_of_y):
    """(pipelined grads [S][L/S] dicts, sequential grads likewise, the
    sequential gradient of x) of loss_of_y(y)."""
    stages = case["stages"]
    mesh = jtests._pp_mesh(stages)
    layers = _jlayers(case["layers"])
    x = jnp.asarray(case["x"])
    g_pp = jax.grad(lambda p: loss_of_y(jpp.pipeline_apply(
        jtests._layer_fn, p, x, mesh, extras=None)))(
        jpp.stack_stage_params(layers, stages))
    g_seq, g_x = jax.grad(lambda ls, xx: loss_of_y(
        jtests._sequential(ls, xx, None)), argnums=(0, 1))(layers, x)
    per = len(layers) // stages

    def split(stacked):
        return [[{k: np.asarray(v[s, j]) for k, v in stacked.items()}
                 for j in range(per)] for s in range(stages)]

    return (split(g_pp), split(jpp.stack_stage_params(g_seq, stages)),
            np.asarray(g_x))


def _llm_inputs():
    spec_j, spec_t = jspec(dict(MIXTRAL)), tspec(dict(MIXTRAL))
    jparams = init_params_synthetic(spec_j, quant="bf16", moe_quant="bf16")
    tokens = np.random.default_rng(7).integers(0, 128, (4, 16)).astype(
        np.int32)
    params = params_from_jax(jax.device_get(jparams), spec_t, "cpu")
    # adapters on every default target, their b factors drawn (a zero b
    # would leave every a factor's gradient zero)
    rng = np.random.default_rng(9)
    jlo = jax.tree_util.tree_map_with_path(
        lambda p, x: (rng.standard_normal(x.shape) * 0.05).astype(np.float32)
        if x is not None and getattr(p[-1], "key", None) in (
            "b", "gate_up_b", "down_b") else x,
        jax.device_get(jlora.init_lora(jparams, spec_j,
                                       jlora.LoRAConfig(rank=4), seed=1)))
    labels = np.where(np.random.default_rng(8).random((4, 16)) < 0.25,
                      IGNORE_INDEX, tokens)
    return (spec_j, spec_t, jparams, params, jlo,
            params_from_jax(jlo, spec_t, "cpu"), tokens, labels)


def _jax_llm_grads(jlo, spec, tokens, labels):
    """The loss and LoRA gradients by name of the JAX pipelined forward
    over the virtual pp = 4 mesh, 2 microbatches (jax.grad through its
    shard_map)."""
    lora, base = jlora.split_lora(jax.tree.map(jnp.asarray, jlo))
    mesh = jtests._pp_mesh(4)
    lab = jnp.asarray(labels)[:, 1:]
    tgt = jnp.where(lab == IGNORE_INDEX, 0, lab)
    mask = (lab != IGNORE_INDEX).astype(jnp.float32)

    def loss_of(lo):
        logits = jpp.pipeline_llm_forward(
            jlora.merge_lora_params(lo, base), spec, jnp.asarray(tokens),
            mesh, microbatches=2, compute_dtype=jnp.float32)
        logp = jax.nn.log_softmax(logits[:, :-1], axis=-1)
        nll = -jnp.take_along_axis(logp, tgt[..., None], axis=-1)[..., 0]
        return jnp.sum(nll * mask) / jnp.sum(mask)

    loss, g = jax.jit(jax.value_and_grad(loss_of))(lora)
    return float(loss), jlora._flatten_lora(jax.device_get(g))


def _port_llm_grads(lora, spec, tokens, labels):
    """The single-device loss and LoRA gradients, by name."""
    trainable, base = split_lora(lora)
    params = merge_lora_params(trainable, base)
    cache = tmodel.KVCache.create(spec, 4, 16, torch.float32, "cpu")
    logits, _ = tmodel.forward(params, spec, torch.from_numpy(tokens), cache,
                               compute_dtype=torch.float32)
    total, count = logits_nll(logits, torch.from_numpy(labels))
    loss = total / count
    named = lora_leaves(trainable)
    grads = torch.autograd.grad(loss, [t for _, t in named])
    return float(loss.detach()), {n: g.numpy()
                                  for (n, _), g in zip(named, grads)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Start the ranks, compute the references meanwhile, join them; yields
    (rank outputs, references)."""
    tmp = str(tmp_path_factory.mktemp("pp"))
    (spec_j, spec_t, jparams, params, jlo, lora, tokens,
     labels) = _llm_inputs()
    data = dict(
        forward={c: _forward_case(*c) for c in FORWARD_CASES},
        grad=_grad_case(1, 4, 8, 8, 2, 8, 16),
        nonzero=_grad_case(2, 4, 4, 6, 2, 8, 8, tgt=False),
        spec=spec_t, params=params, params_lora=lora, tokens=tokens,
        labels=labels)
    torch.save(data, os.path.join(tmp, "inputs.pt"))
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=worker.run, args=(r, WORLD, tmp),
                         daemon=True) for r in range(WORLD)]
    for p in procs:
        p.start()
    try:
        ref = {}
        for stages, m in FORWARD_CASES:
            ref[f"forward/{stages}/{m}"] = _jax_forward(
                data["forward"][(stages, m)], stages)
        tgt = jnp.asarray(data["grad"]["tgt"])
        ref["grad"] = _jax_grads(data["grad"],
                                 lambda y: jnp.mean((y - tgt) ** 2))
        ref["nonzero"] = _jax_grads(data["nonzero"],
                                    lambda y: jnp.sum(y ** 2))
        cache = JKVCache.create(spec_j, 4, 16, dtype=jnp.float32)
        ref["llm/forward"] = np.asarray(jax.jit(lambda p, t, c: jforward(
            p, spec_j, t, c, compute_dtype=jnp.float32)[0])(
            jparams, jnp.asarray(tokens), cache))
        ref["llm/pipelined"] = np.asarray(jpp.pipeline_llm_forward(
            jparams, spec_j, jnp.asarray(tokens), jtests._pp_mesh(4),
            microbatches=2, compute_dtype=jnp.float32))
        cache = tmodel.KVCache.create(spec_t, 4, 16, torch.float32, "cpu")
        ref["llm/port"] = tmodel.forward(
            params, spec_t, torch.from_numpy(tokens), cache,
            compute_dtype=torch.float32)[0].numpy()
        ref["llm/loss"], ref["llm/grads"] = _port_llm_grads(
            lora, spec_t, tokens, labels)
        ref["llm/jax_loss"], ref["llm/jax_grads"] = _jax_llm_grads(
            jlo, spec_j, tokens, labels)
    finally:
        for p in procs:
            p.join(JOIN_S)
        hung = [r for r, p in enumerate(procs) if p.is_alive()]
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(5)
    errs = {r: open(os.path.join(tmp, f"err_{r}.txt")).read()
            for r in range(WORLD)
            if os.path.exists(os.path.join(tmp, f"err_{r}.txt"))}
    assert not hung, f"ranks {hung} still running after {JOIN_S} s"
    assert not errs, errs
    assert all(p.exitcode == 0 for p in procs), [p.exitcode for p in procs]
    outs = [torch.load(os.path.join(tmp, f"out_{r}.pt"), weights_only=False)
            for r in range(WORLD)]
    yield outs, ref


def _close(got, want, rtol, atol):
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


@pytest.mark.parametrize("stages,m", FORWARD_CASES)
def test_pipeline_forward_matches_sequential(runs, stages, m):
    """Every rank returns all M microbatches: equal to the JAX pipeline's
    and to the sequential stack's."""
    outs, ref = runs
    pipelined, sequential = ref[f"forward/{stages}/{m}"]
    for out in outs:
        got = out[f"forward/{stages}/{m}"]
        _close(got, pipelined, 2e-6, 2e-6)
        _close(got, sequential, 2e-6, 2e-6)


def test_pipeline_grad_matches_sequential(runs):
    """Rank s's layer gradients equal stage s of the JAX pipelined and
    sequential gradients; the input's gradient (summed over pp) equals the
    sequential one on every rank."""
    outs, ref = runs
    g_pp, g_seq, g_x = ref["grad"]
    for s, out in enumerate(outs):
        for got, want_pp, want_seq in zip(out["grad/stage"], g_pp[s],
                                          g_seq[s]):
            for k in got:
                _close(got[k], want_pp[k], 1e-5, 1e-6)
                _close(got[k], want_seq[k], 1e-5, 1e-6)
        _close(out["grad/x"], g_x, 1e-5, 1e-6)


def test_pipeline_grad_nonzero_everywhere(runs):
    """Every stage's parameters receive a gradient (no microbatch dropped
    at the bubble), the JAX pipeline's own."""
    outs, ref = runs
    g_pp, _, _ = ref["nonzero"]
    for s, out in enumerate(outs):
        for got, want in zip(out["nonzero/stage"], g_pp[s]):
            for k in got:
                assert np.abs(got[k]).sum() > 0, (s, k)
                _close(got[k], want[k], 1e-5, 1e-6)


def test_pipeline_exchanges(runs):
    """M + S - 2 paired exchanges a pass over pp (none after the last
    tick), forward and backward; the outputs' and the input gradient's
    all-reduce; CPU tensors on gloo take the device path."""
    outs, _ = runs
    for out in outs:
        for name, m in (("grad", 8), ("nonzero", 6)):
            got = out[f"{name}/collectives"]
            assert got == {("send_recv", "pp", "device"): 2 * (m + 4 - 2),
                           ("all_reduce", "pp", "device"): 2}, (name, got)


def test_pipeline_llm_matches_forward(runs):
    """The Mixtral-shaped stack (homogeneous MoE + GQA layers) over pp = 4,
    2 microbatches: the JAX pipelined logits and forward()'s, the port's
    and the JAX package's."""
    outs, ref = runs
    for out in outs:
        got = out["llm/logits"]
        for key in ("llm/pipelined", "llm/forward", "llm/port"):
            _close(got, ref[key], 2e-5, 2e-5)


def test_pipeline_llm_lora_grads_match_single_device(runs):
    """With LoRA adapters on every default target: the loss on every rank
    and each rank's stage's LoRA gradients equal the port's single
    device's and jax.grad's of the JAX pipelined forward over pp = 4."""
    outs, ref = runs
    per = MIXTRAL["num_hidden_layers"] // WORLD
    for s, out in enumerate(outs):
        for loss_key, grads_key in (("llm/loss", "llm/grads"),
                                    ("llm/jax_loss", "llm/jax_grads")):
            np.testing.assert_allclose(out["llm/loss"], ref[loss_key],
                                       rtol=1e-6)
            want = {n: g for n, g in ref[grads_key].items()
                    if int(n.split("/")[1]) // per == s}
            assert set(out["llm/grads"]) == set(want) and want, grads_key
            for n, g in want.items():
                got = out["llm/grads"][n]
                assert np.abs(g).max() > 0, n
                _close(got, g, LLM_GRAD_TOL, LLM_GRAD_TOL * np.abs(g).max())


def test_stack_stage_params_refusals():
    """Both packages refuse L not divisible by S (the same message) and
    layers of different structure; a model with a dense prologue layer
    does not pipeline in either."""
    rng = np.random.default_rng(0)
    layers = _toy(rng, 7, 4, 8)
    msg = "7 layers not divisible into 4 pipeline stages"
    with pytest.raises(ValueError, match=msg):
        jpp.stack_stage_params(_jlayers(layers), 4)
    with pytest.raises(ValueError, match=msg):
        tpp.stack_stage_params(layers, 4)
    odd = _toy(rng, 4, 4, 8)
    odd[2] = {"w1": odd[2]["w1"], "w3": odd[2]["w2"]}
    with pytest.raises(ValueError):
        jpp.stack_stage_params(_jlayers(odd), 2)
    with pytest.raises(ValueError, match="layer 2 differs from layer 0"):
        tpp.stack_stage_params(odd, 2)
    wide = _toy(rng, 4, 4, 8)
    wide[3] = _toy(rng, 1, 4, 16)[0]
    with pytest.raises((ValueError, TypeError)):
        jpp.stack_stage_params(_jlayers(wide), 2)
    with pytest.raises(ValueError, match="layer 3 differs.*w1"):
        tpp.stack_stage_params([{k: torch.tensor(v) for k, v in lp.items()}
                                for lp in wide], 2)
    from tests.test_generate import TINY_DS

    spec_j, spec_t = jspec(dict(TINY_DS)), tspec(dict(TINY_DS))
    jparams = init_params_synthetic(spec_j, quant="bf16", moe_quant="bf16")
    with pytest.raises(ValueError):
        jpp.pipeline_llm_forward(jparams, spec_j, jnp.zeros((2, 4), jnp.int32),
                                 jtests._pp_mesh(2), microbatches=1)
    params = params_from_jax(jax.device_get(jparams), spec_t, "cpu")
    mesh = tpp.Mesh({"pp": 2}, {"pp": 0}, {"pp": None}, "cpu")
    with pytest.raises(ValueError, match="differs from layer 0"):
        tpp.pipeline_llm_forward(params, spec_t,
                                 torch.zeros((2, 4), dtype=torch.int64),
                                 mesh, microbatches=1)
