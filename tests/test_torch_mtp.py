"""The port's MTP self-speculation (engine/mtp.py) against the JAX
package's: the counterpart of tests/test_mtp.py, on the models of
tests/test_torch_speculative.py (the same numpy-seeded weights in both
packages, float32 on the CPU; mtp_layer_forward within 2e-4 of the largest
value, tokens and acceptance statistics exact).

A reference hazard (ROADMAP Queue 3): the JAX package's MTP layer computes no
window, no NoPE switch and routes from the post-attention state, so the
port refuses windowed, NoPE, early-router and hybrid specs. The JAX
mtp_params_from_provider builds a V3-style MoE MTP layer as a dense one
and fails (recorded).
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ktransformers_tpu_torch.convert import (
    mtp_params_from_jax,
    params_from_jax,
)
from ktransformers_tpu_torch.engine import mtp as tmtp
from ktransformers_tpu_torch.models.spec import spec_from_hf_config

from tests.test_torch_model import one_torch_thread  # noqa: F401 (fixture)
from tests.test_torch_speculative import (
    CFGS,
    PORT_FNS,
    PROMPT,
    TOL,
    _cfg,
    _jax_fn,
    _jgen,
    _jparams,
    _port,
    check_parity,
    models,
)


@pytest.mark.parametrize("arch", sorted(CFGS))
def test_mtp_layer_forward_matches_jax(arch):
    """Two calls over one head cache (a 5-token catch-up, then a draft
    step) on a converted head, the port's fused projection included."""
    from ktransformers_tpu.engine.mtp import mtp_layer_forward as jfwd
    from ktransformers_tpu.models.model import KVCache as JKVCache

    m = models(arch)
    one = dataclasses.replace(m.jspec, num_layers=1)
    rng = np.random.default_rng(4)
    h = rng.standard_normal((1, 6, m.spec.hidden_size)).astype(np.float32)
    toks = rng.integers(0, 96, (1, 6))
    drafter = tmtp.MTPDrafter(m.m, m.t)
    jc = JKVCache.create(one, 1, 16, dtype=jnp.float32)
    tc = drafter.new_cache()
    step = jax.jit(lambda mp, p, t, hh, c: jfwd(
        mp, p, m.jspec, t, hh, c, m.jt.rope_tables, jnp.float32))
    for sl in (slice(0, 5), slice(5, 6)):
        jl, jh, jc = step(m.jm, m.jt.params, jnp.asarray(toks[:, sl]),
                          jnp.asarray(h[:, sl]), jc)
        tl, th, tc = drafter.step(torch.as_tensor(toks[:, sl]),
                                  torch.as_tensor(h[:, sl]), tc)
        for got, want in ((tl, jl), (th, jh)):
            want = np.asarray(want)
            err = np.abs(got.numpy() - want).max() / np.abs(want).max()
            assert err <= TOL, err
    assert int(tc.lengths[0]) == 6
    assert "qkv_a" in drafter.mtp["layer"]["attn"] \
        or "qkv" in drafter.mtp["layer"]["attn"]


@pytest.mark.parametrize("arch,quant", [("mla", "bf16"), ("gqa", "bf16")])
def test_init_mtp_synthetic_is_the_jax_head(arch, quant):
    """One numpy seed, the same head in both packages, bit for bit."""
    from ktransformers_tpu.engine.mtp import init_mtp_synthetic

    m = models(arch)
    jm = mtp_params_from_jax(jax.device_get(init_mtp_synthetic(
        m.jspec, seed=11, quant=quant)), m.spec, "cpu")
    tm = tmtp.init_mtp_synthetic(m.spec, seed=11, quant=quant,
                                 device="cpu")

    def leaves(node, path=""):
        if isinstance(node, dict):
            for k in sorted(node):
                yield from leaves(node[k], f"{path}.{k}")
        elif dataclasses.is_dataclass(node):
            for f in dataclasses.fields(node):
                yield from leaves(getattr(node, f.name), f"{path}.{f.name}")
        elif isinstance(node, torch.Tensor):
            yield path, node

    got, want = dict(leaves(tm)), dict(leaves(jm))
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("arch", sorted(CFGS))
@pytest.mark.parametrize("name", ["mtp", "mtp_single", "mtp_fused"])
def test_mtp_matches_greedy_and_jax(name, arch, k):
    check_parity(name, arch, k)

def test_mtp_nonzero_acceptance():
    """A dominant lm_head column makes the head's drafts agree with the
    target: rounds accept drafts and the cache protocol advances by a + 1
    a round (the JAX package's test). The three loops count alike, and as
    the JAX fused loop does."""
    from ktransformers_tpu.quant.formats import quantize

    m = models("mla")
    jp = _jparams(m.jspec)
    w = np.zeros((m.spec.hidden_size, m.spec.vocab_size), np.float32)
    w[:, 5] = 1.0
    jp["lm_head"] = quantize(jnp.asarray(w), "bf16")
    jt = _jgen(m.jspec, jp, 128)
    t = _port(jt, m.spec, 128)
    cfg = _cfg(24)
    want = t.generate(PROMPT, cfg)[0]
    jgot, jstats = _jax_fn("mtp_fused")(jt, m.jm, PROMPT, cfg, k=2)
    assert list(jgot) == want
    for name in ("mtp", "mtp_single", "mtp_fused"):
        got, stats = PORT_FNS[name](t, m.m, PROMPT, cfg, k=2)
        assert got == want, name
        assert stats.accepted > 0 and stats.rounds < 24
        assert (stats.rounds, stats.accepted) == (jstats.rounds,
                                                  jstats.accepted), name


# the most cache positions each function may write at P + n, k
def test_mtp_refuses_layouts_it_does_not_compute():
    """The MTP layer runs no window, no NoPE switch and routes
    from the post-attention state, so those layouts and a hybrid spec
    raise, naming the feature."""
    from tests.test_torch_qwen3_next import TINY as QNEXT
    from tests.test_torch_smallthinker import TINY as SMALLTHINKER

    cases = ((SMALLTHINKER, ("sliding-window", "NoPE", "early router")),
             (QNEXT, ("hybrid",)))
    for cfg, words in cases:
        target = types.SimpleNamespace(spec=spec_from_hf_config(dict(cfg)))
        with pytest.raises(ValueError) as e:
            tmtp.MTPDrafter({}, target)
        for w in words:
            assert w in str(e.value)
    tmtp.check_mtp_spec(models("mla").spec)  # DeepSeek's layout passes


def _mtp_tensors(spec, li, rng):
    """HF-named float32 tensors of DeepSeek-V2's MoE layer li and its MTP
    projections (V3's layout of the MTP layer)."""
    a, mo = spec.attention, spec.moe
    d = spec.hidden_size
    pre = f"model.layers.{li}"

    def w(o, i):
        return (rng.standard_normal((o, i)) / np.sqrt(i)).astype(np.float32)

    t = {f"{pre}.enorm.weight": 1 + 0.1 * rng.standard_normal(d),
         f"{pre}.hnorm.weight": 1 + 0.1 * rng.standard_normal(d),
         f"{pre}.eh_proj.weight": w(d, 2 * d),
         f"{pre}.shared_head.norm.weight": 1 + 0.1 * rng.standard_normal(d),
         f"{pre}.input_layernorm.weight": np.ones(d),
         f"{pre}.post_attention_layernorm.weight": np.ones(d)}
    sa = f"{pre}.self_attn"
    h, nope, dr = a.num_heads, a.qk_nope_head_dim, a.qk_rope_head_dim
    t[f"{sa}.q_proj.weight"] = w(h * (nope + dr), d)
    t[f"{sa}.kv_a_proj_with_mqa.weight"] = w(a.kv_lora_rank + dr, d)
    t[f"{sa}.kv_a_layernorm.weight"] = np.ones(a.kv_lora_rank)
    t[f"{sa}.kv_b_proj.weight"] = w(h * (nope + a.v_head_dim),
                                    a.kv_lora_rank)
    t[f"{sa}.o_proj.weight"] = w(d, h * a.v_head_dim)
    f = mo.moe_intermediate_size
    t[f"{pre}.mlp.gate.weight"] = w(mo.num_experts, d)
    for e in range(mo.num_experts):
        base = f"{pre}.mlp.experts.{e}"
        t[f"{base}.gate_proj.weight"] = w(f, d)
        t[f"{base}.up_proj.weight"] = w(f, d)
        t[f"{base}.down_proj.weight"] = w(d, f)
    fs = mo.shared_expert_intermediate_size
    for nm, shape in (("gate_proj", (fs, d)), ("up_proj", (fs, d)),
                      ("down_proj", (d, fs))):
        t[f"{pre}.mlp.shared_experts.{nm}.weight"] = w(*shape)
    return {k: np.asarray(v, np.float32) for k, v in t.items()}


def test_mtp_params_from_provider(tmp_path):
    """A V3-style MTP layer (model.layers.L, a MoE layer) written as a
    safetensors file and read through SafetensorsProvider: the projections
    as written, the decoder layer bit for bit the JAX build_params' layer L
    of a spec one layer deeper. The JAX mtp_params_from_provider renames
    the layer to layer 0 of a one-layer spec, dense under
    first_k_dense_replace = 1, and fails on this file (recorded)."""
    from ktransformers_tpu.engine.mtp import (
        mtp_params_from_provider as j_from_provider,
    )
    from ktransformers_tpu.models.loading import WeightProvider as JProvider
    from ktransformers_tpu.models.loading import build_params as j_build

    from ktransformers_tpu_torch.loader.providers import SafetensorsProvider
    from ktransformers_tpu_torch.loader.safetensors_io import save_file

    m = models("mla")
    li = m.spec.num_layers
    tensors = _mtp_tensors(m.spec, li, np.random.default_rng(9))
    path = str(tmp_path / "mtp.safetensors")
    save_file({k: torch.from_numpy(v) for k, v in tensors.items()}, path)
    head = tmtp.mtp_params_from_provider(SafetensorsProvider(path), m.spec,
                                         quant="bf16", device="cpu")

    class Dict(JProvider):
        def get(self, name):
            return tensors[name]

    pre = f"model.layers.{li}"
    for key, name in (("enorm", "enorm"), ("hnorm", "hnorm"),
                      ("final_norm", "shared_head.norm")):
        np.testing.assert_array_equal(head[key].numpy(),
                                      tensors[f"{pre}.{name}.weight"])
    np.testing.assert_array_equal(
        head["eh_proj"].data.float().numpy(),
        torch.from_numpy(tensors[f"{pre}.eh_proj.weight"].T.copy()).to(
            torch.bfloat16).float().numpy())
    deeper = dataclasses.replace(m.jspec, num_layers=li + 1)
    jlayer = j_build(Dict(), deeper, quant="bf16", layer_indices=[li],
                     include_head=False)["layers"][0]
    want = params_from_jax(jax.device_get({"layers": [jlayer]}), None,
                           "cpu")["layers"][0]
    assert "moe" in head["layer"] and "moe" in want
    for part in ("attn", "moe"):
        for k, v in want[part].items():
            got = head["layer"][part][k]
            if hasattr(v, "gate_up"):
                pairs = ((got.gate_up.data, v.gate_up.data),
                         (got.down.data, v.down.data))
            elif hasattr(v, "data"):
                pairs = ((got.data, v.data),)
            elif isinstance(v, dict):
                pairs = tuple((got[n].data, v[n].data) for n in v)
            else:
                pairs = ((got, v),)
            for x, y in pairs:
                assert torch.equal(x, y), (part, k)
    with pytest.raises(KeyError):
        j_from_provider(Dict(), m.jspec, quant="bf16")
    # the head drafts: finite logits over the vocabulary
    drafter = tmtp.MTPDrafter(head, m.t)
    logits, h, _ = drafter.step(torch.tensor([[5, 6]]),
                                torch.zeros(1, 2, m.spec.hidden_size),
                                drafter.new_cache())
    assert logits.shape == (1, 2, m.spec.vocab_size)
    assert torch.isfinite(logits).all() and torch.isfinite(h).all()
