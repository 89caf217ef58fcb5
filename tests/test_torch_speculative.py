"""The port's speculation (engine/speculative.py, engine/draft_spec.py,
engine/mtp.py) against the JAX package's and against the port's own
greedy Generator: the counterparts of tests/test_speculative.py and
test_draft_spec.py, and what the three have in common (end of sequence,
capacity, refusals, the chat front door); the MTP head's own tests are in
tests/test_torch_mtp.py, on this module's models.

Both packages get the same numpy-seeded weights (the JAX package's
init_params at "bf16", prepared by its Generator, carried across with
convert.params_from_jax; MTP heads with convert.mtp_params_from_jax) and
compute in float32 on the CPU, so greedy tokens agree exactly and the
acceptance statistics too. Tolerances: forward(return_hidden=True) and
mtp_layer_forward within 2e-4 of the largest value.

The draft of the parity cases is the target with seeded noise of one
standard deviation on its lm_head, whose drafts the target accepts in part;
the MTP heads are random (seed 7).

A reference hazard (ROADMAP Queue 3): the JAX package runs speculation in
a cache just long enough for plain generation and its clamped cache write
overwrites valid rows; the port checks capacity before the first step. The
JAX tokens at max_len = P + max_new_tokens are recorded as differing from
greedy.
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
from ktransformers_tpu_torch.engine.draft_spec import draft_generate
from ktransformers_tpu_torch.engine.generate import GenerateConfig, Generator
from ktransformers_tpu_torch.engine.sampler import SamplingConfig
from ktransformers_tpu_torch.engine.speculative import speculative_generate
from ktransformers_tpu_torch.models.model import KVCache, forward
from ktransformers_tpu_torch.models.spec import spec_from_hf_config

from tests.test_generate import TINY_DS
from tests.test_serving import TINY_GQA
from tests.test_torch_model import one_torch_thread  # noqa: F401 (fixture)

CFGS = {"mla": TINY_DS, "gqa": TINY_GQA}
PROMPT = list(range(3, 11))
NEW = 12
MAX_LEN = 96
TOL = 2e-4
F32 = dict(cache_dtype=torch.float32, compute_dtype=torch.float32,
           device="cpu")
FNS = ("speculative", "draft", "mtp", "mtp_single", "mtp_fused")


def _jax_fn(name):
    from ktransformers_tpu.engine import mtp as jmtp
    from ktransformers_tpu.engine.draft_spec import (
        draft_generate as j_draft_generate,
    )
    from ktransformers_tpu.engine.speculative import (
        speculative_generate as j_speculative_generate,
    )

    return {"speculative": j_speculative_generate,
            "draft": j_draft_generate, "mtp": jmtp.mtp_generate,
            "mtp_single": jmtp.mtp_generate_single,
            "mtp_fused": jmtp.mtp_generate_fused}[name]


PORT_FNS = {"speculative": speculative_generate, "draft": draft_generate,
            "mtp": tmtp.mtp_generate,
            "mtp_single": tmtp.mtp_generate_single,
            "mtp_fused": tmtp.mtp_generate_fused}


def _jgen(jspec, params, max_len=MAX_LEN):
    from ktransformers_tpu.engine.generate import Generator as JGenerator

    return JGenerator(params, jspec, max_len=max_len, batch=1,
                      cache_dtype=jnp.float32, compute_dtype=jnp.float32)


def _jparams(jspec, seed=0):
    """init_params at "bf16" with the transforms the port's prepare_params
    applies too (bf16 absorbed mats, the fused projection)."""
    from ktransformers_tpu.models.init import init_params
    from ktransformers_tpu.utils.device_prep import prepare_params

    return prepare_params(init_params(jspec, seed=seed, quant="bf16"), True,
                          jspec)


def _port(jgen, spec, max_len=MAX_LEN):
    return Generator(params_from_jax(jax.device_get(jgen.params), spec,
                                     "cpu"), spec, max_len=max_len, **F32)


_MODELS = {}


def models(arch):
    """Both packages' target, noisy-head draft and MTP head for arch (made
    once: the JAX steps compile once per shape on a Generator)."""
    if arch not in _MODELS:
        from ktransformers_tpu.engine.mtp import init_mtp_synthetic
        from ktransformers_tpu.models.spec import spec_from_hf_config as js
        from ktransformers_tpu.utils.device_prep import prepare_params

        jspec = js(dict(CFGS[arch]))
        spec = spec_from_hf_config(dict(CFGS[arch]))
        jt = _jgen(jspec, _jparams(jspec))
        lm = jt.params["lm_head"]
        w = np.asarray(lm.data, np.float32)
        noise = np.random.default_rng(0).standard_normal(w.shape)
        noisy = jnp.asarray((w + noise * w.std()).astype(np.float32),
                            lm.data.dtype)
        jd = _jgen(jspec, {**jt.params,
                           "lm_head": dataclasses.replace(lm, data=noisy)})
        # the head prepared as the port's MTPDrafter prepares its own
        jm = init_mtp_synthetic(jspec, seed=7, quant="bf16")
        jm["layer"] = prepare_params(
            {"layers": [jm["layer"]]}, True,
            dataclasses.replace(jspec, num_layers=1))["layers"][0]
        _MODELS[arch] = types.SimpleNamespace(
            jspec=jspec, spec=spec, jt=jt, jd=jd, jm=jm,
            t=_port(jt, spec), d=_port(jd, spec),
            m=mtp_params_from_jax(jax.device_get(jm), spec, "cpu"))
    return _MODELS[arch]


def _cfg(n=NEW, **kw):
    return GenerateConfig(max_new_tokens=n, **kw)


def _second(m, name, jax_side):
    if name in ("speculative", "draft"):
        return m.jd if jax_side else m.d
    return m.jm if jax_side else m.m


_GREEDY = {}


def greedy(arch, n=NEW, prompt=tuple(PROMPT)):
    key = (arch, n, prompt)
    if key not in _GREEDY:
        _GREEDY[key] = models(arch).t.generate(list(prompt), _cfg(n))[0]
    return _GREEDY[key]


def test_greedy_matches_jax():
    for arch in CFGS:
        m = models(arch)
        assert greedy(arch) == m.jt.generate([PROMPT], _cfg())[0]


@pytest.mark.parametrize("arch", sorted(CFGS))
def test_forward_return_hidden_matches_jax(arch):
    from ktransformers_tpu.models.model import KVCache as JKVCache
    from ktransformers_tpu.models.model import forward as jforward

    m = models(arch)
    toks = np.random.default_rng(3).integers(0, 96, (2, 9))
    jc = JKVCache.create(m.jspec, 2, 16, dtype=jnp.float32)
    jl, _, jh = jax.jit(lambda p, t, c: jforward(
        p, m.jspec, t, c, compute_dtype=jnp.float32, return_hidden=True))(
        m.jt.params, jnp.asarray(toks, jnp.int32), jc)
    cache = KVCache.create(m.spec, 2, 16, torch.float32, "cpu")
    logits, cache, hidden = forward(
        m.t.params, m.spec, torch.as_tensor(toks), cache,
        compute_dtype=torch.float32, return_hidden=True)
    assert hidden.shape == (2, 9, m.spec.hidden_size)
    assert int(cache.lengths[0]) == 9
    for got, want in ((logits, jl), (hidden, jh)):
        want = np.asarray(want)
        err = np.abs(got.numpy() - want).max() / np.abs(want).max()
        assert err <= TOL, err
    # off by default: the two-value return of every existing caller
    cache = KVCache.create(m.spec, 2, 16, torch.float32, "cpu")
    assert len(forward(m.t.params, m.spec, torch.as_tensor(toks), cache,
                       compute_dtype=torch.float32)) == 2


_JAX_RUNS = {}


def jax_run(name, arch, k):
    key = (name, arch, k)
    if key not in _JAX_RUNS:
        m = models(arch)
        _JAX_RUNS[key] = _jax_fn(name)(m.jt, _second(m, name, True), PROMPT,
                                       _cfg(), k=k)
    return _JAX_RUNS[key]


def check_parity(name, arch, k):
    """The function's tokens are the port's greedy tokens and the JAX
    function's, and its rounds / drafted / accepted counts are JAX's."""
    m = models(arch)
    got, stats = PORT_FNS[name](m.t, _second(m, name, False), PROMPT, _cfg(),
                                k=k)
    want, jstats = jax_run(name, arch, k)
    assert got == greedy(arch) == list(want)
    assert (stats.rounds, stats.drafted, stats.accepted) == (
        jstats.rounds, jstats.drafted, jstats.accepted)
    assert stats.drafted == stats.rounds * k


@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("arch", sorted(CFGS))
@pytest.mark.parametrize("name", ["speculative", "draft"])
def test_speculation_matches_greedy_and_jax(name, arch, k):
    check_parity(name, arch, k)


@pytest.mark.parametrize("arch", sorted(CFGS))
def test_noisy_draft_accepts_some(arch):
    """Not vacuous: the noisy draft's rounds accept some drafts and reject
    others."""
    m = models(arch)
    _, stats = speculative_generate(m.t, m.d, PROMPT, _cfg(), k=3)
    assert 0 < stats.accepted < stats.drafted


@pytest.mark.parametrize("name", ["speculative", "draft"])
def test_same_model_draft_accepts_everything(name):
    m = models("mla")
    twin = Generator(m.t.params, m.spec, max_len=MAX_LEN, **F32)
    out, stats = PORT_FNS[name](m.t, twin, PROMPT, _cfg(), k=3)
    assert out == greedy("mla")
    assert stats.acceptance_rate > 0.99


def test_adversarial_draft_stays_exact():
    """A differently seeded draft model: the target's greedy tokens all
    the same, at any k."""
    m = models("mla")
    bad = _port(_jgen(m.jspec, _jparams(m.jspec, seed=123)), m.spec)
    for fn in (speculative_generate, draft_generate):
        for k in (2, 4):
            out, stats = fn(m.t, bad, PROMPT, _cfg(), k=k)
            assert out == greedy("mla") and stats.rounds >= 1


@pytest.mark.parametrize("name", FNS)
def test_eos_stops(name):
    m = models("mla")
    free = greedy("mla")
    i, eos = next((i, t) for i, t in enumerate(free) if t not in free[:i]
                  and i >= 2)
    out, _ = PORT_FNS[name](m.t, _second(m, name, False), PROMPT,
                            _cfg(eos_token_id=eos), k=3)
    assert out == free[: i + 1] and out[-1] == eos


NEED = {"speculative": lambda p, n, k: (p + n + k - 1, p + n + k - 1),
        "draft": lambda p, n, k: (p + n + k - 1, p + n + k - 2),
        "mtp": lambda p, n, k: (p + n + k - 1, None),
        "mtp_single": lambda p, n, k: (p + n + k - 1, None),
        "mtp_fused": lambda p, n, k: (p + n + 2 * k, None)}


@pytest.mark.parametrize("name", FNS)
def test_capacity_checked_before_the_first_step(name):
    """A cache one row short of what the last round writes
    raises, naming the max_len it needs; one exactly long enough runs and
    gives the greedy tokens."""
    m = models("mla")
    p, n, k = len(PROMPT), NEW, 3
    t_need, d_need = NEED[name](p, n, k)

    def gens(t_len, d_len):
        t = Generator(m.t.params, m.spec, max_len=t_len, **F32)
        if d_need is None:
            return t, m.m
        d = Generator(m.d.params, m.spec, max_len=d_len, **F32)
        return t, d

    fn = PORT_FNS[name]
    with pytest.raises(ValueError, match=f"max_len >= {t_need}"):
        fn(*gens(t_need - 1, d_need or 0), PROMPT, _cfg(), k=k)
    if d_need is not None:
        with pytest.raises(ValueError, match=f"draft.*max_len >= {d_need}"):
            fn(*gens(t_need, d_need - 1), PROMPT, _cfg(), k=k)
    out, _ = fn(*gens(t_need, d_need or 0), PROMPT, _cfg(), k=k)
    assert out == greedy("mla")


def test_jax_overwrites_rows_in_a_tight_cache():
    """Recorded, not a port behaviour: the JAX speculative_generate in a
    cache of exactly prompt + max_new_tokens (P = 10, 12 tokens, k = 4)
    writes past it, its clamped write overwrites valid rows and its tokens
    leave greedy; at max_len 96 they are greedy."""
    m = models("mla")
    prompt = list(range(10))
    tight = _jgen(m.jspec, m.jt.params, 22)
    draft = _jgen(m.jspec, m.jt.params, 22)
    j_spec_gen = _jax_fn("speculative")
    got, _ = j_spec_gen(tight, draft, prompt, _cfg(), k=4)
    ref = greedy("mla", prompt=tuple(prompt))
    assert ref == m.jt.generate([prompt], _cfg())[0]
    assert list(got) != ref
    roomy, _ = j_spec_gen(m.jt, _jgen(m.jspec, m.jt.params), prompt, _cfg(),
                          k=4)
    assert list(roomy) == ref
    with pytest.raises(ValueError, match="max_len >= 25"):
        speculative_generate(Generator(m.t.params, m.spec, 22, **F32),
                             Generator(m.t.params, m.spec, 22, **F32),
                             prompt, _cfg(), k=4)


def test_refusals():
    m = models("mla")
    hot = _cfg(sampling=SamplingConfig(temperature=0.7))
    for name in FNS:
        with pytest.raises(ValueError, match="greedy"):
            PORT_FNS[name](m.t, _second(m, name, False), PROMPT, hot, k=2)
    small = Generator(models("gqa").t.params, models("gqa").spec,
                      max_len=MAX_LEN, **F32)
    small.spec = dataclasses.replace(small.spec, vocab_size=95)
    with pytest.raises(ValueError, match="vocabulary"):
        draft_generate(m.t, small, PROMPT, _cfg(), k=2)


def _packed_dir(path, seed: int) -> str:
    """TINY_DS as a packed directory (save_params and its config.json) of
    the port's synthetic float weights."""
    import json

    from ktransformers_tpu_torch.models.checkpoint import save_params
    from ktransformers_tpu_torch.models.init import init_params_synthetic

    spec = spec_from_hf_config(dict(TINY_DS))
    save_params(init_params_synthetic(spec, seed=seed, quant="bf16",
                                      dtype=torch.float32, device="cpu"),
                str(path))
    (path / "config.json").write_text(json.dumps(TINY_DS))
    return str(path)


def test_chat_with_a_speculative_model(tmp_path, monkeypatch, capsys):
    """chat --speculative-model builds the draft Generator, and its greedy
    turns print what plain greedy chat prints, with the model itself or
    another one as the draft."""
    import io

    from ktransformers_tpu_torch.cli.main import main

    target = _packed_dir(tmp_path / "target", 3)
    other = _packed_dir(tmp_path / "draft", 4)
    args = ["chat", target, "--device", "cpu", "--tokenizer", "ids",
            "--temperature", "0", "--max-new-tokens", "6", "--max-len", "64"]
    outs = []
    for extra in ([], ["--speculative-model", target],
                  ["--speculative-model", other]):
        monkeypatch.setattr("sys.stdin", io.StringIO("5 9 17 33\n"))
        assert main(args + extra) == 0
        outs.append(capsys.readouterr().out)
    assert outs[0] == outs[1] == outs[2]
    assert len(outs[0].split("you>")[1].split()) >= 6
