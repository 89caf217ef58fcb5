"""MTP self-speculation: a DeepSeek-V3-style multi-token-prediction head
drafts from the target's own hidden states (counterpart of
ktransformers_tpu/engine/mtp.py).

MTP convention: at position i the head takes (h_i, emb(t_(i+1))), the
target's pre-final-norm hidden and the next token's embedding, projects
their normed concatenation through eh_proj, runs one decoder layer over its
own one-layer KV cache and predicts t_(i+2). Drafting chains the head's own
hidden output as the next h, so k drafts cost k one-layer steps. The verify
step is the target's, greedy and exact, so the tokens equal the target's
greedy ones whatever the head's weights.

Three loops, as in the JAX package:
- ``mtp_generate``: host-driven, the accept rule on the host;
- ``mtp_generate_single``: a whole round (MTP catch-up, k drafts, verify,
  accept) issued with no host read inside it: the drafts' argmax, the
  cumulative match and the gathers stay on the device, and the host reads
  one small tensor a round;
- ``mtp_generate_fused``: the same round as a draft part and a verify
  part, the next round issued before the last one's tokens are read: a
  non-blocking copy into pinned memory with a CUDA event, read a round
  late (a plain copy on the CPU).
PyTorch runs eagerly, so "one program" here means one stream of launches
with no host read; capturing it in a CUDA graph is later work.

The head's decoder layer runs ``models/model.decoder_layer`` with no
window, rope on, no rotation matrix (so MLA decode takes
``mla_decode_attention``) and the router on the post-attention state, as
the JAX package's ``mtp_layer_forward`` does. That is wrong for a
sliding-window, NoPE, early-router or hybrid layout, so such specs are
refused (``check_mtp_spec``) rather than computed differently from the
model's own layers.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ktransformers_tpu_torch.engine.cuda_graph import readback
from ktransformers_tpu_torch.engine.generate import GenerateConfig, Generator
from ktransformers_tpu_torch.engine.speculative import (
    SpecStats,
    _accept,
    _finished,
    _prompt,
    _set_len,
    check_capacity,
    check_greedy,
)
from ktransformers_tpu_torch.models.model import (
    KVCache,
    _q_positions,
    decoder_layer,
)
from ktransformers_tpu_torch.models.spec import ModelSpec
from ktransformers_tpu_torch.ops.linear import linear
from ktransformers_tpu_torch.ops.moe import MoEWeights
from ktransformers_tpu_torch.ops.norm import rms_norm
from ktransformers_tpu_torch.quant.formats import quantize
from ktransformers_tpu_torch.utils.device_prep import (
    params_to,
    prepare_params,
)

# rounds the fused loop keeps in flight before reading the oldest
FUSED_DEPTH = 2


def check_mtp_spec(spec: ModelSpec) -> None:
    """Raise ValueError, naming them, for layouts the MTP layer would
    compute differently from the model's own layers."""
    n = spec.num_layers
    bad = []
    if any(spec.layer_window(li) for li in range(n)):
        bad.append("sliding-window layers")
    if not all(spec.layer_uses_rope(li) for li in range(n)):
        bad.append("NoPE layers")
    if spec.moe is not None and spec.moe.early_router:
        bad.append("the early router")
    if spec.hybrid:
        bad.append("hybrid linear-attention layers")
    if bad:
        raise ValueError(f"MTP head: {', '.join(bad)} ({spec.model_type}) "
                         "are not computed by the MTP layer")


def mtp_layer_forward(mtp, main_params, spec: ModelSpec, tokens, h_prev,
                      cache: KVCache, rope_tables,
                      compute_dtype=torch.bfloat16,
                      compute_logits: bool = True):
    """tokens [B, S] (t_(i+1) at each position i), h_prev [B, S, H] (the
    target's hidden at i) over a one-layer cache, updated in place: returns
    (logits [B, S, V] or None, h_out [B, S, H], cache)."""
    s = tokens.shape[1]
    eps = spec.rms_norm_eps
    cos_t, sin_t = rope_tables
    pos = _q_positions(cache.lengths, s)
    rope_cs = (cos_t[pos], sin_t[pos])
    e = main_params["embed"][tokens].to(compute_dtype)
    x = torch.cat([rms_norm(e, mtp["enorm"], eps),
                   rms_norm(h_prev.to(compute_dtype), mtp["hnorm"], eps)],
                  dim=-1)
    x = linear(x, mtp["eh_proj"])
    x, buf_a, buf_b = decoder_layer(
        mtp["layer"], spec, x, (cache.bufs_a[0], cache.bufs_b[0]),
        cache.lengths, rope_cs)
    cache.bufs_a[0], cache.bufs_b[0] = buf_a, buf_b
    cache.lengths = cache.lengths + s
    if not compute_logits:
        # catch-up passes need no lm_head read
        return None, x, cache
    xf = rms_norm(x, mtp["final_norm"], eps)
    lm = main_params.get("lm_head")
    if lm is None:
        logits = xf @ main_params["embed"].to(xf.dtype).T
    else:
        logits = linear(xf, lm)
    return logits, x, cache


def _numpy_layer(spec: ModelSpec, li: int, q, rand, quant: str,
                 moe_quant: str) -> dict:
    """One decoder layer drawn in the JAX package's models/init.py
    _layer_params order (q(shape, kind) a QTensor, rand(shape, scale) a
    float tensor), so one numpy seed gives both packages the same head."""
    a = spec.attention
    d = spec.hidden_size

    def ones(n):
        return torch.ones(n, dtype=torch.float32)

    if a.kind == "mla":
        nope, dr, r, v = (a.qk_nope_head_dim, a.qk_rope_head_dim,
                          a.kv_lora_rank, a.v_head_dim)
        h = a.num_heads
        attn = {"kv_a": q((d, r + dr), quant), "kv_a_norm": ones(r)}
        attn["w_uk"] = rand((h, nope, r), 1.0 / np.sqrt(nope))
        attn["w_uv"] = rand((h, r, v), 1.0 / np.sqrt(r))
        attn["o_proj"] = q((h * v, d), quant)
        if a.q_lora_rank:
            attn["q_a"] = q((d, a.q_lora_rank), quant)
            attn["q_a_norm"] = ones(a.q_lora_rank)
            attn["q_b"] = q((a.q_lora_rank, h * (nope + dr)), quant)
        else:
            attn["q_proj"] = q((d, h * (nope + dr)), quant)
    else:
        h, hkv, hd = a.num_heads, a.num_kv_heads, a.head_dim
        attn = {"q_proj": q((d, h * hd * (2 if a.gated_output else 1)),
                            quant)}
        attn["k_proj"] = q((d, hkv * hd), quant)
        attn["v_proj"] = q((d, hkv * hd), quant)
        attn["o_proj"] = q((h * hd, d), quant)
        if a.attention_bias:
            attn["q_bias"] = rand((h * hd,), 0.01)
            attn["k_bias"] = rand((hkv * hd,), 0.01)
            attn["v_bias"] = rand((hkv * hd,), 0.01)
        if a.qk_norm:
            attn["q_norm"] = ones(hd)
            attn["k_norm"] = ones(hd)
    lp = {"input_norm": ones(d), "post_attn_norm": ones(d), "attn": attn}
    if spec.moe is not None and spec.moe.is_moe_layer(li):
        m = spec.moe
        f = m.moe_intermediate_size
        moe = {"router_w": rand((m.num_experts, d), 1.0 / np.sqrt(d))}
        gate_up = q((m.num_experts, d, 2 * f), moe_quant)
        moe["experts"] = MoEWeights(gate_up=gate_up,
                                    down=q((m.num_experts, f, d), moe_quant))
        if m.gate.has_correction_bias:
            moe["router_bias_corr"] = torch.zeros(m.num_experts)
        if m.shared_expert_intermediate_size:
            fs = m.shared_expert_intermediate_size
            sgu = q((d, 2 * fs), quant)
            moe["shared"] = {"gate_up": sgu, "down": q((fs, d), quant)}
            if m.shared_expert_gate:
                moe["shared_gate"] = rand((1, d), 1.0 / np.sqrt(d))
        lp["moe"] = moe
    else:
        f = spec.intermediate_size
        gu = q((d, 2 * f), quant)
        lp["mlp"] = {"gate_up": gu, "down": q((f, d), quant)}
    return lp


def init_mtp_synthetic(spec: ModelSpec, seed: int = 1, quant: str = "int8",
                       moe_quant: str | None = None,
                       dense_layer: bool = False, device="cuda"):
    """A random MTP head whose decoder layer mirrors the model's last layer
    (``dense_layer``: the first dense layer instead). Drawn from numpy in
    the JAX package's order and quantized by quant/formats.quantize (on
    ``device``), so on the CPU it is the JAX package's
    init_mtp_synthetic, bit for bit."""
    d = spec.hidden_size
    rng = np.random.default_rng(seed)
    dev = torch.device(device)

    # the products come out float64 under numpy's promotion and are made
    # float32, as jnp.asarray makes them in the JAX package
    def q(shape, kind):
        w = rng.standard_normal(shape).astype(np.float32) / np.sqrt(shape[-2])
        return quantize(torch.from_numpy(w.astype(np.float32)).to(dev), kind,
                        group_size=128)

    def rand(shape, sc=0.02):
        w = rng.standard_normal(shape).astype(np.float32) * sc
        return torch.from_numpy(w.astype(np.float32)).to(dev)

    li = spec.num_layers - 1
    if dense_layer:
        li = next((i for i in range(spec.num_layers)
                   if spec.moe is None or not spec.moe.is_moe_layer(i)), 0)
    layer = params_to(_numpy_layer(spec, li, q, rand, quant,
                                   moe_quant or quant), dev)
    ones = torch.ones(d, dtype=torch.float32, device=dev)
    return {"enorm": ones, "hnorm": ones.clone(),
            "eh_proj": q((2 * d, d), quant), "layer": layer,
            "final_norm": ones.clone()}


def mtp_params_from_provider(p, spec: ModelSpec, quant: str = "bf16",
                             group_size: int = 128, device="cuda"):
    """A DeepSeek-V3-style MTP head from a provider of HF names: the extra
    layer L = num_hidden_layers (model.layers.L.{enorm, hnorm, eh_proj,
    shared_head.norm} and its decoder layer). The decoder layer is built by
    models/loading.build_params as layer L of a spec one layer deeper, so
    it takes layer L's own kind (V3's MTP layer is a MoE layer; the JAX
    package renames it to layer 0 of a one-layer spec, which makes it
    dense wherever first_k_dense_replace > 0)."""
    from ktransformers_tpu_torch.models.loading import _t, _vec, build_params

    li = spec.num_layers
    base = f"model.layers.{li}"
    deeper = dataclasses.replace(spec, num_layers=li + 1)
    layer = build_params(p, deeper, quant=quant, group_size=group_size,
                         layer_indices=[li], include_head=False,
                         device=device)["layers"][0]
    return params_to({
        "enorm": _vec(p.get(f"{base}.enorm.weight")),
        "hnorm": _vec(p.get(f"{base}.hnorm.weight")),
        "eh_proj": quantize(torch.from_numpy(_t(p.get(
            f"{base}.eh_proj.weight"))), quant, group_size=group_size),
        "layer": layer,
        "final_norm": _vec(p.get(f"{base}.shared_head.norm.weight")),
    }, device)


def prepare_mtp_params(mtp, spec: ModelSpec):
    """The head's matmul weights prepared as the target's are
    (utils/device_prep.prepare_params: bf16 absorbed mats, the fused
    attention projection, the W4A8 repack), in place; returns the head."""
    one = dataclasses.replace(spec, num_layers=1)
    prepared = prepare_params({"layers": [mtp["layer"]],
                               "eh_proj": mtp["eh_proj"]}, one)
    mtp["layer"] = prepared["layers"][0]
    mtp["eh_proj"] = prepared["eh_proj"]
    return mtp


class MTPDrafter:
    """The MTP head over a target Generator: its prepared params and its
    one-layer caches."""

    def __init__(self, mtp_params, target: Generator):
        check_mtp_spec(target.spec)
        self.mtp = prepare_mtp_params(params_to(mtp_params, target.device),
                                      target.spec)
        self.t = target

    def new_cache(self) -> KVCache:
        one = dataclasses.replace(self.t.spec, num_layers=1)
        return KVCache.create(one, self.t.batch, self.t.max_len,
                              self.t.cache_dtype, self.t.device)

    @torch.no_grad()
    def step(self, tokens, h_prev, cache, compute_logits: bool = True):
        """mtp_layer_forward over the target's params and rope tables."""
        t = self.t
        return mtp_layer_forward(self.mtp, t.params, t.spec, tokens, h_prev,
                                 cache, t.rope_tables, t.compute_dtype,
                                 compute_logits)

    def drafts(self, m_cache, bonus, h_bonus, k: int):
        """k argmax-chained draft steps from the bonus token [B] and its
        hidden [B, 1, H]: (drafts [B, k], cache), on the device."""
        cur, h = bonus, h_bonus
        drafted = []
        for _ in range(k):
            dl, h, m_cache = self.step(cur[:, None], h, m_cache)
            cur = dl[:, -1].argmax(-1)
            drafted.append(cur)
        return torch.stack(drafted, dim=1), m_cache

    def catch_up(self, m_cache, t_prev, d_prev, last_prev, a_prev, th_prev):
        """Rewrite the head's rows T_prev .. T_prev + k from the last
        verify's hiddens th_prev [B, k+1, H] and its inputs' successors
        [d_prev | last_prev]; rows < T_prev + a_prev are right and kept,
        the rest is rewound."""
        m_cache.lengths = t_prev
        nxt = torch.cat([d_prev, last_prev[:, None]], dim=1)
        _, _, m_cache = self.step(nxt, th_prev, m_cache,
                                  compute_logits=False)
        m_cache.lengths = (t_prev + a_prev).to(torch.int32)
        return m_cache


def _prime(target: Generator, drafter: MTPDrafter, prompt, cfg):
    """Prompt prefill with hiddens (the Generator's chunks), the head's
    cache primed over positions [0, P-1): (bonus [B], h_bonus [B, 1, H],
    t_cache, m_cache, th [B, P, H])."""
    p = prompt.shape[1]
    t_cache = target.new_cache()
    hs = []
    for i in range(0, p, cfg.prefill_chunk):
        tl, t_cache, h = target._forward(prompt[:, i : i + cfg.prefill_chunk],
                                         t_cache, logits_last_only=True,
                                         return_hidden=True)
        hs.append(h)
    th = torch.cat(hs, dim=1)
    m_cache = drafter.new_cache()
    if p > 1:
        # position i consumes (h_i, t_(i+1)) for i in [0, P-2]
        _, _, m_cache = drafter.step(prompt[:, 1:], th[:, : p - 1], m_cache,
                                     compute_logits=False)
    return tl[:, -1].argmax(-1), th[:, -1:], t_cache, m_cache, th


def _verify(target: Generator, t_cache: KVCache, bonus, d, k: int):
    """One (k+1)-token target step over [bonus | drafts] and the accept
    rule, all on the device: (emitted [B, k+1] (accepted drafts, the next
    token, -1 after it), a [B], next bonus [B], its hidden [B, 1, H],
    hiddens [B, k+1, H], T [B] the length before the step, t_cache at
    length T + a + 1)."""
    t_start = t_cache.lengths
    inp = torch.cat([bonus[:, None], d], dim=1)
    tl, t_cache, th = target._forward(inp, t_cache, return_hidden=True)
    greedy = tl.argmax(-1)  # [B, k+1]
    match = (d == greedy[:, :k]).to(torch.int64)
    a = torch.cumprod(match, dim=1).sum(dim=1)  # [B] in [0, k]
    bonus_new = torch.gather(greedy, 1, a[:, None])[:, 0]
    j = torch.arange(k + 1, device=d.device)[None, :]
    d_pad = torch.nn.functional.pad(d, (0, 1))
    emitted = torch.where(
        j < a[:, None], d_pad,
        torch.where(j == a[:, None], bonus_new[:, None],
                    torch.full_like(d_pad, -1)))
    h_new = torch.gather(th, 1, a[:, None, None].expand(-1, 1, th.shape[-1]))
    t_cache.lengths = (t_start + a + 1).to(torch.int32)
    return emitted, a, bonus_new, h_new, th, t_start, t_cache


def _round_need(p: int, n: int, k: int, extra: int) -> int:
    """The cache positions a pipelined MTP loop may write: its first round
    always runs (at T = P), a later one starts at most at P + n - 2, and up
    to ``extra`` rounds issued after the last needed one advance k + 1
    each."""
    last = p + max(n - 2, 0)
    return last + k + 1 + min(extra, max(n - 1, 0)) * (k + 1)


def _resolve(emitted: np.ndarray, out: list, stats: SpecStats, k: int,
             cfg: GenerateConfig) -> bool:
    """Count one round read back as emitted [k+1] (row 0 of the batch) and
    append its tokens; True once generation is finished."""
    a = int((emitted >= 0).sum()) - 1
    stats.rounds += 1
    stats.drafted += k
    stats.accepted += a
    for tok in emitted[: a + 1]:
        out.append(int(tok))
        if _finished(out, cfg):
            return True
    return False


def mtp_generate(
    target: Generator,
    mtp_params,
    prompt_ids: list[int],
    cfg: GenerateConfig = GenerateConfig(),
    k: int = 3,
) -> tuple[list[int], SpecStats]:
    """Greedy self-speculative generation; the tokens equal the target's
    greedy ones. A round: k MTP draft steps, then one (k+1)-token target
    verify step that returns the hiddens for the next round."""
    check_greedy(cfg)
    p = len(prompt_ids)
    # the head's cache has the target's max_len and never writes further
    check_capacity(target, p + cfg.max_new_tokens + k - 1, "target", k)
    drafter = MTPDrafter(mtp_params, target)
    prompt = _prompt(prompt_ids, target.device)
    bonus, h_last, t_cache, m_cache, th = _prime(target, drafter, prompt,
                                                 cfg)
    out = [int(bonus[0])]
    stats = SpecStats()
    m_frontier = p - 1  # head positions consumed
    t_frontier = p

    def ids(toks):
        return torch.tensor([toks], dtype=torch.int64, device=target.device)

    while not _finished(out, cfg):
        all_tokens = list(prompt_ids) + out
        # catch the head's cache up to position t_frontier - 1 with the
        # (h_i, t_(i+1)) pairs of verified positions, from the hiddens of
        # the last verify (th spans its inputs)
        m_cache = _set_len(m_cache, m_frontier)
        off = t_frontier - th.shape[1]
        toks_catch = all_tokens[m_frontier + 1 : t_frontier]
        if toks_catch:
            hs = th[:, m_frontier - off : t_frontier - 1 - off]
            _, _, m_cache = drafter.step(ids(toks_catch), hs, m_cache)
            m_frontier += len(toks_catch)

        # draft k tokens, chaining the head's own hidden
        drafted = []
        h = h_last
        cur = all_tokens[-1]
        for _ in range(k):
            dl, h, m_cache = drafter.step(ids([cur]), h, m_cache)
            cur = int(dl[0, -1].argmax())
            drafted.append(cur)
        m_frontier += k  # provisional; rewound next round

        # verify
        t_cache = _set_len(t_cache, t_frontier)
        tl, t_cache, th = target._forward(
            ids(all_tokens[t_frontier:] + drafted), t_cache,
            return_hidden=True)
        greedy = tl[0].argmax(-1).tolist()
        accepted = _accept(drafted, greedy, k)
        stats.rounds += 1
        stats.drafted += k
        stats.accepted += accepted
        for tok in drafted[:accepted] + [greedy[accepted]]:
            out.append(tok)
            if _finished(out, cfg):
                break
        t_frontier += accepted + 1
        h_last = th[:, accepted : accepted + 1]
        m_frontier = min(m_frontier, t_frontier - 1)

    return out[: cfg.max_new_tokens], stats


def mtp_generate_single(
    target: Generator,
    mtp_params,
    prompt_ids: list[int],
    cfg: GenerateConfig = GenerateConfig(),
    k: int = 3,
) -> tuple[list[int], SpecStats]:
    """Greedy MTP self-speculation, a whole round (the head's catch-up over
    the last verify, k drafts, verify, accept) issued with no host read
    inside it; the host reads the round's emitted tokens (one [B, k+1]
    tensor) before the next. The tokens equal the target's greedy ones."""
    check_greedy(cfg)
    check_capacity(target, _round_need(len(prompt_ids), cfg.max_new_tokens,
                                       k, 0), "target", k)
    drafter = MTPDrafter(mtp_params, target)
    prompt = _prompt(prompt_ids, target.device)
    bonus, h_bonus, t_cache, m_cache, _ = _prime(target, drafter, prompt,
                                                 cfg)
    out = [int(bonus[0])]
    stats = SpecStats()
    prev = None
    done = False  # one round runs whatever the first token (as in JAX)
    while not done:
        if prev is not None:
            m_cache = drafter.catch_up(m_cache, *prev)
        d, m_cache = drafter.drafts(m_cache, bonus, h_bonus, k)
        emitted, a, bonus, h_bonus, th, t_start, t_cache = _verify(
            target, t_cache, bonus, d, k)
        prev = (t_start, d, bonus, a, th)
        done = _resolve(emitted[0].cpu().numpy(), out, stats, k, cfg)
    return out[: cfg.max_new_tokens], stats


def mtp_generate_fused(
    target: Generator,
    mtp_params,
    prompt_ids: list[int],
    cfg: GenerateConfig = GenerateConfig(),
    k: int = 3,
) -> tuple[list[int], SpecStats]:
    """Greedy MTP self-speculation with a round as two parts, drafts (the
    head's catch-up over the last verify, k argmax-chained one-layer
    steps) and verify + accept, issued back to back with no host read;
    the host reads each round's emitted tokens FUSED_DEPTH - 1 rounds late,
    so the next round is on the device meanwhile. The tokens equal the
    target's greedy ones.

    Positions, with T the verified length at a round's start and b0 the
    emitted but uncached bonus token at position T: the drafts write head
    rows T-1 .. T+k-2 (row T-1 from the target's hidden), the verify
    writes target rows T .. T+k and returns hiddens th; a = leading
    matches; the catch-up rewrites head rows T .. T+k from th, right for
    rows < T+a, exactly the rows kept after the rewind (head length T+a,
    target length T+a+1). A round issued past the end writes up to k + 1
    more rows, which the capacity check counts."""
    check_greedy(cfg)
    n = cfg.max_new_tokens
    check_capacity(target, _round_need(len(prompt_ids), n, k,
                                       FUSED_DEPTH - 1), "target", k)
    drafter = MTPDrafter(mtp_params, target)
    prompt = _prompt(prompt_ids, target.device)
    bonus, h_bonus, t_cache, m_cache, _ = _prime(target, drafter, prompt,
                                                 cfg)
    out = [int(bonus[0])]
    stats = SpecStats()

    def draft_fn(m_cache, bonus, h_bonus, prev):
        if prev is not None:
            m_cache = drafter.catch_up(m_cache, *prev)
        return drafter.drafts(m_cache, bonus, h_bonus, k)

    pending = []  # (host emitted, event) of issued rounds, oldest first
    done = False  # one round runs whatever the first token (as in JAX)
    issued = 0
    prev = None
    while not done:
        while len(pending) < FUSED_DEPTH and issued < n:
            d, m_cache = draft_fn(m_cache, bonus, h_bonus, prev)
            emitted, a, bonus, h_bonus, th, t_start, t_cache = _verify(
                target, t_cache, bonus, d, k)
            # the catch-up's last token column only writes head row T+k,
            # past the kept range (< T+a, a <= k): the next bonus will do
            prev = (t_start, d, bonus, a, th)
            pending.append(readback(emitted[0]))
            issued += 1
        if not pending:
            break
        (host,), event = pending.pop(0)
        if event is not None:
            event.synchronize()
        done = _resolve(host.numpy(), out, stats, k, cfg)
    return out[: cfg.max_new_tokens], stats
