"""Provider-driven params construction (counterpart of
ktransformers_tpu/models/loading.py): one function that makes the params
tree from a ``get(name) -> np.ndarray`` provider of HF-named tensors ([out,
in] for linear weights).

``build_params`` maps the HF names of the families this port runs
(DeepSeek-V2 / V3 MLA, with or without q_lora; Mixtral GQA; Qwen2-MoE
GQA with q / k / v biases, a shared expert and its sigmoid gate;
Qwen3-MoE GQA with per-head q / k norms; SmallThinker's
block_sparse_moe.primary_router and gate / up / down experts; Qwen3-Next's
GatedDeltaNet layers, their in_proj_qkvz / in_proj_ba columns permuted per
key head into [q | k | v | z] and [b | a], and its zero-centred RMSNorm
weights, +1 on every norm but the GatedDeltaNet's own) onto the port's
params tree.
Weights are quantized on the host with
quant/formats.quantize, where the JAX package quantizes them, so the codes
are bit-exact with its build_params; the finished tree moves to
``device`` once, at the end. With ``exact_gguf`` a provider that has
``get_exact`` (loader/providers.GGUFProvider) hands over its tensors' GGUF
codes and block scales as they are (quant/gguf_repack.py), as the JAX
package's build_params does. ``placement`` (placement/spec.py) gives each
module path its (quant, group_size) through ``quant_for``, as in the JAX
package; the paths are the params-tree paths ("layers.3.attn.kv_a",
"layers.3.moe.experts", "lm_head", ...).
"""

from __future__ import annotations

import numpy as np
import torch

from ktransformers_tpu_torch.models.spec import ModelSpec
from ktransformers_tpu_torch.ops.attention import absorb_kv_b_proj
from ktransformers_tpu_torch.ops.moe import MoEWeights
from ktransformers_tpu_torch.quant.formats import quantize
from ktransformers_tpu_torch.utils.device_prep import params_to


class WeightProvider:
    """get(name) -> np.ndarray in HF layout ([out, in] for linear
    weights); KeyError for a name it does not hold."""

    def get(self, name: str) -> np.ndarray:
        raise NotImplementedError

    def maybe(self, name: str):
        try:
            return self.get(name)
        except KeyError:
            return None


def _t(w: np.ndarray) -> np.ndarray:
    """[out, in] -> float32 [in, out]."""
    return np.ascontiguousarray(np.asarray(w, np.float32).T)


def _vec(arr) -> torch.Tensor:
    return torch.from_numpy(np.array(arr, np.float32))


def linear_attn_perms(la) -> tuple[np.ndarray, np.ndarray]:
    """Column permutations of in_proj_qkvz and in_proj_ba. The HF
    checkpoint interleaves their output features per key-head group ([q |
    k | v | z] and [b | a] blocks, transformers' Qwen3-Next
    fix_query_key_value_ordering); the permuted columns are [q_all | k_all
    | v_all | z_all] and [b_all | a_all], which ops/linear_attention.py
    splits contiguously."""
    hk, hv = la.num_k_heads, la.num_v_heads
    dk, dv = la.head_k_dim, la.head_v_dim
    r = hv // hk
    blk = 2 * dk + 2 * r * dv

    def seg(off: int, width: int, block: int) -> np.ndarray:
        return np.concatenate([np.arange(kh * block + off,
                                         kh * block + off + width)
                               for kh in range(hk)])

    qkvz = np.concatenate([seg(0, dk, blk), seg(dk, dk, blk),
                           seg(2 * dk, r * dv, blk),
                           seg(2 * dk + r * dv, r * dv, blk)])
    ba = np.concatenate([seg(0, r, 2 * r), seg(r, r, 2 * r)])
    return qkvz, ba


def build_params(p: WeightProvider, spec: ModelSpec, quant: str = "bf16",
                 moe_quant: str | None = None, group_size: int = 128,
                 placement=None,
                 exact_gguf: bool = False, layer_indices=None,
                 include_head: bool = True, device="cuda", progress=None):
    """The params tree from a provider, on ``device``. ``quant`` for
    attention, dense MLP, shared experts and lm_head, ``moe_quant``
    (default quant) for the routed experts; ``layer_indices`` (default
    all) with ``include_head=False`` builds a partial tree of those layers
    only, as in the JAX package; ``progress(msg)`` hears of each layer.
    ``exact_gguf``: take the provider's
    lossless repack (get_exact) of every tensor it has one for, the
    others (norms, router, embedding, F16 / F32 tensors) as above."""
    moe_quant = moe_quant or quant
    a = spec.attention
    get, maybe = p.get, p.maybe
    can_exact = exact_gguf and hasattr(p, "get_exact")
    if layer_indices is None:
        layer_indices = range(spec.num_layers)

    def pick(path: str, kind: str) -> tuple[str, int]:
        if placement is None:
            return kind, group_size
        return placement.quant_for(path)

    def q(arr: np.ndarray, kind: str, gs: int = group_size):
        return quantize(torch.from_numpy(arr), kind, group_size=gs)

    def exact(name: str):
        if not can_exact:
            return None
        try:
            return p.get_exact(name)
        except KeyError:
            return None

    def qx(name: str, path: str, kind: str = quant):
        qt = exact(name)
        return qt if qt is not None else q(_t(get(name)), *pick(path, kind))

    def qx_fused(gname: str, uname: str, fused_name: str, path: str):
        qt = exact(fused_name)
        if qt is not None:
            return qt
        return q(np.concatenate([_t(get(gname)), _t(get(uname))], 1),
                 *pick(path, quant))

    def vec(name: str) -> torch.Tensor:
        return _vec(get(name))

    # qwen3-next stores its RMSNorm weights zero-centred (output = normed *
    # (1 + w)); the +1 is folded in here, so the norm op stays one
    norm_off = 1.0 if spec.model_type == "qwen3_next" else 0.0

    def nvec(name: str) -> torch.Tensor:
        return vec(name) + norm_off

    layers = []
    for li in layer_indices:
        if progress:
            progress(f"layer {li}/{spec.num_layers}")
        pre = f"model.layers.{li}"
        lp = {
            "input_norm": nvec(f"{pre}.input_layernorm.weight"),
            "post_attn_norm": nvec(f"{pre}.post_attention_layernorm.weight"),
        }
        sa = f"{pre}.self_attn"
        if spec.layer_kind(li) == "linear":
            la_pre = f"{pre}.linear_attn"
            perm_qkvz, perm_ba = linear_attn_perms(spec.linear_attn)
            conv = np.asarray(get(f"{la_pre}.conv1d.weight"), np.float32)
            lk, lg = pick(f"layers.{li}.attn", quant)
            attn = {
                "in_proj_qkvz": q(np.ascontiguousarray(
                    _t(get(f"{la_pre}.in_proj_qkvz.weight"))[:, perm_qkvz]),
                    lk, lg),
                "in_proj_ba": q(np.ascontiguousarray(
                    _t(get(f"{la_pre}.in_proj_ba.weight"))[:, perm_ba]),
                    "bf16", lg),
                "conv_w": torch.from_numpy(np.ascontiguousarray(
                    conv[:, 0, :])),  # [C, 1, K] -> [C, K]
                "dt_bias": vec(f"{la_pre}.dt_bias"),
                "A_log": vec(f"{la_pre}.A_log"),
                # GatedDeltaNet's own gated norm is not zero-centred
                "norm_w": vec(f"{la_pre}.norm.weight"),
                "out_proj": q(_t(get(f"{la_pre}.out_proj.weight")), lk, lg),
            }
        elif a.kind == "mla":
            kv_b = torch.from_numpy(_t(get(f"{sa}.kv_b_proj.weight")))
            w_uk, w_uv = absorb_kv_b_proj(kv_b, a.num_heads,
                                          a.qk_nope_head_dim, a.v_head_dim)
            absorbed = torch.float32 if quant == "f32" else torch.bfloat16
            attn = {
                "kv_a": qx(f"{sa}.kv_a_proj_with_mqa.weight",
                           f"layers.{li}.attn.kv_a"),
                "kv_a_norm": vec(f"{sa}.kv_a_layernorm.weight"),
                "w_uk": w_uk.to(absorbed),
                "w_uv": w_uv.to(absorbed),
                "o_proj": qx(f"{sa}.o_proj.weight",
                             f"layers.{li}.attn.o_proj"),
            }
            if maybe(f"{sa}.kv_a_proj_with_mqa.bias") is not None:
                attn["kv_a_bias"] = vec(f"{sa}.kv_a_proj_with_mqa.bias")
            if a.q_lora_rank:
                attn["q_a"] = qx(f"{sa}.q_a_proj.weight",
                                 f"layers.{li}.attn.q_a")
                attn["q_a_norm"] = vec(f"{sa}.q_a_layernorm.weight")
                attn["q_b"] = qx(f"{sa}.q_b_proj.weight",
                                 f"layers.{li}.attn.q_b")
            else:
                attn["q_proj"] = qx(f"{sa}.q_proj.weight",
                                    f"layers.{li}.attn.q_proj")
        else:
            attn = {}
            for nm in ("q", "k", "v", "o"):
                attn[f"{nm}_proj"] = qx(f"{sa}.{nm}_proj.weight",
                                        f"layers.{li}.attn.{nm}_proj")
                bias = maybe(f"{sa}.{nm}_proj.bias")
                if bias is None:
                    continue
                if nm == "o":  # the JAX package reads no o_proj bias
                    raise NotImplementedError(
                        f"{sa}.o_proj.bias: an output projection bias is "
                        "not ported (nor read by the JAX package)")
                attn[f"{nm}_bias"] = _vec(bias)
            if a.qk_norm:
                attn["q_norm"] = nvec(f"{sa}.q_norm.weight")
                attn["k_norm"] = nvec(f"{sa}.k_norm.weight")
        lp["attn"] = attn

        mlp_pre = f"{pre}.mlp"
        if spec.moe is not None and spec.moe.is_moe_layer(li):
            m = spec.moe
            if maybe(f"{mlp_pre}.gate.weight") is None:
                mlp_pre = f"{pre}.block_sparse_moe"  # mixtral, smallthinker
            router = f"{mlp_pre}.gate.weight"
            if maybe(router) is None:
                router = f"{mlp_pre}.primary_router.weight"  # smallthinker
            moe = {"router_w": vec(router)}
            bias = maybe(f"{mlp_pre}.gate.e_score_correction_bias")
            if bias is not None:
                moe["router_bias_corr"] = _vec(bias)
            exact_gu = exact(f"{mlp_pre}.experts.gate_up_proj")
            exact_dn = exact(f"{mlp_pre}.experts.down_proj")
            stacked = None
            if exact_gu is None or exact_dn is None:
                stacked = maybe(f"{mlp_pre}.experts.gate_up_proj")
            if exact_gu is not None and exact_dn is not None:
                gus = dns = None
            elif stacked is not None:
                # pre-stacked [E, in, 2 * out] / down [E, inter, in]
                gus = np.asarray(stacked, np.float32)
                dns = np.asarray(get(f"{mlp_pre}.experts.down_proj"),
                                 np.float32)
            else:
                gus_list, dns_list = [], []
                for e in range(m.num_experts):
                    base = f"{mlp_pre}.experts.{e}"
                    if maybe(f"{base}.gate_proj.weight") is not None:
                        names = ("gate_proj", "up_proj", "down_proj")
                    elif maybe(f"{base}.w1.weight") is not None:
                        names = ("w1", "w3", "w2")  # mixtral
                    else:  # smallthinker
                        names = ("gate", "up", "down")
                    g, u, dn = (_t(get(f"{base}.{nm}.weight"))
                                for nm in names)
                    gus_list.append(np.concatenate([g, u], axis=1))
                    dns_list.append(dn)
                gus, dns = np.stack(gus_list), np.stack(dns_list)
                del gus_list, dns_list
            if gus is None:
                moe["experts"] = MoEWeights(gate_up=exact_gu, down=exact_dn)
            else:
                ek, eg = pick(f"layers.{li}.moe.experts", moe_quant)
                moe["experts"] = MoEWeights(gate_up=q(gus, ek, eg),
                                            down=q(dns, ek, eg))
            del gus, dns
            if m.shared_expert_intermediate_size:
                # deepseek's shared_experts, qwen2-moe's shared_expert
                base = f"{mlp_pre}.shared_experts"
                if maybe(f"{base}.gate_proj.weight") is None:
                    base = f"{mlp_pre}.shared_expert"
                # shared experts take the dense kind, as in the JAX package
                moe["shared"] = {
                    "gate_up": qx_fused(f"{base}.gate_proj.weight",
                                        f"{base}.up_proj.weight",
                                        f"{base}.gate_up_proj",
                                        f"layers.{li}.moe.shared"),
                    "down": qx(f"{base}.down_proj.weight",
                               f"layers.{li}.moe.shared"),
                }
                if m.shared_expert_gate:
                    # [1, hidden] as HF holds it (a GGUF file's
                    # ffn_gate_inp_shexp is one row of hidden values)
                    moe["shared_gate"] = vec(
                        f"{mlp_pre}.shared_expert_gate.weight").reshape(1, -1)
            lp["moe"] = moe
        elif (maybe(f"{mlp_pre}.gate_proj.weight") is None
              and maybe(f"{pre}.block_sparse_moe.gate.weight") is not None):
            # smallthinker's dense layers live under block_sparse_moe
            bsm = f"{pre}.block_sparse_moe"
            lp["mlp"] = {
                "gate_up": q(np.concatenate([_t(get(f"{bsm}.gate.weight")),
                                             _t(get(f"{bsm}.up.weight"))],
                                            1), *pick(f"layers.{li}.mlp",
                                                      quant)),
                "down": qx(f"{bsm}.down.weight", f"layers.{li}.mlp"),
            }
        else:
            lp["mlp"] = {
                "gate_up": qx_fused(f"{mlp_pre}.gate_proj.weight",
                                    f"{mlp_pre}.up_proj.weight",
                                    f"{mlp_pre}.gate_up_proj",
                                    f"layers.{li}.mlp"),
                "down": qx(f"{mlp_pre}.down_proj.weight", f"layers.{li}.mlp"),
            }
        layers.append(lp)

    params = {
        "embed": vec("model.embed_tokens.weight") if include_head else None,
        "layers": layers,
        "final_norm": nvec("model.norm.weight") if include_head else None,
    }
    if include_head and not spec.tie_word_embeddings:
        params["lm_head"] = qx("lm_head.weight", "lm_head")
    return params_to(params, device)
