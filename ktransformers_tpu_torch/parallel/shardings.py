"""Per-rank slices of parameters, caches and batches over the (dp, ep, tp)
mesh (counterpart of ktransformers_tpu/parallel/shardings.py).

The JAX package hands PartitionSpecs to GSPMD, which inserts the
collectives. Here each rank keeps its own slice and the layers sum and
gather themselves (parallel/collectives.py under a parallel_context):
- experts over ``ep``: rank i keeps slots [i * E/ep, (i + 1) * E/ep) and
  the whole logical_to_physical / expert_mask;
- column-parallel over ``tp`` (each rank its output columns): the query
  heads of the fused qkv_a (MLA without q-LoRA, with kv_a kept whole on
  every rank), q_b, the GQA fused qkv (its q heads, its k heads, its v
  heads), every gate_up (its columns of gate AND its columns of up: a
  contiguous half of [gate | up] would give one rank all gates, wrong
  numbers with no error) and lm_head (the logits gathered over tp);
- row-parallel over ``tp`` (each rank its input rows, the products summed
  over tp): o_proj and every down. A cut of K must keep whole scale
  groups (and a per-channel int4 weight, one group of all K packed across
  it, has none to keep): shard_params raises naming the tensor and its
  group count;
- w_uk / w_uv by head; norms, router, embedding and everything else
  whole.
``rank_spec`` is the spec each rank's forward runs with (its heads and
intermediate widths); the logits come back whole. Every cut weight is
checked by its kernel wrapper's own weight check, so a per-rank shape that
no kernel route takes raises here, never at the first call. Refused under
tp > 1: GatedDeltaNet layers, LoRA adapters (anywhere in a layer), an o_proj
bias, GQA KV heads or widths that do not divide by tp; under ep > 1: LoRA
factors on the routed experts. The two LoRA refusals match the JAX
package, which fails on both (their messages say how). ``cache_shardings``
cuts a cache for its rank (batch over dp; MLA's latent whole over tp; GQA
KV heads over tp) and ``batch_sharding`` is the rank's rows of a batch.
"""

from __future__ import annotations

import dataclasses

import torch

from ktransformers_tpu_torch.cache.paged import PagedKVCache
from ktransformers_tpu_torch.models.model import KVCache
from ktransformers_tpu_torch.models.spec import ModelSpec
from ktransformers_tpu_torch.ops.cuda.quant_matmul import KINDS, check_weight
from ktransformers_tpu_torch.ops.cuda.w4a8_matmul import check_w4a8_weight
from ktransformers_tpu_torch.ops.moe import MoEWeights
from ktransformers_tpu_torch.parallel.mesh import (
    AXIS_DP,
    AXIS_EP,
    AXIS_TP,
    Mesh,
)
from ktransformers_tpu_torch.quant.formats import (
    INT4_KINDS,
    QTensor,
    true_group_count,
)
from ktransformers_tpu_torch.quant.w4a8 import W4A8_KINDS


@dataclasses.dataclass(frozen=True)
class Cut:
    """What one rank keeps of a leaf: ``dims`` ((dim, ((lo, hi), ...)),
    ...), the ranges kept along each cut dim, concatenated in order. For a QTensor
    the dims are of the logical weight [(E,) K, N] (dim -2 = K rows, -1 =
    N columns)."""

    dims: tuple = ()


REPL = Cut()


def _part(n: int, parts: int, i: int, what: str) -> tuple:
    if n % parts:
        raise ValueError(f"{what}: {n} does not divide by {parts}")
    step = n // parts
    return (i * step, (i + 1) * step)


def _heads_cols(h0: int, h1: int, width: int, base: int = 0) -> tuple:
    return (base + h0 * width, base + h1 * width)


def _rank_heads(spec: ModelSpec, tp: int, i: int) -> tuple:
    a = spec.attention
    heads = _part(a.num_heads, tp, i, "attention heads over tp")
    kv = _part(a.num_kv_heads, tp, i, "GQA KV heads over tp") \
        if a.kind == "gqa" else None
    return heads, kv


def _attn_cuts(attn: dict, spec: ModelSpec, tp: int, i: int) -> dict:
    a = spec.attention
    (h0, h1), kv = _rank_heads(spec, tp, i)
    if "o_bias" in attn:
        # each rank's partial sum would add it once more
        raise NotImplementedError("an o_proj bias under tensor parallelism "
                                  "is not ported")
    cuts = {}
    if a.kind == "mla":
        qw = a.qk_nope_head_dim + a.qk_rope_head_dim
        qcols = _heads_cols(h0, h1, qw)
        rw = a.kv_lora_rank + a.qk_rope_head_dim
        for key in attn:
            if key in ("qkv_a", "qkv_a_bias"):
                dim = -1 if key == "qkv_a" else 0
                if a.q_lora_rank:
                    cuts[key] = REPL
                else:
                    q = a.num_heads * qw
                    cuts[key] = Cut(((dim, (qcols, (q, q + rw))),))
            elif key in ("q_proj", "q_b"):
                cuts[key] = Cut(((-1, (qcols,)),))
            elif key in ("w_uk", "w_uv"):
                cuts[key] = Cut(((0, ((h0, h1),)),))
            elif key == "o_proj":
                cuts[key] = Cut(((-2, (_heads_cols(h0, h1, a.v_head_dim),)),))
            else:
                cuts[key] = REPL
        return cuts
    d = a.head_dim
    qw = d * (2 if a.gated_output else 1)
    q = a.num_heads * qw
    kw = a.num_kv_heads * d
    qcols = _heads_cols(h0, h1, qw)
    kcols = _heads_cols(kv[0], kv[1], d, q)
    vcols = _heads_cols(kv[0], kv[1], d, q + kw)
    for key in attn:
        if key in ("qkv", "qkv_bias"):
            dim = -1 if key == "qkv" else 0
            cuts[key] = Cut(((dim, (qcols, kcols, vcols)),))
        elif key in ("q_proj", "q_bias"):
            cuts[key] = Cut(((-1 if key == "q_proj" else 0, (qcols,)),))
        elif key in ("k_proj", "v_proj", "k_bias", "v_bias"):
            cols = _heads_cols(kv[0], kv[1], d)
            cuts[key] = Cut(((-1 if key.endswith("proj") else 0, (cols,)),))
        elif key == "o_proj":
            cuts[key] = Cut(((-2, (_heads_cols(h0, h1, d),)),))
        else:
            cuts[key] = REPL
    return cuts


def _mlp_cuts(inter: int, tp: int, i: int, what: str,
              experts: tuple | None = None) -> tuple:
    """(gate_up cut, down cut) of a GLU MLP of width ``inter``: this rank's
    columns of gate and of up, its rows of down; ``experts`` the rank's
    expert range."""
    f0, f1 = _part(inter, tp, i, f"{what} intermediate {inter} over tp")
    lead = () if experts is None else ((0, (experts,)),)
    gu = Cut(lead + ((-1, ((f0, f1), (inter + f0, inter + f1))),)) \
        if tp > 1 else Cut(lead)
    dn = Cut(lead + ((-2, ((f0, f1),)),)) if tp > 1 else Cut(lead)
    return gu, dn


def _expert_cut(w: MoEWeights, mesh: Mesh, what: str) -> MoEWeights:
    """The Cuts of one layer's experts: this rank's E / ep of them, each
    cut over tp; the map and mask whole."""
    experts = _part(w.num_experts, mesh.size(AXIS_EP), mesh.index(AXIS_EP),
                    f"{what} {w.num_experts} experts over ep")
    gu, dn = _mlp_cuts(w.intermediate_size, mesh.size(AXIS_TP),
                       mesh.index(AXIS_TP), f"{what} experts", experts)
    return MoEWeights(
        gate_up=gu, down=dn,
        logical_to_physical=None if w.logical_to_physical is None else REPL,
        expert_mask=None if w.expert_mask is None else REPL)


def shard_experts(w: MoEWeights, mesh: Mesh) -> MoEWeights:
    """This rank's part of one layer's experts (as shard_params cuts them),
    on mesh.device."""
    return _apply(w, _expert_cut(w, mesh, "experts"), mesh, "experts")


def _lora_keys(node, path: str = "") -> list:
    """Paths of the "<key>_lora" adapters and expert LoRA factors in a
    layer's tree."""
    if isinstance(node, MoEWeights):
        return [f"{path}.lora"] if node.lora is not None else []
    if not isinstance(node, dict):
        return []
    out = []
    for k, v in node.items():
        sub = f"{path}.{k}".lstrip(".")
        out += [sub] if k.endswith("_lora") else _lora_keys(v, sub)
    return out


def param_shardings(params, spec: ModelSpec, mesh: Mesh):
    """A params-shaped tree of Cuts: what this rank of ``mesh`` keeps."""
    tp, ti = mesh.size(AXIS_TP), mesh.index(AXIS_TP)
    ep = mesh.size(AXIS_EP)
    layers = []
    for li, lp in enumerate(params["layers"]):
        if tp > 1:
            if spec.layer_kind(li) == "linear":
                raise NotImplementedError(
                    f"layer {li}: GatedDeltaNet layers under tensor "
                    "parallelism are not ported")
            lora = _lora_keys(lp)
            if lora:
                raise NotImplementedError(
                    f"layer {li}: LoRA adapters {lora} under tensor "
                    "parallelism are not ported; nor does the JAX package "
                    "run them: its parallel/shardings.py param_shardings "
                    "gives a '<key>_lora' dict one replicated spec, and "
                    "shard_params fails on any tree with LoRA leaves "
                    "(ValueError: Expected dict, got NamedSharding)")
        out = {k: REPL for k in lp}
        out["attn"] = (_attn_cuts(lp["attn"], spec, tp, ti) if tp > 1
                       else {k: REPL for k in lp["attn"]})
        if "moe" in lp:
            moe = {k: REPL for k in lp["moe"]}
            w = lp["moe"]["experts"]
            if not isinstance(w, MoEWeights):
                raise ValueError(f"layer {li}: offloaded experts are not "
                                 "sharded")
            if ep > 1 and w.lora is not None:
                raise NotImplementedError(
                    f"layer {li}: expert LoRA factors under expert "
                    "parallelism are not ported; nor does the JAX package "
                    "train them: its parallel/ep.py _expert_sharded_specs "
                    "builds MoEWeights without lora, so the factors enter "
                    "shard_map whole (TypeError: expected rhs group "
                    "dimension size to be ..., got ...)")
            moe["experts"] = _expert_cut(w, mesh, f"layer {li}:")
            sh = lp["moe"].get("shared")
            if sh is not None:
                gu, dn = _mlp_cuts(sh["gate_up"].out_features // 2, tp, ti,
                                   f"layer {li} shared expert")
                moe["shared"] = {k: {"gate_up": gu, "down": dn}.get(k, REPL)
                                 for k in sh}
            out["moe"] = moe
        elif "mlp" in lp:
            gu, dn = _mlp_cuts(lp["mlp"]["gate_up"].out_features // 2, tp, ti,
                               f"layer {li} MLP")
            out["mlp"] = {k: {"gate_up": gu, "down": dn}.get(k, REPL)
                          for k in lp["mlp"]}
        layers.append(out)
    cuts = {k: REPL for k in params}
    cuts["layers"] = layers
    if "lm_head" in params and tp > 1:
        v = _part(params["lm_head"].out_features, tp, ti, "lm_head columns")
        cuts["lm_head"] = Cut(((-1, (v,)),))
    return cuts


def _take(t: torch.Tensor, dim: int, ranges) -> torch.Tensor:
    return torch.cat([t.narrow(dim, lo, hi - lo) for lo, hi in ranges],
                     dim=dim)


def _cut_rows(qt: QTensor, ranges, what: str) -> QTensor:
    """K rows of a QTensor: whole scale groups (packed rows of the int4
    kinds, group-split within each group), or any rows of a per-channel
    weight whose codes are one a row."""
    k = qt.in_features
    gs = qt.group_size
    packed = qt.kind in INT4_KINDS
    if gs == 0 and not packed:
        return dataclasses.replace(qt, data=_take(qt.data, -2, ranges))
    g = gs or k
    ng = k // g
    if any(lo % g or hi % g for lo, hi in ranges):
        raise ValueError(
            f"{what}: a tensor-parallel cut of K={k} at rows "
            f"{list(ranges)} splits its scale groups ({ng} groups of {g}); "
            "the cut must keep whole groups")
    rows = [(lo // 2, hi // 2) for lo, hi in ranges] if packed else ranges
    groups = [(lo // g, hi // g) for lo, hi in ranges]
    pick = lambda t: None if t is None else _take(t, -2, groups)  # noqa: E731
    return dataclasses.replace(qt, data=_take(qt.data, -2, rows),
                               scales=pick(qt.scales), zeros=pick(qt.zeros))


def _cut_qtensor(qt: QTensor, cut: Cut, what: str) -> QTensor:
    ng = true_group_count(qt) if qt.scales is not None else 0
    if qt.scales is not None and qt.scales.shape[-2] > max(ng, 1):
        # padded scale rows (the JAX package's sublane padding): drop them
        qt = dataclasses.replace(
            qt, scales=qt.scales[..., :ng, :],
            zeros=None if qt.zeros is None else qt.zeros[..., :ng, :])
    for dim, ranges in cut.dims:
        if dim == -2:
            qt = _cut_rows(qt, ranges, what)
            continue
        pick = lambda t: None if t is None else _take(  # noqa: E731
            t, dim, ranges)
        qt = dataclasses.replace(qt, data=pick(qt.data),
                                 scales=pick(qt.scales), zeros=pick(qt.zeros))
    qt = dataclasses.replace(
        qt, data=qt.data.contiguous(),
        scales=None if qt.scales is None else qt.scales.contiguous(),
        zeros=None if qt.zeros is None else qt.zeros.contiguous())
    if cut.dims:
        _check_route(qt, what)
    return qt


def _check_route(qt: QTensor, what: str) -> None:
    """Raise unless the kernels take this (cut) weight: the W4A8 wrappers'
    check for the int4 kinds the W4A8 repack takes (repacked or not yet),
    quant_matmul's for its other kinds; the plain kinds take any shape."""
    ndim = qt.data.dim()
    if qt.kind in W4A8_KINDS:
        view = qt if qt.act_quant else dataclasses.replace(
            qt, data=qt.data.view(torch.int8), act_quant=True)
        check_w4a8_weight(view, ndim, what)
    elif qt.kind in KINDS:
        check_weight(qt, ndim, what)


def _apply(node, cut, mesh: Mesh, path: str):
    if cut is REPL and isinstance(node, (dict, list)):
        cut = ({k: REPL for k in node} if isinstance(node, dict)
               else [REPL] * len(node))
    if isinstance(node, QTensor):
        return _cut_qtensor(node, cut, path).to(mesh.device)
    if isinstance(node, MoEWeights):
        return MoEWeights(
            gate_up=_apply(node.gate_up, cut.gate_up, mesh,
                           f"{path}.gate_up"),
            down=_apply(node.down, cut.down, mesh, f"{path}.down"),
            lora=_apply(node.lora, REPL, mesh, f"{path}.lora"),
            logical_to_physical=None if node.logical_to_physical is None
            else node.logical_to_physical.to(mesh.device),
            expert_mask=None if node.expert_mask is None
            else node.expert_mask.to(mesh.device),
            n_shared_fused=node.n_shared_fused)
    if isinstance(node, dict):
        return {k: _apply(v, cut[k], mesh, f"{path}.{k}".lstrip("."))
                for k, v in node.items()}
    if isinstance(node, list):
        return [_apply(v, c, mesh, f"{path}.{i}")
                for i, (v, c) in enumerate(zip(node, cut))]
    if node is None:
        return None
    t = node
    for dim, ranges in cut.dims:
        t = _take(t, dim, ranges)
    return t.contiguous().to(mesh.device)


def shard_params(params, spec: ModelSpec, mesh: Mesh):
    """This rank's parameters (a new tree on mesh.device; the input is not
    changed), cut as param_shardings says. Run the forward with
    rank_spec(spec, mesh) under parallel_context(mesh)."""
    return _apply(params, param_shardings(params, spec, mesh), mesh, "")


def rank_spec(spec: ModelSpec, mesh: Mesh) -> ModelSpec:
    """The spec of one rank's forward: its query (and GQA KV) heads and its
    share of every intermediate width; vocabulary, experts and everything
    else global (the router and the gathered logits are whole)."""
    tp = mesh.size(AXIS_TP)
    if tp == 1:
        return spec
    a = spec.attention
    attn = dataclasses.replace(
        a, num_heads=a.num_heads // tp,
        num_kv_heads=a.num_kv_heads // tp if a.kind == "gqa"
        else a.num_kv_heads)
    moe = spec.moe
    if moe is not None:
        moe = dataclasses.replace(
            moe, moe_intermediate_size=moe.moe_intermediate_size // tp,
            shared_expert_intermediate_size=(
                moe.shared_expert_intermediate_size // tp))
    return dataclasses.replace(spec, attention=attn, moe=moe,
                               intermediate_size=spec.intermediate_size // tp)


def batch_sharding(mesh: Mesh, batch: int) -> slice:
    """This rank's rows of a batch of ``batch`` sequences (over dp)."""
    return slice(*_part(batch, mesh.size(AXIS_DP), mesh.index(AXIS_DP),
                        "batch over dp"))


def cache_shardings(cache, spec: ModelSpec, mesh: Mesh):
    """This rank's part of a cache made for the global spec: a KVCache's
    sequences over dp (its lengths with them); GQA KV heads over tp (MLA's
    latent cache has no heads and stays whole on every tp rank); a
    PagedKVCache's pools whole over dp (the page tables say which pages a
    rank's sequences use), GQA heads over tp. A new cache on mesh.device."""
    tp, ti = mesh.size(AXIS_TP), mesh.index(AXIS_TP)
    a = spec.attention
    heads = None
    if a.kind == "gqa" and tp > 1:
        heads = _part(a.num_kv_heads, tp, ti, "GQA KV heads over tp")
    dev = mesh.device

    def pool(t, li, lead_dp: bool):
        if lead_dp:
            t = t[batch_sharding(mesh, t.shape[0])]
        if li not in linear and heads is not None:
            t = t[:, :, heads[0]:heads[1]]
        return t.contiguous().to(dev)

    if isinstance(cache, KVCache):
        linear = {li for li in range(spec.num_layers)
                  if spec.layer_kind(li) == "linear"}
        if linear and tp > 1:
            raise NotImplementedError("GatedDeltaNet state under tensor "
                                      "parallelism is not ported")
        return KVCache(
            cache.lengths[batch_sharding(mesh, cache.lengths.shape[0])]
            .to(dev),
            [pool(t, li, True) for li, t in enumerate(cache.bufs_a)],
            [pool(t, li, True) for li, t in enumerate(cache.bufs_b)])
    if isinstance(cache, PagedKVCache):
        linear = set(cache.linear_layers)
        if tp > 1 and (linear or cache.planes(cache.paged_layers[0])):
            raise NotImplementedError(
                "GatedDeltaNet state and page summaries under tensor "
                "parallelism are not ported")
        return dataclasses.replace(
            cache,
            bufs_a=[pool(t, li, False) for li, t in enumerate(cache.bufs_a)],
            bufs_b=[pool(t, li, False) for li, t in enumerate(cache.bufs_b)])
    raise TypeError(f"cache_shardings: {type(cache).__name__}")
