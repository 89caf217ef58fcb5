"""Pipeline parallelism: the GPipe schedule over a ``pp`` axis of ranks
(counterpart of ktransformers_tpu/parallel/pp.py).

The JAX package stacks each stage's layers on a leading axis sharded over
pp and runs the schedule as one lax.scan inside shard_map; jax.grad
through its ppermute is the backward pipeline. Here rank s of the axis
keeps stage s's layers as a list (stack_stage_params checks and cuts them,
place_stages keeps the rank's own) and runs the ticks itself:
- pipeline_apply: M microbatches through S stages in M + S - 1 ticks. At
  tick t stage s computes microbatch t - s where 0 <= t - s < M (stage 0
  reads it from x_mb, every other stage what the previous one sent), an
  idle tick gives zeros, and after every tick but the last each rank sends
  its activation to the next stage and receives the previous stage's in
  one paired exchange (collectives.ring_shift). The last stage's outputs
  are summed over pp (the other ranks hold zeros), so every rank returns
  all M of them.
- its gradient is one torch.autograd.Function whose backward runs the
  ticks in reverse: a rank receives its output's cotangent from the next
  stage (the last stage takes the returned outputs' cotangent, which every
  rank holds: it enters once, not S times), back-propagates through the
  stage's graph kept from the forward and sends its input's cotangent to
  the previous stage in the same paired exchange. The tensors of the
  stage's layers that require a gradient get theirs on their own rank;
  x_mb's is summed over pp (stage 0 alone reads it), as shard_map sums a
  replicated input's; ``extras`` get none.
- pipeline_llm_forward: the embedding, the pipelined decoder layers
  (models/model.py decoder_layer, kind "full", over a fresh cache of the
  microbatch's length each call, so only activations cross stages), the
  final norm and the lm_head on every rank.

make_pp_mesh makes the whole world one pipeline, rank s being stage s.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from ktransformers_tpu_torch.models.model import decoder_layer, lm_head_logits
from ktransformers_tpu_torch.models.spec import ModelSpec
from ktransformers_tpu_torch.ops.norm import rms_norm
from ktransformers_tpu_torch.ops.rope import precompute_rope_tables
from ktransformers_tpu_torch.parallel.collectives import (
    all_reduce,
    ring_shift,
)
from ktransformers_tpu_torch.parallel.mesh import Mesh, card_device
from ktransformers_tpu_torch.quant.formats import QTensor
from ktransformers_tpu_torch.utils.device_prep import params_to

AXIS_PP = "pp"


def make_pp_mesh(device=None) -> Mesh:
    """This rank's pipeline axis: every rank of the world, rank r being
    stage r. ``device``: where this rank computes (default: cuda; with no
    card, card_device raises)."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    if device is None:
        device = card_device()
    group = dist.new_group(list(range(world))) if world > 1 else None
    return Mesh({AXIS_PP: world}, {AXIS_PP: rank}, {AXIS_PP: group}, device)


def _structure(node, path: str):
    """(path, what) of every node of a layer tree: a container's keys or
    length, an array's (tensor's) shape and dtype, a dataclass's fields
    (a QTensor's), any other value itself."""
    if isinstance(node, dict):
        yield path, ("dict", tuple(node))
        for k, v in node.items():
            yield from _structure(v, f"{path}.{k}")
    elif isinstance(node, (list, tuple)):
        yield path, (type(node).__name__, len(node))
        for i, v in enumerate(node):
            yield from _structure(v, f"{path}.{i}")
    elif isinstance(node, torch.Tensor) or hasattr(node, "__array__"):
        yield path, ("array", tuple(node.shape), str(node.dtype))
    elif dataclasses.is_dataclass(node) and not isinstance(node, type):
        yield path, (type(node).__name__,)
        for f in dataclasses.fields(node):
            yield from _structure(getattr(node, f.name), f"{path}.{f.name}")
    else:
        yield path, node


def stack_stage_params(layer_params: list, num_stages: int) -> list:
    """The L layers as S = num_stages lists of L / S consecutive layers
    (stage s holds layers [s L/S, (s + 1) L/S)). L must divide by S, and
    every layer must have the structure of layer 0 (the JAX package stacks
    them on one axis: the same tree, shapes and dtypes)."""
    n = len(layer_params)
    if n % num_stages:
        raise ValueError(
            f"{n} layers not divisible into {num_stages} pipeline stages")
    if n:
        first = list(_structure(layer_params[0], ""))
        for i, lp in enumerate(layer_params[1:], 1):
            other = list(_structure(lp, ""))
            if other != first:
                where = next((a[0] for a, b in zip(first, other) if a != b),
                             "its leaf count")
                raise ValueError(
                    f"pipeline stages need layers of one structure: layer "
                    f"{i} differs from layer 0 at {where or 'its root'}")
    per = n // num_stages
    return [list(layer_params[s * per:(s + 1) * per])
            for s in range(num_stages)]


def place_stages(stages: list, mesh: Mesh) -> list:
    """This rank's stage of stack_stage_params' lists, on mesh.device (the
    other stages stay where they are: the rank keeps none of them)."""
    if len(stages) != mesh.size(AXIS_PP):
        raise ValueError(f"{len(stages)} stages on a pp axis of "
                         f"{mesh.size(AXIS_PP)} ranks")
    return [params_to(lp, mesh.device) for lp in stages[mesh.index(AXIS_PP)]]


def _map_tensors(fn, node):
    """node with fn applied to every tensor (dicts, lists, tuples and
    dataclasses walked; a QTensor's codes never need a gradient)."""
    if isinstance(node, torch.Tensor):
        return fn(node)
    if isinstance(node, dict):
        return {k: _map_tensors(fn, v) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return type(node)(_map_tensors(fn, v) for v in node)
    if dataclasses.is_dataclass(node) and not isinstance(
            node, (type, QTensor)):
        return dataclasses.replace(node, **{
            f.name: _map_tensors(fn, getattr(node, f.name))
            for f in dataclasses.fields(node)})
    return node


@dataclasses.dataclass
class _Schedule:
    """One pipeline_apply call: the layer function, this rank's layers (its
    trainable tensors replaced by ``aliases``: detached tensors on the same
    storage, the roots of the stage graphs), the mesh and the extras."""

    layer_fn: object
    layers: list
    mesh: Mesh
    extras: object
    aliases: list

    def stage(self, x):
        for lp in self.layers:
            x = self.layer_fn(lp, x, self.extras)
        return x

    def forward(self, x_mb: torch.Tensor, keep: bool):
        """(outputs [M, ...] on every rank, {tick: (stage input, stage
        output)} graphs of this rank's active ticks where ``keep``)."""
        n, s = self.mesh.size(AXIS_PP), self.mesh.index(AXIS_PP)
        m = x_mb.shape[0]
        ticks = m + n - 1
        zero = torch.zeros_like(x_mb[0])
        outs = torch.zeros_like(x_mb)
        recv, kept = zero, {}
        for t in range(ticks):
            y = zero
            if 0 <= t - s < m:
                x_in = x_mb[t] if s == 0 else recv
                if keep:
                    with torch.enable_grad():
                        x_in = x_in.detach().requires_grad_(True)
                        y = self.stage(x_in)
                    kept[t] = (x_in, y)
                    y = y.detach()
                else:
                    y = self.stage(x_in)
                if s == n - 1:
                    outs[t - s] = y
            if t < ticks - 1:
                recv = ring_shift(y, self.mesh, AXIS_PP)
        return all_reduce(outs, self.mesh, AXIS_PP), kept

    def backward(self, kept: dict, d_out: torch.Tensor, m: int,
                 x_grad: bool):
        """(gradient of x_mb or None, gradients of the aliases) from the
        outputs' cotangent d_out, the ticks in reverse."""
        n, s = self.mesh.size(AXIS_PP), self.mesh.index(AXIS_PP)
        ticks = m + n - 1
        zero = torch.zeros_like(d_out[0])
        d_x = torch.zeros_like(d_out) if x_grad else None
        grads = [None] * len(self.aliases)
        d_recv = zero  # cotangent of what this rank received at tick t + 1
        for t in reversed(range(ticks)):
            d_y = zero
            if t < ticks - 1:
                d_y = ring_shift(d_recv, self.mesh, AXIS_PP, step=-1)
            d_recv = zero
            if t not in kept:
                continue
            if s == n - 1:
                d_y = d_y + d_out[t - s]
            x_in, y = kept.pop(t)
            # the gradient of <y, d_y> is d_y's vector-Jacobian product, bit
            # for bit; grad(y, ..., grad_outputs) would do the same, but its
            # first call in a process imports sympy (seconds, once a rank)
            with torch.enable_grad():
                dot = (y * d_y).sum()
            got = torch.autograd.grad(dot, [x_in] + self.aliases,
                                      allow_unused=True)
            for i, g in enumerate(got[1:]):
                if g is not None:
                    grads[i] = g if grads[i] is None else grads[i] + g
            if got[0] is not None:
                if s > 0:
                    d_recv = got[0]
                elif x_grad:
                    d_x[t] = got[0]
        if x_grad:
            d_x = all_reduce(d_x, self.mesh, AXIS_PP)
        return d_x, grads


class _Pipeline(torch.autograd.Function):
    @staticmethod
    def forward(ctx, run: _Schedule, x_mb, *leaves):
        out, kept = run.forward(x_mb, keep=True)
        ctx.run, ctx.kept, ctx.m = run, kept, x_mb.shape[0]
        return out

    @staticmethod
    def backward(ctx, d_out):
        d_x, grads = ctx.run.backward(ctx.kept, d_out.contiguous(), ctx.m,
                                      ctx.needs_input_grad[1])
        ctx.kept = None
        return (None, d_x, *grads)


def pipeline_apply(layer_fn, stage_params: list, x_mb: torch.Tensor,
                   mesh: Mesh, *, extras=None) -> torch.Tensor:
    """x_mb [M, mb, ...] through every stage's layers, GPipe schedule (see
    the module docstring). ``layer_fn(one_layer_params, x, extras) -> x``
    applies one layer; ``stage_params`` is this rank's list of layers
    (place_stages). Returns [M, mb, ...] on every rank of the pipeline."""
    layers = list(stage_params)
    leaves, seen = [], set()

    def collect(t):
        if t.requires_grad and id(t) not in seen:
            seen.add(id(t))
            leaves.append(t)
        return t

    _map_tensors(collect, layers)
    record = torch.is_grad_enabled() and (leaves or x_mb.requires_grad)
    if not record:
        run = _Schedule(layer_fn, layers, mesh, extras, [])
        return run.forward(x_mb, keep=False)[0]
    alias = {id(t): t.detach().requires_grad_(True) for t in leaves}
    run = _Schedule(layer_fn,
                    _map_tensors(lambda t: alias.get(id(t), t), layers),
                    mesh, extras, [alias[id(t)] for t in leaves])
    return _Pipeline.apply(run, x_mb, *leaves)


def pipeline_llm_forward(params, spec: ModelSpec, tokens: torch.Tensor,
                         mesh: Mesh, *, microbatches: int,
                         compute_dtype=torch.bfloat16) -> torch.Tensor:
    """Logits [B, S, V] of a full-sequence (cacheless) forward with the
    decoder layers pipelined over ``mesh``'s pp axis: embed -> GPipe(layers)
    -> norm -> lm_head, on every rank. ``params["layers"]`` holds all the
    model's layers (the rank takes its stage's); they must share one
    structure, so a model with dense prologue layers
    (first_k_dense_replace > 0) pipelines only without them. Every layer runs as a full-attention layer with rope and no
    window (the JAX package's kind="full"); specs whose layers differ
    raise."""
    b, s = tokens.shape
    if b % microbatches:
        raise ValueError(f"batch {b} not divisible by {microbatches} mb")
    n = mesh.size(AXIS_PP)
    plain = [li for li in range(spec.num_layers)
             if spec.layer_kind(li) != "full" or spec.layer_window(li)
             or not spec.layer_uses_rope(li)]
    if plain:
        raise NotImplementedError(
            f"layers {plain}: linear, windowed or NoPE layers are not "
            "pipelined")
    stage = place_stages(stack_stage_params(list(params["layers"]), n), mesh)
    mb = b // microbatches
    dev = tokens.device
    x = params["embed"][tokens].to(compute_dtype)
    cos_t, sin_t = precompute_rope_tables(spec.rope, dev)
    pos = torch.arange(s, device=dev)[None, :].expand(mb, s)
    a = spec.attention
    if a.kind == "mla":
        shapes = ((mb, s, a.kv_lora_rank), (mb, s, a.qk_rope_head_dim))
    else:
        shapes = ((mb, s, a.num_kv_heads, a.head_dim),) * 2

    def layer_fn(lp, h, rope_cs):
        cache = tuple(torch.zeros(sh, dtype=compute_dtype, device=dev)
                      for sh in shapes)
        lengths = torch.zeros((mb,), dtype=torch.int32, device=dev)
        return decoder_layer(lp, spec, h, cache, lengths, rope_cs,
                             kind="full")[0]

    y = pipeline_apply(layer_fn, stage, x.reshape(microbatches, mb, s, -1),
                       mesh, extras=(cos_t[pos], sin_t[pos]))
    y = rms_norm(y.reshape(b, s, -1), params["final_norm"], spec.rms_norm_eps)
    return lm_head_logits(params, y)
