"""LoRA SFT trainer (counterpart of ktransformers_tpu/sft/train.py):
next-token cross-entropy over (input_ids, labels) batches, AdamW on the
LoRA leaves only, the quantized base frozen.

The backward runs through the kernels' input-gradient rules (ops/vjp.py):
every base matmul's dx is a transposed kernel (csrc/quant_matmul_t.cu).
The optimizer is optax's chain(clip_by_global_norm, adamw) written out in
PyTorch with optax's arithmetic: clipping scales by max_norm / norm only
when the norm is at least max_norm (no epsilon, unlike
torch.nn.utils.clip_grad_norm_), Adam's eps is added outside the square
root, the weight decay is decoupled (added to the Adam step, times the
learning rate).

Trainer(mesh=...) trains over a (dp, ep, tp) mesh of ranks
(parallel/mesh.py), as the JAX Trainer does over its mesh: each dp rank
takes its rows of the batch (parallel/shardings.batch_sharding); the loss
is the global masked mean, each rank's sum of nll * mask over the sum of
the mask all-reduced over dp (not a mean of the ranks' means, which
differs wherever the ranks hold different numbers of IGNORE_INDEX labels),
and train_step returns it; the gradients are summed over dp, clipped by
the global norm of the sum; AdamW's moments are cut as the JAX package's
_zero1_sharding places them (ZeRO-1): a leaf whose leading axis divides by
dp keeps on each rank the moments of its rows [i n / dp, (i + 1) n / dp)
only, the others (and the count) whole. Each rank updates its rows and the
updated leaf is all-gathered over dp. With ep > 1 the rank holds its shard
of the experts (parallel/shardings.shard_params) and runs under
parallel_context (parallel/ep.py records the gradient); adapters on the
attention, the shared experts and the dense MLPs train there. LoRA factors
on the routed experts under ep > 1, and any LoRA under tp > 1, raise
NotImplementedError: the JAX package fails on both (shard_params names
how).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ktransformers_tpu_torch.models.model import KVCache, forward
from ktransformers_tpu_torch.models.spec import ModelSpec
from ktransformers_tpu_torch.ops.rope import precompute_rope_tables
from ktransformers_tpu_torch.parallel.collectives import (
    all_gather,
    all_reduce,
)
from ktransformers_tpu_torch.parallel.context import parallel_context
from ktransformers_tpu_torch.parallel.mesh import AXIS_DP, AXIS_EP, AXIS_TP
from ktransformers_tpu_torch.parallel.shardings import (
    batch_sharding,
    rank_spec,
    shard_params,
)
from ktransformers_tpu_torch.sft.lora import (
    lora_leaves,
    merge_lora_params,
    split_lora,
    tree_map_with_path,
)

IGNORE_INDEX = -100


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 1e-4
    weight_decay: float = 0.0
    b1: float = 0.9
    b2: float = 0.999
    max_grad_norm: float = 1.0
    seq_len: int = 512
    # rematerialize each decoder layer in the backward: activation memory
    # of one layer instead of all, for a second forward
    remat: bool = True


def masked_nll(params, spec: ModelSpec, input_ids: torch.Tensor,
               labels: torch.Tensor, compute_dtype, remat: bool = False,
               rope_tables=None) -> tuple[torch.Tensor, torch.Tensor]:
    """(sum of the next-token NLL over the unmasked labels, their count):
    logits[:, t] (after reading token t) is scored against labels[:, t +
    1]; labels equal to IGNORE_INDEX (prompt, padding) are masked. A fresh
    cache of the batch's length each call."""
    b, s = input_ids.shape
    cache = KVCache.create(spec, b, s, dtype=compute_dtype,
                           device=input_ids.device)
    logits, _ = forward(params, spec, input_ids, cache,
                        rope_tables=rope_tables, compute_dtype=compute_dtype,
                        remat=remat)
    return logits_nll(logits, labels)


def logits_nll(logits: torch.Tensor,
               labels: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """masked_nll's (sum, count) from the logits [B, S, V] themselves."""
    logp = torch.log_softmax(logits[:, :-1].to(torch.float32), dim=-1)
    lab = labels[:, 1:]
    tgt = torch.where(lab == IGNORE_INDEX, torch.zeros_like(lab), lab)
    nll = -torch.gather(logp, -1, tgt[..., None])[..., 0]
    mask = (lab != IGNORE_INDEX).to(torch.float32)
    return (nll * mask).sum(), mask.sum()


def loss_fn(params, spec: ModelSpec, input_ids: torch.Tensor,
            labels: torch.Tensor, compute_dtype, remat: bool = False,
            rope_tables=None) -> torch.Tensor:
    """The mean next-token CE over the unmasked labels (masked_nll)."""
    total, count = masked_nll(params, spec, input_ids, labels,
                              compute_dtype, remat, rope_tables)
    return total / torch.clamp(count, min=1.0)


class Trainer:
    """Holds the LoRA leaves (trainable, cloned from the params given) and
    the frozen base of one model on one device (``cuda`` unless told
    otherwise; a mesh's device with ``mesh``), and AdamW's moments (this
    rank's rows of them over dp). ``ep_impl``: the EP combine under a mesh
    with ep ranks (parallel/context.py)."""

    def __init__(self, params_with_lora, spec: ModelSpec,
                 cfg: TrainConfig = TrainConfig(),
                 compute_dtype=torch.float32, mesh=None, device="cuda",
                 ep_impl: str = "psum"):
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.spec = spec
        self.cfg = cfg
        self.compute_dtype = compute_dtype
        self.mesh = mesh
        self.ep_impl = ep_impl
        if mesh is not None:
            device = mesh.device
            if mesh.size(AXIS_EP) > 1 or mesh.size(AXIS_TP) > 1:
                # this rank's expert shard; refuses expert LoRA under ep and
                # any LoRA under tp
                params_with_lora = shard_params(params_with_lora, spec, mesh)
                self.spec = rank_spec(spec, mesh)
        self.device = torch.device(device)
        lora, self.base = split_lora(params_with_lora)
        self.lora = tree_map_with_path(
            lambda p, x: None if x is None
            else x.detach().clone().requires_grad_(True), lora)
        self.leaves = [t for _, t in lora_leaves(self.lora)]
        self.dp = mesh.size(AXIS_DP) if mesh is not None else 1
        self.rows = [self._zero1_rows(t) for t in self.leaves]
        self.mu = [torch.zeros_like(self._mine(t, r))
                   for t, r in zip(self.leaves, self.rows)]
        self.nu = [torch.zeros_like(m) for m in self.mu]
        self.count = 0
        self.rope_tables = precompute_rope_tables(spec.rope, self.device)

    def _zero1_rows(self, t: torch.Tensor) -> slice | None:
        """This rank's rows of a leaf's moments (the JAX package's
        _zero1_sharding: the leading axis over dp where it divides), or
        None where every rank keeps them whole."""
        if self.dp == 1 or t.dim() == 0 or t.shape[0] % self.dp:
            return None
        return batch_sharding(self.mesh, t.shape[0])

    @staticmethod
    def _mine(t: torch.Tensor, rows: slice | None) -> torch.Tensor:
        return t if rows is None else t[rows]

    @property
    def params(self):
        """Current merged params (for eval / generation)."""
        return merge_lora_params(self.lora, self.base)

    def _update(self, grads: list[torch.Tensor]) -> None:
        """optax.chain(clip_by_global_norm(max_norm), adamw(...)) and
        apply_updates, in place on the leaves, from the full (dp-summed)
        gradients: each rank steps its rows of a cut leaf, and the stepped
        rows are all-gathered over dp."""
        c = self.cfg
        norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
        keep = norm < c.max_grad_norm
        grads = [torch.where(keep, g, (g / norm) * c.max_grad_norm)
                 for g in grads]
        self.count += 1
        f32 = dict(dtype=torch.float32, device=self.device)
        bc1 = 1 - torch.tensor(c.b1, **f32) ** self.count
        bc2 = 1 - torch.tensor(c.b2, **f32) ** self.count
        stepped = []
        for p, g, mu, nu, rows in zip(self.leaves, grads, self.mu, self.nu,
                                      self.rows):
            g, mine = self._mine(g, rows), self._mine(p, rows)
            mu.copy_((1 - c.b1) * g + c.b1 * mu)
            nu.copy_((1 - c.b2) * (g * g) + c.b2 * nu)
            step = (mu / bc1.to(mu.dtype)) / (
                torch.sqrt(nu / bc2.to(nu.dtype)) + 1e-8)
            step = step + c.weight_decay * mine
            mine.add_((-c.learning_rate * step).to(p.dtype))
            if rows is not None:
                stepped.append((p, mine))
        if stepped:
            flat = torch.cat([m.reshape(-1).to(torch.float32)
                              for _, m in stepped])
            full = all_gather(flat, self.mesh, AXIS_DP, dim=0).reshape(
                self.dp, -1)
            at = 0
            for p, m in stepped:
                part = full[:, at:at + m.numel()]
                p.copy_(part.reshape(self.dp * m.shape[0], *m.shape[1:]))
                at += m.numel()

    def loss_and_grads(self, input_ids, labels):
        """(the loss, the LoRA gradients) of a batch (int arrays [B, S]),
        under a mesh the global loss and the gradients summed over dp,
        every rank holding the same."""
        ids = torch.as_tensor(np.asarray(input_ids), dtype=torch.int64,
                              device=self.device)
        lab = torch.as_tensor(np.asarray(labels), dtype=torch.int64,
                              device=self.device)
        if self.mesh is None:
            loss = loss_fn(self.params, self.spec, ids, lab,
                           self.compute_dtype, remat=self.cfg.remat,
                           rope_tables=self.rope_tables)
            grads = torch.autograd.grad(loss, self.leaves, allow_unused=True)
            return float(loss.detach()), [
                torch.zeros_like(p) if g is None else g
                for p, g in zip(self.leaves, grads)]
        rows = batch_sharding(self.mesh, ids.shape[0])
        with parallel_context(self.mesh, ep_impl=self.ep_impl):
            total, count = masked_nll(
                self.params, self.spec, ids[rows], lab[rows],
                self.compute_dtype, remat=self.cfg.remat,
                rope_tables=self.rope_tables)
            count = all_reduce(count, self.mesh, AXIS_DP)
            loss = total / torch.clamp(count, min=1.0)
            # the backward reruns rematerialized layers: still in the context
            grads = torch.autograd.grad(loss, self.leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(self.leaves, grads)]
        if self.dp > 1:
            flat = all_reduce(torch.cat([g.reshape(-1).to(torch.float32)
                                         for g in grads]), self.mesh, AXIS_DP)
            parts = flat.split([g.numel() for g in grads])
            grads = [f.reshape(g.shape).to(g.dtype)
                     for f, g in zip(parts, grads)]
        return float(all_reduce(loss.detach(), self.mesh, AXIS_DP)), grads

    def train_step(self, input_ids, labels) -> float:
        """One step on a batch (int arrays [B, S]); returns the loss (the
        global loss under a mesh)."""
        loss, grads = self.loss_and_grads(input_ids, labels)
        with torch.no_grad():
            self._update(grads)
        return loss
