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
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ktransformers_tpu_torch.models.model import KVCache, forward
from ktransformers_tpu_torch.models.spec import ModelSpec
from ktransformers_tpu_torch.ops.rope import precompute_rope_tables
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


def loss_fn(params, spec: ModelSpec, input_ids: torch.Tensor,
            labels: torch.Tensor, compute_dtype, remat: bool = False,
            rope_tables=None) -> torch.Tensor:
    """Next-token CE: logits[:, t] (after reading token t) is scored against
    labels[:, t + 1]; labels equal to IGNORE_INDEX (prompt, padding) are
    masked. A fresh cache of the batch's length each call."""
    b, s = input_ids.shape
    cache = KVCache.create(spec, b, s, dtype=compute_dtype,
                           device=input_ids.device)
    logits, _ = forward(params, spec, input_ids, cache,
                        rope_tables=rope_tables, compute_dtype=compute_dtype,
                        remat=remat)
    logp = torch.log_softmax(logits[:, :-1].to(torch.float32), dim=-1)
    lab = labels[:, 1:]
    tgt = torch.where(lab == IGNORE_INDEX, torch.zeros_like(lab), lab)
    nll = -torch.gather(logp, -1, tgt[..., None])[..., 0]
    mask = (lab != IGNORE_INDEX).to(torch.float32)
    return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)


class Trainer:
    """Holds the LoRA leaves (trainable, cloned from the params given) and
    the frozen base of one model on one device (``cuda`` unless told
    otherwise), and AdamW's moments."""

    def __init__(self, params_with_lora, spec: ModelSpec,
                 cfg: TrainConfig = TrainConfig(),
                 compute_dtype=torch.float32, mesh=None, device="cuda"):
        if mesh is not None:
            raise NotImplementedError(
                "the distributed (ZeRO-1) trainer is not ported (ROADMAP "
                "Queue 1 item 11c)")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.spec = spec
        self.cfg = cfg
        self.compute_dtype = compute_dtype
        self.device = torch.device(device)
        lora, self.base = split_lora(params_with_lora)
        self.lora = tree_map_with_path(
            lambda p, x: None if x is None
            else x.detach().clone().requires_grad_(True), lora)
        self.leaves = [t for _, t in lora_leaves(self.lora)]
        self.mu = [torch.zeros_like(t) for t in self.leaves]
        self.nu = [torch.zeros_like(t) for t in self.leaves]
        self.count = 0
        self.rope_tables = precompute_rope_tables(spec.rope, self.device)

    @property
    def params(self):
        """Current merged params (for eval / generation)."""
        return merge_lora_params(self.lora, self.base)

    def _update(self, grads: list[torch.Tensor]) -> None:
        """optax.chain(clip_by_global_norm(max_norm), adamw(...)) and
        apply_updates, in place on the leaves."""
        c = self.cfg
        norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
        keep = norm < c.max_grad_norm
        grads = [torch.where(keep, g, (g / norm) * c.max_grad_norm)
                 for g in grads]
        self.count += 1
        f32 = dict(dtype=torch.float32, device=self.device)
        bc1 = 1 - torch.tensor(c.b1, **f32) ** self.count
        bc2 = 1 - torch.tensor(c.b2, **f32) ** self.count
        for p, g, mu, nu in zip(self.leaves, grads, self.mu, self.nu):
            mu.copy_((1 - c.b1) * g + c.b1 * mu)
            nu.copy_((1 - c.b2) * (g * g) + c.b2 * nu)
            step = (mu / bc1.to(mu.dtype)) / (
                torch.sqrt(nu / bc2.to(nu.dtype)) + 1e-8)
            step = step + c.weight_decay * p
            p.add_((-c.learning_rate * step).to(p.dtype))

    def train_step(self, input_ids, labels) -> float:
        """One step on a batch (int arrays [B, S]); returns the loss."""
        ids = torch.as_tensor(np.asarray(input_ids), dtype=torch.int64,
                              device=self.device)
        lab = torch.as_tensor(np.asarray(labels), dtype=torch.int64,
                              device=self.device)
        loss = loss_fn(self.params, self.spec, ids, lab, self.compute_dtype,
                       remat=self.cfg.remat, rope_tables=self.rope_tables)
        grads = torch.autograd.grad(loss, self.leaves, allow_unused=True)
        with torch.no_grad():
            self._update([torch.zeros_like(p) if g is None else g
                          for p, g in zip(self.leaves, grads)])
        return float(loss.detach())
