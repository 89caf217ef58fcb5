"""Routed experts kept in host memory and streamed to the card per call
(counterpart of ktransformers_tpu/offload/experts.py).

``offload_moe_weights`` replaces a layer's MoEWeights by an
``OffloadedMoEWeights``: the experts' quantized bytes (data, scales, zero
points) stay on the host, and ops/moe.py:moe_forward hands the layer's
routed rows to its ``forward`` (``moe_forward_offloaded``). Each call then
1. reads the routed ids back to the host;
2. gathers the distinct experts among them (at most E, whatever the row
   count) into a pinned staging buffer;
3. copies the buffer to the card with non_blocking=True;
4. runs the gathered matmuls (row 10, gathered_quant_matmul, for int4_g
   that is not repacked) on the gathered tensor, each (token, slot) row
   reading its expert's place in it.
So a step moves the active experts' quantized bytes and nothing else, and
the experts never take the W4A8 repack (utils/device_prep.prepare_params
sees no QTensor in them): on the same bytes the card computes what the
resident gather path computes with KT_W4A8=0. The JAX package gathers one
copy per (token, slot) row; the distinct experts give each row the same
bytes. Each tensor has two staging buffers, used in turn and shared by
every offloaded layer of the process, and a buffer is refilled only after
the copy that last read it has completed (its CUDA event), so the gather
of one matmul overlaps the copy of the other. On the CPU the same gathers
run with plain copies.

A layer's logical_to_physical map and expert_mask stay with its
OffloadedMoEWeights: each call sends the routed ids to their slots and
gives a masked expert weight 0 (reading slot 0 in its place), as the JAX
package's offload/experts.py:110, 126-130 does. Expert LoRA factors are
refused.
"""

from __future__ import annotations

import torch

from ktransformers_tpu_torch.ops.activations import (
    ActivationConfig,
    glu_activate,
)
from ktransformers_tpu_torch.quant.formats import QTensor


class _Staging:
    """Two pinned host buffers of one tensor's gathered rows, used in turn;
    a buffer is written only after the copy that last read it is done."""

    def __init__(self, pinned: bool):
        self.pinned = pinned
        self.bufs = [None, None]
        self.events = [None, None]
        self.turn = 0

    def take(self, shape, dtype) -> tuple[torch.Tensor, int]:
        i, self.turn = self.turn, 1 - self.turn
        if self.events[i] is not None:
            self.events[i].synchronize()
        buf = self.bufs[i]
        if buf is None or buf.numel() < _numel(shape) or buf.dtype != dtype:
            buf = torch.empty(_numel(shape), dtype=dtype,
                              pin_memory=self.pinned)
            self.bufs[i] = buf
        return buf[:_numel(shape)].view(shape), i

    def sent(self, i: int, device: torch.device) -> None:
        """Record that buffer i's copy to ``device`` is enqueued."""
        if device.type == "cuda":
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(device))
            self.events[i] = ev


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= s
    return n


# the staging of every OffloadedMoEWeights in the process, by (matrix,
# tensor, pinned): the layers run one after another
_STAGING: dict = {}


class OffloadedMoEWeights:
    """Host mirror of one layer's expert QTensors (gate_up [E, K(/2), 2I],
    down [E, I(/2), K]) and its staging buffers. Not a dataclass, so the
    params tree walkers (params_to, enable_w4a8) leave it as it is."""

    def __init__(self, gate_up: QTensor, down: QTensor,
                 logical_to_physical=None, expert_mask=None):
        self.gate_up = self._host(gate_up)
        self.down = self._host(down)
        self.logical_to_physical = logical_to_physical
        self.expert_mask = expert_mask
        self.intermediate_size = gate_up.out_features // 2
        self._pinned = torch.cuda.is_available()
        self.bytes_streamed = 0  # host -> card bytes so far (all calls)

    @staticmethod
    def _host(qt: QTensor) -> QTensor:
        if qt.act_quant:
            raise ValueError("offload_moe_weights: the experts were already "
                             "repacked for W4A8; offload them before "
                             "prepare_params")
        return qt.to("cpu")

    @property
    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size()
                   for q in (self.gate_up, self.down)
                   for t in (q.data, q.scales, q.zeros) if t is not None)

    def device_qtensor(self, which: str, ids: torch.Tensor,
                       device: torch.device) -> QTensor:
        """The experts ids [R] (host int64) of ``which`` ("gate_up" /
        "down") gathered into a QTensor [R, ...] on ``device``."""
        qt = getattr(self, which)
        parts = {}
        for name in ("data", "scales", "zeros"):
            src = getattr(qt, name)
            if src is None:
                parts[name] = None
                continue
            stage = _STAGING.setdefault((which, name, self._pinned),
                                        _Staging(self._pinned))
            host, i = stage.take((ids.shape[0], *src.shape[1:]), src.dtype)
            torch.index_select(src, 0, ids, out=host)
            parts[name] = host.to(device, non_blocking=True)
            stage.sent(i, device)
            self.bytes_streamed += host.numel() * host.element_size()
        return QTensor(parts["data"], parts["scales"], parts["zeros"],
                       kind=qt.kind, group_size=qt.group_size,
                       act_quant=False)

    def forward(self, x, topk_idx, topk_weights,
                act: ActivationConfig = ActivationConfig()) -> torch.Tensor:
        return moe_forward_offloaded(x, self, topk_idx, topk_weights, act)


def offload_moe_weights(w):
    """A layer's MoEWeights with its experts moved to host memory: the
    OffloadedMoEWeights that ops/moe.py:moe_forward streams from. Refuses
    expert LoRA factors (the streamed path has no LoRA term) and fused
    shared experts (their rows would be streamed every call)."""
    if getattr(w, "lora", None) is not None:
        raise ValueError("offload_moe_weights: experts with LoRA factors "
                         "are not offloaded")
    if getattr(w, "n_shared_fused", 0):
        raise ValueError("offload_moe_weights: fused shared experts are not "
                         "offloaded")
    return OffloadedMoEWeights(w.gate_up, w.down,
                               getattr(w, "logical_to_physical", None),
                               getattr(w, "expert_mask", None))


def moe_forward_offloaded(x: torch.Tensor, off: OffloadedMoEWeights,
                          topk_idx: torch.Tensor, topk_weights: torch.Tensor,
                          act: ActivationConfig = ActivationConfig()
                          ) -> torch.Tensor:
    """x [T, d]; topk_idx [T, k]; topk_weights [T, k] float32: the routed
    experts' bytes streamed to x's device, then the gathered matmuls there,
    one row per (token, slot), as the JAX package's moe_forward_offloaded
    (every T, prefill too)."""
    from ktransformers_tpu_torch.ops.moe import gathered_matmul, placed_routes

    topk_idx, topk_weights = placed_routes(off, topk_idx, topk_weights)
    t, k = topk_idx.shape
    inter = off.intermediate_size
    uniq, inv = topk_idx.reshape(t * k).to("cpu", torch.int64).unique(
        return_inverse=True)
    row_ids = inv.to(x.device, torch.int32).reshape(t, k)
    gu = off.device_qtensor("gate_up", uniq, x.device)
    h = gathered_matmul(x, gu, row_ids)  # rows index the gathered tensor
    a = glu_activate(h[..., :inter], h[..., inter:], act)
    dn = off.device_qtensor("down", uniq, x.device)
    y = gathered_matmul(a, dn, row_ids)
    return (y * topk_weights[:, :, None].to(y.dtype)).sum(dim=1).to(x.dtype)
