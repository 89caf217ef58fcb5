"""GPTQ / AWQ checkpoints into ``int4_gz`` (counterpart of
ktransformers_tpu/loader/gptq.py).

The packed codes and per-group (scale, zero) pairs go over LOSSLESSLY:
``int4_gz`` stores codes as q - 8 and zeros as z - 8, so dequant is (q - z)
* s (quant/formats.py) and compute runs on the checkpoint's own integers,
through the zero-term W4A8 kernels after prepare_params' repack.

Layouts (AutoGPTQ / AutoAWQ conventions), logical weight [N out, K in]:

GPTQ: qweight int32 [K/8, N] (8 consecutive k an int32, LSB first),
  qzeros int32 [G, N/8] (8 consecutive n, LSB first), scales f16 [G, N],
  g_idx int32 [K] (only the monotonic k // gs order: desc_act checkpoints
  raise). checkpoint_format "gptq" stores z - 1 (AutoGPTQ v1), "gptq_v2"
  stores z.
AWQ: qweight int32 [K, N/8] and qzeros int32 [G, N/8] with nibble i
  holding column 8 j + AWQ_ORDER[i]; scales f16 [G, N].
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from ktransformers_tpu_torch.models.loading import WeightProvider
from ktransformers_tpu_torch.quant.formats import QTensor, dequantize, pack_int4

# AutoAWQ's order_map: nibble i of an int32 holds logical column offset
# AWQ_ORDER[i]
AWQ_ORDER = (0, 2, 4, 6, 1, 3, 5, 7)


def _unpack_int32_nibbles(a: np.ndarray, axis: int) -> np.ndarray:
    """int32 array -> uint8 nibbles in [0, 15], ``axis`` 8x longer (LSB
    first)."""
    a = a.astype(np.uint32)
    shifts = np.arange(8, dtype=np.uint32) * 4
    moved = np.moveaxis(a, axis, -1)[..., None]  # [..., P, 1]
    nib = (moved >> shifts) & 0xF  # [..., P, 8]
    out = nib.reshape(*moved.shape[:-2], -1)  # [..., P * 8]
    return np.moveaxis(out, -1, axis).astype(np.uint8)


def _to_qtensor(q: np.ndarray, scales: np.ndarray, zeros: np.ndarray,
                group_size: int) -> QTensor:
    """q [K, N] uint8 in [0, 15], scales / zeros [G, N] -> int4_gz."""
    codes = torch.from_numpy(q.astype(np.int32) - 8)
    return QTensor(
        pack_int4(codes, group_size),
        torch.from_numpy(np.asarray(scales, np.float32)),
        torch.from_numpy(zeros.astype(np.float32) - 8.0),
        kind="int4_gz", group_size=group_size,
    )


def gptq_to_qtensor(qweight, qzeros, scales, g_idx=None,
                    v2: bool = False) -> QTensor:
    """AutoGPTQ tensors -> int4_gz QTensor in the [K, N] layout."""
    k = qweight.shape[0] * 8
    gs = k // scales.shape[0]
    if g_idx is not None:
        expect = np.arange(k, dtype=np.int64) // gs
        if not np.array_equal(np.asarray(g_idx, np.int64), expect):
            raise NotImplementedError(
                "GPTQ desc_act (non-monotonic g_idx) needs the checkpoint "
                "repacked to the monotonic group order first")
    q = _unpack_int32_nibbles(np.asarray(qweight), axis=0)  # [K, N]
    z = _unpack_int32_nibbles(np.asarray(qzeros), axis=1)  # [G, N]
    if not v2:
        z = (z + 1) & 0xF  # AutoGPTQ v1 stores z - 1
    return _to_qtensor(q, np.asarray(scales, np.float32), z, gs)


def awq_to_qtensor(qweight, qzeros, scales) -> QTensor:
    """AutoAWQ tensors -> int4_gz QTensor in the [K, N] layout."""
    gs = qweight.shape[0] // scales.shape[0]
    inv = np.argsort(AWQ_ORDER)

    def unpack_awq(a):
        nib = _unpack_int32_nibbles(np.asarray(a), axis=1)
        # undo the interleave: nibble i holds column 8 j + AWQ_ORDER[i]
        nib = nib.reshape(*nib.shape[:-1], -1, 8)[..., inv]
        return nib.reshape(*nib.shape[:-2], -1)

    return _to_qtensor(unpack_awq(qweight), np.asarray(scales, np.float32),
                       unpack_awq(qzeros), gs)


def detect_quant_method(path: str):
    """'gptq', 'awq' or None for a checkpoint directory, from config.json's
    quantization_config (or quantize_config.json)."""
    for fname in ("config.json", "quantize_config.json"):
        fp = os.path.join(path, fname)
        if not os.path.exists(fp):
            continue
        with open(fp) as f:
            cfg = json.load(f)
        qc = cfg.get("quantization_config", cfg)
        m = qc.get("quant_method")
        if m in ("gptq", "awq"):
            return m
        if ("bits" in qc and "group_size" in qc
                and fname == "quantize_config.json"):
            return "gptq"
    return None


def _cat_n(a: QTensor, b: QTensor) -> QTensor:
    if a.kind != b.kind or a.group_size != b.group_size:
        raise ValueError("gate and up projections differ in format")
    return QTensor(torch.cat([a.data, b.data], -1),
                   torch.cat([a.scales, b.scales], -1),
                   torch.cat([a.zeros, b.zeros], -1),
                   kind=a.kind, group_size=a.group_size)


class QuantizedSafetensorsProvider(WeightProvider):
    """Wraps a SafetensorsProvider: ``get_exact(name)`` gives a GPTQ / AWQ
    module's int4_gz QTensor for "<module>.weight"; for the fused names
    build_params asks ("<mlp>.gate_up_proj", gate and up along N) and for
    the stacked routed experts ("<mlp>.experts.gate_up_proj" /
    ".experts.down_proj", [E, K, N]) it assembles them from the per-expert
    modules. ``get`` gives a packed module's float32 dequant in the HF [N,
    K] layout and passes plain tensors through, so ``maybe`` sees packed
    modules too. (The JAX package's provider raises KeyError from ``get``
    on every plain tensor and has no fused or stacked names.)"""

    def __init__(self, base, method: str, v2: bool = False):
        self.base = base
        self.method = method
        self.v2 = v2
        self._names = set(base.keys())

    def keys(self):
        return self.base.keys()

    def get(self, name):
        if name.endswith(".weight") and self._packed(name[: -7]):
            qt = self.get_exact(name)
            return dequantize(qt, torch.float32).numpy().T
        return self.base.get(name)

    def _packed(self, stem: str) -> bool:
        return f"{stem}.qweight" in self._names

    def _module(self, stem: str) -> QTensor:
        raw = self.base._raw
        if self.method == "awq":
            return awq_to_qtensor(raw(f"{stem}.qweight"),
                                  raw(f"{stem}.qzeros"), raw(f"{stem}.scales"))
        g_idx = (raw(f"{stem}.g_idx") if f"{stem}.g_idx" in self._names
                 else None)
        return gptq_to_qtensor(raw(f"{stem}.qweight"), raw(f"{stem}.qzeros"),
                               raw(f"{stem}.scales"), g_idx, v2=self.v2)

    def _experts(self, pre: str, names: tuple) -> QTensor:
        """Stack experts 0, 1, ... of ``pre`` (the fused gate || up of
        names[0] and names[1], or names[0] alone) along a new axis 0."""
        per = []
        while self._packed(f"{pre}.{len(per)}.{names[0]}"):
            stems = [f"{pre}.{len(per)}.{n}" for n in names]
            qts = [self._module(st) for st in stems]
            per.append(qts[0] if len(qts) == 1 else _cat_n(*qts))
        if not per:
            raise KeyError(pre)
        return QTensor(torch.stack([q.data for q in per]),
                       torch.stack([q.scales for q in per]),
                       torch.stack([q.zeros for q in per]),
                       kind=per[0].kind, group_size=per[0].group_size)

    def get_exact(self, name: str):
        if name.endswith(".experts.gate_up_proj"):
            return self._experts(name[: -len(".gate_up_proj")],
                                 ("gate_proj", "up_proj"))
        if name.endswith(".experts.down_proj"):
            return self._experts(name[: -len(".down_proj")], ("down_proj",))
        if name.endswith("gate_up_proj"):
            base = name[: -len("gate_up_proj")]
            if not self._packed(f"{base}gate_proj"):
                raise KeyError(name)
            return _cat_n(self._module(f"{base}gate_proj"),
                          self._module(f"{base}up_proj"))
        if not name.endswith(".weight") or not self._packed(name[: -7]):
            raise KeyError(name)  # a plain tensor: the loader falls back
        return self._module(name[: -len(".weight")])
