"""Observability of the serving loop (counterpart of
ktransformers_tpu/utils/observability.py: setup_logging, StageTimer and
check_numerics).

Device work is asynchronous, so the stage timer measures HOST wall
segments between dispatch points (schedule / dispatch / readback /
bookkeeping), and the numeric guard runs on values that are already being
read back to the host, so it adds no device synchronisation.
"""

from __future__ import annotations

import collections
import logging
import os
import time

import numpy as np
import torch


def setup_logging(level: str | None = None) -> logging.Logger:
    """The package's logger, given one stream handler the first time; its
    level from ``level`` or KT_LOG_LEVEL (default INFO)."""
    logger = logging.getLogger("ktransformers_tpu_torch")
    if not logger.handlers:
        h = logging.StreamHandler()
        h.setFormatter(logging.Formatter(
            "%(asctime)s %(name)s %(levelname)s %(message)s"))
        logger.addHandler(h)
    logger.setLevel((level or os.environ.get("KT_LOG_LEVEL", "INFO")).upper())
    return logger


class StageTimer:
    """Accumulating wall-time profile over named stages.

    Enabled via KT_FORWARD_TIME_PROFILE=1 or explicitly. Near-zero cost
    when disabled."""

    def __init__(self, enabled: bool | None = None):
        if enabled is None:
            enabled = os.environ.get("KT_FORWARD_TIME_PROFILE", "0") == "1"
        self.enabled = enabled
        self.totals: dict[str, float] = collections.defaultdict(float)
        self.counts: dict[str, int] = collections.defaultdict(int)
        self._t0: float | None = None
        self._stage: str | None = None

    def stage(self, name: str) -> None:
        """End the current stage (if any) and start `name`."""
        if not self.enabled:
            return
        now = time.perf_counter()
        if self._stage is not None:
            self.totals[self._stage] += now - self._t0
            self.counts[self._stage] += 1
        self._stage = name
        self._t0 = now

    def end(self) -> None:
        if self.enabled and self._stage is not None:
            self.totals[self._stage] += time.perf_counter() - self._t0
            self.counts[self._stage] += 1
            self._stage = None

    def report(self) -> dict[str, dict]:
        return {
            k: {
                "total_s": round(v, 4),
                "count": self.counts[k],
                "avg_ms": round(1e3 * v / max(self.counts[k], 1), 3),
            }
            for k, v in sorted(self.totals.items())
        }


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}[{k!r}]")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}[{i}]")
    else:
        yield path, tree


def check_numerics(tree, where: str = "") -> None:
    """Raise FloatingPointError on any non-finite floating leaf of a nest
    of dicts / lists holding numpy arrays or CPU tensors. Call it on
    host-visible values (tokens or logits already read back)."""
    for path, leaf in _leaves(tree):
        if leaf is None:
            continue
        if isinstance(leaf, torch.Tensor):
            bad = leaf.is_floating_point() and not bool(
                torch.isfinite(leaf).all())
        else:
            a = np.asarray(leaf)
            bad = a.dtype.kind == "f" and not np.isfinite(a).all()
        if bad:
            raise FloatingPointError(f"non-finite values at {path} {where}")
