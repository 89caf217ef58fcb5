"""Serving (counterpart of ktransformers_tpu/serving): continuous batching
over a paged KV cache, a host-side FCFS scheduler feeding fixed-shape model
steps, and the OpenAI / Ollama-compatible HTTP layer (server.py, on the
standard library)."""

from ktransformers_tpu_torch.serving.engine import ServeEngine
from ktransformers_tpu_torch.serving.scheduler import (
    Query,
    Scheduler,
    SchedulerConfig,
)

__all__ = ["Query", "Scheduler", "SchedulerConfig", "ServeEngine"]
