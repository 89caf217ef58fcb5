"""Server configuration: one typed object for every serve-time knob
(counterpart of ktransformers_tpu/serving/config.py, the same fields).

Loadable from JSON, or YAML through PyYAML imported when the file is not
JSON (``serve --config-file server.json``); command-line flags override
file values and unknown keys are refused. The sparse page budget and its
anchor / retrieval reach the engine (the kinds are checked when the config
is made); so does routing collection. ``rebalance_interval_steps`` is taken
as the JAX package takes it, and no engine reads it (re-placement is
``ServeEngine.apply_expert_rebalance``).
"""

from __future__ import annotations

import dataclasses
import json


@dataclasses.dataclass
class ServerConfig:
    # network
    host: str = "0.0.0.0"
    port: int = 8192
    api_key: str | None = None  # require `Authorization: Bearer <key>`
    mount_web: bool = True  # serve the chat page at /

    # model
    model_path: str | None = None
    model_name: str = "ktransformers-tpu"
    config_path: str | None = None  # HF config.json (raw GGUF loads)
    tokenizer_path: str | None = None
    quant: str = "int8"  # dense / attention QTensor kind
    moe_quant: str = "int4_g"  # routed-expert kind
    placement_yaml: str | None = None  # per-module rules (name or file)

    # scheduler / memory
    max_batch_size: int = 8
    prefill_chunk: int = 256
    page_size: int = 64
    num_pages: int = 2048
    max_pages_per_query: int = 64
    enable_prefix_cache: bool = True

    # generation defaults (per-request fields still override)
    max_new_tokens: int = 128
    temperature: float = 0.6
    top_p: float = 0.95

    # features
    offload: bool = False  # routed experts computed in host memory
    sparse_budget: int | None = None  # top-K-page decode attention
    sparse_anchor: str = "quest"  # page-summary anchor kind
    sparse_retrieval: str = "layer"  # retrieval granularity
    collect_routing: bool = False  # routing stats for expert re-placement
    rebalance_interval_steps: int = 0  # taken as in JAX; no engine reads it
    decode_pipeline_depth: int = 3  # in-flight decode steps (engine)

    # observability
    log_level: str = "info"
    check_numerics: bool = False

    @classmethod
    def field_names(cls) -> set[str]:
        return {f.name for f in dataclasses.fields(cls)}

    @classmethod
    def from_file(cls, path: str, **overrides) -> "ServerConfig":
        """Load JSON or YAML; ``overrides`` (CLI values that are not None)
        win."""
        with open(path) as f:
            text = f.read()
        try:
            data = json.loads(text)
        except ValueError:
            try:
                import yaml
            except ImportError as e:
                raise ImportError(
                    f"{path} is not JSON, and reading YAML needs PyYAML, "
                    "which is not installed; write the config as JSON") from e
            data = yaml.safe_load(text) or {}
        if not isinstance(data, dict):
            raise ValueError(f"{path}: expected a mapping at top level")
        unknown = set(data) - cls.field_names()
        if unknown:
            raise ValueError(
                f"{path}: unknown config keys {sorted(unknown)}; "
                f"valid keys: {sorted(cls.field_names())}")
        data.update({k: v for k, v in overrides.items() if v is not None})
        return cls(**data)

    def __post_init__(self):
        """Refuse a sparse kind that does not exist and a re-placement
        interval without the statistics it reads."""
        from ktransformers_tpu_torch.ops.sparse_attention import (
            ANCHOR_KINDS,
            RETRIEVAL_KINDS,
        )

        if self.sparse_anchor not in ANCHOR_KINDS:
            raise ValueError(f"sparse_anchor {self.sparse_anchor!r}: one of "
                             f"{ANCHOR_KINDS}")
        if self.sparse_retrieval not in RETRIEVAL_KINDS:
            raise ValueError(f"sparse_retrieval {self.sparse_retrieval!r}: "
                             f"one of {RETRIEVAL_KINDS}")

    def scheduler_config(self):
        from ktransformers_tpu_torch.serving.scheduler import SchedulerConfig

        return SchedulerConfig(
            max_batch_size=self.max_batch_size,
            prefill_chunk=self.prefill_chunk,
            page_size=self.page_size,
            max_pages_per_query=self.max_pages_per_query,
        )
