r"""Placement rules: regex-matched per-module assignment of quant kind and
group size (counterpart of ktransformers_tpu/placement/spec.py).

A spec is a list of entries, first match wins:

    [{"match": {"name": "layers\\.\\d+\\.moe\\.experts.*"},
      "assign": {"quant": "int4_g", "group_size": 128}},
     {"match": {"name": ".*"}, "assign": {"quant": "int8"}}]

Module paths are the params-tree paths ("embed", "lm_head",
"layers.3.attn.q_proj", "layers.7.moe.experts", "layers.7.moe.shared",
...). ``shard`` and ``offload`` are kept on the rule and not acted on;
other assign keys land in ``extra``. Specs are read from JSON, or from
YAML through PyYAML imported when a YAML file or string is given.
"""

from __future__ import annotations

import dataclasses
import json
import re
from typing import Any


@dataclasses.dataclass(frozen=True)
class PlacementRule:
    pattern: str
    quant: str | None = None
    group_size: int | None = None
    shard: str | None = None  # "expert" | "tensor" | "replicate"
    offload: str | None = None  # None | "host"
    extra: dict = dataclasses.field(default_factory=dict)

    def matches(self, path: str) -> bool:
        return re.fullmatch(self.pattern, path) is not None


def _yaml_load(text_or_file):
    try:
        import yaml
    except ImportError as e:
        raise ImportError(
            "a YAML placement spec needs PyYAML, which is not installed; "
            "give the same rules as a JSON file (a list of {\"match\": "
            "{\"name\": regex}, \"assign\": {...}} objects, as in "
            "ktransformers_tpu_torch/placement/rules/*.json)") from e
    return yaml.safe_load(text_or_file)


@dataclasses.dataclass
class PlacementSpec:
    rules: list[PlacementRule]
    default_quant: str = "bf16"
    default_group_size: int = 128

    @staticmethod
    def from_dict(entries: list[dict[str, Any]]) -> "PlacementSpec":
        rules = []
        for e in entries:
            match = e.get("match", {})
            assign = e.get("assign", {})
            rules.append(PlacementRule(
                pattern=match.get("name", ".*"),
                quant=assign.get("quant"),
                group_size=assign.get("group_size"),
                shard=assign.get("shard"),
                offload=assign.get("offload"),
                extra={k: v for k, v in assign.items()
                       if k not in ("quant", "group_size", "shard",
                                    "offload")},
            ))
        return PlacementSpec(rules)

    @staticmethod
    def from_json(path: str) -> "PlacementSpec":
        with open(path) as f:
            return PlacementSpec.from_dict(json.load(f) or [])

    @staticmethod
    def from_yaml(path_or_str: str) -> "PlacementSpec":
        """A YAML file path or YAML text (the JAX package's heuristic: text
        with a newline, or whose first line has no colon, is tried as a
        path first)."""
        if "\n" in path_or_str or ":" not in path_or_str.split("\n")[0]:
            try:
                with open(path_or_str) as f:
                    data = _yaml_load(f)
            except (OSError, ValueError):
                data = _yaml_load(path_or_str)
        else:
            data = _yaml_load(path_or_str)
        return PlacementSpec.from_dict(data or [])

    def resolve(self, path: str) -> PlacementRule:
        for rule in self.rules:
            if rule.matches(path):
                return rule
        return PlacementRule(pattern=".*", quant=self.default_quant)

    def quant_for(self, path: str) -> tuple[str, int]:
        r = self.resolve(path)
        return (r.quant or self.default_quant,
                r.group_size or self.default_group_size)


def default_moe_placement(moe_quant: str = "int4_g",
                          dense_quant: str = "int8") -> PlacementSpec:
    """Routed experts in the cheapest kind, everything else denser."""
    return PlacementSpec.from_dict([
        {"match": {"name": r"layers\.\d+\.(moe|mlp)\.experts.*"},
         "assign": {"quant": moe_quant}},
        {"match": {"name": r"(embed|.*norm.*)"}, "assign": {"quant": "bf16"}},
        {"match": {"name": ".*"}, "assign": {"quant": dense_quant}},
    ])
