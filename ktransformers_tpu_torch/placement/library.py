"""The shipped placement rules (counterpart of
ktransformers_tpu/placement/library.py): one JSON file per registry preset
under rules/, the JAX package's YAML library with its comments dropped.
``load_placement`` takes a library name, a JSON file or a YAML file / text.
"""

from __future__ import annotations

import os

from ktransformers_tpu_torch.placement.spec import PlacementSpec

RULES_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "rules")


def available_placements() -> list[str]:
    """Names of the shipped rule files (registry preset names)."""
    return sorted(f[: -len(".json")] for f in os.listdir(RULES_DIR)
                  if f.endswith(".json"))


def load_placement(name_or_path: str,
                   mesh_size: int | None = None) -> PlacementSpec:
    """A spec by library name ("<name>-<N>chip" first when mesh_size > 1
    and such a file is shipped), else a JSON file, else YAML (PyYAML)."""
    if os.sep not in name_or_path:
        if mesh_size and mesh_size > 1:
            var = os.path.join(RULES_DIR, f"{name_or_path}-{mesh_size}chip.json")
            if os.path.exists(var):
                return PlacementSpec.from_json(var)
        lib = os.path.join(RULES_DIR, name_or_path + ".json")
        if os.path.exists(lib):
            return PlacementSpec.from_json(lib)
    if name_or_path.endswith(".json") and os.path.exists(name_or_path):
        return PlacementSpec.from_json(name_or_path)
    return PlacementSpec.from_yaml(name_or_path)
