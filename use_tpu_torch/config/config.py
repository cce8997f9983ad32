"""Config system: YAML experiment overlays + dotted CLI overrides.

Replaces the reference's Hydra tree (reference configs/train.yaml defaults
list, configs/experiment/*.yaml '@package _global_' overlays, CLI
'key.subkey=value' overrides) with a dependency-free equivalent:

    cfg = load_config("SGMSE_Large", ["train.lr=1e-4", "data.batch_size=8"])

Experiments are YAML files in use_tpu_torch/config/experiments/; an experiment may
set `defaults: <other>` to inherit and override (the Hydra defaults-list
analog). Values are parsed with YAML semantics (so `1e-4`, `true`, `[1,2]`
work).
"""
from __future__ import annotations

import os
from typing import Dict, Optional, Sequence

import yaml

EXPERIMENTS_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "experiments")


def deep_update(base: Dict, overlay: Dict) -> Dict:
    for k, v in overlay.items():
        if isinstance(v, dict) and isinstance(base.get(k), dict):
            deep_update(base[k], v)
        else:
            base[k] = v
    return base


def parse_overrides(overrides: Sequence[str]) -> Dict:
    out: Dict = {}
    for item in overrides:
        if "=" not in item:
            raise ValueError(f"override {item!r} must be key.path=value")
        key, value = item.split("=", 1)
        node = out
        parts = key.strip().split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        parsed = yaml.safe_load(value)
        if isinstance(parsed, str):
            # YAML 1.1 misses bare scientific notation like 1e-5
            try:
                parsed = int(parsed)
            except ValueError:
                try:
                    parsed = float(parsed)
                except ValueError:
                    pass
        node[parts[-1]] = parsed
    return out


def _load_yaml(name_or_path: str) -> Dict:
    path = name_or_path
    if not os.path.exists(path):
        path = os.path.join(EXPERIMENTS_DIR, f"{name_or_path}.yaml")
    if not os.path.exists(path):
        avail = sorted(
            f[:-5] for f in os.listdir(EXPERIMENTS_DIR) if f.endswith(".yaml")
        )
        raise FileNotFoundError(
            f"experiment {name_or_path!r} not found; available: {avail}"
        )
    with open(path) as f:
        return yaml.safe_load(f) or {}


def load_config(experiment: str, overrides: Optional[Sequence[str]] = None) -> Dict:
    cfg = _load_yaml(experiment)
    chain = [cfg]
    while "defaults" in chain[-1]:
        parent = _load_yaml(chain[-1].pop("defaults"))
        chain.append(parent)
    merged: Dict = {}
    for layer in reversed(chain):
        deep_update(merged, layer)
    if overrides:
        deep_update(merged, parse_overrides(list(overrides)))
    return merged
