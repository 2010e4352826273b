"""YAML overlay configuration (the port's copy of radzero_tpu/config/config.py).

The reference's ``Config`` (common/utils.py:21-62): a base YAML file plus
an *ordered* list of overlay YAML files, deep-merged so later files win on
leaf collisions, then the command line's arguments merged under
``cfg["args"]``, with ``user`` / ``name`` overriding ``experiment.user`` /
``experiment.name``. PyYAML in place of OmegaConf; the merge
(``update_nested_dict``) is the same.

The YAML files beside this module are the JAX package's, value for value,
but for the keys ``configs/paths.yaml`` names (tests/test_torch_config.py
holds them to the JAX loader's dict).
"""

from __future__ import annotations

import argparse
import os
from typing import Any, Dict, List, Optional

import yaml


def update_nested_dict(original: Dict[str, Any], updates: Dict[str, Any]) -> None:
    """Deep-merge ``updates`` into ``original`` in place (ref common/utils.py:21-29)."""
    for key, value in updates.items():
        if key in original and isinstance(value, dict) and isinstance(original[key], dict):
            update_nested_dict(original[key], value)
        else:
            original[key] = value


def _load_yaml(path: str) -> Dict[str, Any]:
    with open(path, "r") as f:
        data = yaml.safe_load(f)
    return data or {}


def _overlay_path(cfg_path: str, cfg_name: str) -> str:
    """``configs/<name>.yaml`` beside the base file, else ``cfg_name`` itself
    (with ``.yaml`` added when it lacks it) where that file exists."""
    name = cfg_name if cfg_name.endswith(".yaml") else cfg_name + ".yaml"
    path = os.path.join(os.path.dirname(cfg_path), "configs", name)
    if not os.path.exists(path) and os.path.exists(name):
        return name
    return path


def load_config(
    cfg_path: str,
    add_cfg_list: Optional[List[str]] = None,
    overrides: Optional[Dict[str, Any]] = None,
) -> Dict[str, Any]:
    """Load base YAML + ordered overlays (+ programmatic overrides last)."""
    config = _load_yaml(cfg_path)
    for cfg_name in add_cfg_list or []:
        update_nested_dict(config, _load_yaml(_overlay_path(cfg_path, cfg_name)))
    if overrides:
        update_nested_dict(config, overrides)
    return config


class Config:
    """argparse-driven variant matching the reference CLI contract (common/utils.py:32-62)."""

    def __init__(self, args: argparse.Namespace):
        self.config = load_config(args.cfg_path, getattr(args, "add_cfg_list", []) or [])
        self.config["args"] = vars(args)
        for key in ("user", "name"):
            if self.config["args"].get(key):
                self.config.setdefault("experiment", {})[key] = self.config["args"][key]

    def __getitem__(self, key: str) -> Any:
        return self.config[key]

    def get(self, key: str, default: Any = None) -> Any:
        return self.config.get(key, default)


def str2bool(v) -> bool:
    """CLI boolean parser (ref common/utils.py:159-167)."""
    if isinstance(v, bool):
        return v
    if v.lower() in ("yes", "true", "t", "y", "1"):
        return True
    if v.lower() in ("no", "false", "f", "n", "0"):
        return False
    raise argparse.ArgumentTypeError("Boolean value expected.")
