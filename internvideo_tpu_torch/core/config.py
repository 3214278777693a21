"""Typed configuration: python-file configs + dotlist CLI overrides.

Port of internvideo_tpu/core/config.py (pure Python, same behaviour). A
config file is a python module defining `config` (any dataclass). Overrides
are `a.b.c=value` strings; values parse as python literals when possible,
else stay strings. Dataclasses are immutable, so overrides rebuild them with
dataclasses.replace along the path.
"""

from __future__ import annotations

import ast
import dataclasses
import importlib.util
import sys
from typing import Any, Sequence


def load_config(path: str) -> Any:
    spec = importlib.util.spec_from_file_location("_ivt_torch_config", path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules["_ivt_torch_config"] = mod
    spec.loader.exec_module(mod)
    if not hasattr(mod, "config"):
        raise ValueError(f"{path} must define a `config` object")
    return mod.config


def _parse_value(s: str) -> Any:
    try:
        return ast.literal_eval(s)
    except (ValueError, SyntaxError):
        return s


def apply_overrides(cfg: Any, overrides: Sequence[str]) -> Any:
    for item in overrides:
        if "=" not in item:
            raise ValueError(f"override {item!r} is not key=value")
        key, raw = item.split("=", 1)
        cfg = _set_path(cfg, key.strip().split("."), _parse_value(raw.strip()))
    return cfg


def _set_path(node: Any, path: list[str], value: Any) -> Any:
    key = path[0]
    if dataclasses.is_dataclass(node):
        if not hasattr(node, key):
            raise AttributeError(f"{type(node).__name__} has no field {key!r}")
        child = getattr(node, key)
        new_child = value if len(path) == 1 else _set_path(child, path[1:], value)
        return dataclasses.replace(node, **{key: new_child})
    if isinstance(node, dict):
        child = node.get(key)
        new_child = value if len(path) == 1 else _set_path(child, path[1:], value)
        return {**node, key: new_child}
    raise TypeError(f"cannot override into {type(node).__name__} at {key!r}")


def config_to_dict(cfg: Any) -> Any:
    if dataclasses.is_dataclass(cfg) and not isinstance(cfg, type):
        return {
            f.name: config_to_dict(getattr(cfg, f.name))
            for f in dataclasses.fields(cfg)
        }
    if isinstance(cfg, dict):
        return {k: config_to_dict(v) for k, v in cfg.items()}
    if isinstance(cfg, (list, tuple)):
        return [config_to_dict(v) for v in cfg]
    return cfg
