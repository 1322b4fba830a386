"""YAML configuration (the port's copy of ``mindaudio_tpu.train.config``,
pinned to it by ``tests/test_torch_recipe_infra.py``).

An attribute-dict ``Config`` with ``base_config`` inheritance (child keys
win) and a ``--dotted.key`` command-line flag for every scalar or list key,
re-typed from the YAML value it overrides.
"""

from __future__ import annotations

import argparse
import os
from typing import Optional

import yaml

__all__ = ["Config", "load_config", "get_config", "parse_cli_to_yaml"]


class Config(dict):
    """dict with attribute access, recursively applied."""

    def __init__(self, d=None):
        super().__init__()
        for k, v in (d or {}).items():
            self[k] = Config(v) if isinstance(v, dict) else v

    def __getattr__(self, name):
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name, value):
        self[name] = Config(value) if isinstance(value, dict) else value

    def to_dict(self):
        return {k: v.to_dict() if isinstance(v, Config) else v for k, v in self.items()}


def _deep_merge(base: dict, override: dict) -> dict:
    out = dict(base)
    for k, v in override.items():
        if k in out and isinstance(out[k], dict) and isinstance(v, dict):
            out[k] = _deep_merge(out[k], v)
        else:
            out[k] = v
    return out


def load_config(path: str) -> Config:
    """Load YAML with ``base_config`` inheritance (child keys win)."""
    with open(path) as f:
        cfg = yaml.safe_load(f) or {}
    base_path = cfg.pop("base_config", None)
    if base_path:
        if not os.path.isabs(base_path):
            base_path = os.path.join(os.path.dirname(path), base_path)
        base = load_config(base_path).to_dict()
        cfg = _deep_merge(base, cfg)
    return Config(cfg)


def parse_cli_to_yaml(cfg: Config, argv=None, parser: Optional[argparse.ArgumentParser] = None):
    """Auto-generate ``--dotted.key`` CLI flags for every scalar key and merge."""
    parser = parser or argparse.ArgumentParser()

    def add_flags(prefix, d):
        for k, v in d.items():
            key = f"{prefix}{k}"
            if isinstance(v, dict):
                add_flags(key + ".", v)
            elif isinstance(v, (int, float, str, bool, list)) or v is None:
                # every flag parses as str; the YAML value is re-typed at
                # merge time — a numeric default must not hard-reject a
                # numeric override of a different kind (--ctc_weight 0.3
                # over an int-zero default), and a null default must not
                # lock the key to str forever. List keys take YAML syntax
                # ("[200,400]"); a bare scalar becomes a one-element list.
                parser.add_argument(f"--{key}", type=str, default=None)

    add_flags("", cfg)
    args, _ = parser.parse_known_args(argv)

    def retype(old, raw: str):
        if isinstance(old, bool):
            return raw.lower() in ("1", "true", "yes")
        try:  # numbers / null / lists parse as YAML scalars
            parsed = yaml.safe_load(raw)
        except yaml.YAMLError:
            return raw
        if isinstance(old, str) and not isinstance(parsed, str):
            return raw  # string-typed keys keep the literal text
        if isinstance(old, list) and not isinstance(parsed, list):
            return [parsed]  # bare scalar over a list key → one-element list
        return parsed

    for key, val in vars(args).items():
        if val is None:
            continue
        node = cfg
        parts = key.split(".")
        for p in parts[:-1]:
            node = node[p]
        node[parts[-1]] = retype(node.get(parts[-1]), val)
    return cfg


def get_config(path: str, argv=None) -> Config:
    """Load ``path`` and merge the command-line overrides of ``argv``."""
    return parse_cli_to_yaml(load_config(path), argv)
