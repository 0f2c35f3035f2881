"""YAML config tree with attribute access and an argparse merge.

The three-section `model / data / training` schema of the JAX package's
`utils/config.py` and its `cfg.update_flat(vars(args))` pattern: dotted-path
get and set, `None` from YAML `null`, and a dump for the run directory's
`config.yaml` copy.

Files are read with PyYAML's `safe_load` and written with `safe_dump`, as
in the JAX package (imported where they are used, so that importing the
port needs no PyYAML). PyYAML resolves YAML 1.1, under which `2e-4` and
`1e-08` are strings (a float needs a dot): callers convert with
`float(...)` where they need a number, as the JAX package's do.
"""
from __future__ import annotations

import copy
from typing import Any, Dict, Optional


class Config(dict):
    """dict with recursive attribute access: cfg.model.unet.resolution."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        for k, v in list(self.items()):
            if not isinstance(v, Config):
                super().__setitem__(k, _wrap(v))

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = _wrap(value)

    def get_path(self, path: str, default: Any = None) -> Any:
        node: Any = self
        for part in path.split("."):
            if not isinstance(node, dict) or part not in node:
                return default
            node = node[part]
        return node

    def set_path(self, path: str, value: Any) -> None:
        parts = path.split(".")
        node = self
        for p in parts[:-1]:
            if p not in node or not isinstance(node[p], dict):
                node[p] = Config()
            node = node[p]
        node[parts[-1]] = _wrap(value)

    def update_flat(self, flat: Dict[str, Any]) -> None:
        """Merge a flat dict (e.g. vars(args)); keys may be dotted paths.
        A None never overwrites a value (argparse defaults)."""
        for k, v in flat.items():
            if v is None and self.get_path(k) is not None:
                continue
            self.set_path(k, v)

    def to_dict(self) -> dict:
        return _unwrap(self)

    def dump(self, path: str) -> None:
        import yaml
        with open(path, "w") as f:
            yaml.safe_dump(self.to_dict(), f, sort_keys=False)

    def clone(self) -> "Config":
        return _wrap(copy.deepcopy(self.to_dict()))


def _wrap(v: Any) -> Any:
    if isinstance(v, Config):
        return v
    if isinstance(v, dict):
        return Config({k: _wrap(x) for k, x in v.items()})
    if isinstance(v, list):
        return [_wrap(x) for x in v]
    return v


def _unwrap(v: Any) -> Any:
    if isinstance(v, dict):
        return {k: _unwrap(x) for k, x in v.items()}
    if isinstance(v, list):
        return [_unwrap(x) for x in v]
    return v


def load_config(path: str, overrides: Optional[Dict[str, Any]] = None) -> Config:
    import yaml
    with open(path) as f:
        cfg = _wrap(yaml.safe_load(f) or {})
    if overrides:
        cfg.update_flat(overrides)
    return cfg


def load_config_dict(d: Optional[Dict[str, Any]],
                     overrides: Optional[Dict[str, Any]] = None) -> Config:
    """A Config from an in-memory dict: the programmatic twin of load_config."""
    cfg = _wrap(d or {})
    if overrides:
        cfg.update_flat(overrides)
    return cfg
