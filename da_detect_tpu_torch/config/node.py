"""A minimal yacs-compatible config tree.

The reference framework drives everything off a yacs ``CfgNode`` singleton
(reference: maskrcnn_benchmark/config/__init__.py, defaults.py:21-430) merged
from YAML files plus ``KEY VALUE`` CLI pairs. We keep the same public surface
(attribute access, ``merge_from_file``, ``merge_from_list``, ``clone``,
``freeze``) so the reference's ``configs/*.yaml`` zoo parses unchanged, without
depending on yacs.
"""

from __future__ import annotations

import ast
import copy
from typing import Any, Iterable

import yaml


class ConfigError(Exception):
    pass


_VALID_SCALARS = (int, float, bool, str, type(None))


def _check_value(full_key: str, v: Any) -> Any:
    if isinstance(v, dict):
        return CfgNode({k: _check_value(f"{full_key}.{k}", vv) for k, vv in v.items()})
    if isinstance(v, list):
        v = tuple(v)
    if isinstance(v, tuple):
        return tuple(_check_value(full_key, x) for x in v)
    if not isinstance(v, _VALID_SCALARS):
        raise ConfigError(f"invalid config value type at {full_key}: {type(v)}")
    return v


def _decode(v: Any) -> Any:
    """yacs-style value decoding: strings that parse as python literals
    (e.g. the "(600,)" tuples the reference yamls use) become those literals."""
    if isinstance(v, str):
        try:
            out = ast.literal_eval(v)
            if isinstance(out, _VALID_SCALARS + (tuple, list)):
                return out
        except (ValueError, SyntaxError):
            pass
    return v


def _coerce(old: Any, new: Any, full_key: str) -> Any:
    """Coerce `new` toward the type of the default `old` (yacs semantics)."""
    if old is None or new is None:
        return new
    if isinstance(old, tuple) and isinstance(new, (list, tuple)):
        return tuple(new)
    if isinstance(old, tuple) and isinstance(new, _VALID_SCALARS):
        # scalar into a tuple-typed key (e.g. MIN_SIZE_TRAIN: 600)
        return (new,)
    if type(old) is type(new):
        return new
    # int -> float promotion; bool is not an int here
    if isinstance(old, float) and isinstance(new, int) and not isinstance(new, bool):
        return float(new)
    if isinstance(old, str):
        return str(new)
    raise ConfigError(
        f"type mismatch at {full_key}: default {type(old).__name__} vs new {type(new).__name__}"
    )


class CfgNode(dict):
    """dict with attribute access, recursive merge, and freeze support."""

    __IMMUTABLE = "_cfgnode_immutable"

    def __init__(self, init: dict | None = None):
        super().__init__()
        object.__setattr__(self, CfgNode.__IMMUTABLE, False)
        if init:
            for k, v in init.items():
                super().__setitem__(k, _check_value(k, v))

    # -- attribute protocol ------------------------------------------------
    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError:
            raise AttributeError(name)

    def __setattr__(self, name: str, value: Any) -> None:
        if object.__getattribute__(self, CfgNode.__IMMUTABLE):
            raise ConfigError(f"cannot set {name}: config is frozen")
        super().__setitem__(name, _check_value(name, value))

    def __setitem__(self, name: str, value: Any) -> None:
        if object.__getattribute__(self, CfgNode.__IMMUTABLE):
            raise ConfigError(f"cannot set {name}: config is frozen")
        super().__setitem__(name, _check_value(name, value))

    # -- merge -------------------------------------------------------------
    def _merge_dict(self, other: dict, prefix: str = "") -> None:
        for k, v in other.items():
            full_key = f"{prefix}.{k}" if prefix else str(k)
            if k not in self:
                raise ConfigError(f"unknown config key: {full_key}")
            cur = self[k]
            if isinstance(cur, CfgNode):
                if not isinstance(v, dict):
                    raise ConfigError(f"cannot overwrite node {full_key} with a scalar")
                cur._merge_dict(v, full_key)
            else:
                v = _decode(v)
                super().__setitem__(k, _check_value(full_key, _coerce(cur, _check_value(full_key, v), full_key)))

    def merge_from_other_cfg(self, other: "CfgNode") -> None:
        self._merge_dict(other)

    def merge_from_file(self, path: str) -> None:
        with open(path) as f:
            data = yaml.safe_load(f)
        if data:
            self._merge_dict(data)

    def merge_from_list(self, opts: Iterable[Any]) -> None:
        opts = list(opts)
        if len(opts) % 2 != 0:
            raise ConfigError("merge_from_list expects KEY VALUE pairs")
        for key, value in zip(opts[0::2], opts[1::2]):
            node = self
            parts = str(key).split(".")
            for p in parts[:-1]:
                nxt = node.get(p)
                if not isinstance(nxt, CfgNode):
                    raise ConfigError(f"unknown config key: {key}")
                node = nxt
            leaf = parts[-1]
            if leaf not in node:
                raise ConfigError(f"unknown config key: {key}")
            value = _decode(value)
            dict.__setitem__(node, leaf, _check_value(key, _coerce(node[leaf], _check_value(key, value), key)))

    # -- lifecycle ---------------------------------------------------------
    def clone(self) -> "CfgNode":
        out = CfgNode()
        for k, v in self.items():
            dict.__setitem__(out, k, v.clone() if isinstance(v, CfgNode) else copy.deepcopy(v))
        return out

    def freeze(self) -> None:
        object.__setattr__(self, CfgNode.__IMMUTABLE, True)
        for v in self.values():
            if isinstance(v, CfgNode):
                v.freeze()

    def defrost(self) -> None:
        object.__setattr__(self, CfgNode.__IMMUTABLE, False)
        for v in self.values():
            if isinstance(v, CfgNode):
                v.defrost()

    def is_frozen(self) -> bool:
        return object.__getattribute__(self, CfgNode.__IMMUTABLE)

    def dump(self) -> str:
        def to_plain(n):
            return {k: to_plain(v) if isinstance(v, CfgNode) else (list(v) if isinstance(v, tuple) else v) for k, v in n.items()}

        return yaml.safe_dump(to_plain(self), sort_keys=True)

    def __deepcopy__(self, memo):
        return self.clone()

    def __reduce__(self):
        # through __init__ (dict's default sets items before it runs): the
        # ranks of a data-parallel run receive their config pickled
        return (CfgNode, (dict(self),), self.is_frozen())

    def __setstate__(self, frozen: bool) -> None:
        if frozen:
            self.freeze()

    def __repr__(self) -> str:
        return f"CfgNode({dict.__repr__(self)})"
