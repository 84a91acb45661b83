"""Config system: yacs-compatible tree + dataset/model catalogs.

Unlike the reference (global mutable ``cfg`` singleton,
maskrcnn_benchmark/config/__init__.py), the canonical API here is
``get_cfg()`` returning a fresh clone; a module-level ``cfg`` is still
exported for drop-in compatibility with reference-style tooling.
"""

from .node import CfgNode, ConfigError
from .defaults import get_default_cfg
from .catalog import DatasetCatalog, ModelCatalog


def get_cfg() -> CfgNode:
    """Return a fresh mutable copy of the default config."""
    return get_default_cfg()


# compatibility singleton (reference tools mutate this in place)
cfg = get_default_cfg()

__all__ = ["CfgNode", "ConfigError", "get_cfg", "cfg", "DatasetCatalog", "ModelCatalog"]
