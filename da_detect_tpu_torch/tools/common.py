"""Shared CLI plumbing (port of ``da_detect_tpu/tools/common.py``; reference
tools/train_net*.py:256-347): arguments, config merge, output directory,
user catalog, logging, seeding, and the device.

The tools run on the card (``--device cuda``, the default) and raise
without one; ``--device cpu`` runs the kernels' plain versions on the CPU.
"""

from __future__ import annotations

import argparse
import logging
import os
import sys

import numpy as np
import torch

from ..config import get_cfg
from ..config.catalog import load_user_catalog
from ..entry import resolve_device

_HANDLERS: list[logging.Handler] = []


def base_parser(description: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=description)
    p.add_argument("--config-file", default="", metavar="FILE")
    p.add_argument("--skip-test", action="store_true")
    # the reference's setup_seed(100)
    p.add_argument("--seed", type=int, default=100)
    p.add_argument("--device", default="cuda",
                   help="cuda (the default; raises without a card) or cpu")
    p.add_argument("--log-period", type=int, default=20,
                   help="log, and read the loss, every N iterations")
    p.add_argument("opts", nargs=argparse.REMAINDER, default=None)
    return p


def _setup_logger(output_dir: str) -> None:
    """The package's log to stderr and to ``output_dir/log.txt`` (one set of
    handlers a process: a second setup replaces the first's)."""
    root = logging.getLogger("da_detect_tpu_torch")
    for h in _HANDLERS:
        root.removeHandler(h)
        h.close()
    _HANDLERS.clear()
    fmt = logging.Formatter("%(asctime)s %(name)s %(levelname)s: %(message)s")
    for h in (logging.StreamHandler(sys.stderr),
              logging.FileHandler(os.path.join(output_dir, "log.txt"))):
        h.setFormatter(fmt)
        root.addHandler(h)
        _HANDLERS.append(h)
    root.setLevel(logging.INFO)


def setup(args, logger_name: str):
    """Returns (cfg, logger, device). ``MODEL.OUTPUT_DIR`` becomes
    ``OUTPUT_DIR/OUTPUT_SAVE_NAME``; ``PATHS_CATALOG`` names a user catalog
    module."""
    device = resolve_device(args.device)
    cfg = get_cfg()
    if args.config_file:
        cfg.merge_from_file(args.config_file)
    if args.opts:
        cfg.merge_from_list(args.opts)
    output_dir = os.path.join(cfg.MODEL.OUTPUT_DIR, cfg.MODEL.OUTPUT_SAVE_NAME)
    cfg.MODEL.OUTPUT_DIR = output_dir
    cfg.freeze()
    if cfg.PATHS_CATALOG:
        if not os.path.exists(cfg.PATHS_CATALOG):
            raise FileNotFoundError(f"PATHS_CATALOG {cfg.PATHS_CATALOG}")
        load_user_catalog(cfg.PATHS_CATALOG)
    os.makedirs(output_dir, exist_ok=True)
    _setup_logger(output_dir)
    logger = logging.getLogger(logger_name)
    logger.info("device %s (%s)", device,
                torch.cuda.get_device_name(device)
                if device.type == "cuda" else "plain kernels")
    if args.config_file:
        logger.info("loaded configuration file %s", args.config_file)
    np.random.seed(args.seed)
    return cfg, logger, device
