"""Shared CLI plumbing (port of ``da_detect_tpu/tools/common.py``; reference
tools/train_net*.py:256-347): arguments, config merge, output directory,
user catalog, logging, seeding, and the device.

The tools run on the card (``--device cuda``, the default) and raise
without one; ``--device cpu`` runs the kernels' plain versions on the CPU.
``--profile DIR`` writes a ``torch.profiler`` trace of training iterations
10-20 there; ``--use-tensorboard`` logs the training meters as TensorBoard
scalars under ``TENSORBOARD_EXPERIMENT``.

Under ``torchrun --nproc_per_node N -m da_detect_tpu_torch.tools.<cli>``
``setup`` starts the process group (NCCL, one card a rank; gloo with
``--device cpu``): each rank trains data-parallel on its own
IMS_PER_BATCH // 2 triples and evaluates its shard of the test set. The
main process creates the output directory and logs to stdout; every rank
logs to ``log_rank<r>.txt`` there. Run plainly, a CLI is one process.
"""

from __future__ import annotations

import argparse
import logging
import os

import numpy as np
import torch

from ..config import get_cfg
from ..config.catalog import load_user_catalog
from ..entry import resolve_device
from ..parallel.ddp import check_mesh, init_distributed
from ..utils import comm
from ..utils.env import setup_environment
from ..utils.logging_utils import collect_env_info, setup_logger


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
    p.add_argument("--use-tensorboard", action="store_true")
    p.add_argument("--profile", default="",
                   help="directory to write a torch.profiler trace of "
                        "iterations 10-20")
    p.add_argument("opts", nargs=argparse.REMAINDER, default=None)
    return p


def setup(args, logger_name: str):
    """Returns (cfg, logger, device). ``MODEL.OUTPUT_DIR`` becomes
    ``OUTPUT_DIR/OUTPUT_SAVE_NAME``; ``PATHS_CATALOG`` names a user catalog
    module. Under ``torchrun`` the process group starts here (the device is
    the rank's card) and ``TPU.MESH_*`` are checked against its size."""
    setup_environment()
    device = init_distributed(resolve_device(args.device))
    rank, world = comm.get_rank(), comm.get_world_size()
    cfg = get_cfg()
    if args.config_file:
        cfg.merge_from_file(args.config_file)
    if args.opts:
        cfg.merge_from_list(args.opts)
    output_dir = os.path.join(cfg.MODEL.OUTPUT_DIR, cfg.MODEL.OUTPUT_SAVE_NAME)
    cfg.MODEL.OUTPUT_DIR = output_dir
    cfg.freeze()
    check_mesh(cfg, world)
    if cfg.PATHS_CATALOG:
        if not os.path.exists(cfg.PATHS_CATALOG):
            raise FileNotFoundError(f"PATHS_CATALOG {cfg.PATHS_CATALOG}")
        load_user_catalog(cfg.PATHS_CATALOG)
    if comm.is_main_process():
        os.makedirs(output_dir, exist_ok=True)
    comm.synchronize()
    # the package's root logger, so that the engine's and data's logs show
    setup_logger("da_detect_tpu_torch", output_dir, rank)
    logger = logging.getLogger(logger_name)
    logger.info("device %s (%s), rank %d of %d", device,
                torch.cuda.get_device_name(device)
                if device.type == "cuda" else "plain kernels", rank, world)
    if args.config_file:
        logger.info("loaded configuration file %s", args.config_file)
    logger.info("environment:\n%s", collect_env_info())
    np.random.seed(args.seed)
    return cfg, logger, device


def ablation_main(argv, description: str, zeroed: tuple, logger_name: str):
    """The DA ablation CLIs: ``train_net``'s DA training (multistep
    schedule) with the loss weights ``zeroed`` set to 0 before the user's
    options, as the JAX package's do."""
    from .train_core import run_training

    args = base_parser(description).parse_args(argv)
    args.opts = [x for key in zeroed for x in (key, "0.0")] + (
        args.opts or [])
    cfg, logger, device = setup(args, logger_name)
    return run_training(cfg, logger, mode="da", schedule_kind="multistep",
                        device=device, skip_test=args.skip_test,
                        seed=args.seed, log_period=args.log_period,
                        use_tensorboard=args.use_tensorboard,
                        profile_dir=args.profile)
