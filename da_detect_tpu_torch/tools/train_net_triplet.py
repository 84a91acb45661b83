"""Triplet DA trainer (port of ``da_detect_tpu/tools/train_net_triplet.py``;
reference tools/train_net_triplet.py): the WACV-23 method's entry point:
cosine learning rate, (source, positive, negative) domain triples,
adaptive-margin triplet regularization.

    python -m da_detect_tpu_torch.tools.train_net_triplet \
        --config-file configs/da_faster_rcnn/<yaml> [--device cpu] \
        [KEY VALUE ...]
"""

from __future__ import annotations

from .common import base_parser, setup
from .train_core import run_training


def main(argv=None):
    args = base_parser("DA-Detect triplet training (PyTorch port)"
                       ).parse_args(argv)
    cfg, logger, device = setup(args, "da_detect_tpu_torch.train_triplet")
    if not cfg.MODEL.DOMAIN_ADAPTATION_ON:
        logger.warning("DOMAIN_ADAPTATION_ON is False: training source-only")
        mode = "source_only"
    else:
        mode = "da_triplet" if cfg.DATASETS.TARGET_TRAIN_negative else "da"
    logger.info("cosine annealing is chosen for lr scheduler")
    return run_training(cfg, logger, mode=mode, schedule_kind="cosine",
                        device=device, skip_test=args.skip_test,
                        seed=args.seed, log_period=args.log_period,
                        use_tensorboard=args.use_tensorboard,
                        profile_dir=args.profile)


if __name__ == "__main__":
    main()
