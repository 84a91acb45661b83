"""Classic trainer (port of ``da_detect_tpu/tools/train_net.py``; reference
tools/train_net.py): source-only, or 2-domain DA when
``MODEL.DOMAIN_ADAPTATION_ON``; warmup multi-step schedule.

    python -m da_detect_tpu_torch.tools.train_net --config-file <yaml> \
        [--device cpu] [KEY VALUE ...]
"""

from __future__ import annotations

from .common import base_parser, setup
from .train_core import run_training


def main(argv=None):
    args = base_parser("DA-Detect training (PyTorch port)").parse_args(argv)
    cfg, logger, device = setup(args, "da_detect_tpu_torch.train")
    mode = "da" if cfg.MODEL.DOMAIN_ADAPTATION_ON else "source_only"
    return run_training(cfg, logger, mode=mode, schedule_kind="multistep",
                        device=device, skip_test=args.skip_test,
                        seed=args.seed, log_period=args.log_period,
                        use_tensorboard=args.use_tensorboard,
                        profile_dir=args.profile)


if __name__ == "__main__":
    main()
