"""Offline dataset staging CLI (port of
``da_detect_tpu/tools/stage_dataset.py``): decode and prep every (image,
geometry) variant of the configured datasets into the staging cache
(``data/staging.py``, ``DATALOADER.STAGE_DIR``), so that a later training
or evaluation run decodes nothing.

    python -m da_detect_tpu_torch.tools.stage_dataset --config-file <yaml> \
        [--eval] [KEY VALUE ...]

Staging runs on the host; ``--device`` is not used.
"""

from __future__ import annotations

import time

from ..data import prestage_datasets
from .common import base_parser, setup


def main(argv=None) -> int:
    """Returns the number of canvases staged."""
    p = base_parser("DA-Detect offline dataset staging (PyTorch port)")
    p.add_argument("--eval", action="store_true",
                   help="stage the TEST datasets (eval geometry) instead of "
                        "the train/DA datasets")
    p.set_defaults(device="cpu")
    args = p.parse_args(argv)
    cfg, logger, _ = setup(args, "da_detect_tpu_torch.stage")
    if not cfg.DATALOADER.STAGE_CACHE:
        logger.warning("DATALOADER.STAGE_CACHE is off: nothing to do")
        return 0
    t0 = time.perf_counter()
    n = prestage_datasets(cfg, is_train=not args.eval)
    dt = time.perf_counter() - t0
    logger.info("staged %d canvases in %.1fs (%.1f ms each)", n, dt,
                1e3 * dt / max(n, 1))
    return n


if __name__ == "__main__":
    main()
