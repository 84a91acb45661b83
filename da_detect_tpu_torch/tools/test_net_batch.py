"""Batch evaluation over every checkpoint in a directory (port of
``da_detect_tpu/tools/test_net_batch.py``; reference tools/test_net_batch.py
loops over the model_*.pth files): each checkpoint's model, oldest first,
through ``train_core.run_eval``.

    python -m da_detect_tpu_torch.tools.test_net_batch --config-file <yaml> \
        --ckpt-dir OUTPUT_DIR/OUTPUT_SAVE_NAME [--device cpu] [KEY VALUE ...]
"""

from __future__ import annotations

from ..utils.checkpoint import Checkpointer
from .common import base_parser, setup
from .train_core import build_model, run_eval


def main(argv=None) -> dict:
    """Returns {iteration: run_eval's results}."""
    p = base_parser("DA-Detect batch evaluation (PyTorch port)")
    p.add_argument("--ckpt-dir", required=True)
    args = p.parse_args(argv)
    cfg, logger, device = setup(args, "da_detect_tpu_torch.test_batch")
    model = build_model(cfg, device, args.seed)
    ck = Checkpointer(args.ckpt_dir)
    steps = ck.all_steps()
    logger.info("found %d checkpoints: %s", len(steps), steps)
    results = {}
    for step in steps:
        ck.load_model(model, step)
        logger.info("===== evaluating checkpoint %d =====", step)
        results[step] = run_eval(cfg, logger, model, device)
    return results


if __name__ == "__main__":
    main()
