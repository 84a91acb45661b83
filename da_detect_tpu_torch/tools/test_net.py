"""Evaluation CLI (port of ``da_detect_tpu/tools/test_net.py``; reference
tools/test_net.py). ``--ckpt`` names a training output directory (its
newest checkpoint's model is restored) or a weight file (C2 ``.pkl`` or
torch ``.pth``); without it, ``MODEL.OUTPUT_DIR``'s checkpoint or else
``MODEL.WEIGHT``.

    python -m da_detect_tpu_torch.tools.test_net --config-file <yaml> \
        --ckpt OUTPUT_DIR/OUTPUT_SAVE_NAME [--device cpu] [KEY VALUE ...]
"""

from __future__ import annotations

from ..utils.checkpoint import Checkpointer, load_weight_file
from .common import base_parser, setup
from .train_core import build_model, run_eval


def main(argv=None):
    p = base_parser("DA-Detect evaluation (PyTorch port)")
    p.add_argument("--ckpt", default="", help="checkpoint dir or weight file")
    args = p.parse_args(argv)
    cfg, logger, device = setup(args, "da_detect_tpu_torch.test")
    model = build_model(cfg, device, args.seed)
    ck = Checkpointer(args.ckpt or cfg.MODEL.OUTPUT_DIR)
    weight = args.ckpt or cfg.MODEL.WEIGHT
    if ck.has_checkpoint():
        step = ck.resume_model(model)
        logger.info("loaded checkpoint at iteration %d", step)
    elif weight:
        load_weight_file(weight, model,
                         cfg.MODEL.ROI_BOX_HEAD.POOLER_RESOLUTION)
    return run_eval(cfg, logger, model, device)


if __name__ == "__main__":
    main()
