"""Export a serving artifact of the eval forward (port of
``da_detect_tpu/tools/export_serving.py``): the fixed-canvas eval program
is exported once and shipped beside the weights, so a serving process
needs no model code (``--format stablehlo``) and, on the card, replays one
CUDA graph a request (``--format aot``; ``engine/serving.py``).

    python -m da_detect_tpu_torch.tools.export_serving \\
        --config-file configs/da_faster_rcnn/....yaml \\
        --output serving.pt2 --format aot [--ckpt DIR] [--batch-size N] \\
        [--with-masks | --with-keypoints] [--image-dtype uint8] \\
        [--device cpu]

``--ckpt`` names a training output directory (its newest checkpoint's
model) or a weight file; without it, ``MODEL.OUTPUT_DIR``'s checkpoint or
else ``MODEL.WEIGHT``, as ``test_net`` takes them. Load side::

    from da_detect_tpu_torch.engine.serving import load_serving
    serving = load_serving("serving.pt2")
    detections = serving(model.state_dict(), image_batch)
"""

from __future__ import annotations

import torch

from ..engine.serving import export_serving
from ..utils.checkpoint import Checkpointer, load_weight_file
from .common import base_parser, setup
from .train_core import build_model


def main(argv=None):
    p = base_parser("DA-Detect serving export (PyTorch port)")
    p.add_argument("--output", required=True, help="artifact path (.pt2)")
    p.add_argument("--format", default="aot", choices=("aot", "stablehlo"))
    p.add_argument("--ckpt", default="", help="checkpoint dir or weight file")
    p.add_argument("--batch-size", type=int, default=1)
    p.add_argument("--with-masks", action="store_true")
    p.add_argument("--with-keypoints", action="store_true")
    p.add_argument("--image-dtype", default="float32",
                   choices=("float32", "uint8"),
                   help="uint8 exports a raw-pixel server: clients ship 1 "
                        "byte a pixel, normalization runs inside the "
                        "exported program (engine/serving.py::batch_spec)")
    args = p.parse_args(argv)
    cfg, logger, device = setup(args, "da_detect_tpu_torch.export_serving")
    model = build_model(cfg, device, args.seed)
    ck = Checkpointer(args.ckpt or cfg.MODEL.OUTPUT_DIR)
    weight = args.ckpt or cfg.MODEL.WEIGHT
    if ck.has_checkpoint():
        step = ck.resume_model(model)
        logger.info("exporting with checkpoint at iteration %d", step)
    elif weight:
        load_weight_file(weight, model,
                         cfg.MODEL.ROI_BOX_HEAD.POOLER_RESOLUTION)
    meta = export_serving(cfg, model, model.state_dict(), args.output,
                          fmt=args.format, batch_size=args.batch_size,
                          with_masks=args.with_masks,
                          with_keypoints=args.with_keypoints,
                          image_dtype=getattr(torch, args.image_dtype))
    logger.info("wrote %s: %s", args.output,
                {k: v for k, v in meta.items() if k != "variables"})
    return meta


if __name__ == "__main__":
    main()
