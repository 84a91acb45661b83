"""Draw the detections of every image of a folder (port of
``da_detect_tpu/demo/draw_detection.py``; reference
demo/draw_detection.py).

    python -m da_detect_tpu_torch.demo.draw_detection --config-file <yaml> \
        --input-dir IN --output-dir OUT [--weight W] [--device cpu] \
        [KEY VALUE ...]
"""

from __future__ import annotations

import argparse
import glob
import os

from ..config import get_cfg
from .predictor import COCODemo, require_cv2


def main(argv=None):
    p = argparse.ArgumentParser(description="draw detections on a folder")
    p.add_argument("--config-file", required=True)
    p.add_argument("--input-dir", required=True)
    p.add_argument("--output-dir", required=True)
    p.add_argument("--confidence-threshold", type=float, default=0.7)
    p.add_argument("--weight", default="")
    p.add_argument("--device", default="cuda",
                   help="cuda (the default; raises without a card) or cpu")
    p.add_argument("opts", nargs=argparse.REMAINDER, default=None)
    args = p.parse_args(argv)
    cv = require_cv2()

    cfg = get_cfg()
    cfg.merge_from_file(args.config_file)
    if args.opts:
        cfg.merge_from_list(args.opts)
    cfg.freeze()

    demo = COCODemo(cfg, confidence_threshold=args.confidence_threshold,
                    weight=args.weight or None, device=args.device)
    os.makedirs(args.output_dir, exist_ok=True)
    paths = sorted(sum((glob.glob(os.path.join(args.input_dir, e))
                        for e in ("*.png", "*.jpg", "*.jpeg")), []))
    for path in paths:
        out = demo.run_on_opencv_image(cv.imread(path))
        dst = os.path.join(args.output_dir, os.path.basename(path))
        cv.imwrite(dst, out)
        print(f"{path} -> {dst}")
    return paths


if __name__ == "__main__":
    main()
