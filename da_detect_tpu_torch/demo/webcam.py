"""Detections on a camera's frames, shown in a window until ESC (port of
``da_detect_tpu/demo/webcam.py``; reference demo/webcam.py).

    python -m da_detect_tpu_torch.demo.webcam --config-file <yaml> \
        [--camera 0] [--device cpu] [KEY VALUE ...]
"""

from __future__ import annotations

import argparse

from ..config import get_cfg
from .predictor import COCODemo, require_cv2


def main(argv=None):
    p = argparse.ArgumentParser(description="webcam detection demo")
    p.add_argument("--config-file", required=True)
    p.add_argument("--confidence-threshold", type=float, default=0.7)
    p.add_argument("--camera", type=int, default=0)
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
                    device=args.device)
    cam = cv.VideoCapture(args.camera)
    frames = 0
    while True:
        ret, img = cam.read()
        if not ret:
            break
        cv.imshow("DA-Detect", demo.run_on_opencv_image(img))
        frames += 1
        if cv.waitKey(1) == 27:  # ESC
            break
    cam.release()
    cv.destroyAllWindows()
    return frames


if __name__ == "__main__":
    main()
