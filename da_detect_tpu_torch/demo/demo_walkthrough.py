# %% [markdown]
# # DA-Detect demo (PyTorch port)
#
# The runnable counterpart of the reference's `demo/Mask_R-CNN_demo.ipynb`
# (a jupytext percent-format script: open it as a notebook with
# `jupytext --to ipynb demo_walkthrough.py`, or run `python -m
# da_detect_tpu_torch.demo.demo_walkthrough [image.png ...]`). It follows
# the notebook: build a config, construct `COCODemo`, run prediction and
# the overlay on an image; the demo prepares the image, runs the forward on
# the card and post-processes.
#
# Port of `da_detect_tpu/demo/demo_walkthrough.py`.

# %%
from __future__ import annotations

import sys

import numpy as np

# %% [markdown]
# Build the model configuration. Any YAML of `configs/` works; with no
# checkpoint at hand this walkthrough keeps a random-weight COCO model at a
# small canvas, so it runs anywhere. Set `MODEL.WEIGHT` (through `opts`)
# to a checkpoint for real predictions. `device="cpu"` runs the CPU's plain
# versions of the kernels.

# %%
def build_demo(confidence_threshold: float = 0.5, masks: bool = False,
               device=None, opts=()):
    from ..config import get_cfg
    from .predictor import COCODemo

    cfg = get_cfg()
    cfg.MODEL.ROI_BOX_HEAD.NUM_CLASSES = 81  # COCO classes
    cfg.MODEL.MASK_ON = masks
    cfg.TPU.IMAGE_SHAPE = (480, 640)
    cfg.INPUT.MIN_SIZE_TEST = 448
    cfg.INPUT.MAX_SIZE_TEST = 640
    cfg.merge_from_list(list(opts))
    return COCODemo(cfg, confidence_threshold=confidence_threshold,
                    device=device)


# %% [markdown]
# Load an image as BGR uint8 (the OpenCV convention the predictor expects,
# as the notebook's `load()` converts PIL's RGB to BGR). Without a path a
# synthetic one stands in, so the walkthrough needs no file.

# %%
def load_bgr(path: str | None) -> np.ndarray:
    if path:
        from .predictor import require_cv2

        img = require_cv2().imread(path)
        if img is None:
            raise FileNotFoundError(path)
        return img
    rng = np.random.RandomState(0)
    img = np.full((480, 640, 3), 160, np.uint8)
    img[140:300, 200:420] = (40, 90, 200)  # a "thing" to look at
    img += rng.randint(0, 20, img.shape, dtype=np.uint8)
    return img


# %% [markdown]
# Compute the predictions and the annotated overlay. `run_on_opencv_image`
# is the single entry point (boxes, classes and scores; mask contours and
# keypoint skeletons when the model has those heads).

# %%
def main(argv=None, device=None, opts=()):
    from .predictor import require_cv2

    argv = sys.argv[1:] if argv is None else argv
    demo = build_demo(device=device, opts=opts)
    for path in argv or [None]:
        overlay = demo.run_on_opencv_image(load_bgr(path))
        out = (path or "demo") + ".pred.png"
        require_cv2().imwrite(out, overlay)
        print(f"wrote {out} ({overlay.shape[1]}x{overlay.shape[0]})")
    return 0


# %%
if __name__ == "__main__":
    main()
