"""The triplet's rainy auxiliary domain (port of
``da_detect_tpu/tools/generate_rainy_dataset.py``; reference
efficientderain-master/generate_rainy_cityscape.py).

    python -m da_detect_tpu_torch.tools.generate_rainy_dataset \
        --src <cityscapes>/leftImg8bit --dst <rainy>/leftImg8bit \
        [--mask-dir <streak masks>] [--seed 0]

Every image of the clean tree (.png, .jpg, .jpeg) is written at the same
relative path with rain streaks screen-composited over it,
``out = img + rain - img * rain`` after darkening the image by 0.85
(``rain_aug``). Without ``--mask-dir`` the streaks are drawn procedurally
(``synth_rain_mask``: lines at one slant an image, motion-blurred); with it,
each image takes a mask of that directory at random, resized to the image.
The draws come from one ``np.random.RandomState(seed)`` in the JAX tool's
order, so both write the same pixels. The pixel-aligned rainy images reuse
the clean domain's annotations.

Host code: numpy and cv2 (lines, the blur, decode, resize and encode);
without cv2 the tool raises.
"""

from __future__ import annotations

import argparse
import glob
import os

import numpy as np

try:
    import cv2
except ImportError:
    cv2 = None

EXTENSIONS = (".png", ".jpg", ".jpeg")


def _cv2():
    if cv2 is None:
        raise ImportError("generate_rainy_dataset needs cv2 (opencv-python) "
                          "to draw, blur and write the rain streaks")
    return cv2


def synth_rain_mask(h: int, w: int, rng: np.random.RandomState,
                    density: float = 0.0012, length_rng=(18, 42),
                    slant_rng=(-12, 12), thickness: int = 1,
                    intensity_rng=(0.35, 0.9)) -> np.ndarray:
    """A procedural rain-streak field in [0, 1], float32 [h, w]: ``density``
    * h * w lines of random length and intensity at one slant, blurred
    along the vertical by a 5-tap box."""
    cv = _cv2()
    mask = np.zeros((h, w), np.float32)
    slant = rng.uniform(*slant_rng)
    dx = np.tan(np.deg2rad(slant))
    for _ in range(int(density * h * w)):
        x0 = rng.randint(0, w)
        y0 = rng.randint(-10, h)
        length = rng.randint(*length_rng)
        intensity = rng.uniform(*intensity_rng)
        cv.line(mask, (x0, y0), (int(x0 + dx * length), y0 + length),
                float(intensity), thickness)
    k = 5
    kernel = np.zeros((k, k), np.float32)
    kernel[:, k // 2] = 1.0 / k
    return np.clip(cv.filter2D(mask, -1, kernel), 0.0, 1.0)


def rain_aug(img: np.ndarray, mask: np.ndarray,
             darken: float = 0.85) -> np.ndarray:
    """Screen-composite the streaks ``mask`` [H, W] over the darkened uint8
    image [H, W, 3]."""
    x = img.astype(np.float32) / 255.0 * darken
    r = mask[..., None]
    out = x + r - x * r
    return (np.clip(out, 0.0, 1.0) * 255.0).astype(np.uint8)


def process_tree(src_root: str, dst_root: str, *, seed: int = 0,
                 mask_dir: str | None = None, exts=EXTENSIONS) -> int:
    """Write the rainy copy of ``src_root`` under ``dst_root``; returns the
    images written. Directories in ``os.walk`` order, files sorted within
    each (the JAX tool's order, which fixes the draws)."""
    cv = _cv2()
    rng = np.random.RandomState(seed)
    masks = sorted(glob.glob(os.path.join(mask_dir, "*"))) if mask_dir \
        else None
    count = 0
    for dirpath, _, filenames in os.walk(src_root):
        out_dir = os.path.join(dst_root, os.path.relpath(dirpath, src_root))
        os.makedirs(out_dir, exist_ok=True)
        for fn in sorted(filenames):
            if not fn.lower().endswith(exts):
                continue
            img = cv.imread(os.path.join(dirpath, fn), cv.IMREAD_COLOR)
            if img is None:
                continue
            h, w = img.shape[:2]
            if masks:
                m = cv.imread(masks[rng.randint(len(masks))],
                              cv.IMREAD_GRAYSCALE)
                m = cv.resize(m, (w, h)).astype(np.float32) / 255.0
            else:
                m = synth_rain_mask(h, w, rng)
            cv.imwrite(os.path.join(out_dir, fn), rain_aug(img, m))
            count += 1
    return count


def main(argv=None) -> int:
    """Returns the images written."""
    p = argparse.ArgumentParser(description="synthesize a rainy domain")
    p.add_argument("--src", required=True, help="clean image tree")
    p.add_argument("--dst", required=True, help="output tree")
    p.add_argument("--mask-dir", default=None,
                   help="rain-streak masks to use instead of drawn ones")
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    n = process_tree(args.src, args.dst, seed=args.seed,
                     mask_dir=args.mask_dir)
    print(f"wrote {n} rainy images to {args.dst}")
    return n


if __name__ == "__main__":
    main()
