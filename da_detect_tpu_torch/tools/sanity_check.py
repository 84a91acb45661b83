"""End-to-end self-test (port of ``da_detect_tpu/tools/sanity_check.py``):
write a synthetic aligned clean / foggy / rainy triple, train the triplet-DA
detector from scratch for a few hundred steps on the card, and check that
AP50 rises: the whole stack (data -> RPN -> ROI -> DA -> eval) learns
without real datasets or pretrained weights.

    python -m da_detect_tpu_torch.tools.sanity_check [--iters 800] [--da]
    python -m da_detect_tpu_torch.tools.sanity_check --ablation --iters 200

``--ablation`` is the DA-direction gate: under a structural domain shift (a
channel-inverted target) triplet-DA training must beat source-only training
on the target domain by ``--min-gap`` AP50. ``--device cpu`` runs the plain
kernels on the CPU.

The model has a GroupNorm backbone (FrozenBN is an identity affine at init
and diverges from scratch, in the reference as in the JAX package) and
computes in ``TPU.COMPUTE_DTYPE`` (bfloat16 by default). Its GroupNorm
outputs are float32 (``layers/norms.py``), so the pooler gets a float32 C4
map and the float32 ROIAlign kernels run inside the bfloat16 model, as the
float32 Pallas ROIAlign does in the JAX package.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import tempfile
import time

import numpy as np

from .. import kernels
from ..data.image_io import write_png
from ..data.transforms import resize_u8


def build_synthetic(root: str, n_images: int, seed: int,
                    fog=(0.55, 110.0), hw=(120, 160), texture="noise",
                    invert: bool = False):
    """Noise images with solid rectangles at the GT boxes; foggy/rainy are
    pixel-aligned degradations. ``fog`` = (contrast, offset) of the target
    domain; with ``invert`` it degrades the channel-inverted image (a
    structural shift the ablation gate needs: an affine fog alone is mostly
    absorbed by the GN-normalized backbone). ``hw``: the images' size.
    ``texture="natural"``: a spatially correlated background (a coarse
    field upsampled, plus mild noise) that compresses like a photograph.

    The numpy draws are the JAX package's, in its order, so the default
    texture gives its images, annotations and catalog; "natural" upsamples
    with the port's uint8 resize (within one level of cv2's). PNGs come
    from the port's writer."""
    rng = np.random.RandomState(seed)
    h, w = hw
    dirs = {k: os.path.join(root, k) for k in ("clean", "foggy", "rainy")}
    fog_a, fog_b = fog
    for d in dirs.values():
        os.makedirs(d, exist_ok=True)
    images, annotations = [], []
    ann_id = 1
    for i in range(n_images):
        if texture == "natural":
            coarse = rng.randint(0, 60, (h // 8 + 1, w // 8 + 1, 3),
                                 dtype=np.uint8)
            img = resize_u8(coarse, h, w)
            img = (img.astype(np.int16)
                   + rng.randint(-3, 4, (h, w, 3))).clip(0, 59).astype(
                       np.uint8)
        else:
            img = rng.randint(0, 60, (h, w, 3), dtype=np.uint8)
        for _ in range(int(rng.randint(1, 4))):
            # box size scales with the canvas (15-40 px at 120x160)
            bw, bh = (int(v) for v in rng.randint(h // 8, h // 3, 2))
            x1 = int(rng.randint(0, w - bw - 1))
            y1 = int(rng.randint(0, h - bh - 1))
            lab = int(rng.randint(1, 3))
            color = (220, 40, 40) if lab == 1 else (40, 220, 40)
            img[y1:y1 + bh, x1:x1 + bw] = color
            annotations.append({
                "id": ann_id, "image_id": i + 1, "category_id": lab,
                "bbox": [x1, y1, bw, bh], "area": bw * bh, "iscrowd": 0,
                "segmentation": [[x1, y1, x1 + bw, y1, x1 + bw, y1 + bh,
                                  x1, y1 + bh]]})
            ann_id += 1
        base = (255.0 - img.astype(np.float32) if invert
                else img.astype(np.float32))
        foggy = (base * fog_a + fog_b
                 + rng.randn(h, w, 3) * 8).clip(0, 255).astype(np.uint8)
        rain = img.copy()
        rain[:, ::7] = np.minimum(rain[:, ::7].astype(int) + 120,
                                  255).astype(np.uint8)
        name = f"img_{i:04d}.png"
        for d, arr in ((dirs["clean"], img), (dirs["foggy"], foggy),
                       (dirs["rainy"], rain)):
            write_png(os.path.join(d, name), arr)
        images.append({"id": i + 1, "file_name": name, "height": h,
                       "width": w})
    with open(os.path.join(root, "instances.json"), "w") as f:
        json.dump({"images": images, "annotations": annotations,
                   "categories": [{"id": 1, "name": "car"},
                                  {"id": 2, "name": "person"}]}, f)
    cat = {f"sanity_{k}_cocostyle": {"img_dir": os.path.relpath(d, root),
                                     "ann_file": "instances.json"}
           for k, d in dirs.items()}
    with open(os.path.join(root, "catalog.json"), "w") as f:
        json.dump(cat, f)
    return root


def sanity_cfg(da: bool, iters: int):
    """The JAX package's sanity configuration: the GN R-50-C4 model from
    scratch at a 128x160 canvas, 3 classes, 600 -> 128 proposals."""
    from ..config import get_cfg

    cfg = get_cfg()
    cfg.TPU.IMAGE_SHAPE = (128, 160)
    cfg.TPU.MAX_GT_BOXES = 10
    cfg.MODEL.DOMAIN_ADAPTATION_ON = bool(da)
    cfg.MODEL.BACKBONE.USE_GN = True
    cfg.MODEL.BACKBONE.FREEZE_CONV_BODY_AT = 0
    cfg.INPUT.TO_BGR255 = False
    cfg.INPUT.PIXEL_MEAN = (0.485, 0.456, 0.406)
    cfg.INPUT.PIXEL_STD = (0.229, 0.224, 0.225)
    cfg.MODEL.ROI_BOX_HEAD.NUM_CLASSES = 3
    cfg.MODEL.RPN.PRE_NMS_TOP_N_TRAIN = 600
    cfg.MODEL.RPN.POST_NMS_TOP_N_TRAIN = 128
    cfg.MODEL.RPN.PRE_NMS_TOP_N_TEST = 600
    cfg.MODEL.RPN.POST_NMS_TOP_N_TEST = 128
    cfg.MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE = 64
    cfg.MODEL.DA_HEADS.DA_TRIPLET_INS_WEIGHT = 0.0
    cfg.INPUT.MIN_SIZE_TRAIN = (120,)
    cfg.INPUT.MAX_SIZE_TRAIN = 160
    cfg.INPUT.MIN_SIZE_TEST = 120
    cfg.INPUT.MAX_SIZE_TEST = 160
    cfg.DATASETS.TRAIN = ("sanity_clean_cocostyle",)
    cfg.DATASETS.SOURCE_TRAIN = ("sanity_clean_cocostyle",)
    cfg.DATASETS.TARGET_TRAIN = ("sanity_foggy_cocostyle",)
    cfg.DATASETS.TARGET_TRAIN_negative = ("sanity_rainy_cocostyle",)
    cfg.DATASETS.TEST = (("sanity_foggy_cocostyle" if da
                          else "sanity_clean_cocostyle"),)
    cfg.SOLVER.IMS_PER_BATCH = 2 if da else 4
    cfg.SOLVER.BASE_LR = 0.01
    cfg.SOLVER.WARMUP_ITERS = 100
    cfg.SOLVER.WARMUP_FACTOR = 0.1
    cfg.SOLVER.WARMUP_LR = 0.001
    cfg.SOLVER.MAX_ITER = iters
    cfg.TEST.IMS_PER_BATCH = 2
    cfg.TEST.DETECTIONS_PER_IMG = 10
    return cfg


def ablation_cfg(da: bool, iters: int):
    """An arm of the ablation gate: ``sanity_cfg`` evaluated on the
    inverted target, with margin headroom (the margin can grow: int(margin)
    != int(max_margin)) and the JAX package's CPU-affordable box head
    (pool 7, 16 ROIs an image; the DA-direction signal is in the
    adversarial heads, not the ROI capacity)."""
    cfg = sanity_cfg(da, iters)
    cfg.DATASETS.TEST = ("sanity_foggy_cocostyle",)
    cfg.MODEL.DA_HEADS.TRIPLET_MAX_MARGIN = 3.0
    cfg.MODEL.ROI_BOX_HEAD.POOLER_RESOLUTION = 7
    cfg.MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE = 16
    return cfg


def _launches() -> dict:
    return dict(kernels.LAUNCHES)


def _since(before: dict) -> dict:
    return {k: v - before.get(k, 0) for k, v in kernels.LAUNCHES.items()
            if v != before.get(k, 0)}


def train_and_eval(cfg, da: bool, iters: int, logger, seed: int = 0,
                   test_dataset: str | None = None, device="cuda",
                   model=None):
    """Train from scratch per ``cfg`` on ``device`` (``"cosine"`` for DA,
    ``"multistep"`` for source-only) and evaluate. ``model``: the detector
    to train (on ``device``), else one built from ``seed``. Returns (AP50 on
    the test set, final TrainState, a record of the run: steps, seconds,
    steps a second, and the kernels' launches in training and in
    evaluation)."""
    import torch

    from ..data import make_data_loader, make_data_loader_da
    from ..engine.inference import inference
    from ..engine.trainer import create_train_state, do_train
    from ..entry import resolve_device
    from .train_core import build_model

    device = resolve_device(device)
    if model is None:
        model = build_model(cfg, device, seed)
    packed = bool(cfg.TPU.PACKED_TRANSPORT)
    if da:
        loader = make_data_loader_da(cfg, device=device, aligned=True,
                                     seed=seed, packed=packed)
    else:
        loader, _ = make_data_loader(cfg, is_train=True, device=device,
                                     seed=seed, packed=packed)
    state = create_train_state(cfg, model, seed,
                               "cosine" if da else "multistep")
    before = _launches()
    t0 = time.perf_counter()
    try:
        state = do_train(state, iter(loader), max_iter=iters,
                         log_period=max(iters // 4, 1), aligned=da)
    finally:
        loader.close()
    if next(model.parameters()).is_cuda:
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    train_launches = _since(before)
    logger.info("%d iters in %.0fs", iters, seconds)

    tl, ds = make_data_loader(
        cfg, is_train=False, device=device,
        dataset_names=(test_dataset,) if test_dataset else cfg.DATASETS.TEST)
    before = _launches()
    try:
        res, _ = inference(model, tl, ds)
    finally:
        tl.close()
    run = dict(iters=iters, train_s=seconds, steps_per_s=iters / seconds,
               train_launches=train_launches, eval_images=len(ds),
               eval_launches=_since(before))
    return res["bbox"]["AP50"], state, run


def run_ablation(args, logger) -> dict:
    """The DA-direction gate: with the channel-inverted target, triplet-DA
    training must beat source-only training on the target domain by
    ``args.min_gap`` AP50 (the JAX package calibrated it at 200 iterations:
    source-only 0.013, triplet-DA 0.405). The adaptive image margin is
    reported, not gated. Prints the JAX package's verdict line; returns it
    with each arm's run record under ``"arms"``; raises SystemExit(1) on
    FAIL."""
    results, arms = {}, {}
    for da in (False, True):
        ap50, state, run = train_and_eval(
            ablation_cfg(da, args.iters), da, args.iters, logger,
            test_dataset="sanity_foggy_cocostyle", device=args.device)
        arm = "da" if da else "source_only"
        results[arm] = round(ap50, 4)
        arms[arm] = dict(run, ap50=ap50)
        if da:
            results["margin_img"] = round(float(state.da_state.margin_img),
                                          4)
    gap = results["da"] - results["source_only"]
    ok = gap >= args.min_gap
    verdict = dict({"sanity_check": "PASS" if ok else "FAIL",
                    "mode": "ablation", "gap": round(gap, 4),
                    "min_gap": args.min_gap}, **results)
    print(json.dumps(verdict))
    if not ok:
        raise SystemExit(1)
    return dict(verdict, arms=arms)


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--iters", type=int, default=800)
    p.add_argument("--images", type=int, default=16)
    p.add_argument("--da", action="store_true",
                   help="full triplet-DA path (default: source-only)")
    p.add_argument("--ablation", action="store_true",
                   help="DA-direction gate: train source-only AND triplet-DA "
                        "under a strong domain shift; DA must win on the "
                        "target domain")
    p.add_argument("--min-ap50", type=float, default=0.5)
    p.add_argument("--min-gap", type=float, default=0.05)
    p.add_argument("--data-dir", default="")
    p.add_argument("--device", default="cuda",
                   help="cuda (the default; raises without a card) or cpu")
    args = p.parse_args(argv)

    from ..utils.logging_utils import setup_logger

    root = args.data_dir or tempfile.mkdtemp(prefix="dd_sanity_")
    # ablation: the structural inverted shift; plain --da keeps the milder
    # affine fog
    build_synthetic(root, args.images, seed=3,
                    fog=(0.8, 10.0) if args.ablation else (0.55, 110.0),
                    invert=args.ablation)
    os.environ["DA_DETECT_DATA_DIR"] = root
    setup_logger("da_detect_tpu_torch", None)
    logger = logging.getLogger("da_detect_tpu_torch.sanity")

    if args.ablation:
        return run_ablation(args, logger)

    cfg = sanity_cfg(args.da, args.iters)
    ap50, _, run = train_and_eval(cfg, args.da, args.iters, logger,
                                  device=args.device)
    verdict = {"sanity_check": "PASS" if ap50 >= args.min_ap50 else "FAIL",
               "mode": "da" if args.da else "source_only",
               "AP50": round(ap50, 4), "threshold": args.min_ap50}
    print(json.dumps(verdict))
    if verdict["sanity_check"] == "FAIL":
        raise SystemExit(1)
    return dict(verdict, run=run)


if __name__ == "__main__":
    main()
