"""Entry points of the PyTorch port: the flagship model's eval forward and
its triplet-DA training step, and the eval forward of the X-101-32x8d FPN
DCN configuration.

``entry(device=None)`` is the counterpart of ``__graft_entry__.entry()``: it
returns ``(fn, example_args)`` for the eval forward of DA-Faster R-CNN on
R-50-C4 with 9 Cityscapes classes; ``entry(cfg=dcn_cfg())`` serves the
X-101-32x8d-FPN model with deformable res3-res5 instead. ``train_entry(device=None)`` is the
single-device counterpart of ``__graft_entry__._dryrun_impl``: one
(source, positive, negative) triple and a train step over it. Both run on the
card unless the caller asks for ``device="cpu"``; with no card and no
explicit CPU they raise.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import numpy as np
import torch

from .config import get_cfg
from .engine.trainer import create_train_state, make_train_step
from .models import build_detection_model
from .models.detector import eval_only
from .structures.image_batch import ImageBatch, Targets

DCN_YAML = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "configs",
    "da_faster_rcnn",
    "e2e_triplet_da_faster_rcnn_X_101_32x8d_FPN_dcn_cityscapes_to_foggy_"
    "cityscapes.yaml")


def flagship_cfg(canvas=(320, 640), train_tops=(600, 128),
                 test_tops=(600, 128)):
    """The flagship configuration at a given canvas, in float32 (the port's
    compute dtype)."""
    cfg = get_cfg()
    cfg.MODEL.DOMAIN_ADAPTATION_ON = True
    cfg.MODEL.ROI_BOX_HEAD.NUM_CLASSES = 9
    cfg.MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE = 256
    cfg.MODEL.ROI_HEADS.NMS = 0.3
    cfg.MODEL.RPN.PRE_NMS_TOP_N_TRAIN = train_tops[0]
    cfg.MODEL.RPN.POST_NMS_TOP_N_TRAIN = train_tops[1]
    cfg.MODEL.RPN.PRE_NMS_TOP_N_TEST = test_tops[0]
    cfg.MODEL.RPN.POST_NMS_TOP_N_TEST = test_tops[1]
    cfg.TPU.IMAGE_SHAPE = canvas
    cfg.TPU.MAX_GT_BOXES = 24
    cfg.TPU.COMPUTE_DTYPE = "float32"
    return cfg


def dcn_cfg(canvas=(608, 1216)):
    """The X-101-32x8d-FPN-DCN triplet-DA YAML of the repository's configs
    (DCN in res3-res5, FPN 256, MLP head 1024, 9 classes), read with the
    port's config copy, at a given canvas in float32. Its TEST.BBOX_AUG
    (test-time augmentation, a dataset-level loop) is not part of the model
    forward that ``entry`` serves."""
    cfg = get_cfg()
    cfg.merge_from_file(DCN_YAML)
    cfg.TPU.IMAGE_SHAPE = canvas
    cfg.TPU.COMPUTE_DTYPE = "float32"
    return cfg


def make_batch(cfg, b: int, seed: int = 0, is_source: bool = True,
               device="cpu") -> tuple[ImageBatch, Targets]:
    """A synthetic batch of b images with padded targets, drawn from
    ``np.random.RandomState(seed)`` in the same order as the JAX package's
    ``__graft_entry__._batch``, so both see the same pixels and boxes."""
    h, w = cfg.TPU.IMAGE_SHAPE
    g = cfg.TPU.MAX_GT_BOXES
    rng = np.random.RandomState(seed)
    x1 = rng.uniform(0, w - 60, (b, g)).astype(np.float32)
    y1 = rng.uniform(0, h - 60, (b, g)).astype(np.float32)
    boxes = np.stack([x1, y1, x1 + rng.uniform(10, 50, (b, g)),
                      y1 + rng.uniform(10, 50, (b, g))], -1).astype(np.float32)
    images = rng.randn(b, h, w, 3).astype(np.float32)
    labels = rng.randint(1, 9, (b, g))
    valid = rng.rand(b, g) > 0.3
    batch = ImageBatch(
        # NHWC memory viewed as NCHW: channels_last, no copy
        images=torch.from_numpy(images).permute(0, 3, 1, 2),
        sizes=torch.from_numpy(np.tile([[h, w]], (b, 1)).astype(np.int32)),
        orig_sizes=torch.from_numpy(
            np.tile([[h * 2, w * 2]], (b, 1)).astype(np.int32)),
        is_source=torch.full((b,), is_source),
    ).to(device)
    targets = Targets(boxes=torch.from_numpy(boxes).to(device),
                      labels=torch.from_numpy(labels).to(device),
                      valid=torch.from_numpy(valid).to(device))
    return batch, targets


def resolve_device(device=None) -> torch.device:
    """``None`` means the card. Raises rather than run on the CPU unasked."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port's entry points run on the card; pass "
            "device='cpu' to run its plain versions on the CPU")
    return device


def prepare_model(model, device):
    """Move a model to ``device`` in channels-last memory, and make float32
    convolutions and matmuls on the card full float32 (cuDNN defaults to
    TF32 for convolutions). The port's modules behave the same in train and
    eval mode (FrozenBN; the DA dropout follows ``deterministic``)."""
    if device.type == "cuda":
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    return model.to(device=device, memory_format=torch.channels_last).eval()


def triplet_batches(cfg, k: int = 1, seed: int = 0, device="cpu") -> tuple:
    """(batch_s, targets_s, batch_p, targets_s, batch_n, targets_s): k source
    images from ``make_batch``, the positive target a pixel copy of them (the
    aligned-data contract), the negative target the source + 200, all three
    with the source's targets, as ``__graft_entry__._dryrun_impl`` builds
    them."""
    b_s, t_s = make_batch(cfg, k, seed, is_source=True, device=device)
    b_p = dataclasses.replace(b_s, is_source=torch.zeros_like(b_s.is_source))
    b_n = dataclasses.replace(b_p, images=b_s.images + 200.0)
    return b_s, t_s, b_p, t_s, b_n, t_s


def train_cfg():
    """``_dryrun_impl``'s configuration: the flagship at canvas 64x96 with
    64 -> 16 training proposals, 8 GT boxes, 16 sampled ROIs an image, and
    the adaptive image margin live (max 3.0, start -0.5)."""
    cfg = flagship_cfg(canvas=(64, 96), train_tops=(64, 16))
    cfg.TPU.MAX_GT_BOXES = 8
    cfg.MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE = 16
    cfg.MODEL.DA_HEADS.TRIPLET_MAX_MARGIN = 3.0
    cfg.MODEL.DA_HEADS.TRIPLET_MARGIN_IMG = -0.5
    return cfg


def entry(device: Optional[str] = None, seed: int = 0, cfg=None):
    """(fn, example_args): the eval forward of the flagship model (or of
    ``cfg``), ``fn(model, batch) -> Detections``, with random weights drawn
    from ``seed``."""
    device = resolve_device(device)
    cfg = flagship_cfg() if cfg is None else cfg
    model = prepare_model(build_detection_model(cfg, seed=seed), device)
    batch, _ = make_batch(cfg, 1, seed, device=device)

    def forward(model, batch):
        return model(batch)

    return forward, (model, batch)


def train_entry(device: Optional[str] = None, seed: int = 0, cfg=None,
                aligned: Optional[bool] = None):
    """(step_fn, (state, batch_args)): the triplet-DA train step of ``cfg``
    (default ``train_cfg()``) on one (source, positive, negative) triple,
    ``step_fn(state, *batch_args) -> (state, metrics)``, with random weights
    drawn from ``seed`` and the triplet trainer's cosine schedule.
    ``aligned`` defaults to ``MODEL.DA_HEADS.ALIGNMENT``."""
    device = resolve_device(device)
    cfg = train_cfg() if cfg is None else cfg
    if eval_only(cfg):
        raise NotImplementedError(
            "training an FPN or deformable-conv model is the FPN/DCN "
            "training slice of the port")
    if aligned is None:
        aligned = cfg.MODEL.DA_HEADS.ALIGNMENT
    model = prepare_model(build_detection_model(cfg, seed=seed), device)
    state = create_train_state(cfg, model, seed, "cosine")
    step = make_train_step(model, state.optimizer, aligned=aligned)
    return step, (state, triplet_batches(cfg, 1, seed, device=device))
