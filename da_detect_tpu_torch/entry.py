"""Entry points of the PyTorch port: the eval forward and the triplet-DA
training step of the flagship model and of the X-101-32x8d FPN DCN
configuration.

``entry(device=None)`` is the counterpart of ``__graft_entry__.entry()``: it
returns ``(fn, example_args)`` for the eval forward of DA-Faster R-CNN on
R-50-C4 with 9 Cityscapes classes; ``entry(cfg=dcn_cfg())`` serves the
X-101-32x8d-FPN model with deformable res3-res5 instead.
``train_entry(device=None)`` is the single-device counterpart of
``__graft_entry__._dryrun_impl``: one (source, positive, negative) triple and
a train step over it; ``train_entry(cfg=dcn_train_cfg())`` trains the
X-101-32x8d-FPN-DCN model. ``entry(cfg=mask_cfg(), with_masks=True)`` is
the eval forward of the Cityscapes Mask R-CNN (R-50-FPN, ``MASK_ON``) with
its mask probabilities, and ``source_train_entry(cfg=mask_cfg())`` its
source-only train step on 2 images. ``fbnet_cfg(yaml)`` (the FBNet Faster
and Mask R-CNN YAMLs) and ``retinanet_cfg()`` (the RetinaNet R-50-FPN YAML)
serve and train the same way, at their YAMLs' canvases.
``entry(cfg=keypoint_cfg(), with_keypoints=True)`` is the eval forward of
Keypoint R-CNN (R-50-FPN, ``KEYPOINT_ON``) with each detection's 17
keypoints, and ``source_train_entry(cfg=keypoint_cfg())`` its source-only
train step on 2 images with GT keypoints. ``entry(cfg=vgg_cfg())`` and
``train_entry(cfg=vgg_cfg())`` serve and train the VGG-16 DA-Faster R-CNN
on the flagship's triplet-DA settings.
``dryrun_multichip(n)`` runs the train step data-parallel over n ranks
(DDP) against one process on the same global batch. All run on the card unless the caller asks for ``device="cpu"``;
with no card and no explicit CPU they raise.

Compute dtype: ``flagship_cfg`` and ``dcn_cfg`` default to bfloat16, the JAX
package's ``TPU.COMPUTE_DTYPE`` (which ``__graft_entry__._flagship_cfg`` and
the YAMLs keep), so ``entry()`` computes as ``__graft_entry__.entry()``
does; ``train_cfg`` is float32, as ``_dryrun_impl`` sets it. Parameters,
gradients and optimizer state are float32 in both.
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
from .structures.image_batch import MASK_RESOLUTION, ImageBatch, Targets
from .utils.env import reference_numerics

DCN_YAML = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "configs",
    "da_faster_rcnn",
    "e2e_triplet_da_faster_rcnn_X_101_32x8d_FPN_dcn_cityscapes_to_foggy_"
    "cityscapes.yaml")
MASK_YAML = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "configs",
    "cityscapes", "e2e_mask_rcnn_R_50_FPN_1x_cocostyle.yaml")
CONFIGS = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "configs")
FBNET_MASK_YAML = os.path.join(CONFIGS,
                               "e2e_mask_rcnn_fbnet_xirb16d_dsmask.yaml")
FBNET_CHAM_YAML = os.path.join(CONFIGS,
                               "e2e_faster_rcnn_fbnet_chamv1a_600.yaml")
RETINANET_YAML = os.path.join(CONFIGS, "retinanet",
                              "retinanet_R-50-FPN_1x.yaml")
KEYPOINT_YAML = os.path.join(CONFIGS, "e2e_keypoint_rcnn_R_50_FPN_1x.yaml")
FLAGSHIP_YAML = os.path.join(
    CONFIGS, "da_faster_rcnn",
    "e2e_triplet_da_faster_rcnn_R_50_C4_cityscapes_to_foggy_cityscapes.yaml")


def flagship_cfg(canvas=(320, 640), train_tops=(600, 128),
                 test_tops=(600, 128), dtype="bfloat16"):
    """The flagship configuration at a given canvas, as
    ``__graft_entry__._flagship_cfg`` builds it, computing in ``dtype``
    (``TPU.COMPUTE_DTYPE``: bfloat16, the JAX package's default, or
    float32)."""
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
    cfg.TPU.COMPUTE_DTYPE = dtype
    return cfg


def dcn_cfg(canvas=(608, 1216), dtype="bfloat16"):
    """The X-101-32x8d-FPN-DCN triplet-DA YAML of the repository's configs
    (DCN in res3-res5, FPN 256, MLP head 1024, 9 classes), read with the
    port's config copy, at a given canvas, computing in ``dtype`` (bfloat16,
    the YAML's, or float32). Its TEST.BBOX_AUG (test-time augmentation, a
    dataset-level loop) is not part of the model forward that ``entry``
    serves."""
    cfg = get_cfg()
    cfg.merge_from_file(DCN_YAML)
    cfg.TPU.IMAGE_SHAPE = canvas
    cfg.TPU.COMPUTE_DTYPE = dtype
    return cfg


def dcn_train_cfg(canvas=(608, 1216), dtype="bfloat16"):
    """``dcn_cfg`` for training: the YAML's DA settings (image triplet,
    AdvGRL, instance triplet weight 0, no alignment) with the top-k of
    proposal selection exact (``TPU.APPROX_TOPK`` off: ``approx_max_k`` is
    TPU-only; the port's top-k is exact either way)."""
    cfg = dcn_cfg(canvas, dtype)
    cfg.TPU.APPROX_TOPK = False
    return cfg


def _yaml_cfg(yaml: str, dtype: str):
    """``yaml`` read with the port's config copy, uncut, computing in
    ``dtype``, at the YAML's own training canvas (``canvas_for``, used in
    eval too), the top-k of proposal selection exact (``TPU.APPROX_TOPK``
    is TPU-only)."""
    from .data.transforms import canvas_for

    cfg = get_cfg()
    cfg.merge_from_file(yaml)
    cfg.TPU.IMAGE_SHAPE = canvas_for(cfg, is_train=True)
    cfg.TPU.COMPUTE_DTYPE = dtype
    cfg.TPU.APPROX_TOPK = False
    return cfg


def mask_cfg(dtype="bfloat16"):
    """The Cityscapes instance-segmentation YAML (R-50-FPN, FPN2MLP box
    head, 9 classes, ``MaskRCNNFPNFeatureExtractor`` + ``MaskRCNNC4Predictor``
    at pool 14, sampling 2), read with the port's config copy, computing in
    ``dtype`` (bfloat16, every YAML's ``TPU.COMPUTE_DTYPE``, or float32), at
    the YAML's own canvas, 800 x 1344 (``canvas_for``, the same in training
    and eval), with its 512 ROIs an image and 100 GT slots; the top-k of
    proposal selection exact (``TPU.APPROX_TOPK`` is TPU-only)."""
    return _yaml_cfg(MASK_YAML, dtype)


def fbnet_cfg(yaml: str = FBNET_MASK_YAML, dtype: str = "bfloat16"):
    """An FBNet YAML (default the xirb16d_dsmask Mask R-CNN: 320 x 640, 81
    classes, 512 ROIs an image) by ``_yaml_cfg``. Its per-card train batch
    is 16 images (``per_card_images``)."""
    return _yaml_cfg(yaml, dtype)


def retinanet_cfg(dtype: str = "bfloat16"):
    """The RetinaNet R-50-FPN YAML (81 classes) by ``_yaml_cfg``: 800 x
    1344, 800 / 1333 rounded up to its SIZE_DIVISIBILITY 32."""
    return _yaml_cfg(RETINANET_YAML, dtype)


def keypoint_cfg(dtype: str = "bfloat16"):
    """The Keypoint R-CNN R-50-FPN YAML (2 classes, 17 keypoints, 512 ROIs
    an image, the keypoint pooler at P 14, sampling 2, over P2-P5) by
    ``_yaml_cfg``, uncut: 800 x 1344."""
    return _yaml_cfg(KEYPOINT_YAML, dtype)


def vgg_cfg(dtype: str = "bfloat16"):
    """The flagship triplet-DA YAML (Cityscapes -> Foggy Cityscapes with the
    rainy negative domain, 9 classes, AdvGRL, image and instance triplet) on
    the VGG-16 body of the original DA-Faster R-CNN, by ``_yaml_cfg`` at
    the YAML's 608 x 1216 canvas: ``CONV_BODY "VGG-16"`` (one stride-16
    map of 512 channels), ``FPN2MLPFeatureExtractor`` over that one level
    (``POOLER_SCALES (0.0625,)``, ``POOLER_RESOLUTION 7``), the
    ``FPNPredictor`` and ``MLP_HEAD_DIM 1024``; the DA instance head reads
    the MLP features (the VGG branch of ``models/da.py``)."""
    cfg = _yaml_cfg(FLAGSHIP_YAML, dtype)
    cfg.merge_from_list([
        "MODEL.BACKBONE.CONV_BODY", "VGG-16",
        "MODEL.ROI_BOX_HEAD.FEATURE_EXTRACTOR", "FPN2MLPFeatureExtractor",
        "MODEL.ROI_BOX_HEAD.POOLER_SCALES", (0.0625,),
        "MODEL.ROI_BOX_HEAD.POOLER_RESOLUTION", 7,
        "MODEL.ROI_BOX_HEAD.PREDICTOR", "FPNPredictor",
        "MODEL.ROI_BOX_HEAD.MLP_HEAD_DIM", 1024])
    return cfg


def per_card_images(cfg) -> int:
    """The per-card share of ``SOLVER.IMS_PER_BATCH`` over the 8 cards the
    YAMLs' batches are for: 16 for the FBNet mask YAMLs, 2 for RetinaNet
    R-50-FPN, the Cityscapes mask YAML and the keypoint YAML."""
    return max(1, cfg.SOLVER.IMS_PER_BATCH // 8)


def synthetic_masks(rng: np.random.RandomState, b: int, g: int,
                    m: int = MASK_RESOLUTION) -> np.ndarray:
    """[b, g, m, m] float32 binary masks in their boxes' frames: an ellipse
    each, centre in the middle 40% of the box, radii 25-50% of its sides,
    drawn from ``rng``."""
    c = rng.uniform(0.3, 0.7, (b, g, 2, 1, 1)) * m
    r = rng.uniform(0.25, 0.5, (b, g, 2, 1, 1)) * m
    y = np.arange(m, dtype=np.float64)[:, None]
    x = np.arange(m, dtype=np.float64)[None, :]
    inside = (((y - c[:, :, 0]) / r[:, :, 0]) ** 2
              + ((x - c[:, :, 1]) / r[:, :, 1]) ** 2) <= 1.0
    return inside.astype(np.float32)


def synthetic_keypoints(rng: np.random.RandomState, boxes: np.ndarray,
                        k: int = 17) -> np.ndarray:
    """[b, g, k, 3] float32 keypoints (x, y, visibility) for boxes
    [b, g, 4]: each point uniform inside its box, visibility drawn from
    {0, 1, 2}, rows of visibility 0 all zeros (as the loader makes them),
    drawn from ``rng``."""
    b, g = boxes.shape[:2]
    u = rng.uniform(0.0, 1.0, (b, g, k, 2))
    vis = rng.randint(0, 3, (b, g, k)).astype(np.float32)
    lo, hi = boxes[:, :, None, :2], boxes[:, :, None, 2:]
    xy = lo + u * (hi - lo)
    kps = np.concatenate([xy, vis[..., None]], -1).astype(np.float32)
    kps[vis == 0] = 0.0
    return kps


def make_batch(cfg, b: int, seed: int = 0, is_source: bool = True,
               device="cpu", with_masks: bool = False,
               with_keypoints: bool = False) -> tuple[ImageBatch, Targets]:
    """A synthetic batch of b images with padded targets, drawn from
    ``np.random.RandomState(seed)`` in the same order as the JAX package's
    ``__graft_entry__._batch``, so both see the same pixels and boxes (the
    labels, drawn in 1..8, folded into the classes of a model with fewer
    than 9); ``with_masks``: GT masks too (``synthetic_masks``, drawn after
    the rest); ``with_keypoints``: GT keypoints too
    (``synthetic_keypoints``, ``ROI_KEYPOINT_HEAD.NUM_CLASSES`` a box,
    drawn last)."""
    h, w = cfg.TPU.IMAGE_SHAPE
    g = cfg.TPU.MAX_GT_BOXES
    rng = np.random.RandomState(seed)
    x1 = rng.uniform(0, w - 60, (b, g)).astype(np.float32)
    y1 = rng.uniform(0, h - 60, (b, g)).astype(np.float32)
    boxes = np.stack([x1, y1, x1 + rng.uniform(10, 50, (b, g)),
                      y1 + rng.uniform(10, 50, (b, g))], -1).astype(np.float32)
    images = rng.randn(b, h, w, 3).astype(np.float32)
    labels = rng.randint(1, 9, (b, g))
    classes = cfg.MODEL.ROI_BOX_HEAD.NUM_CLASSES
    if classes < 9:
        labels = 1 + (labels - 1) % (classes - 1)
    valid = rng.rand(b, g) > 0.3
    batch = ImageBatch(
        # NHWC memory viewed as NCHW: channels_last, no copy
        images=torch.from_numpy(images).permute(0, 3, 1, 2),
        sizes=torch.from_numpy(np.tile([[h, w]], (b, 1)).astype(np.int32)),
        orig_sizes=torch.from_numpy(
            np.tile([[h * 2, w * 2]], (b, 1)).astype(np.int32)),
        is_source=torch.full((b,), is_source),
    ).to(device)
    masks = (torch.from_numpy(synthetic_masks(rng, b, g)).to(device)
             if with_masks else None)
    kps = (torch.from_numpy(synthetic_keypoints(
        rng, boxes, cfg.MODEL.ROI_KEYPOINT_HEAD.NUM_CLASSES)).to(device)
        if with_keypoints else None)
    targets = Targets(boxes=torch.from_numpy(boxes).to(device),
                      labels=torch.from_numpy(labels).to(device),
                      valid=torch.from_numpy(valid).to(device), masks=masks,
                      keypoints=kps)
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
    TF32 for convolutions) and bfloat16 matmuls accumulate in float32, as
    the JAX package's do. The port's modules behave the same in train and
    eval mode (FrozenBN; the DA dropout follows ``deterministic``)."""
    if device.type == "cuda":
        reference_numerics()
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
    """``_dryrun_impl``'s configuration: the flagship at canvas 64x96 in
    float32 with 64 -> 16 training proposals, 8 GT boxes, 16 sampled ROIs an
    image, and the adaptive image margin live (max 3.0, start -0.5)."""
    cfg = flagship_cfg(canvas=(64, 96), train_tops=(64, 16), dtype="float32")
    cfg.TPU.MAX_GT_BOXES = 8
    cfg.MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE = 16
    cfg.MODEL.DA_HEADS.TRIPLET_MAX_MARGIN = 3.0
    cfg.MODEL.DA_HEADS.TRIPLET_MARGIN_IMG = -0.5
    return cfg


def entry(device: Optional[str] = None, seed: int = 0, cfg=None,
          with_masks: bool = False, with_keypoints: bool = False):
    """(fn, example_args): the eval forward of the flagship model (or of
    ``cfg``), ``fn(model, batch) -> Detections``, with random weights drawn
    from ``seed``; ``with_masks`` (a ``MASK_ON`` cfg): ``fn`` returns
    (Detections, mask probabilities [B, D, Hm, Wm]); ``with_keypoints`` (a
    ``KEYPOINT_ON`` cfg): (Detections, keypoints [B, D, K, 3])."""
    device = resolve_device(device)
    cfg = flagship_cfg() if cfg is None else cfg
    model = prepare_model(build_detection_model(cfg, seed=seed), device)
    batch, _ = make_batch(cfg, 1, seed, device=device)

    def forward(model, batch):
        return model(batch, with_masks=with_masks,
                     with_keypoints=with_keypoints)

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
    if aligned is None:
        aligned = cfg.MODEL.DA_HEADS.ALIGNMENT
    model = prepare_model(build_detection_model(cfg, seed=seed), device)
    state = create_train_state(cfg, model, seed, "cosine")
    step = make_train_step(model, state.optimizer, aligned=aligned)
    return step, (state, triplet_batches(cfg, 1, seed, device=device))


def source_train_entry(device: Optional[str] = None, seed: int = 0,
                       cfg=None):
    """(step_fn, (state, (batch, targets))): the source-only train step of
    ``cfg`` (default ``mask_cfg()``; a RetinaNet cfg too) on
    ``per_card_images(cfg)`` source images with GT masks when
    ``MODEL.MASK_ON`` and GT keypoints when ``MODEL.KEYPOINT_ON``, ``step_fn(state, batch, targets) -> (state,
    metrics)``, random weights drawn from ``seed``, the multistep schedule
    of ``train_net``."""
    device = resolve_device(device)
    cfg = mask_cfg() if cfg is None else cfg
    model = prepare_model(build_detection_model(cfg, seed=seed), device)
    state = create_train_state(cfg, model, seed, "multistep")
    step = make_train_step(model, state.optimizer)
    return step, (state, make_batch(cfg, per_card_images(cfg),
                                    seed, device=device,
                                    with_masks=cfg.MODEL.MASK_ON,
                                    with_keypoints=cfg.MODEL.KEYPOINT_ON))


# ---------------------------------------------------------------- DDP

DRYRUN_STEPS = 3
# the margin grows by TRIPLET_MARGIN_LR a step after the first (the
# positive is a pixel copy of the source: the image hinge is exactly 0)
DRYRUN_MARGINS = (-0.5, -0.499, -0.498)
# step losses; each leaf's final parameters within this share of its
# largest change over the steps, plus a float32 ulp of its weights
DRYRUN_LOSS_RTOL, DRYRUN_PARAM_REL = 1e-4, 1e-3


def dryrun_cfg():
    """``train_cfg`` with sampling budgets above every candidate pool (RPN
    1024 of 360 anchors an image; ROI 64 at positive fraction 0.5 of 16
    proposals and 8 GT boxes), so that each rank's sampler takes what the
    single process's does whatever their draws."""
    cfg = train_cfg()
    cfg.MODEL.RPN.BATCH_SIZE_PER_IMAGE = 1024
    cfg.MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE = 64
    cfg.MODEL.ROI_HEADS.POSITIVE_FRACTION = 0.5
    return cfg


def _dryrun_steps(step, state, args) -> dict:
    """``DRYRUN_STEPS`` steps: each step's global losses and margin, and the
    final parameters (whole: a split leaf gathered) and DAState, on the
    CPU."""
    from .parallel.tensor import full_state_dict

    losses, margins = [], []
    for _ in range(DRYRUN_STEPS):
        state, metrics = step(state, *args)
        losses.append({k: float(v) for k, v in metrics.items()})
        margins.append(float(state.da_state.margin_img))
    full = full_state_dict(state.model)
    return dict(losses=losses, margins=margins,
                params={n: full[n].detach().cpu().clone()
                        for n, _ in state.model.named_parameters()},
                da_state={f.name: float(getattr(state.da_state, f.name))
                          for f in dataclasses.fields(state.da_state)})


def _dryrun_modes(n: int) -> list:
    """(label, spatial, model) of each run of ``dryrun_multichip(n)``: dp,
    and with n >= 4 and even the JAX dry run's "dp x sp2" and "dp x tp2"
    meshes."""
    modes = [("dp", 1, 1)]
    if n >= 4 and n % 2 == 0:
        modes += [(f"dp{n // 2} x sp2", 2, 1), (f"dp{n // 2} x tp2", 1, 2)]
    return modes


def _dryrun_rank(rank, world, init_method, cfg, device_type, threads):
    """One rank of ``dryrun_multichip``: each mode's run, its data slice of
    the ``world`` triples, the step through DDP over the data group."""
    from .parallel import (data_shard, init_distributed, make_mesh,
                           parallelize, set_mesh, wrap_train_forward)

    torch.set_num_threads(threads)
    dev = torch.device("cuda", rank) if device_type == "cuda" \
        else torch.device("cpu")
    dev = init_distributed(dev, init_method=init_method, rank=rank,
                           world_size=world)
    out = {}
    for label, spatial, model_ranks in _dryrun_modes(world):
        mesh = make_mesh(spatial=spatial, model=model_ranks)
        set_mesh(None if label == "dp" else mesh)
        model = parallelize(prepare_model(build_detection_model(cfg, seed=0),
                                          dev))
        state = create_train_state(cfg, model, 0, "cosine")
        step = make_train_step(model, state.optimizer, aligned=True,
                               deterministic=True,
                               forward=wrap_train_forward(model,
                                                          "da_triplet"))
        args = data_shard(triplet_batches(cfg, world, seed=0, device=dev),
                          mesh)
        out[label] = _dryrun_steps(step, state, args)
        set_mesh(None)
    return out


def dryrun_multichip(n: int, device: Optional[str] = None, cfg=None) -> dict:
    """The triplet-DA step over ``n`` ranks against one process on the same
    global batch (the counterpart of ``__graft_entry__.dryrun_multichip``):
    ``cfg`` (default ``dryrun_cfg()``, the flagship at 64x96), n triples
    (the positive a pixel copy of the source), dropout off,
    ``DRYRUN_STEPS`` steps; data-parallel, and with n >= 4 and even also
    under the (data=n/2, space=2) and (data=n/2, model=2) meshes, as the
    JAX dry run's "dp x sp2" and "dp x tp2". The ranks are spawned
    processes (one spawn runs every mode), through NCCL on ``n`` cards
    (``device`` None or "cuda") or gloo on the CPU. Raises unless, in every
    mode, every rank's losses match the single process's (rtol
    ``DRYRUN_LOSS_RTOL``), the margins are ``DRYRUN_MARGINS`` on every rank,
    the ranks' final (whole) parameters and DAState are identical, and they
    match the single process's (``DRYRUN_PARAM_REL``). Prints a line a
    run; returns the dp comparison, with each mesh's under ``meshes``."""
    from .parallel import spawn

    dev = resolve_device(device)
    if dev.type == "cuda" and torch.cuda.device_count() < n:
        raise RuntimeError(f"dryrun_multichip({n}) needs {n} cards, this "
                           f"machine has {torch.cuda.device_count()}")
    cfg = dryrun_cfg() if cfg is None else cfg
    model = prepare_model(build_detection_model(cfg, seed=0), dev)
    init = {k: p.detach().cpu().clone() for k, p in model.named_parameters()}
    state = create_train_state(cfg, model, 0, "cosine")
    step = make_train_step(model, state.optimizer, aligned=True,
                           deterministic=True)
    single = _dryrun_steps(step, state, triplet_batches(cfg, n, 0, dev))
    del model, state, step
    print(f"dryrun_multichip({n}): single process ok, {DRYRUN_STEPS}-step "
          f"loss_total={single['losses'][-1]['loss_total']:.6f}, margins="
          f"{single['margins']}", flush=True)
    threads = max(1, torch.get_num_threads() // n)
    ranks = spawn(_dryrun_rank, n, cfg, dev.type, threads)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    out = {}
    for label, _, _ in _dryrun_modes(n):
        out[label] = _dryrun_check(n, label, [r[label] for r in ranks],
                                   single, init, backend)
    return dict(out["dp"], meshes={k: v for k, v in out.items()
                                   if k != "dp"})


def _dryrun_check(n, label, ranks, single, init, backend) -> dict:
    for r, got in enumerate(ranks):
        if got["da_state"] != ranks[0]["da_state"] or any(
                not torch.equal(p, ranks[0]["params"][k])
                for k, p in got["params"].items()):
            raise AssertionError(f"dryrun_multichip({n}) {label}: rank {r}'s "
                                 "parameters or DAState differ from rank 0's")
        for i, (a, b) in enumerate(zip(got["losses"], single["losses"])):
            bad = {k: (a[k], b[k]) for k in b
                   if abs(a[k] - b[k]) > DRYRUN_LOSS_RTOL * abs(b[k]) + 1e-7}
            if bad or set(a) != set(b):
                raise AssertionError(f"dryrun_multichip({n}) {label}: rank "
                                     f"{r} step {i + 1} losses {bad}")
    got = ranks[0]
    if not np.allclose(got["margins"], DRYRUN_MARGINS, rtol=0, atol=1e-6):
        raise AssertionError(f"dryrun_multichip({n}) {label}: margins "
                             f"{got['margins']} != {DRYRUN_MARGINS}")
    worst = 0.0
    for k, p in single["params"].items():
        change = float((p - init[k]).abs().max())
        ulp = 1.2e-7 * float(init[k].abs().max())
        err = float((got["params"][k] - p).abs().max())
        worst = max(worst, err / (DRYRUN_PARAM_REL * change + ulp + 1e-30))
    if worst > 1.0:
        raise AssertionError(f"dryrun_multichip({n}) {label}: final "
                             f"parameters off the single process's: "
                             f"{worst:.3f} x the bound")
    for key, v in single["da_state"].items():
        if abs(got["da_state"][key] - v) > 1e-6:
            raise AssertionError(f"dryrun_multichip({n}) {label}: DAState "
                                 f"{key} {got['da_state'][key]} != {v}")
    print(f"dryrun_multichip({n}): {label} ok over {n} ranks ({backend}), "
          f"{DRYRUN_STEPS}-step loss_total="
          f"{got['losses'][-1]['loss_total']:.6f}, margins match, params "
          f"within {worst:.3f} of the bound", flush=True)
    return dict(world=n, backend=backend, losses=got["losses"],
                single_losses=single["losses"], margins=got["margins"],
                param_bound_used=worst)
