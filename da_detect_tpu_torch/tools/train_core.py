"""Shared training and evaluation code of the train_net* and test_net
CLIs (port of ``da_detect_tpu/tools/train_core.py``). In a process group
(``torchrun``) training runs the step through DDP and evaluation merges the
ranks' shards."""

from __future__ import annotations

import torch.distributed as dist

from ..data import make_data_loader, make_data_loader_da
from ..engine.inference import evaluate_merged, inference
from ..engine.trainer import create_train_state, do_train
from ..entry import prepare_model
from ..models import build_detection_model
from ..parallel import parallelize
from ..parallel.ddp import wrap_train_forward
from ..utils import comm
from ..utils.checkpoint import Checkpointer, load_weight_file
from ..utils.metric_logger import MetricLogger, TensorboardLogger


def build_model(cfg, device, seed: int):
    """The detector of ``cfg`` on ``device`` (a ``GeneralizedRCNN``, or a
    ``RetinaNet`` under ``MODEL.RETINANET_ON``, which trains source-only
    and answers with the same ``Detections``), random weights from
    ``seed`` (a checkpoint or ``MODEL.WEIGHT`` replaces them), under the
    process's mesh (``parallel.parallelize``; nothing changes without
    one)."""
    return parallelize(prepare_model(build_detection_model(cfg, seed=seed),
                                     device))


def run_training(cfg, logger, *, mode: str, schedule_kind: str, device,
                 skip_test: bool = False, seed: int = 100,
                 log_period: int = 20, use_tensorboard: bool = False,
                 profile_dir: str = ""):
    """Train ``mode`` ("source_only", "da" or "da_triplet") from the
    loader's batches, resuming from ``MODEL.OUTPUT_DIR``'s newest checkpoint
    or starting from ``MODEL.WEIGHT``; then evaluate on ``DATASETS.TEST``
    unless ``skip_test``. ``use_tensorboard``: the meters also go to
    ``TENSORBOARD_EXPERIMENT`` as scalars; ``profile_dir``: a profiler trace
    of iterations 10-20 (``do_train``). In a process group each rank reads
    its loader shard and steps through DDP (``parallel.wrap_train_forward``:
    the parameters ``mode`` leaves unused are left out of the reduction).
    Returns (state, meters)."""
    model = build_model(cfg, device, seed)
    packed = bool(cfg.TPU.PACKED_TRANSPORT)
    aligned = mode != "source_only" and cfg.MODEL.DA_HEADS.ALIGNMENT
    if mode == "source_only":
        loader, _ = make_data_loader(cfg, is_train=True, device=device,
                                     with_masks=cfg.MODEL.MASK_ON,
                                     with_keypoints=cfg.MODEL.KEYPOINT_ON,
                                     seed=seed, packed=packed)
    else:
        loader = make_data_loader_da(cfg, device=device,
                                     aligned=cfg.MODEL.DA_HEADS.ALIGNMENT,
                                     seed=seed, packed=packed)
    state = create_train_state(cfg, model, seed, schedule_kind)
    forward = wrap_train_forward(model, mode) if dist.is_initialized() \
        else None
    checkpointer = Checkpointer(cfg.MODEL.OUTPUT_DIR)
    if checkpointer.has_checkpoint():
        state, _ = checkpointer.resume(state)
    elif cfg.MODEL.WEIGHT:
        load_weight_file(cfg.MODEL.WEIGHT, model,
                         cfg.MODEL.ROI_BOX_HEAD.POOLER_RESOLUTION)
        logger.info("loaded MODEL.WEIGHT %s", cfg.MODEL.WEIGHT)

    eval_fn = None
    if cfg.MODEL.EVAL_USE_IN_TRAINING and cfg.DATASETS.TEST and not skip_test:
        def eval_fn(st, iteration):
            run_eval(cfg, logger, model, device)

    meters = (TensorboardLogger(cfg.TENSORBOARD_EXPERIMENT,
                                start_iter=state.step)
              if use_tensorboard and comm.is_main_process()
              else MetricLogger())
    try:
        state = do_train(
            state, iter(loader), max_iter=cfg.SOLVER.MAX_ITER,
            checkpointer=checkpointer,
            checkpoint_period=cfg.SOLVER.CHECKPOINT_PERIOD, meters=meters,
            aligned=aligned, log_period=log_period, eval_fn=eval_fn,
            test_period=cfg.SOLVER.TEST_PERIOD,
            profile_dir=profile_dir or None, forward=forward)
    finally:
        loader.close()
        meters.close()
    if not skip_test and cfg.DATASETS.TEST:
        run_eval(cfg, logger, model, device)
    return state, meters


def run_eval(cfg, logger, model, device):
    """Evaluate ``model`` on each of ``DATASETS.TEST``: the TTA passes and
    their merge when ``TEST.BBOX_AUG.ENABLED`` (boxes only), else one pass
    with the expected-results gate, in ``bbox`` and, with a mask head
    (``MODEL.MASK_ON``), ``segm``, with a keypoint head
    (``MODEL.KEYPOINT_ON``), ``keypoints``. In a process group each rank runs its
    shard and the merged predictions are evaluated once. Returns {dataset
    name: results}."""
    from ..engine.bbox_aug import compute_on_dataset_aug

    results = {}
    for name in cfg.DATASETS.TEST:
        if cfg.TEST.BBOX_AUG.ENABLED:
            logger.info("evaluating on %s with bbox TTA", name)
            predictions, dataset = compute_on_dataset_aug(model, cfg, name,
                                                          device)
            res, _ = evaluate_merged(dataset, predictions,
                                     output_folder=cfg.MODEL.OUTPUT_DIR)
        else:
            loader, dataset = make_data_loader(
                cfg, is_train=False, device=device, dataset_names=(name,),
                packed=bool(cfg.TPU.PACKED_TRANSPORT))
            logger.info("evaluating on %s (%d images)", name, len(dataset))
            iou_types = ("bbox",)
            if cfg.MODEL.MASK_ON:
                iou_types += ("segm",)
            if cfg.MODEL.KEYPOINT_ON:
                iou_types += ("keypoints",)
            try:
                res, _ = inference(
                    model, loader, dataset, iou_types=iou_types,
                    output_folder=cfg.MODEL.OUTPUT_DIR,
                    expected_results=cfg.TEST.EXPECTED_RESULTS,
                    expected_results_sigma_tol=(
                        cfg.TEST.EXPECTED_RESULTS_SIGMA_TOL),
                    style=cfg.TEST.EVAL_STYLE)
            finally:
                loader.close()
        results[name] = res
    return results
