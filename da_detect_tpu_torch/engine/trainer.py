"""Training engine (port of ``da_detect_tpu/engine/trainer.py``).

One step: the training forward over all domains, the sum of the losses, the
backward, one Detectron-SGD update and the new ``DAState``. The host loop
(reference do_da_train, trainer.py:150-336) feeds batches, logs windowed
metrics, checkpoints and runs the in-training eval. It reads the losses on
the host only at log and checkpoint boundaries, where it also stops on a
non-finite loss, so the steps in between queue on the card without a sync.
Unlike the JAX package's pure step, the port updates the model, the
optimizer and the ``TrainState`` in place (no second copy of the weights).
On N ranks the step runs through DDP (``parallel/ddp.py``): each rank's
losses are its share of the global batch's, its gradients DDP's mean, and
its ``DAState`` the same as every other rank's.
``profile_dir`` traces a range of iterations with ``torch.profiler`` (the
reference has only wall-clock meters).
"""

from __future__ import annotations

import dataclasses
import logging
import math
import os
import time
from typing import Callable, Optional

import torch

from ..models.da import DAState
from ..parallel.ddp import global_average
from ..solver.optim import DetectronSGD, make_optimizer
from ..utils.comm import get_rank, get_world_size
from ..utils.metric_logger import MetricLogger, eta_string

log = logging.getLogger(__name__)

# the iterations ``do_train`` traces under ``profile_dir``: [first, end)
PROFILE_RANGE = (10, 20)


@dataclasses.dataclass
class TrainState:
    step: int                   # updates made so far
    model: torch.nn.Module
    optimizer: DetectronSGD
    da_state: DAState
    generator: torch.Generator  # sampling priorities and DA dropout


def create_train_state(cfg, model: torch.nn.Module, seed: int = 0,
                       schedule_kind: str = "multistep") -> TrainState:
    """A TrainState at step 0 for ``model`` (already on its device): the
    optimizer, ``DAState`` seeded from ``TRIPLET_MARGIN_IMG/INS`` and a
    generator on the model's device seeded with ``seed`` plus the process's
    rank (the ranks of a data-parallel run draw apart)."""
    dev = next(model.parameters()).device
    da = cfg.MODEL.DA_HEADS
    return TrainState(
        step=0, model=model,
        optimizer=make_optimizer(cfg, model, schedule_kind),
        da_state=DAState.create(da.TRIPLET_MARGIN_IMG, da.TRIPLET_MARGIN_INS,
                                device=dev),
        generator=torch.Generator(device=dev).manual_seed(seed + get_rank()))


def _global_metrics(losses: dict, total: torch.Tensor) -> dict:
    """The losses and ``loss_total`` of the global batch: the ranks' mean of
    their shares, in one all-reduce (a single process: its own)."""
    metrics = {k: v.detach() for k, v in losses.items()}
    metrics["loss_total"] = total.detach()
    if get_world_size() == 1:
        return metrics
    mean = global_average(torch.stack([v.float() for v in metrics.values()]))
    return dict(zip(metrics, mean.unbind()))


def make_train_step(model: torch.nn.Module, optimizer: DetectronSGD, *,
                    aligned: bool = False, deterministic: bool = False,
                    forward: Optional[Callable] = None) -> Callable:
    """Returns ``step(state, batch_s, targets_s[, batch_t, targets_t[,
    batch_n, targets_n]]) -> (state, metrics)``: metrics are the losses and
    ``loss_total`` of the global batch, detached 0-d tensors on the device.
    ``deterministic`` turns the DA dropout off (parity tests). ``forward``
    runs ``model.train_forward`` (default: itself); a data-parallel run
    passes its DDP module (``parallel.wrap_train_forward``), which averages
    the ranks' gradients in the backward."""

    def step(state: TrainState, batch_s, targets_s, *rest):
        optimizer.zero_grad()
        # looked up at each call: a wrapper set on the model applies
        losses, new_da = (forward or model.train_forward)(
            batch_s, targets_s, state.da_state, *rest, aligned=aligned,
            deterministic=deterministic, generator=state.generator)
        total = sum(v.float() for v in losses.values())
        total.backward()
        optimizer.step(state.step)
        state.step += 1
        state.da_state = new_da
        return state, _global_metrics(losses, total)

    return step


def _finite_total(metrics, iteration: int) -> float:
    total = float(metrics["loss_total"])
    if not math.isfinite(total):
        log.error("loss diverged to %s at iteration %d; aborting", total,
                  iteration)
        raise FloatingPointError(f"non-finite loss at {iteration}")
    return total


def do_train(state: TrainState, data_iter, *, max_iter: int,
             checkpointer=None, checkpoint_period: int = 2500,
             meters: Optional[MetricLogger] = None, aligned: bool = False,
             log_period: int = 20,
             eval_fn: Optional[Callable[[TrainState, int], None]] = None,
             test_period: int = 0,
             profile_dir: str | None = None,
             forward: Optional[Callable] = None) -> TrainState:
    """The host loop from ``state.step`` (a resumed run's iteration) to
    ``max_iter``: ``data_iter`` yields tuples in ``train_forward``'s order,
    already on the device (a loader's batches). The loss is read on the host
    only at log and checkpoint boundaries (a non-finite one raises
    ``FloatingPointError`` there, and no checkpoint of it is written).
    Timing is averaged over each log window, because the steps between two
    reads queue on the card. ``eval_fn(state, iteration)`` runs every
    ``test_period`` iterations (``SOLVER.TEST_PERIOD``) or, with
    ``test_period`` 0, after each checkpoint. ``profile_dir``: a
    ``torch.profiler`` trace (CPU, and the card's kernels when the model is
    on one) of iterations ``PROFILE_RANGE`` (the JAX package's 10-20, the
    last excluded), written as ``trace_<first>-<last>.json`` (rank r > 0:
    ``..._rank<r>.json``) when it stops (at the range's end, or at
    ``max_iter``). ``forward``: the DDP module of
    a data-parallel run (``make_train_step``); every rank runs this loop,
    reads the global losses and checkpoints (``Checkpointer.save`` writes on
    the main process only)."""
    meters = meters or MetricLogger()
    train_step = make_train_step(state.model, state.optimizer,
                                 aligned=aligned, forward=forward)
    start_iter = state.step
    log.info("start training at iteration %d", start_iter)
    start = last = window_start = time.perf_counter()
    window_iters, window_data = 0, 0.0
    profiler = None
    for iteration in range(start_iter, max_iter):
        if profile_dir and iteration == PROFILE_RANGE[0]:
            profiler = _start_profiler(state)
            log.info("profiler trace started -> %s", profile_dir)
        if profiler is not None and iteration == PROFILE_RANGE[1]:
            _stop_profiler(profiler, profile_dir, iteration)
            profiler = None
        batch_args = next(data_iter)
        window_data += time.perf_counter() - last
        state, metrics = train_step(state, *batch_args)
        window_iters += 1
        if iteration % log_period == 0 or iteration == max_iter - 1:
            _finite_total(metrics, iteration)
            now = time.perf_counter()
            meters.update(iteration=iteration,
                          time=(now - window_start) / window_iters,
                          data=window_data / window_iters,
                          **{k: float(v) for k, v in metrics.items()})
            window_start, window_iters, window_data = now, 0, 0.0
            eta = eta_string(meters.meters["time"].global_avg,
                             max_iter - iteration)
            log.info("eta: %s  iter: %d  %s", eta, iteration, str(meters))
        last = time.perf_counter()
        if checkpointer is not None \
                and (iteration + 1) % checkpoint_period == 0:
            _finite_total(metrics, iteration)
            checkpointer.save(iteration + 1, state)
            if eval_fn is not None and not test_period:
                eval_fn(state, iteration + 1)
        if eval_fn is not None and test_period \
                and (iteration + 1) % test_period == 0:
            eval_fn(state, iteration + 1)
    if profiler is not None:
        _stop_profiler(profiler, profile_dir, max_iter)
    if checkpointer is not None:
        checkpointer.save(max_iter, state)
    total_time = time.perf_counter() - start
    log.info("total training time: %s (%.4f s/it)",
             eta_string(1.0, int(total_time)),
             total_time / max(max_iter - start_iter, 1))
    return state


def _start_profiler(state: TrainState):
    activities = [torch.profiler.ProfilerActivity.CPU]
    if next(state.model.parameters()).is_cuda:
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    profiler = torch.profiler.profile(activities=activities)
    profiler.start()
    return profiler


def _stop_profiler(profiler, profile_dir: str, end: int) -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    profiler.stop()
    os.makedirs(profile_dir, exist_ok=True)
    rank = get_rank()
    path = os.path.join(profile_dir,
                        f"trace_{PROFILE_RANGE[0]}-{end - 1}"
                        f"{f'_rank{rank}' if rank else ''}.json")
    profiler.export_chrome_trace(path)
    log.info("profiler trace stopped: %s", path)
