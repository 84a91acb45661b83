"""What each rank of ``tests/test_torch_ddp.py``'s two-process runs does.

A module of its own, importing no JAX: the ranks are spawned processes,
which import the module that holds their function and nothing of the test
file. ``rank_work`` runs every piece in one process group (gloo on the CPU)
and returns what the test compares.
"""

from __future__ import annotations

import dataclasses
import sys
from contextlib import contextmanager, nullcontext

import torch

CPU = torch.device("cpu")


def _comm_checks(rank: int, world: int) -> dict:
    from da_detect_tpu_torch.parallel import global_average, global_mean, \
        global_sum
    from da_detect_tpu_torch.utils import comm

    comm.synchronize()
    x = torch.tensor([1.0 + rank, 10.0 * rank])
    return dict(
        world=comm.get_world_size(), rank=comm.get_rank(),
        main=comm.is_main_process(),
        gathered=comm.all_gather({"rank": rank, "tag": f"r{rank}"}),
        reduced=comm.reduce_dict({"a": 1.0 + rank, "b": 2.0 * rank}),
        summed=comm.reduce_dict({"a": 1.0 + rank}, average=False),
        merged=comm.accumulate_predictions({f"img{rank}": rank,
                                            f"img{rank + 2}": rank}),
        global_sum=global_sum(x).tolist(),
        global_average=global_average(x).tolist(),
        # shares of sum(num) / max(sum(den), 1): (1 + 2) / (3 + 1)
        global_mean=float(global_mean(torch.tensor(1.0 + rank),
                                      torch.tensor(3.0 - 2 * rank), 1.0)))


@contextmanager
def _local_normalizers():
    """Each rank's losses normalized over its own batch, and its own probe
    and triplet losses: what DDP around the single-process losses gives."""
    from da_detect_tpu_torch.models import (box_head, da, keypoint_head,
                                            mask_head, rpn)

    def local_mean(num, den, floor):
        return num / den.clamp(min=floor)

    saved = [(m, n, getattr(m, n)) for m, n in (
        (rpn, "global_mean"), (box_head, "global_mean"), (da, "global_mean"),
        (mask_head, "global_mean"), (keypoint_head, "global_mean"),
        (da, "global_average"))]
    for m, n, _ in saved:
        setattr(m, n, local_mean if n == "global_mean" else (lambda x: x))
    try:
        yield
    finally:
        for m, n, f in saved:
            setattr(m, n, f)


def _model(spec, cfg=None):
    """The step config's model with the JAX variables, or ``cfg``'s with
    its seed-0 weights; and a TrainState."""
    from da_detect_tpu_torch.engine.trainer import create_train_state
    from da_detect_tpu_torch.entry import prepare_model
    from da_detect_tpu_torch.models import build_detection_model
    from da_detect_tpu_torch.utils.weights import load_jax_variables

    model = build_detection_model(cfg or spec["cfg"])
    if cfg is None:
        load_jax_variables(model, spec["variables"])
    model = prepare_model(model, CPU)
    return model, create_train_state(cfg or spec["cfg"], model, 0, "cosine")


def _steps(spec, rank: int, world: int, local: bool) -> dict:
    """``spec["steps"]`` triplet steps through DDP on this rank's triple of
    the global batch: each step's logged losses and DAState, and the final
    parameters."""
    from da_detect_tpu_torch.engine.trainer import make_train_step
    from da_detect_tpu_torch.parallel import shard, wrap_train_forward

    model, state = _model(spec)
    step = make_train_step(model, state.optimizer, aligned=True,
                           deterministic=True,
                           forward=wrap_train_forward(model, "da_triplet"))
    args = shard(spec["batch"], rank, world)
    losses, states = [], []
    with _local_normalizers() if local else nullcontext():
        for _ in range(spec["steps"]):
            state, metrics = step(state, *args)
            losses.append({k: float(v) for k, v in metrics.items()})
            states.append({f.name: float(getattr(state.da_state, f.name))
                           for f in dataclasses.fields(state.da_state)})
    return dict(losses=losses, da_states=states,
                params={n: p.detach().clone()
                        for n, p in model.named_parameters()})


def _source_steps(spec, rank: int, world: int, local: bool) -> dict:
    """``spec["steps"]`` source-only steps of a narrowed Mask or Keypoint
    R-CNN through DDP on this rank's image of the 2-image global batch (GT
    masks or keypoints on): each step's losses, and the final parameters;
    with ``local`` each rank's own normalizers."""
    from da_detect_tpu_torch.engine.trainer import make_train_step
    from da_detect_tpu_torch.parallel import shard, wrap_train_forward

    model, state = _model(spec)
    step = make_train_step(model, state.optimizer,
                           forward=wrap_train_forward(model, "source_only"))
    args = shard(spec["batch"], rank, world)
    losses = []
    with _local_normalizers() if local else nullcontext():
        for _ in range(spec["steps"]):
            state, metrics = step(state, *args)
            losses.append({k: float(v) for k, v in metrics.items()})
    return dict(losses=losses,
                params={n: p.detach().clone()
                        for n, p in model.named_parameters()})


def _source_only(spec, rank: int, world: int) -> list:
    """Two source-only steps of a model with DA heads through DDP (the heads
    left out of the reduction: the second step would raise if DDP waited
    for their gradients); the DA heads that took a gradient other than the
    optimizer's zero one."""
    from da_detect_tpu_torch.engine.trainer import make_train_step
    from da_detect_tpu_torch.parallel import shard, wrap_train_forward

    model, state = _model(spec)
    step = make_train_step(model, state.optimizer,
                           forward=wrap_train_forward(model, "source_only"))
    args = shard(spec["batch"][:2], rank, world)
    for _ in range(2):
        state, _ = step(state, *args)
    return sorted(n for n, p in model.named_parameters()
                  if n.startswith("da_heads") and bool(p.grad.any()))


def _checkpoint(spec, rank: int, world: int, out_dir: str) -> dict:
    """A step, a save by every rank (the main one writes), a resume by
    every rank into a fresh state."""
    import os

    from da_detect_tpu_torch.engine.trainer import make_train_step
    from da_detect_tpu_torch.parallel import shard, wrap_train_forward
    from da_detect_tpu_torch.utils.checkpoint import Checkpointer

    model, state = _model(spec)
    step = make_train_step(model, state.optimizer, aligned=True,
                           forward=wrap_train_forward(model, "da_triplet"))
    state, _ = step(state, *shard(spec["batch"], rank, world))
    ckpt = Checkpointer(out_dir)
    path = ckpt.save(state.step, state)
    files = sorted(os.listdir(out_dir))
    _, fresh = _model(spec)
    fresh, start = ckpt.resume(fresh)
    return dict(path=path, files=files, start=start,
                own_generator=torch.equal(fresh.generator.get_state(),
                                          state.generator.get_state()),
                same_model=all(torch.equal(a, b) for a, b in zip(
                    fresh.model.state_dict().values(),
                    state.model.state_dict().values())))


def _eval(spec, rank: int, out_dir: str) -> dict:
    """The tiny dataset's eval shard of this rank and the merged COCO
    evaluation."""
    from da_detect_tpu_torch.config.catalog import DatasetCatalog
    from da_detect_tpu_torch.data import make_data_loader
    from da_detect_tpu_torch.engine.inference import inference

    img_dir, ann = spec["eval_data"]
    DatasetCatalog.get = staticmethod(lambda name: {
        "factory": "COCODataset",
        "args": {"root": img_dir, "ann_file": ann}})
    model, _ = _model(spec, spec["eval_cfg"])
    with torch.no_grad():
        for layer in (model.rpn["head"].cls_logits,
                      model.roi_heads["box"]["predictor"].cls_score):
            layer.weight.mul_(30.0)
    loader, dataset = make_data_loader(spec["eval_cfg"], is_train=False,
                                       device=CPU)
    shard_ids = []
    results, predictions = inference(
        model, _recording(loader, shard_ids), dataset,
        output_folder=out_dir if rank == 0 else None)
    return dict(shard=shard_ids, results=results, predictions=predictions)


def _recording(loader, ids: list):
    for batch, image_ids in loader:
        ids.extend(i for i in image_ids if i is not None)
        yield batch, image_ids


def rank_work(rank: int, world: int, init_method: str, spec: dict) -> dict:
    from da_detect_tpu_torch.parallel import init_distributed

    torch.set_num_threads(1)
    init_distributed(CPU, init_method=init_method, rank=rank,
                     world_size=world)
    out = dict(comm=_comm_checks(rank, world),
               steps=_steps(spec, rank, world, local=False),
               local_steps=_steps(spec, rank, world, local=True),
               source_only_da_grads=_source_only(spec, rank, world),
               checkpoint=_checkpoint(spec, rank, world, spec["ckpt_dir"]),
               eval=_eval(spec, rank, spec["eval_dir"]),
               mask=_source_steps(spec["mask"], rank, world, local=False),
               mask_local=_source_steps(spec["mask"], rank, world,
                                        local=True),
               kp=_source_steps(spec["kp"], rank, world, local=False),
               kp_local=_source_steps(spec["kp"], rank, world, local=True))
    out["jax_imported"] = any(m == "jax" or m.startswith("jax.")
                              for m in sys.modules)
    return out
