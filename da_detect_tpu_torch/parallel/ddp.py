"""Data-parallel training over N processes, one card each, with DDP (the
counterpart of ``da_detect_tpu/parallel/mesh.py``'s ``data`` axis; the
reference's only parallelism is NCCL DDP, train_net_triplet.py:83-88,301-309).

Each rank holds a replica of the model and trains on its own k triples
(``IMS_PER_BATCH // 2``, per process as in the JAX package's multi-process
loader); DDP all-reduces the gradients as their mean. That mean is the
gradient of the JAX package's loss over the global batch only if each
rank's loss is its share of that global loss. Most terms are not means over
a count that is the same on every rank: the RPN and box-head losses divide
by the sampled and source rows, the instance BCE and the consistency loss by
the valid instances. So the losses compute their normalizers over the
global batch: ``global_mean(num, den)`` is ``N * num / sum_r den_r``, whose
mean over the ranks is the global ``sum_r num_r / sum_r den_r``. Quantities
that steer the step (the AdvGRL probe losses, the image triplet loss that
moves the adaptive margin) are the ranks' mean (``global_average``), so
every rank takes the same GRL weight and keeps the same ``DAState``.

In a single process (no process group, or world size 1) every helper is the
identity, and the losses are computed as before, bit for bit.

Spatial and tensor parallelism (``TPU.MESH_SPATIAL`` / ``TPU.MESH_MODEL``)
are a later slice of the port: ``check_mesh`` raises on them.
"""

from __future__ import annotations

import dataclasses
import os
import warnings

import torch
import torch.distributed as dist
from torch import nn
from torch.nn.parallel import DistributedDataParallel

from ..utils.comm import get_world_size


def init_distributed(device: torch.device, *, backend: str | None = None,
                     init_method: str = "env://", rank: int | None = None,
                     world_size: int | None = None) -> torch.device:
    """Start this process's group and return its device. ``rank`` and
    ``world_size`` default to the ``torchrun`` environment (RANK,
    WORLD_SIZE; LOCAL_RANK picks the card); without WORLD_SIZE and without
    them the process is alone and nothing starts. The backend is NCCL on
    the card (device ``cuda:LOCAL_RANK``) and gloo on the CPU; ``backend``
    overrides it (gloo on the card: two ranks sharing one card). A backend
    that fails to start raises."""
    if dist.is_initialized():
        return device
    if world_size is None:
        if "WORLD_SIZE" not in os.environ:
            return device
        world_size = int(os.environ["WORLD_SIZE"])
        rank = int(os.environ["RANK"])
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    if device.type == "cuda":
        torch.cuda.set_device(device)
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    kw = dict(device_id=device) if backend == "nccl" else {}
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world_size, **kw)
    return device


def shutdown() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()


def _rank_main(rank, fn, world, init_method, out_dir, args):
    try:
        result = fn(rank, world, init_method, *args)
    finally:
        shutdown()
    torch.save(result, os.path.join(out_dir, f"rank{rank}.pt"))


def spawn(fn, world: int, *args, tmp_dir: str | None = None) -> list:
    """Run ``fn(rank, world, init_method, *args)`` in ``world`` new
    processes (the "spawn" start method; ``init_method`` a file store in a
    temporary directory, or under ``tmp_dir``, for ``init_distributed``)
    and return what each returned, in rank order (``torch.save``d). A rank
    that raises makes this raise; the process group of each rank is
    destroyed when its ``fn`` ends. ``fn`` must be importable (a module's
    top-level function)."""
    import tempfile

    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory(prefix="ddp_", dir=tmp_dir) as tmp:
        init_method = "file://" + os.path.join(tmp, "store")
        mp.start_processes(_rank_main,
                           args=(fn, world, init_method, tmp, args),
                           nprocs=world, start_method="spawn")
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"),
                           weights_only=False) for r in range(world)]


def check_mesh(cfg, world: int) -> None:
    """``TPU.MESH_DATA`` is -1 or the world size; spatial or tensor
    parallelism raises."""
    t = cfg.TPU
    for key in ("MESH_SPATIAL", "MESH_MODEL"):
        if t[key] > 1:
            raise NotImplementedError(
                f"TPU.{key}={t[key]}: spatial and tensor parallelism are a "
                "later slice of the port; it trains data-parallel only")
    if t.MESH_DATA not in (-1, world):
        raise ValueError(f"TPU.MESH_DATA={t.MESH_DATA} with {world} "
                         "processes: set -1 (all) or the world size")


def check_divisible(batch_size: int, world: int, group: int = 1) -> None:
    """A global batch of ``batch_size`` images in groups of ``group`` (3 for
    a triple) must split evenly over the ranks (JAX ``check_divisible``)."""
    if (batch_size // group) % world:
        raise ValueError(f"batch of {batch_size // group} groups not "
                         f"divisible by {world} ranks")


def shard(args: tuple, rank: int, world: int) -> tuple:
    """Rank ``rank``'s rows of a global batch: every tensor field of each
    ``ImageBatch`` / ``Targets`` in ``args`` cut to its ``rank``-th of
    ``world`` equal parts along the leading axis, as the JAX package's
    ``data`` sharding places them (so triple i keeps its three images)."""
    out = []
    for a in args:
        n = a.images.shape[0] if hasattr(a, "images") else a.boxes.shape[0]
        check_divisible(n, world)
        lo, hi = rank * n // world, (rank + 1) * n // world
        out.append(dataclasses.replace(a, **{
            f.name: getattr(a, f.name)[lo:hi]
            for f in dataclasses.fields(a)
            if getattr(a, f.name) is not None}))
    return tuple(out)


def global_sum(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over the ranks, without a gradient; ``x`` itself in a
    single process."""
    if get_world_size() == 1:
        return x
    y = x.detach().clone()
    dist.all_reduce(y)
    return y


def global_average(x: torch.Tensor) -> torch.Tensor:
    """The ranks' mean of ``x``, without a gradient: the global value of a
    mean over a count that is the same on every rank, or of a rank's share
    from ``global_mean``."""
    world = get_world_size()
    return x if world == 1 else global_sum(x) / world


def global_mean(num: torch.Tensor, den: torch.Tensor,
                floor: float) -> torch.Tensor:
    """This rank's share of ``sum_r num_r / max(sum_r den_r, floor)``: the
    ranks' mean of the shares is that global value, and DDP's mean of their
    gradients its gradient. ``num / max(den, floor)`` in a single
    process."""
    world = get_world_size()
    if world == 1:
        return num / den.clamp(min=floor)
    return num * world / global_sum(den).clamp(min=floor)


class TrainForward(nn.Module):
    """The detector's ``train_forward`` as a module's ``forward``: DDP
    prepares its gradient reduction in ``forward``."""

    def __init__(self, model: nn.Module):
        super().__init__()
        self.model = model

    def forward(self, *args, **kwargs):
        return self.model.train_forward(*args, **kwargs)


def unused_parameters(model, mode: str) -> list[str]:
    """The trainable parameters that take no gradient in ``mode``
    ("source_only", "da" or "da_triplet"): the DA heads in source-only
    training (and in an RPN-only model, which returns before them), the
    image head when the image and consistency losses weigh 0, the instance
    head when the instance and consistency losses do; and the mask and
    keypoint heads in the DA modes, whose loaders carry no GT masks or
    keypoints (the mask loss is 0 there, the keypoint loss absent, and
    neither head runs). Every other parameter gets a gradient in every
    step (the aligned re-pool that a 0 instance triplet weight skips runs
    the box head's own extractor, which the detection pass uses anyway)."""
    unused = []
    if mode != "source_only":
        for key in ("mask", "keypoint"):
            if key in getattr(model, "roi_heads", {}):
                unused += [f"roi_heads.{key}.{n}" for n, p in
                           model.roi_heads[key].named_parameters()
                           if p.requires_grad]
    da = model.da_heads
    if da is None:
        return unused
    heads = []
    if mode == "source_only" or model.rpn_only:
        heads = ["imghead", "inshead"]
    else:
        if da.img_weight == 0 and da.cst_weight == 0:
            heads.append("imghead")
        if da.ins_weight == 0 and da.cst_weight == 0:
            heads.append("inshead")
    return unused + [f"da_heads.{h}.{n}" for h in heads
                     for n, p in getattr(da, h).named_parameters()
                     if p.requires_grad]


def wrap_train_forward(model, mode: str) -> DistributedDataParallel:
    """DDP over ``TrainForward(model)``: call it as ``train_forward``. The
    parameters ``unused_parameters`` names are left out of the reduction
    (their gradients stay None, as in a single process) instead of
    ``find_unused_parameters``, which would search the graph every step;
    buffers are not broadcast (FrozenBN's are constants), as the reference
    sets it."""
    module = TrainForward(model)
    DistributedDataParallel._set_params_and_buffers_to_ignore_for_model(
        module, [f"model.{n}" for n in unused_parameters(model, mode)])
    dev = next(model.parameters()).device
    with warnings.catch_warnings():
        # newer torch renames the option; its replacement would sync the
        # buffers at construction
        warnings.filterwarnings("ignore", ".*broadcast_buffers",
                                FutureWarning)
        return DistributedDataParallel(
            module, device_ids=[dev.index] if dev.type == "cuda" else None,
            broadcast_buffers=False)
