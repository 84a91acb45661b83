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

Under a (data, space, model) mesh (``mesh.py``; ``TPU.MESH_SPATIAL`` /
``TPU.MESH_MODEL``) the ranks of one data slice hold the same batch and
compute the same losses, so DDP and these reductions run over the mesh's
data group only: ``N`` above is the data size, not the world's.
``check_mesh`` validates the keys against the world size.
"""

from __future__ import annotations

import dataclasses
import os
import warnings

import torch
import torch.distributed as dist
from torch import nn
from torch.nn.parallel import DistributedDataParallel

from .mesh import check_divisible, current_mesh, data_group, data_world


def card_for(local_rank: int, local_world: int,
             cards: int) -> tuple[str, int]:
    """(backend, card) of local rank ``local_rank`` of the ``local_world``
    processes of a host with ``cards`` cards: NCCL, a card a rank, when
    there are enough; else gloo, ranks sharing the cards (rank r on card
    r modulo the cards; NCCL refuses two ranks on one card)."""
    if local_world <= cards:
        return "nccl", local_rank
    return "gloo", local_rank % cards


def init_distributed(device: torch.device, *, init_method: str = "env://",
                     rank: int | None = None,
                     world_size: int | None = None) -> torch.device:
    """Start this process's group and return its device. ``rank`` and
    ``world_size`` default to the ``torchrun`` environment (RANK,
    WORLD_SIZE); without WORLD_SIZE and without them the process is alone
    and nothing starts. On the CPU the backend is gloo; on the card it is
    ``card_for``'s, of the host's local ranks (LOCAL_RANK and
    LOCAL_WORLD_SIZE, else ``rank`` and ``world_size``: the processes
    ``spawn`` starts on one host): a device without an index becomes the
    rank's card. A backend that fails to start raises."""
    if dist.is_initialized():
        return device
    if world_size is None:
        if "WORLD_SIZE" not in os.environ:
            return device
        world_size = int(os.environ["WORLD_SIZE"])
        rank = int(os.environ["RANK"])
    backend = "gloo"
    if device.type == "cuda":
        backend, card = card_for(
            int(os.environ.get("LOCAL_RANK", rank)),
            int(os.environ.get("LOCAL_WORLD_SIZE", world_size)),
            torch.cuda.device_count())
        if device.index is None:
            device = torch.device("cuda", card)
        torch.cuda.set_device(device)
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
    """``TPU.MESH_SPATIAL`` and ``TPU.MESH_MODEL`` are at least 1 and their
    product divides the ``world`` processes; ``TPU.MESH_DATA`` is -1 (the
    rest) or world / (spatial * model). Each error names its key."""
    t = cfg.TPU
    for key in ("MESH_SPATIAL", "MESH_MODEL"):
        if t[key] < 1:
            raise ValueError(f"TPU.{key}={t[key]}: at least 1")
    inner = t.MESH_SPATIAL * t.MESH_MODEL
    if world % inner:
        raise ValueError(
            f"TPU.MESH_SPATIAL={t.MESH_SPATIAL} x TPU.MESH_MODEL="
            f"{t.MESH_MODEL} = {inner} does not divide the {world} "
            "processes")
    if t.MESH_DATA not in (-1, world // inner):
        raise ValueError(f"TPU.MESH_DATA={t.MESH_DATA} with {world} "
                         f"processes and {inner} a data slice: set -1 (all) "
                         f"or {world // inner}")


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
    """``x`` summed over the ranks (of the data group), without a gradient;
    ``x`` itself in a single process."""
    if data_world() == 1:
        return x
    y = x.detach().clone()
    dist.all_reduce(y, group=data_group())
    return y


def global_average(x: torch.Tensor) -> torch.Tensor:
    """The ranks' mean of ``x``, without a gradient: the global value of a
    mean over a count that is the same on every rank, or of a rank's share
    from ``global_mean``."""
    world = data_world()
    return x if world == 1 else global_sum(x) / world


def global_mean(num: torch.Tensor, den: torch.Tensor,
                floor: float) -> torch.Tensor:
    """This rank's share of ``sum_r num_r / max(sum_r den_r, floor)``: the
    ranks' mean of the shares is that global value, and DDP's mean of their
    gradients its gradient. ``num / max(den, floor)`` in a single
    process."""
    world = data_world()
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


def wrap_train_forward(model, mode: str, group=None) -> nn.Module:
    """DDP over ``TrainForward(model)``: call it as ``train_forward``. The
    parameters ``unused_parameters`` names are left out of the reduction
    (their gradients stay None, as in a single process) instead of
    ``find_unused_parameters``, which would search the graph every step;
    buffers are not broadcast (FrozenBN's are constants), as the reference
    sets it. Under a mesh DDP runs over its data group (``group``
    overrides it), and a mesh of one data slice needs none: the plain
    ``TrainForward``."""
    module = TrainForward(model)
    mesh = current_mesh()
    if group is None and mesh is not None:
        if mesh.data == 1:
            return module
        group = mesh.data_group
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
            broadcast_buffers=False, process_group=group)
