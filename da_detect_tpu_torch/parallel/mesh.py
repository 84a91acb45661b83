"""The (data, space, model) process mesh (port of
``da_detect_tpu/parallel/mesh.py``).

The JAX package folds its devices into a mesh whose ``data`` axis shards
the batch, whose ``space`` axis (``TPU.MESH_SPATIAL``) splits every canvas's
H over its devices, and whose ``model`` axis (``TPU.MESH_MODEL``) splits the
wide channel axes of the parameters; GSPMD derives the collectives. Here
the devices are processes (one rank a card, or ranks sharing one card
through gloo), folded the same way: ``model`` varies fastest, then
``space``, then ``data``. Each rank holds its coordinates and three process
groups: the ranks that share its (space, model) coordinates (its ``data``
group), its (data, model) (``space``) and its (data, space) (``model``).
The collectives are written by hand in ``ddp.py`` (data), ``spatial.py``
(space) and ``tensor.py`` (model); ``parallelize(model, mesh)`` puts a
model under the mesh.

The collectives each mode runs in a training step, and over which group
(all built from ``all_reduce``, ``all_gather`` and ``broadcast``):

- data (``data`` > 1): DDP's gradient all-reduce (buckets, mean) and the
  losses' normalizers and probes (``global_sum``/``global_average``: a few
  scalar all-reduces), over the data group.
- space (``space`` > 1): in the backbone, per convolution and pool, one
  all-gather of each rank's edge strips (its halo rows) forward and one
  all-reduce of the strips' gradients backward; per GroupNorm two
  all-reduces of group sums forward and two backward; per deformable
  convolution one all-gather of the map forward and one all-reduce of its
  gradient backward; per output map of the backbone one all-gather forward
  (the backward keeps the own rows, no collective); after the backward one
  all-reduce of every gradient (``reduce_mesh_grads``: the backbone's
  partial sums summed, the rest averaged); all over the space group.
- model (``model`` > 1): per split layer one all-gather of the output
  channels forward and one all-reduce of the input gradient backward; per
  split norm one all-gather of its vectors forward (the backward keeps the
  own slice); after the backward one all-reduce (mean) of the replicated
  leaves' gradients (``reduce_mesh_grads``); over the model group.

The ranks of a data slice compute the replicated leaves' gradients each on
its own. They agree only to rounding where an operation's order is not
fixed (cuDNN's backward, say), so ``reduce_mesh_grads`` averages them over
the slice: every rank then applies the same bits and the replicated
parameters never drift apart, whatever the ops. Its cost is one all-reduce
of those gradients a step (PERF.md, phase ``mesh2``).

A single process (no process group) has no mesh: ``current_mesh()`` is
None and every helper is the identity.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from ..utils import comm

_CURRENT: "Mesh | None" = None


class Mesh:
    """``world`` ranks folded into (data, space, model); this process is
    ``rank``. ``groups``: build the three process groups (every rank of the
    world must build the same mesh, in the same order, as
    ``dist.new_group`` requires); without a process group there are none
    (a mesh to reason about placement only)."""

    def __init__(self, world: int, rank: int = 0, spatial: int = 1,
                 model: int = 1, groups: bool = False):
        inner = spatial * model
        if spatial < 1 or model < 1 or world % inner:
            raise ValueError(f"{world} devices not divisible by "
                             f"spatial*model = {inner}")
        self.world, self.rank = world, rank
        self.data, self.space, self.model = world // inner, spatial, model
        self.grid = np.arange(world).reshape(self.data, spatial, model)
        d, s, m = (int(c[0]) for c in np.nonzero(self.grid == rank))
        self.coords = (d, s, m)
        self.data_group = self.space_group = self.model_group = None
        if groups:
            self._build_groups()

    def _build_groups(self) -> None:
        g = self.grid
        d, s, m = self.coords
        for axis, attr in ((0, "data_group"), (1, "space_group"),
                           (2, "model_group")):
            lines = np.moveaxis(g, axis, -1).reshape(-1, g.shape[axis])
            for line in lines:
                group = dist.new_group([int(r) for r in line])
                if self.rank in line:
                    setattr(self, attr, group)

    @property
    def axis_names(self) -> tuple:
        return ("data",) + (("space",) if self.space > 1 else ()) + (
            ("model",) if self.model > 1 else ())

    @property
    def shape(self) -> dict:
        """{axis: size}, the axes of JAX's mesh (``space`` and ``model``
        only when > 1)."""
        sizes = dict(data=self.data, space=self.space, model=self.model)
        return {a: sizes[a] for a in self.axis_names}

    @property
    def devices(self) -> np.ndarray:
        """The ranks in JAX's device-grid layout (an axis a name)."""
        return self.grid.reshape(tuple(self.shape.values()))

    @property
    def data_rank(self) -> int:
        return self.coords[0]

    @property
    def space_rank(self) -> int:
        return self.coords[1]

    @property
    def model_rank(self) -> int:
        return self.coords[2]

    @property
    def is_data_leader(self) -> bool:
        """The rank of its data slice that speaks for it (space and model
        coordinates 0): the one whose eval predictions are merged."""
        return self.coords[1:] == (0, 0)

    def __repr__(self) -> str:
        sizes = dict(data=self.data, space=self.space, model=self.model)
        return f"Mesh({sizes}, rank={self.rank}, coords={self.coords})"


def make_mesh(num_devices: int = -1, spatial: int = 1, model: int = 1,
              rank: int | None = None) -> Mesh:
    """The mesh of ``num_devices`` ranks (-1: the process group's world, or
    1 without one), as JAX's ``make_mesh`` folds its devices; ``rank``
    defaults to this process's. It has process groups when it spans the
    whole process group (build it on every rank)."""
    live = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if live else 1
    n = num_devices if num_devices and num_devices > 0 else world
    if rank is None:
        rank = dist.get_rank() if live else 0
    return Mesh(n, rank, spatial, model, groups=live and n == world > 1)


def set_mesh(mesh: Mesh | None) -> None:
    """Make ``mesh`` the process's mesh (None: none)."""
    global _CURRENT
    _CURRENT = mesh


def current_mesh() -> Mesh | None:
    return _CURRENT


def init_mesh(spatial: int = 1, model: int = 1) -> Mesh | None:
    """The process group's mesh, made the current one; None (and none set)
    in a single process, and at spatial = model = 1, where the world is
    the data group (plain data parallelism, as before the mesh)."""
    if not (dist.is_available() and dist.is_initialized()) \
            or spatial == model == 1:
        set_mesh(None)
        return None
    mesh = make_mesh(spatial=spatial, model=model)
    set_mesh(mesh)
    return mesh


def data_axis_size(mesh: Mesh | None) -> int:
    return 1 if mesh is None else mesh.data


def model_axis_size(mesh: Mesh | None) -> int:
    return 1 if mesh is None else mesh.model


def data_group():
    """The current mesh's data group; None (the whole world) without one."""
    return None if _CURRENT is None else _CURRENT.data_group


def data_world() -> int:
    """The ranks that see different data: the current mesh's ``data``
    size, else the world size (``utils.comm``: 1 in a single process)."""
    if _CURRENT is not None:
        return _CURRENT.data
    return comm.get_world_size()


def data_rank() -> int:
    """This rank's data coordinate (its loader shard, its generator's
    seed): the mesh's, else the process rank."""
    if _CURRENT is not None:
        return _CURRENT.data_rank
    return comm.get_rank()


def check_divisible(batch_size: int, parts: int, group: int = 1) -> None:
    """A global batch of ``batch_size`` images in groups of ``group`` (3 for
    a triple) must split evenly over ``parts`` data ranks (JAX
    ``check_divisible`` with ``parts = data_axis_size(mesh)``)."""
    if (batch_size // group) % parts:
        raise ValueError(f"batch of {batch_size // group} groups not "
                         f"divisible by {parts} data ranks")


def _all_reduce_flat(grads: list, group) -> None:
    """Sum ``grads`` over ``group`` in place, in one all-reduce."""
    if not grads:
        return
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, group=group)
    at = 0
    for g in grads:
        g.copy_(flat[at:at + g.numel()].view_as(g))
        at += g.numel()


def reduce_mesh_grads(model) -> None:
    """Make the gradients of ``model`` (under ``parallelize``) those of its
    data slice, after the backward (DDP averages over data). Over space:
    the backbone's are partial sums (``partition_backbone``), summed; every
    other is whole on each rank, averaged. Over model: each rank's slice
    of a split leaf is its own; every replicated leaf's is averaged.
    Nothing for a model outside a mesh."""
    mesh = getattr(model, "_mesh", None)
    if mesh is None:
        return
    named = [(n, p) for n, p in model.named_parameters()
             if p.grad is not None]
    if mesh.space > 1:
        partial = {id(p) for p in model._space_partial}
        grads = [p.grad for _, p in named]
        _all_reduce_flat(grads, mesh.space_group)
        for _, p in named:
            if id(p) not in partial:
                p.grad.div_(mesh.space)
    if mesh.model > 1:
        grads = [p.grad for n, p in named if n not in model._tp_plan]
        _all_reduce_flat(grads, mesh.model_group)
        for g in grads:
            g.div_(mesh.model)


def replicate(tensors, mesh: Mesh | None):
    """Every tensor of ``tensors`` (a module, a dict or a sequence) made
    equal to rank 0's in place (a broadcast over the world); the identity
    in a single process. Returns ``tensors``."""
    if mesh is None or mesh.world == 1:
        return tensors
    if isinstance(tensors, torch.nn.Module):
        items = list(tensors.state_dict().values())
    elif isinstance(tensors, dict):
        items = list(tensors.values())
    else:
        items = list(tensors)
    with torch.no_grad():
        for t in items:
            dist.broadcast(t, 0)
    return tensors


def _chunk(n: int, parts: int, i: int) -> tuple[int, int]:
    """JAX's shard of an axis of ``n`` over ``parts`` devices: chunks of
    ceil(n / parts), the last ones shorter."""
    size = -(-n // parts)
    return min(i * size, n), min((i + 1) * size, n)


class BatchSharding:
    """Rank r's part of a global batch, the rows JAX's ``BatchSharding.put``
    places on device r: every tensor field cut over ``data`` on its leading
    axis; ``ImageBatch.images`` [B, 3, H, W] also over ``space`` on H;
    ``sizes``, ``orig_sizes`` and ``is_source`` over ``data`` only."""

    def __init__(self, mesh: Mesh | None):
        self.mesh = mesh

    def put(self, tree):
        mesh = self.mesh
        if mesh is None or mesh.world == 1:
            return tree
        d, s, _ = mesh.coords

        def cut(x, rows=False):
            lo, hi = _chunk(x.shape[0], mesh.data, d)
            x = x[lo:hi]
            if rows and mesh.space > 1:
                lo, hi = _chunk(x.shape[2], mesh.space, s)
                x = x[:, :, lo:hi]
            return x

        def go(node):
            if isinstance(node, (tuple, list)):
                return type(node)(go(n) for n in node)
            if dataclasses.is_dataclass(node):
                check_divisible(_leading(node), mesh.data)
                return dataclasses.replace(node, **{
                    f.name: cut(getattr(node, f.name), f.name == "images")
                    for f in dataclasses.fields(node)
                    if getattr(node, f.name) is not None})
            return cut(node)

        return go(tree)


def _leading(node) -> int:
    for f in dataclasses.fields(node):
        v = getattr(node, f.name)
        if isinstance(v, torch.Tensor):
            return v.shape[0]
    return 0


def batch_sharding(mesh: Mesh | None) -> BatchSharding:
    return BatchSharding(mesh)


def data_sharding(mesh: Mesh | None) -> BatchSharding:
    """JAX's ``NamedSharding(mesh, P("data"))``: every leaf's leading axis
    over ``data``, whole over ``space`` and ``model``. Here a placement
    whose ``put(tree)`` is this rank's part: every tensor field, images
    too, cut over the mesh's data axis alone (``put_batch`` dispatches to
    it). None, or one data rank: the whole batch."""
    if mesh is None or mesh.data == 1:
        return BatchSharding(None)
    return BatchSharding(Mesh(mesh.data, mesh.data_rank))


def put_batch(tree, sharding):
    """``tree`` placed by ``sharding`` (JAX's ``put_batch``): None passes
    it through; an object with ``.put`` (``BatchSharding``,
    ``data_sharding``) is called on it; a device (a ``torch.device`` or
    its name, as ``jax.device_put`` takes one) moves every tensor of it
    there. JAX's plain ``NamedSharding`` has no counterpart here: a rank
    holds its own part, which only a ``.put`` can cut."""
    if sharding is None:
        return tree
    if hasattr(sharding, "put"):
        return sharding.put(tree)
    if isinstance(sharding, (torch.device, str)):
        return _to_device(tree, torch.device(sharding))
    raise TypeError(f"put_batch: no placement for {type(sharding).__name__}"
                    " (None, an object with .put, or a device)")


def _to_device(node, device: torch.device):
    if isinstance(node, torch.Tensor):
        return node.to(device)
    if isinstance(node, (tuple, list)):
        return type(node)(_to_device(n, device) for n in node)
    if isinstance(node, dict):
        return {k: _to_device(v, device) for k, v in node.items()}
    if dataclasses.is_dataclass(node):
        return dataclasses.replace(node, **{
            f.name: _to_device(getattr(node, f.name), device)
            for f in dataclasses.fields(node)})
    return node


def shard_batch(tree, mesh: Mesh | None):
    """This rank's part of the global batch ``tree`` (a batch, or a tuple
    of ``ImageBatch`` / ``Targets``), as JAX places it (``BatchSharding``).
    A model under a space mesh takes its data slice's whole canvases
    (``data_shard``) and cuts its own rows in the backbone; these are the
    rows it cuts when S divides H."""
    return BatchSharding(mesh).put(tree)


def data_shard(tree, mesh: Mesh | None):
    """This rank's data slice of the global batch ``tree``: every field cut
    over ``data`` only (what a model under the mesh takes)."""
    return data_sharding(mesh).put(tree)
