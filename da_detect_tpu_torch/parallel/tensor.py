"""Tensor parallelism (``TPU.MESH_MODEL``): the Megatron-style column split
of the JAX package's ``model`` axis (``da_detect_tpu/parallel/mesh.py``
``shard_model``), with the collectives written by hand.

Which leaves split (``split_plan``): exactly those JAX's rule splits in
``params``, whose trailing axis in JAX's layout is at least
``min_channels`` (256) and divisible by the ``model`` size. In the port's
layouts that axis is a ``Conv2d``'s (and a deformable conv's) output
channels, OIHW dim 0; a ``Linear``'s ``[out, in]`` dim 0; a
``ConvTranspose2d``'s ``[in, out, kh, kw]`` dim 1; the biases' and the
GroupNorm and BatchNorm vectors' dim 0. Each model rank keeps its slice
of a split leaf (so its SGD momentum is the slice too); FrozenBN's buffers
are not parameters (JAX's ``frozen``, not ``params``) and stay whole: the
output a FrozenBN normalizes is always whole (gathered).

Forward: a split layer computes its own output channels from the whole
input (``split_call``) and all-gathers them over the model group
(backward: each rank keeps its own slice of the gradient); the input's
gradient, a partial sum a rank, is all-reduced over model. A grouped
convolution splits on group boundaries (its input channels of its own
groups; ``model`` must divide the groups). A split norm gathers its
vectors at use (backward: the own slice; every rank's is whole, computed
identically). The gradient of a split leaf is its slice's whole gradient;
a replicated leaf's is computed identically on every model rank. So the
model group needs no gradient reduction.

Checkpoints hold whole tensors: ``full_state_dict`` and
``full_optimizer_state`` gather the slices (every rank calls them);
``local_state_dict`` and ``local_optimizer_state`` cut a whole state to
this rank's slices.
"""

from __future__ import annotations

import torch
from torch import nn

from ..layers import (BatchNorm, ConvTranspose2d, DeformConv2d, GroupNorm,
                      Linear)
from .spatial import (MeshConv2d, MeshDeformConv2d, MeshGroupNorm,
                      _keep_format, all_gather, all_reduce_sum)


class _ToModel(torch.autograd.Function):
    """Megatron's f: the identity forward, the gradient all-reduced over
    the model group backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_sum(g, ctx.group), None


class _GatherModel(torch.autograd.Function):
    """Megatron's g: the ranks' slices all-gathered along ``dim`` forward,
    the own slice of the gradient backward."""

    @staticmethod
    def forward(ctx, y, dim, group, parts, me):
        ctx.dim, ctx.me, ctx.n = dim, me, y.shape[dim]
        out = torch.cat(all_gather(y, group, parts), dim=dim)
        return _keep_format(out, y)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.me * ctx.n, ctx.n), None, None, None, \
            None


def _gather(y: torch.Tensor, mesh, dim: int) -> torch.Tensor:
    return _GatherModel.apply(y, dim, mesh.model_group, mesh.model,
                              mesh.model_rank)


def split_call(layer, x: torch.Tensor, compute) -> torch.Tensor:
    """``compute(x, weight, bias, groups)`` of ``layer``; split over model
    (``layer._split``): on the whole input (the input channels of its own
    groups), then its output channels all-gathered."""
    bias = getattr(layer, "bias", None)
    groups = getattr(layer, "groups", 1)
    if not layer._split:
        return compute(x, layer.weight, bias, groups)
    mesh = layer._mesh
    x = _ToModel.apply(x, mesh.model_group)
    if groups > 1:
        c = x.shape[1] // mesh.model
        x = x[:, mesh.model_rank * c:(mesh.model_rank + 1) * c]
        groups //= mesh.model
    return _gather(compute(x, layer.weight, bias, groups), mesh,
                   layer._split_dim)


def full_vector(module, name: str) -> torch.Tensor:
    """A norm's vector, whole: gathered over model when it is split."""
    p = getattr(module, name)
    if name not in getattr(module, "_split_names", ()):
        return p
    return _gather(p, module._mesh, 0)


class MeshLinear(Linear):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return split_call(self, x, lambda xs, w, b, _g: self.linear(xs, w, b))


class MeshConvTranspose2d(ConvTranspose2d):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return split_call(self, x, lambda xs, w, b, _g: self.conv(xs, w, b))


class MeshBatchNorm(BatchNorm):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w, b = full_vector(self, "weight"), full_vector(self, "bias")
        mul = torch.rsqrt(self.running_var + self.eps) * w
        return ((x.float() - self.running_mean.view(1, -1, 1, 1))
                * mul.view(1, -1, 1, 1) + b.view(1, -1, 1, 1))


def _axis(module, name: str, p: torch.Tensor, min_channels: int):
    """The port's dim of JAX's trailing axis of ``module``'s parameter
    ``name``; None for a scalar, or a narrow leaf of another module."""
    if isinstance(module, nn.ConvTranspose2d) and name == "weight":
        return 1
    if p.dim() and isinstance(module, (nn.Conv2d, nn.Linear, DeformConv2d,
                                       nn.ConvTranspose2d, GroupNorm,
                                       BatchNorm)):
        return 0
    if p.dim() and max(p.shape) >= min_channels:
        raise NotImplementedError(
            f"no tensor-parallel layout for {type(module).__name__}.{name}")
    return None


def split_plan(model: nn.Module, parts: int,
               min_channels: int = 256) -> dict:
    """{parameter name: the dim split over ``parts`` model ranks}: JAX's
    ``shard_model`` rule on the port's layouts."""
    plan = {}
    for mname, module in model.named_modules():
        for pname, p in module.named_parameters(recurse=False):
            dim = _axis(module, pname, p, min_channels)
            if dim is None:
                continue
            size = p.shape[dim]
            if size >= min_channels and size % parts == 0:
                plan[f"{mname}.{pname}" if mname else pname] = dim
    return plan


_MESH_CLASS = ((DeformConv2d, MeshDeformConv2d), (nn.Conv2d, MeshConv2d),
               (nn.ConvTranspose2d, MeshConvTranspose2d),
               (nn.Linear, MeshLinear), (GroupNorm, MeshGroupNorm),
               (BatchNorm, MeshBatchNorm))


def shard_model(model: nn.Module, mesh, min_channels: int = 256) -> dict:
    """Split ``model``'s wide leaves over ``mesh``'s model group in place:
    each module holding one takes its mesh class and keeps its own slice.
    Returns the plan (``split_plan``); empty without a model axis."""
    if mesh is None or mesh.model == 1:
        return {}
    plan = split_plan(model, mesh.model, min_channels)
    modules = dict(model.named_modules())
    by_module: dict = {}
    for name, dim in plan.items():
        mname, _, pname = name.rpartition(".")
        by_module.setdefault(mname, []).append((pname, dim))
    for mname, leaves in by_module.items():
        module = modules[mname]
        cls = next(c for base, c in _MESH_CLASS if isinstance(module, base))
        if getattr(module, "groups", 1) > 1:
            if module.groups % mesh.model or isinstance(
                    module, nn.ConvTranspose2d):
                raise ValueError(
                    f"{mname}: {module.groups} groups cannot split over "
                    f"{mesh.model} model ranks")
            if getattr(module, "deformable_groups", 1) > 1:
                raise NotImplementedError(
                    f"{mname}: a grouped kernel with deformable groups "
                    "under TPU.MESH_MODEL")
        if not isinstance(module, cls):
            if not hasattr(module, "compute_dtype"):
                module.compute_dtype = torch.float32
            module.__class__ = cls
            module._rows = False
        module._mesh, module._split = mesh, True
        module._split_names = {p for p, _ in leaves}
        # the dim of the layer's output its ranks' channels gather along
        module._split_dim = -1 if isinstance(module, nn.Linear) else 1
        for pname, dim in leaves:
            p = getattr(module, pname)
            setattr(module, pname, nn.Parameter(
                local_value(p.detach(), dim, mesh).clone(),
                requires_grad=p.requires_grad))
    return plan


def local_value(value: torch.Tensor, dim: int, mesh) -> torch.Tensor:
    n = value.shape[dim] // mesh.model
    return value.narrow(dim, mesh.model_rank * n, n)


def _full(value: torch.Tensor, dim: int, mesh) -> torch.Tensor:
    return torch.cat(all_gather(value, mesh.model_group, mesh.model),
                     dim=dim)


def _plan(model):
    return getattr(model, "_tp_plan", None) or {}


def full_state_dict(model: nn.Module) -> dict:
    """``model.state_dict()`` with every split leaf whole (gathered over
    model: every rank calls it)."""
    state = model.state_dict()
    for name, dim in _plan(model).items():
        state[name] = _full(state[name], dim, model._mesh)
    return state


def local_state_dict(model: nn.Module, state: dict) -> dict:
    """A whole ``state`` (a checkpoint's, a weight file's) cut to this
    rank's slices of ``model``'s split leaves."""
    plan = _plan(model)
    if not plan:
        return state
    out = dict(state)
    for name, dim in plan.items():
        if name in out:
            out[name] = local_value(out[name], dim, model._mesh).clone()
    return out


def _momentum_names(optimizer) -> list:
    return [optimizer.names[p] for g in optimizer.sgd.param_groups
            for p in g["params"]]


def _with_momentum(optimizer, model: nn.Module, state: dict, fn) -> dict:
    """``state`` (an optimizer's state dict) with each split leaf's
    momentum replaced by ``fn(momentum, dim)``, in copies of the
    per-parameter dicts: ``optimizer.state_dict()`` packs the live ones,
    which must keep their slices."""
    plan = _plan(model)
    if not plan:
        return state
    names = _momentum_names(optimizer)
    out = dict(state, state={i: dict(st) for i, st in state["state"].items()})
    for i, st in out["state"].items():
        name = names[int(i)]
        if name in plan and st.get("momentum_buffer") is not None:
            st["momentum_buffer"] = fn(st["momentum_buffer"], plan[name])
    return out


def full_optimizer_state(optimizer, model: nn.Module) -> dict:
    """``optimizer.state_dict()`` with every split leaf's momentum whole
    (gathered over model: every rank calls it); the optimizer keeps its
    slices."""
    return _with_momentum(optimizer, model, optimizer.state_dict(),
                          lambda m, dim: _full(m, dim, model._mesh))


def local_optimizer_state(optimizer, model: nn.Module, state: dict) -> dict:
    """A whole optimizer ``state`` (a checkpoint's) cut to this rank's
    slices of the split leaves' momentum."""
    return _with_momentum(
        optimizer, model, state,
        lambda m, dim: local_value(m, dim, model._mesh).clone())
