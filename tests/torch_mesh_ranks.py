"""What each rank of ``tests/test_torch_mesh.py``'s four-process run does.

A module of its own, importing no JAX (the ranks are spawned processes
that import the module holding their function). ``rank_work`` runs every
piece in one process group (gloo on the CPU): the triplet steps under
three meshes, the FPN-DCN eval forward under three, the GroupNorm,
RetinaNet (P6/P7), VGG-16 and FBNet backbones on row shards, SAME padding
and a conv on row shards, the FBNet Mask R-CNN's eval forward under three
meshes and its source-only step under two, a checkpoint under model=2 and
the DDP trap, and returns what the test compares.
"""

from __future__ import annotations

import dataclasses
import sys

import torch
import torch.distributed as dist

CPU = torch.device("cpu")


def _model(cfg, variables, mesh, min_channels):
    from da_detect_tpu_torch.entry import prepare_model
    from da_detect_tpu_torch.models import build_detection_model
    from da_detect_tpu_torch.parallel import parallelize
    from da_detect_tpu_torch.utils.weights import load_jax_variables

    model = prepare_model(build_detection_model(cfg), CPU)
    parallelize(model, mesh, min_channels)
    load_jax_variables(model, variables)  # whole, cut to the rank's slices
    return model


def _full_params(model) -> dict:
    from da_detect_tpu_torch.parallel.tensor import full_state_dict

    full = full_state_dict(model)
    return {n: full[n].clone() for n, _ in model.named_parameters()}


def _steps(spec, mesh, ddp_group=None, after_first=None) -> dict:
    """``spec["steps"]`` triplet steps on this rank's data slice of the
    global batch: each step's losses and DAState, the whole parameters
    after step 1 and at the end, and this rank's own slices.
    ``after_first(state)`` runs after step 1."""
    from da_detect_tpu_torch.engine.trainer import (create_train_state,
                                                    make_train_step)
    from da_detect_tpu_torch.parallel import data_shard, wrap_train_forward

    model = _model(spec["cfg"], spec["variables"], mesh,
                   spec["min_channels"])
    state = create_train_state(spec["cfg"], model, 0, "cosine")
    step = make_train_step(model, state.optimizer, aligned=True,
                           deterministic=True,
                           forward=wrap_train_forward(model, "da_triplet",
                                                      group=ddp_group))
    args = data_shard(spec["batch"], mesh)
    losses, states, first = [], [], None
    for i in range(spec["steps"]):
        state, metrics = step(state, *args)
        losses.append({k: float(v) for k, v in metrics.items()})
        states.append({f.name: float(getattr(state.da_state, f.name))
                       for f in dataclasses.fields(state.da_state)})
        if i == 0:
            first = _full_params(model)
            if after_first is not None:
                after_first(state)
    return dict(losses=losses, da_states=states, first=first,
                params=_full_params(model),
                local={n: p.detach().clone()
                       for n, p in model.named_parameters()},
                plan=dict(getattr(model, "_tp_plan", {}) or {}),
                state=state)


def _checkpoint(spec, mesh, out_dir: str) -> dict:
    """The steps under ``mesh`` (model=2) with a save by every rank after
    step 1 (training goes on from the live state) and at the end, then a
    fresh split model and optimizer resumed from the last file: its whole
    parameters and momentum against the file's."""
    from da_detect_tpu_torch.engine.trainer import create_train_state
    from da_detect_tpu_torch.parallel.tensor import (full_optimizer_state,
                                                     full_state_dict)
    from da_detect_tpu_torch.utils.checkpoint import Checkpointer

    ckpt = Checkpointer(out_dir)
    run = _steps(spec, mesh,
                 after_first=lambda st: ckpt.save(st.step, st))
    state = run["state"]
    path = ckpt.save(state.step, state)
    fresh_model = _model(spec["cfg"], spec["variables"], mesh,
                         spec["min_channels"])
    fresh = create_train_state(spec["cfg"], fresh_model, 0, "cosine")
    fresh, start = ckpt.resume(fresh)
    saved = torch.load(path, weights_only=True)
    model_state = full_state_dict(fresh.model)
    momentum = full_optimizer_state(fresh.optimizer, fresh.model)["state"]
    return dict(
        path=path, start=start, losses=run["losses"], params=run["params"],
        local_shapes={
            n: tuple(p.shape) for n, p in fresh.model.named_parameters()},
        resumed_model=all(torch.equal(v, saved["model"][k])
                          for k, v in model_state.items())
        and set(model_state) == set(saved["model"]),
        resumed_momentum=all(torch.equal(
            st["momentum_buffer"],
            saved["optimizer"]["state"][i]["momentum_buffer"])
            for i, st in momentum.items()))


def _eval(spec, mesh) -> dict:
    """A narrowed model's eval forward on this rank's data slice (with
    masks when ``spec["with_masks"]``): its detections (and mask
    probabilities)."""
    from da_detect_tpu_torch.parallel import data_shard

    model = _model(spec["cfg"], spec["variables"], mesh,
                   spec["min_channels"])
    masks = spec.get("with_masks", False)
    with torch.no_grad():
        out = model(data_shard(spec["batch"], mesh),
                    **({"with_masks": True} if masks else {}))
    dets, probs = out if masks else (out, None)
    return dict(dets=dets, probs=probs, plan=dict(model._tp_plan))


def _source_step(spec, mesh) -> dict:
    """One source-only step of a narrowed model on this rank's data slice
    (DDP over the data group): the global losses and every trainable
    gradient the step applies, whole (split leaves gathered)."""
    from da_detect_tpu_torch.engine.trainer import (create_train_state,
                                                    make_train_step)
    from da_detect_tpu_torch.parallel import data_shard, wrap_train_forward
    from da_detect_tpu_torch.parallel.tensor import _full

    model = _model(spec["cfg"], spec["variables"], mesh,
                   spec["min_channels"])
    state = create_train_state(spec["cfg"], model, 0, "multistep")
    step = make_train_step(model, state.optimizer, deterministic=True,
                           forward=wrap_train_forward(model, "source_only"))
    state, metrics = step(state, *data_shard(spec["batch"], mesh))
    plan = model._tp_plan
    return dict(
        losses={k: float(v) for k, v in metrics.items()
                if k != "loss_total"}, plan=dict(plan),
        grads={n: _full(p.grad, plan[n], mesh) if n in plan
               else p.grad.clone()
               for n, p in model.named_parameters() if p.requires_grad})


SAME_PAD_HEIGHTS = (12, 13)


def same_pad_pass(k: int, s: int, mesh=None) -> dict:
    """``layers.rows.same_pad`` then an unpadded k x k conv at stride s on
    maps of SAME_PAD_HEIGHTS rows (at stride 2 the even side pads
    (k - 2) // 2 rows before and one more after, the odd side (k - 1) / 2
    on each; 13 rows split 7/6 over 2 ranks), for a fixed
    random projection of the output: the output, the input's gradient and
    the kernel's. With ``mesh``, each rank pads and fetches through
    ``MeshRowOps.same_pad`` and convolves its own output rows
    (``MeshConv2d``); the output is gathered whole, the input's gradient
    is the rank's own rows and the kernel's is summed over space."""
    from da_detect_tpu_torch.layers import Conv2d
    from da_detect_tpu_torch.layers.rows import same_pad
    from da_detect_tpu_torch.parallel import spatial

    out = {}
    for h in SAME_PAD_HEIGHTS:
        gen = torch.Generator().manual_seed(10 * k + s + h)
        x = torch.randn(1, 4, h, 9, generator=gen).contiguous(
            memory_format=torch.channels_last)
        conv = Conv2d(4, 3, k, stride=s, bias=False)
        with torch.no_grad():
            conv.weight.copy_(torch.randn(conv.weight.shape, generator=gen))
        if mesh is None:
            x.requires_grad_(True)
            y = conv(same_pad(x, k, s))
        else:
            lo, hi = spatial.row_range(h, mesh.space, mesh.space_rank)
            x = x[:, :, lo:hi].detach().requires_grad_(True)
            spatial._swap(conv, spatial.MeshConv2d, mesh)
            conv._rows = True
            with spatial._pass(x, h):
                ys = conv(spatial.row_same_pad(x, mesh, k, s))
                y = spatial.gather_rows(ys, mesh, spatial.global_height(ys),
                                        sum_grad=False)
        proj = torch.randn(y.shape, generator=gen)
        (y * proj).sum().backward()
        w_grad = conv.weight.grad
        if mesh is not None:
            w_grad = spatial.all_reduce_sum(w_grad, mesh.space_group)
        out[h] = dict(y=y.detach(), x_grad=x.grad, w_grad=w_grad)
    return out


def backbone_pass(cfg, images, mesh=None, seed: int = 0) -> dict:
    """``cfg``'s backbone (seed-0 weights) on ``images``: its output maps
    (whole) and, for a fixed random projection of them, the gradients of
    its parameters (a space mesh's partial sums summed over space)."""
    from da_detect_tpu_torch.entry import prepare_model
    from da_detect_tpu_torch.models import build_detection_model
    from da_detect_tpu_torch.parallel import parallelize, reduce_mesh_grads

    model = prepare_model(build_detection_model(cfg, seed=0), CPU)
    parallelize(model, mesh)
    feats = model.backbone(images, impl="plain")
    gen = torch.Generator().manual_seed(seed)
    loss = sum((f.float() * torch.randn(f.shape, generator=gen)).sum()
               for f in feats)
    loss.backward()
    reduce_mesh_grads(model)
    return dict(feats=[f.detach() for f in feats],
                grads={n: p.grad.clone() for n, p in
                       model.backbone.named_parameters()
                       if p.grad is not None})


def layer_pass(mesh=None) -> dict:
    """A conv, a BatchNorm, a transposed conv, a GroupNorm and a linear
    layer (weights from seed 0), each split over ``mesh``'s model group
    (every leaf of at least 16 channels): the output, the input's gradient
    and every parameter's whole gradient for a fixed projection."""
    from torch import nn

    from da_detect_tpu_torch.layers import (BatchNorm, Conv2d,
                                            ConvTranspose2d, GroupNorm,
                                            Linear)
    from da_detect_tpu_torch.parallel.tensor import _full, shard_model

    torch.manual_seed(0)
    stack = nn.ModuleDict(dict(
        conv=Conv2d(8, 64, 3, padding=1), bn=BatchNorm(64),
        convt=ConvTranspose2d(64, 32, 2, stride=2), gn=GroupNorm(32, 8),
        fc=Linear(32, 16)))
    with torch.no_grad():
        for p in stack.parameters():
            p.normal_()
        stack.bn.running_var.uniform_(0.5, 2.0)
    x = torch.randn(2, 8, 6, 5, requires_grad=True)
    plan = shard_model(stack, mesh, 16) if mesh is not None else {}
    y = stack.conv(x)
    y = stack.gn(stack.convt(stack.bn(y)))
    y = stack.fc(y.mean((2, 3)))
    (y * torch.randn(y.shape)).sum().backward()
    return dict(y=y.detach(), x_grad=x.grad, plan=plan, grads={
        n: _full(p.grad, plan[n], mesh) if n in plan else p.grad
        for n, p in stack.named_parameters()})


def grad_mean(mesh, rank: int) -> dict:
    """Two linear layers under ``mesh`` (model=2; the first split, at 32
    channels), each gradient set to rank + 1 as if the ranks had summed
    in another order: the gradients ``reduce_mesh_grads`` leaves."""
    from da_detect_tpu_torch.layers import Linear
    from da_detect_tpu_torch.parallel import parallelize, reduce_mesh_grads

    torch.manual_seed(0)
    stack = torch.nn.ModuleDict(dict(wide=Linear(8, 32), head=Linear(32, 4)))
    parallelize(stack, mesh, 32)
    for p in stack.parameters():
        p.grad = torch.full_like(p, float(rank + 1))
    reduce_mesh_grads(stack)
    return dict(plan=dict(stack._tp_plan),
                grads={n: p.grad for n, p in stack.named_parameters()})


def rank_work(rank: int, world: int, init_method: str, spec: dict) -> dict:
    from da_detect_tpu_torch import parallel
    from da_detect_tpu_torch.parallel import (init_distributed, make_mesh,
                                              set_mesh)

    torch.set_num_threads(1)
    init_distributed(CPU, init_method=init_method, rank=rank,
                     world_size=world)
    out = {}

    def under(spatial, model):
        mesh = make_mesh(spatial=spatial, model=model)
        set_mesh(mesh)
        return mesh

    mesh = under(1, 1)
    out["replicated"] = parallel.replicate(
        [torch.full((3,), float(rank))], mesh)[0]
    out["layers"] = layer_pass(under(1, 2))
    out["grad_mean"] = grad_mean(under(1, 2), rank)
    for label, s, m in spec["meshes"]:
        run = _steps(spec["step"], under(s, m))
        run.pop("state")
        out[label] = run
    for label, s, m in spec["dcn_meshes"]:
        out[f"dcn_{label}"] = _eval(spec["dcn"], under(s, m))
    for label, cfg in spec["bodies"].items():
        out[f"body_{label}"] = backbone_pass(cfg, spec["body_images"][label],
                                             under(2, 1))
    out["same_pad"] = {(k, s): same_pad_pass(k, s, under(2, 1))
                       for k, s in spec["same_pad_cases"]}
    for label, s, m in spec["fbnet_meshes"]:
        out[f"fbnet_{label}"] = _eval(spec["fbnet"], under(s, m))
    for label, s, m in spec["fbnet_step_meshes"]:
        out[f"fbnet_step_{label}"] = _source_step(spec["fbnet_step"],
                                                  under(s, m))
    out["checkpoint"] = _checkpoint(spec["step"], under(1, 2),
                                    spec["ckpt_dir"])
    trap = _steps(dict(spec["step"], steps=1), under(1, 2),
                  ddp_group=dist.group.WORLD)
    out["trap"] = dict(losses=trap["losses"], first=trap["first"])
    set_mesh(None)
    out["jax_imported"] = any(m == "jax" or m.startswith("jax.")
                              for m in sys.modules)
    return out
