"""Shared helpers for the PyTorch port's tests (tests/test_torch_*.py).

Inputs and weights are drawn with numpy from a seed and handed to both the
JAX reference and the port. Weights never come from either framework's own
initializer: the two draw different numbers from one seed.
"""

from __future__ import annotations

import functools
import itertools

import jax
import numpy as np
import torch

import __graft_entry__ as graft


def tiny_cfgs():
    """(JAX cfg, port cfg) of the flagship model, narrowed for the CPU:
    canvas 64x96, 64 -> 16 proposals, stem 16, width 8, res2 32, float32."""
    from da_detect_tpu_torch.entry import flagship_cfg

    jcfg = graft._flagship_cfg(canvas=(64, 96), test_tops=(64, 16))
    pcfg = flagship_cfg(canvas=(64, 96), test_tops=(64, 16))
    for cfg in (jcfg, pcfg):
        cfg.MODEL.RESNETS.STEM_OUT_CHANNELS = 16
        cfg.MODEL.RESNETS.WIDTH_PER_GROUP = 8
        cfg.MODEL.RESNETS.RES2_OUT_CHANNELS = 32
        cfg.TPU.COMPUTE_DTYPE = "float32"
    return jcfg, pcfg


def _path_str(path) -> str:
    return "/".join(str(getattr(k, "key", k)) for k in path)


def random_variables(shapes, seed: int, scales: dict | None = None) -> dict:
    """numpy variables with the structure of ``shapes`` (a tree of
    ShapeDtypeStructs, e.g. from ``jax.eval_shape`` of an init).

    Conv and Dense kernels: normal with std 1/sqrt(fan_in); biases:
    normal(0.1); FrozenBN scales uniform(0.5, 1.5), biases normal(0.1) — so
    the folded affine is exercised, not the identity. ``scales`` maps a path
    suffix (e.g. "cls_logits/kernel") to a factor, which spreads the scores
    that proposal and detection selection sort (random-init scores otherwise
    sit within float32 noise of each other)."""
    rng = np.random.RandomState(seed)
    scales = scales or {}

    def draw(path, s):
        name = _path_str(path)
        if name.endswith("/kernel"):
            fan_in = int(np.prod(s.shape[:-1]))
            v = rng.randn(*s.shape) / np.sqrt(fan_in)
        elif name.endswith("/scale"):
            v = rng.uniform(0.5, 1.5, s.shape)
        else:
            v = 0.1 * rng.randn(*s.shape)
        for suffix, factor in scales.items():
            if name.endswith(suffix):
                v = v * factor
        return v.astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def to_numpy_tree(tree):
    return jax.tree.map(np.asarray, tree)


def nhwc_to_torch(x) -> torch.Tensor:
    """numpy NHWC -> torch logical NCHW in channels-last memory."""
    return torch.from_numpy(np.array(x)).permute(0, 3, 1, 2)


def torch_to_nhwc(x: torch.Tensor) -> np.ndarray:
    return x.detach().permute(0, 2, 3, 1).numpy()


def module_state(variables: dict, jax_prefix: str, torch_prefix: str) -> dict:
    """The port state_dict of one submodule: wrap ``variables`` of a JAX
    submodule under ``jax_prefix`` (e.g. "backbone/body"), map them with the
    port's loader and strip ``torch_prefix`` from the names."""
    from da_detect_tpu_torch.utils.weights import jax_state_dict

    wrapped = {}
    for coll, tree in variables.items():
        for part in reversed(jax_prefix.split("/")):
            tree = {part: tree}
        wrapped[coll] = tree
    state = jax_state_dict(wrapped)
    return {k[len(torch_prefix):]: v for k, v in state.items()}


# one train step's losses and gradients, without the update: the JAX
# package's (jax.value_and_grad of train_forward) and the port's, dropout off
LOSS_RTOL = 1e-4
GRAD_REL, GRAD_FLOOR = 1e-3, 1e-6


def jax_step_one(jcfg, jmodel, variables, args, aligned, with_state=False):
    """(losses, gradients as port state_dict names) of one JAX step on the
    numpy ``variables``, sampling key 3, dropout off; with ``with_state``
    also the new DAState's fields as floats."""
    from da_detect_tpu.models.da import DAState as JDAState
    from da_detect_tpu_torch.utils.weights import jax_state_dict

    da = JDAState.create(jcfg.MODEL.DA_HEADS.TRIPLET_MARGIN_IMG,
                         jcfg.MODEL.DA_HEADS.TRIPLET_MARGIN_INS)

    def loss_fn(params):
        losses, new_state = jmodel.apply(
            {"params": params, "frozen": variables["frozen"]}, args[0],
            args[1], da, *args[2:], aligned=aligned, deterministic=True,
            method=jmodel.train_forward,
            rngs={"sampling": jax.random.PRNGKey(3),
                  "dropout": jax.random.PRNGKey(4)})
        return sum(losses.values()), (losses, new_state)

    (_, (losses, new_state)), grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(variables["params"])
    out = ({k: float(x) for k, x in losses.items()},
           jax_state_dict({"params": grads}, cfg_fc6_chw(jcfg)))
    if with_state:
        out += ({f: float(getattr(new_state, f)) for f in DA_STATE_FIELDS},)
    return out


DA_STATE_FIELDS = ("margin_img", "margin_ins", "last_triplet_img",
                   "last_triplet_ins")


def cfg_fc6_chw(cfg):
    """The (C, P, P) pooled map an FPN MLP head's fc6 reads, or None."""
    if cfg.MODEL.ROI_BOX_HEAD.FEATURE_EXTRACTOR != "FPN2MLPFeatureExtractor":
        return None
    p = cfg.MODEL.ROI_BOX_HEAD.POOLER_RESOLUTION
    return cfg.MODEL.BACKBONE.OUT_CHANNELS, p, p


def port_step_one(model, state, args, aligned, impl=None, with_state=False):
    """(losses, gradients of the trainable leaves) of one port step; with
    ``with_state`` also the new DAState's fields as floats."""
    for p in model.parameters():
        p.grad = None
    losses, new_state = model.train_forward(
        args[0], args[1], state.da_state, *args[2:], aligned=aligned,
        deterministic=True, generator=state.generator, impl=impl)
    sum(losses.values()).backward()
    grads = {n: p.grad.clone() for n, p in model.named_parameters()
             if p.requires_grad}
    out = ({k: v.item() for k, v in losses.items()}, grads)
    if with_state:
        out += ({f: float(getattr(new_state, f)) for f in DA_STATE_FIELDS},)
    return out


def assert_losses_match(got: dict, want: dict) -> None:
    assert set(got) == set(want)
    for name in want:
        np.testing.assert_allclose(got[name], want[name], rtol=LOSS_RTOL,
                                   err_msg=f"{name}: {got} vs {want}")


def assert_grads_match(got: dict, want: dict) -> None:
    """Every trainable gradient within GRAD_REL of its leaf's largest |g|,
    plus GRAD_FLOOR of the model's largest for leaves that cancel to near
    zero."""
    floor = GRAD_FLOOR * max(float(g.abs().max()) for g in want.values())
    for name, g in got.items():
        w = want[name]
        err = float((g - w).abs().max())
        assert err <= GRAD_REL * float(w.abs().max()) + floor, (
            f"{name}: max |diff| {err:.3e}, max |g| "
            f"{float(w.abs().max()):.3e}")


# the FPN models' scales for random_variables: the RPN's objectness spread
# (x 30), the two box-delta layers towards the JAX package's own init, and
# the deformable convs' offset predictors drawn so that samples move about a
# pixel off the grid
FPN_SCALES = {"rpn_head/cls_logits/kernel": 30.0,
              "rpn_head/bbox_pred/kernel": 0.03,
              "predictor/bbox_pred/kernel": 0.1,
              "conv_offset/kernel": 0.1}


def _narrow_fpn_train(cfg, gather_mode):
    r = cfg.MODEL.RESNETS
    if r.NUM_GROUPS > 1:
        r.NUM_GROUPS, r.WIDTH_PER_GROUP = 4, 2
    else:
        r.WIDTH_PER_GROUP = 8
    r.STEM_OUT_CHANNELS, r.RES2_OUT_CHANNELS = 8, 16
    cfg.MODEL.BACKBONE.OUT_CHANNELS = 16
    cfg.MODEL.ROI_BOX_HEAD.MLP_HEAD_DIM = 32
    cfg.merge_from_list([
        "MODEL.RPN.PRE_NMS_TOP_N_TRAIN", 64,
        "MODEL.RPN.POST_NMS_TOP_N_TRAIN", 32,
        "MODEL.RPN.FPN_POST_NMS_TOP_N_TRAIN", 48,
        "MODEL.RPN.BATCH_SIZE_PER_IMAGE", 4096,
        "MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE", 128,
        "MODEL.ROI_HEADS.POSITIVE_FRACTION", 0.5,
        "MODEL.DA_HEADS.TRIPLET_MAX_MARGIN", 3.0,
        "MODEL.DA_HEADS.TRIPLET_MARGIN_IMG", -0.5,
        "TPU.MAX_GT_BOXES", 8,
        "TPU.IMAGE_SHAPE", (64, 96),
        "TPU.COMPUTE_DTYPE", "float32",
        "TPU.APPROX_TOPK", False,
        "TPU.DCN_GATHER", gather_mode])
    return cfg


def fpn_train_cfgs(yaml, gather_mode="four", depth50=False):
    """(JAX cfg, port cfg) of an FPN triplet-DA YAML for a training step on
    the CPU: canvas 64x96, stem 8, res2 16, FPN 16, MLP head 32, a grouped
    body at 4 groups x 2 (else width 8), float32, exact top-k; budgets 64 ->
    32 proposals a level and 48 across the batch, 8 GT boxes, RPN batch
    4096 and ROI batch 128 at positive fraction 0.5 (above every candidate
    pool, so both samplers take every candidate whatever their draws).
    ``depth50``: the body at depth 50 ("R-50-FPN" with the YAML's grouping
    and deformable stages)."""
    from da_detect_tpu.config import get_cfg as j_get_cfg
    from da_detect_tpu_torch.config import get_cfg

    cfgs = []
    for cfg in (j_get_cfg(), get_cfg()):
        cfg.merge_from_file(yaml)
        if depth50:
            cfg.MODEL.BACKBONE.CONV_BODY = "R-50-FPN"
        cfgs.append(_narrow_fpn_train(cfg, gather_mode))
    return tuple(cfgs)


def triplet_batches(jcfg, pcfg):
    """Three different images, source, positive and negative, each with its
    own targets (gradients through every triplet term), for JAX and the
    port."""
    from da_detect_tpu_torch.entry import make_batch

    jargs, pargs = [], []
    for seed, is_source in ((0, True), (1, False), (2, False)):
        jargs += graft._batch(jcfg, 1, seed=seed, is_source=is_source)
        pargs += make_batch(pcfg, 1, seed=seed, is_source=is_source)
    return jargs, pargs


def jax_train_variables(jmodel, jargs, scales=FPN_SCALES):
    """numpy variables of the JAX model's training init (DA heads
    included)."""
    from da_detect_tpu.models.da import DAState as JDAState

    shapes = jax.eval_shape(lambda: jmodel.init(
        {"params": jax.random.PRNGKey(0), "sampling": jax.random.PRNGKey(1),
         "dropout": jax.random.PRNGKey(2)}, jargs[0], jargs[1],
        JDAState.create(), *jargs[2:], method=jmodel.train_forward))
    return random_variables(shapes, seed=1, scales=scales)


# bfloat16: tolerances in ulps of bfloat16 (8 significant bits) at the
# reference's largest magnitude
def bf16_ulp(magnitude: float) -> float:
    """One bfloat16 ulp at ``magnitude``: 2 ** (floor(log2 m) - 7)."""
    m = float(magnitude)
    return 2.0 ** (np.floor(np.log2(m)) - 7) if m > 0 else 0.0


def as_f32(x) -> np.ndarray:
    """A numpy or jax array, or a torch tensor, as float32 numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(np.asarray(x).astype(np.float32))


def ulps_off(got, want) -> float:
    """The largest |got - want| in bfloat16 ulps of max |want|."""
    g, w = as_f32(got), as_f32(want)
    top = float(np.abs(w).max()) if w.size else 0.0
    if top == 0.0:
        return float(np.abs(g).max()) if g.size else 0.0
    return float(np.abs(g - w).max()) / bf16_ulp(top)


def assert_ulps(got, want, ulps: float, what: str = "") -> None:
    """|got - want| <= ``ulps`` bfloat16 ulps of max |want|, elementwise."""
    g, w = as_f32(got), as_f32(want)
    assert g.shape == w.shape, (what, g.shape, w.shape)
    off = ulps_off(g, w)
    assert off <= ulps, f"{what}: {off:.2f} bf16 ulps of max |ref| > {ulps}"


def bf16_numpy(x: np.ndarray) -> np.ndarray:
    """float32 numpy rounded to bfloat16 values (round to nearest even),
    still float32: the same bfloat16 input for both frameworks."""
    return torch.from_numpy(np.ascontiguousarray(x)).to(
        torch.bfloat16).float().numpy()


class JaxProposals:
    """Proposal selection of the JAX package handed to the port, for tests
    where a bfloat16 near-tie flips a selection: ``record`` wraps the JAX
    detector's ``select_proposals`` so that each call's proposals reach the
    host through ``jax.debug.callback`` (under jit and grad alike), indexed
    by call order; ``inject`` makes the port's detector take them, call by
    call, in place of its own, and keeps the port's own selections in
    ``own`` (to count the flips)."""

    def __init__(self):
        self.calls: dict = {}
        self.own: list = []

    def record(self, monkeypatch) -> None:
        from da_detect_tpu.models import detector as jdet

        original = jdet.select_proposals
        count = itertools.count()

        def stash(i, *arrays):
            self.calls[i] = tuple(np.asarray(a) for a in arrays)

        def recorded(*args, **kwargs):
            props = original(*args, **kwargs)
            jax.debug.callback(functools.partial(stash, next(count)),
                               props.boxes, props.scores, props.valid)
            return props

        monkeypatch.setattr(jdet, "select_proposals", recorded)

    def inject(self, monkeypatch) -> None:
        from da_detect_tpu_torch.models import detector as pdet
        from da_detect_tpu_torch.models import rpn as prpn

        count = itertools.count()

        def injected(*args, **kwargs):
            self.own.append(prpn.select_proposals(*args, **kwargs))
            boxes, scores, valid = self.calls[next(count)]
            return prpn.Proposals(torch.tensor(boxes), torch.tensor(scores),
                                  torch.tensor(valid))

        monkeypatch.setattr(pdet, "select_proposals", injected)

    def flips(self) -> tuple[int, int]:
        """(valid JAX proposals that the port's own selection lacks, valid
        JAX proposals), over every call: a box counts as kept when the
        port's own selection of that call has one within 0.25 px."""
        lacks = total = 0
        for i, own in enumerate(self.own):
            boxes, _, valid = self.calls[i]
            for b in range(boxes.shape[0]):
                mine = own.boxes[b][own.valid[b]].numpy()
                for box in boxes[b][valid[b]]:
                    total += 1
                    lacks += not bool(
                        (np.abs(mine - box).max(-1) <= 0.25).any()) \
                        if len(mine) else 1
        return lacks, total


def assert_twins(dets, jdets, box_atol=1e-3, score_atol=1e-5) -> None:
    """Each image's valid JAX detections, each with its own twin among the
    port's (same label, box within ``box_atol`` px, score within
    ``score_atol``): scores that saturate at 1.0 tie, and a float32
    rounding apart may swap two of them in the order."""
    for i in range(dets.valid.shape[0]):
        mine = dets.valid[i].numpy()
        boxes, labels = dets.boxes[i].numpy()[mine], dets.labels[i][mine]
        scores = dets.scores[i].numpy()[mine]
        free = np.ones(len(boxes), bool)
        theirs = np.asarray(jdets.valid[i])
        for box, label, score in zip(np.asarray(jdets.boxes[i])[theirs],
                                     np.asarray(jdets.labels[i])[theirs],
                                     np.asarray(jdets.scores[i])[theirs]):
            ok = free & (labels.numpy() == label) \
                & (np.abs(boxes - box).max(-1) <= box_atol) \
                & (np.abs(scores - score) <= score_atol)
            assert ok.any(), (i, box, label, score)
            free[np.argmax(ok)] = False


# the tiny on-disk triple of tests/data_factory.py for the port's loaders
TINY_NAMES = {"tiny_clean_cocostyle": "clean",
              "tiny_foggy_cocostyle": "foggy",
              "tiny_rainy_cocostyle": "rainy"}


def register_port_tiny_catalog(dirs: dict, monkeypatch) -> None:
    """Point the ``tiny_*`` names of the port's ``DatasetCatalog`` at the
    ``tests/data_factory.make_triplet_datasets`` tree ``dirs``, undone with
    ``monkeypatch``; other names resolve as before."""
    from da_detect_tpu_torch.config.catalog import DatasetCatalog

    original = DatasetCatalog.get

    def get(name):
        if name not in TINY_NAMES:
            return original(name)
        img_dir, ann = dirs[TINY_NAMES[name]]
        return {"factory": "COCODataset",
                "args": {"root": img_dir, "ann_file": ann}}

    monkeypatch.setattr(DatasetCatalog, "get", staticmethod(get))


def write_user_catalog(dirs: dict, root: str) -> None:
    """``root/catalog.json``: the ``tiny_*`` names as the port's catalog
    reads user entries under ``$DA_DETECT_DATA_DIR`` (set it to ``root``);
    ``dirs`` must lie under ``root``."""
    import json
    import os

    entries = {name: {"img_dir": os.path.relpath(dirs[key][0], root),
                      "ann_file": os.path.relpath(dirs[key][1], root)}
               for name, key in TINY_NAMES.items()}
    with open(os.path.join(root, "catalog.json"), "w") as f:
        json.dump(entries, f)


# Mask R-CNN: the YAMLs the mask tests narrow
MASK_C4_YAML = "configs/e2e_mask_rcnn_R_50_C4_1x.yaml"
MASK_GN_YAML = "configs/gn_baselines/e2e_mask_rcnn_R_50_FPN_1x_gn.yaml"


def mask_cfgs(yaml=None, dtype: str = "float32"):
    """(JAX cfg, port cfg) of a ``MASK_ON`` YAML (default the Cityscapes
    R-50-FPN one) for the CPU: ``_narrow_fpn_train``'s widths and budgets
    (canvas 64x96, 8 GT boxes, every candidate sampled) with the mask head's
    convs at 16 channels, 9 classes (the Cityscapes YAML's; COCO's 81 leave
    random-weight scores under the threshold), no DA heads, computing in
    ``dtype``. A GroupNorm
    YAML keeps 32 channels wherever a GroupNorm divides them into 32
    groups."""
    from da_detect_tpu.config import get_cfg as j_get_cfg
    from da_detect_tpu_torch.config import get_cfg
    from da_detect_tpu_torch.entry import MASK_YAML

    cfgs = []
    for cfg in (j_get_cfg(), get_cfg()):
        cfg.merge_from_file(yaml or MASK_YAML)
        _narrow_fpn_train(cfg, "four")
        width = 32 if cfg.MODEL.ROI_MASK_HEAD.USE_GN else 16
        if width == 32:
            cfg.MODEL.RESNETS.STEM_OUT_CHANNELS = 32
            cfg.MODEL.RESNETS.WIDTH_PER_GROUP = 32
            cfg.MODEL.RESNETS.RES2_OUT_CHANNELS = 32
            cfg.MODEL.BACKBONE.OUT_CHANNELS = 32
            cfg.MODEL.ROI_BOX_HEAD.CONV_HEAD_DIM = 32
        cfg.MODEL.ROI_MASK_HEAD.CONV_LAYERS = (width,) * 4
        cfg.MODEL.ROI_BOX_HEAD.NUM_CLASSES = 9
        cfg.MODEL.DOMAIN_ADAPTATION_ON = False
        cfg.TPU.COMPUTE_DTYPE = dtype
        cfgs.append(cfg)
    return tuple(cfgs)


def mask_batches(jcfg, pcfg, b: int = 2, seed: int = 0):
    """b source images with GT masks, for JAX and the port: the port's
    ``make_batch(with_masks=True)`` and the same arrays in the JAX
    package's ``Targets``."""
    import jax.numpy as jnp

    from da_detect_tpu_torch.entry import make_batch

    jb, jt = graft._batch(jcfg, b, seed=seed)
    pb, pt = make_batch(pcfg, b, seed=seed, with_masks=True)
    return (jb, jt.replace(masks=jnp.asarray(pt.masks.numpy()))), (pb, pt)


# Keypoint R-CNN: the YAMLs the keypoint tests narrow
KEYPOINT_YAMLS = ("configs/e2e_keypoint_rcnn_R_50_FPN_1x.yaml",
                  "configs/caffe2/e2e_keypoint_rcnn_R_50_FPN_1x_caffe2.yaml",
                  "configs/quick_schedules/"
                  "e2e_keypoint_rcnn_R_50_FPN_quick.yaml")


def keypoint_cfgs(dtype: str = "float32"):
    """(JAX cfg, port cfg) of the keypoint R-CNN YAML for the CPU:
    ``_narrow_fpn_train``'s widths and budgets (canvas 64x96, 8 GT boxes,
    every candidate sampled) with the keypoint head's eight convs at 16
    channels, the YAML's 2 classes and 17 keypoints, no DA heads, computing
    in ``dtype``."""
    from da_detect_tpu.config import get_cfg as j_get_cfg
    from da_detect_tpu_torch.config import get_cfg

    cfgs = []
    for cfg in (j_get_cfg(), get_cfg()):
        cfg.merge_from_file(KEYPOINT_YAMLS[0])
        _narrow_fpn_train(cfg, "four")
        cfg.MODEL.ROI_KEYPOINT_HEAD.CONV_LAYERS = (16,) * 8
        cfg.MODEL.DOMAIN_ADAPTATION_ON = False
        cfg.TPU.COMPUTE_DTYPE = dtype
        cfgs.append(cfg)
    return tuple(cfgs)


def keypoint_batches(jcfg, pcfg, b: int = 2, seed: int = 0):
    """b source images with GT keypoints, for JAX and the port: the port's
    ``make_batch(with_keypoints=True)`` (its labels folded into the 2
    classes) and the same arrays in the JAX package's ``Targets``."""
    import jax.numpy as jnp

    from da_detect_tpu_torch.entry import make_batch

    jb, jt = graft._batch(jcfg, b, seed=seed)
    pb, pt = make_batch(pcfg, b, seed=seed, with_keypoints=True)
    jt = jt.replace(labels=jnp.asarray(pt.labels.numpy(), jt.labels.dtype),
                    keypoints=jnp.asarray(pt.keypoints.numpy()))
    return (jb, jt), (pb, pt)
