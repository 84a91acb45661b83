"""The port's VGG-16 DA-Faster R-CNN against the JAX package's, on the same
numpy weights and inputs: the body's forward, the eval forward of
``entry.vgg_cfg`` narrowed, and one aligned triplet-DA step's losses and
every gradient. (The C5 bodies and the body table:
``tests/test_torch_aux.py``.)

Config: ``entry.vgg_cfg`` (the flagship triplet-DA YAML on ``CONV_BODY
"VGG-16"`` with ``FPN2MLPFeatureExtractor`` over the one stride-16 map at
P 7 and the ``FPNPredictor``) at canvas 64x96 (a 4x6 map), VGG's own widths
kept, ``MLP_HEAD_DIM`` 32, float32, exact top-k, 8 GT boxes; training
budgets 64 -> 32 proposals, RPN batch 4096 and ROI batch 128 at positive
fraction 0.5 (above the 360 anchors and 40 proposals, so both samplers take
every candidate whatever their draws); eval 64 -> 16 proposals. The aligned
step turns on ``ALIGNMENT`` with instance triplet weight 1.0 (the aligned
trainer's setting, as ``chip_smoke.py`` runs it), ``deterministic=True``
(no DA dropout: torch cannot replay JAX's draws). The JAX step is compiled
once for the file (a module fixture).

ReLU near-ties: a VGG conv output within float32 rounding of 0 can take
the other side of its ReLU in the two frameworks (their convolutions sum in
other orders), and a gate that flips moves the gradients of every layer
below it by a whole pixel's term (the chip run's ``relu_flips``). The step
test therefore captures JAX's VGG conv outputs (Flax
``capture_intermediates``, in the step's own compile) and hands the port
JAX's value at each position whose gate differs, as
``torch_harness.JaxProposals`` hands it JAX's proposals at near-ties: the
value moves by less than 1e-5 of its layer's
largest |x| (asserted), the gradient passes through unchanged. The flips
are counted and bounded; every other output is held to JAX's within 1e-5
of its layer's largest |x| on the way.

Tolerances: bodies rtol 1e-5 and atol 1e-5 of the output's largest
magnitude (float32 sums in another order); detections as many valid an
image, each JAX detection with a twin among the port's (same label, box
within 1e-3 px, score within 1e-5, ``assert_twins``); the step's losses
rtol 1e-4 and every gradient within 1e-3 of its leaf's largest |g| plus
1e-6 of the model's largest (``torch_harness.assert_grads_match``).
"""

import jax
import numpy as np
import pytest
import torch

from da_detect_tpu.config import get_cfg as j_get_cfg
from da_detect_tpu.models import build_detection_model as j_build
from da_detect_tpu.solver.optim import param_labels
from da_detect_tpu_torch import entry, kernels
from da_detect_tpu_torch.engine.trainer import create_train_state
from da_detect_tpu_torch.models import build_detection_model
from da_detect_tpu_torch.models.backbone.vgg import VGG16
from da_detect_tpu_torch.utils.weights import (jax_state_dict,
                                               load_jax_variables, torch_name)
from tests.torch_harness import (FPN_SCALES, assert_grads_match,
                                 assert_losses_match, assert_twins,
                                 cfg_fc6_chw, jax_train_variables,
                                 module_state, nhwc_to_torch, port_step_one,
                                 random_variables, torch_to_nhwc,
                                 triplet_batches)

CPU = torch.device("cpu")
LOSSES = {"loss_objectness", "loss_rpn_box_reg", "loss_classifier",
          "loss_box_reg", "loss_da_image", "loss_da_instance",
          "triplet_loss_image", "triplet_loss_instance"}
# the box head's class scores spread too for the eval forward (random-init
# scores otherwise sit under the detection threshold)
EVAL_SCALES = {**FPN_SCALES, "predictor/cls_score/kernel": 30.0}


@pytest.fixture(scope="module", autouse=True)
def _threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _close(got: torch.Tensor, want, what: str = "") -> None:
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(torch_to_nhwc(got), want, rtol=1e-5,
                               atol=1e-5 * float(np.abs(want).max()),
                               err_msg=what)


def vgg_cfgs(aligned: bool = False):
    """(JAX cfg, port cfg) of ``entry.vgg_cfg`` narrowed for the CPU (the
    module docstring); the JAX one merges the same YAML and overrides."""
    pcfg = entry.vgg_cfg("float32")
    jcfg = j_get_cfg()
    jcfg.merge_from_file(entry.FLAGSHIP_YAML)
    opts = [
        "MODEL.BACKBONE.CONV_BODY", "VGG-16",
        "MODEL.ROI_BOX_HEAD.FEATURE_EXTRACTOR", "FPN2MLPFeatureExtractor",
        "MODEL.ROI_BOX_HEAD.POOLER_SCALES", (0.0625,),
        "MODEL.ROI_BOX_HEAD.POOLER_RESOLUTION", 7,
        "MODEL.ROI_BOX_HEAD.PREDICTOR", "FPNPredictor",
        "MODEL.ROI_BOX_HEAD.MLP_HEAD_DIM", 32,
        "MODEL.RPN.PRE_NMS_TOP_N_TRAIN", 64,
        "MODEL.RPN.POST_NMS_TOP_N_TRAIN", 32,
        "MODEL.RPN.PRE_NMS_TOP_N_TEST", 64,
        "MODEL.RPN.POST_NMS_TOP_N_TEST", 16,
        "MODEL.RPN.BATCH_SIZE_PER_IMAGE", 4096,
        "MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE", 128,
        "MODEL.ROI_HEADS.POSITIVE_FRACTION", 0.5,
        "MODEL.DA_HEADS.ALIGNMENT", aligned,
        "MODEL.DA_HEADS.DA_TRIPLET_INS_WEIGHT", 1.0 if aligned else 0.0,
        "TPU.MAX_GT_BOXES", 8,
        "TPU.IMAGE_SHAPE", (64, 96),
        "TPU.COMPUTE_DTYPE", "float32",
        "TPU.APPROX_TOPK", False]
    for cfg in (jcfg, pcfg):
        cfg.merge_from_list(opts)
    return jcfg, pcfg


def _port_model(pcfg, variables):
    model = build_detection_model(pcfg)
    load_jax_variables(model, variables)
    model = entry.prepare_model(model, CPU)
    return model, create_train_state(pcfg, model, 0, "cosine")


@pytest.fixture(scope="module")
def aligned_reference():
    """The aligned configs, numpy variables (params only: VGG has no
    FrozenBN), the three batches and JAX's aligned step on them."""
    jcfg, pcfg = vgg_cfgs(aligned=True)
    jmodel = j_build(jcfg)
    jargs, pargs = triplet_batches(jcfg, pcfg)
    variables = jax_train_variables(jmodel, jargs, EVAL_SCALES)
    assert set(variables) == {"params"}
    want = jax_aligned_step(jcfg, jmodel, variables, jargs)
    return jcfg, pcfg, jmodel, variables, jargs, pargs, want


VGG_CONVS = [f"conv{b + 1}_{c + 1}"
             for b, n in enumerate((2, 2, 3, 3, 3)) for c in range(n)]
# the most ReLU gates the step may find flipped between the frameworks
MAX_FLIPS = 16


def jax_aligned_step(jcfg, jmodel, variables, jargs):
    """JAX's aligned step in one compile, as
    ``torch_harness.jax_step_one`` takes it (sampling key 3, dropout off):
    (losses, gradients as port state_dict names, each VGG conv's outputs
    before its ReLU in call order: source, positive, negative passes,
    NHWC numpy)."""
    from da_detect_tpu.models.backbone.vgg import VGG16 as JVGG16
    from da_detect_tpu.models.da import DAState as JDAState

    da = JDAState.create(jcfg.MODEL.DA_HEADS.TRIPLET_MARGIN_IMG,
                         jcfg.MODEL.DA_HEADS.TRIPLET_MARGIN_INS)

    def loss_fn(params):
        (losses, _), state = jmodel.apply(
            {"params": params}, jargs[0], jargs[1], da, *jargs[2:],
            aligned=True, deterministic=True, method=jmodel.train_forward,
            rngs={"sampling": jax.random.PRNGKey(3),
                  "dropout": jax.random.PRNGKey(4)},
            capture_intermediates=lambda m, name: (
                name == "__call__" and isinstance(m.parent, JVGG16)),
            mutable=["intermediates"])
        return sum(losses.values()), (losses, state["intermediates"])

    (_, (losses, inter)), grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(variables["params"])
    outputs = {n: [np.asarray(x) for x in inter["backbone"][n]["__call__"]]
               for n in VGG_CONVS}
    return ({k: float(x) for k, x in losses.items()},
            jax_state_dict({"params": grads}, cfg_fc6_chw(jcfg)), outputs)


class JaxReluGates:
    """Forward hooks on the port's VGG convs: each output is checked
    against JAX's (within 1e-5 of the layer's largest |x|), and where its
    ReLU gate differs from JAX's the output takes JAX's value, its gradient
    kept (the module docstring). ``flips``: (conv, call, positions, largest
    |port - JAX| there)."""

    def __init__(self, outputs: dict):
        self.outputs = outputs
        self.calls = dict.fromkeys(outputs, 0)
        self.flips = []

    def attach(self, vgg) -> list:
        return [getattr(vgg, n).register_forward_hook(self._hook(n))
                for n in self.outputs]

    def _hook(self, name):
        def hook(_module, _inputs, out):
            i = self.calls[name]
            self.calls[name] += 1
            want = nhwc_to_torch(self.outputs[name][i])
            top = float(want.abs().max())
            diff = (out.detach() - want).abs()
            assert float(diff.max()) <= 1e-5 * top, (name, i, diff.max(), top)
            flip = (out.detach() > 0) != (want > 0)
            if flip.any():
                self.flips.append((name, i, int(flip.sum()),
                                   float(diff[flip].max())))
            return out + ((want - out) * flip).detach()
        return hook


# ---------------------------------------------------------------- bodies

def test_vgg_cfg_overrides():
    """``entry.vgg_cfg``: the flagship YAML's DA settings at its 608x1216
    canvas with the six overrides; its body is the VGG-16 of the DA heads'
    VGG branch (instance features of MLP_HEAD_DIM, no avgpool)."""
    cfg = entry.vgg_cfg()
    assert cfg.TPU.COMPUTE_DTYPE == "bfloat16"
    assert tuple(cfg.TPU.IMAGE_SHAPE) == (608, 1216)
    assert cfg.MODEL.BACKBONE.CONV_BODY == "VGG-16"
    box = cfg.MODEL.ROI_BOX_HEAD
    assert (box.FEATURE_EXTRACTOR, tuple(box.POOLER_SCALES),
            box.POOLER_RESOLUTION, box.PREDICTOR, box.MLP_HEAD_DIM) == (
        "FPN2MLPFeatureExtractor", (0.0625,), 7, "FPNPredictor", 1024)
    da = cfg.MODEL.DA_HEADS
    assert cfg.MODEL.DOMAIN_ADAPTATION_ON and da.TRIPLET_USE and da.DA_ADV_GRL
    assert box.NUM_CLASSES == 9
    _, pcfg = vgg_cfgs()
    model = build_detection_model(pcfg)
    assert isinstance(model.backbone, VGG16)
    assert model.da_heads.inshead.fc1_da.in_features == 32
    assert not model.da_heads.avgpool_ins


def test_vgg_body_matches_jax():
    """conv1_1..conv5_3 with four 2x2 pools on a 40x56 input (not a
    multiple of 16: each pool floors), one stride-16 map of 512."""
    from da_detect_tpu.models.backbone.vgg import VGG16 as JVGG16

    x = np.random.RandomState(5).randn(2, 40, 56, 3).astype(np.float32)
    jmod = JVGG16()
    variables = random_variables(jax.eval_shape(
        lambda: jmod.init(jax.random.PRNGKey(0), x)), seed=2)
    (want,) = jax.jit(jmod.apply)(variables, x)
    pmod = VGG16()
    pmod.load_state_dict(module_state(variables, "backbone", "backbone."))
    (got,) = pmod(nhwc_to_torch(x))
    assert tuple(got.shape) == (2, 512, 2, 3)
    _close(got, want)


# ---------------------------------------------------------------- model

def test_vgg_eval_forward_matches_jax(aligned_reference):
    """The eval forward of the narrowed VGG model on the source batch: as
    many valid detections an image, each JAX detection with a twin; and
    impl="cuda" on CPU tensors (the wrappers' plain branches) launches
    nothing and gives the same detections."""
    jcfg, pcfg, jmodel, variables, jargs, pargs, _ = aligned_reference
    jdets = jax.jit(lambda v, b: jmodel.apply(v, b))(variables, jargs[0])
    valid = np.asarray(jdets.valid)
    assert valid.sum() >= 4
    model, _ = _port_model(pcfg, variables)
    with torch.no_grad():
        dets = model(pargs[0], impl="plain")
        before = dict(kernels.LAUNCHES)
        via_wrappers = model(pargs[0])
    assert dict(kernels.LAUNCHES) == before
    np.testing.assert_array_equal(dets.valid.sum(1).numpy(), valid.sum(1))
    assert_twins(dets, jdets)
    for a, b in zip(via_wrappers, dets):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_vgg_aligned_step_matches_jax(aligned_reference):
    """One aligned triplet-DA step (source, positive and negative passes,
    the instance triplet on re-pooled members): losses and every trainable
    gradient against JAX's, the DA heads' VGG branch included, with the
    VGG ReLU gates that float32 rounding flips set to JAX's side
    (``JaxReluGates``). The port's
    frozen set equals JAX's ``param_labels`` under FREEZE_CONV_BODY_AT 2:
    empty, since those labels freeze ``backbone/body/...`` paths that a
    VGG body does not have; every VGG conv trains."""
    jcfg, pcfg, _, variables, _, pargs, (want_losses, want_grads,
                                         outputs) = aligned_reference
    model, state = _port_model(pcfg, variables)
    gates = JaxReluGates(outputs)
    handles = gates.attach(model.backbone)
    try:
        losses, grads = port_step_one(model, state, pargs, aligned=True)
    finally:
        for h in handles:
            h.remove()
    assert set(gates.calls.values()) == {3}
    assert sum(f[2] for f in gates.flips) <= MAX_FLIPS, gates.flips
    assert set(want_losses) == LOSSES
    assert want_losses["triplet_loss_instance"] > 0
    assert_losses_match(losses, want_losses)
    labels = param_labels(variables["params"],
                          jcfg.MODEL.BACKBONE.FREEZE_CONV_BODY_AT)
    assert jcfg.MODEL.BACKBONE.FREEZE_CONV_BODY_AT == 2
    jax_frozen = {
        torch_name("/".join(str(k.key) for k in path))
        for path, label in jax.tree_util.tree_flatten_with_path(labels)[0]
        if label == "frozen"}
    port_frozen = {n for n, p in model.named_parameters()
                   if not p.requires_grad}
    assert port_frozen == jax_frozen == set()
    assert set(grads) == set(want_grads)
    assert sum(n.startswith("backbone.conv") for n in grads) == 26
    assert_grads_match(grads, want_grads)
