"""The port's from-scratch learning gate (``tools/sanity_check.py``) against
the JAX package's: its synthetic datasets, its configuration, one triplet
step of its GroupNorm model, and the tool's plumbing.

- ``build_synthetic``: with the default noise texture the images (read back
  with cv2), annotations and ``catalog.json`` equal JAX's exactly, in the
  ablation mode (inverted target) and the default one; with
  ``texture="natural"`` the pixels are within one level (the port's uint8
  resize against cv2's, ``tests/test_torch_data.py``) and the rest equal.
- ``sanity_cfg``: key for key (``MODEL.DEVICE`` is each package's default).
- One triplet step (aligned, the sanity model's DA settings) of the GN
  model, narrowed for the CPU (stem 32, width 32, res2 64; the ablation's
  pool 7; 64 -> 16 proposals), float32, against ``jax.value_and_grad`` of
  JAX's: losses rtol 1e-4, every gradient leaf within 3% of its norm (L2;
  the step's own sensitivity to float32 rounding, see the test), the
  heads the sensitivity reaches less within 0.1% or 1%. The
  random draws are taken out of play as in ``tests/test_torch_train.py``:
  the RPN and ROI sampling budgets exceed every candidate pool (1200
  anchors, 16 + 10 proposals), so both samplers keep every candidate, and
  the DA dropout is off.
- ``train_and_eval`` and ``main`` for 2-3 iterations on the CPU (narrowed).
- The JAX package's own gate, ``test_da_ablation_direction``, as a
  ``slow`` twin (200 iterations a arm at full width: minutes on the CPU),
  and, also ``slow``, 40 float32 steps of the gate's DA arm at full width
  against JAX's from the same initial weights and batches.
"""

import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from da_detect_tpu.models import build_detection_model as j_build
from da_detect_tpu.models.da import DAState as JDAState
from da_detect_tpu.tools import sanity_check as jsanity
from da_detect_tpu_torch import entry
from da_detect_tpu_torch.config import get_cfg
from da_detect_tpu_torch.engine.trainer import create_train_state
from da_detect_tpu_torch.layers import GroupNorm
from da_detect_tpu_torch.models import build_detection_model
from da_detect_tpu_torch.tools import sanity_check as psanity
from da_detect_tpu_torch.utils.weights import load_jax_variables
from tests.torch_harness import (assert_losses_match, jax_step_one,
                                 port_step_one, random_variables)

GN_STEP_REL = 3e-2
# leaves the step's ill-conditioning reaches less (module prefix -> relative
# L2 bound): the RPN head, the image-level DA head, the res5 box head and
# its predictor
GN_STEP_REL_BY_MODULE = {"rpn.head.": 1e-3, "da_heads.imghead.": 1e-3,
                         "roi_heads.box.": 1e-2}
SCORE_SCALES = {"rpn_head/cls_logits/kernel": 30.0,
                "predictor/cls_score/kernel": 30.0}


@pytest.fixture(scope="module", autouse=True)
def _threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _tree(root):
    import cv2

    out = {}
    for dom in ("clean", "foggy", "rainy"):
        d = os.path.join(root, dom)
        for name in sorted(os.listdir(d)):
            out[(dom, name)] = cv2.imread(os.path.join(d, name))
    with open(os.path.join(root, "instances.json")) as f:
        ann = json.load(f)
    with open(os.path.join(root, "catalog.json")) as f:
        cat = json.load(f)
    return out, ann, cat


MODES = {"ablation": dict(fog=(0.8, 10.0), invert=True),
         "default": dict(fog=(0.55, 110.0), invert=False)}


@pytest.mark.parametrize("mode", sorted(MODES))
def test_build_synthetic_equals_jax(tmp_path, mode):
    jsanity.build_synthetic(str(tmp_path / "jax"), 5, seed=3, **MODES[mode])
    psanity.build_synthetic(str(tmp_path / "port"), 5, seed=3,
                            **MODES[mode])
    want, want_ann, want_cat = _tree(str(tmp_path / "jax"))
    got, got_ann, got_cat = _tree(str(tmp_path / "port"))
    assert got_ann == want_ann and got_cat == want_cat
    assert sorted(got) == sorted(want) and len(got) == 15
    for key, img in want.items():
        assert np.array_equal(got[key], img), key


def test_build_synthetic_natural_texture_within_one_level(tmp_path):
    kw = dict(fog=(0.8, 10.0), invert=True, hw=(96, 128),
              texture="natural")
    jsanity.build_synthetic(str(tmp_path / "jax"), 3, seed=5, **kw)
    psanity.build_synthetic(str(tmp_path / "port"), 3, seed=5, **kw)
    want, want_ann, want_cat = _tree(str(tmp_path / "jax"))
    got, got_ann, got_cat = _tree(str(tmp_path / "port"))
    assert got_ann == want_ann and got_cat == want_cat
    for key, img in want.items():
        diff = np.abs(got[key].astype(int) - img.astype(int))
        assert diff.max() <= 1, key
    assert any(not np.array_equal(got[k], want[k]) for k in want)


def _flat(node, prefix=""):
    out = {}
    for k, v in node.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


@pytest.mark.parametrize("da", [False, True], ids=["source_only", "da"])
def test_sanity_cfg_equals_jax_key_for_key(da):
    from da_detect_tpu.config import get_cfg as j_get_cfg

    want = _flat(jsanity.sanity_cfg(da, 200))
    got = _flat(psanity.sanity_cfg(da, 200))
    assert set(got) == set(want)
    differ = {k for k in want if got[k] != want[k]}
    assert differ == {"MODEL.DEVICE"}
    assert want["MODEL.DEVICE"] == j_get_cfg().MODEL.DEVICE
    assert got["MODEL.DEVICE"] == get_cfg().MODEL.DEVICE


def _narrow(cfg):
    """The sanity model narrowed for the CPU, in float32, with the
    ablation arms' pool and sampling budgets above every candidate pool."""
    r = cfg.MODEL.RESNETS
    r.STEM_OUT_CHANNELS, r.WIDTH_PER_GROUP, r.RES2_OUT_CHANNELS = 32, 32, 64
    cfg.TPU.COMPUTE_DTYPE = "float32"
    cfg.MODEL.ROI_BOX_HEAD.POOLER_RESOLUTION = 7
    cfg.MODEL.DA_HEADS.TRIPLET_MAX_MARGIN = 3.0
    return cfg


def _step_cfgs():
    cfgs = []
    for mod in (jsanity, psanity):
        cfg = _narrow(mod.sanity_cfg(True, 200))
        cfg.MODEL.RPN.PRE_NMS_TOP_N_TRAIN = 64
        cfg.MODEL.RPN.POST_NMS_TOP_N_TRAIN = 16
        cfg.MODEL.RPN.BATCH_SIZE_PER_IMAGE = 2048
        cfg.MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE = 256
        cfg.MODEL.ROI_HEADS.POSITIVE_FRACTION = 0.5
        cfgs.append(cfg)
    return cfgs


def _two_classes(labels):
    """The synthetic batches' labels 1..8 folded onto the sanity model's
    two classes."""
    return (labels - 1) % 2 + 1


def test_sanity_gn_triplet_step_matches_jax():
    """One aligned triplet step of the sanity GN model: losses and every
    gradient against JAX's, from the same numpy weights (GN scales and
    biases drawn, not the identity) and batches.

    The step's gradients are ill-conditioned: scaling the port's own input
    images by 1 + 1e-7, 1e-6 or 1e-5 moves its gradient leaves by up to
    about 1% (L2; the same 0.4-0.7% whatever the size of the change, so a
    discrete switch, not a smooth amplification: the image triplet's
    distances over near-zero ReLU rows, the x30 logits' classifier), while
    the losses move by 1e-6 and the RPN losses' gradients by 2e-5. Float32
    rounding in another order (PyTorch's GroupNorm sums by Welford's method,
    Flax's as E[x²] - E[x]²) takes the two frameworks 1.6% apart at most.
    Each body and instance-head leaf is held, in L2, within ``GN_STEP_REL``
    (3%) of its norm; the RPN head and the image-level DA head within 0.1%,
    the res5 box head and predictor within 1% (``GN_STEP_REL_BY_MODULE``:
    the switch reaches them less); the losses to rtol 1e-4. A wrong group,
    statistic or weight moves leaves by O(1). Score scales at 1 and a margin
    that keeps every triplet row off its hinge do not make the body's
    leaves better conditioned: their gaps stay as wide."""
    jcfg, pcfg = _step_cfgs()
    jmodel = j_build(jcfg)
    jargs = []
    for seed, src in ((0, True), (1, False), (2, False)):
        b, t = graft._batch(jcfg, 1, seed=seed, is_source=src)
        jargs += [b, t.replace(labels=_two_classes(t.labels))]
    key = jax.random.PRNGKey(0)
    shapes = jax.eval_shape(lambda: jmodel.init(
        {"params": key, "sampling": key, "dropout": key}, jargs[0],
        jargs[1], JDAState.create(), *jargs[2:], aligned=True,
        method=jmodel.train_forward))
    v = random_variables(shapes, seed=1, scales=SCORE_SCALES)
    want_losses, want_grads = jax_step_one(jcfg, jmodel, v, jargs, True)

    model = build_detection_model(pcfg)
    load_jax_variables(model, v)
    model = entry.prepare_model(model, torch.device("cpu"))
    state = create_train_state(pcfg, model, 0, "cosine")
    pargs = []
    for seed, src in ((0, True), (1, False), (2, False)):
        b, t = entry.make_batch(pcfg, 1, seed=seed, is_source=src)
        pargs += [b, dataclasses.replace(t, labels=_two_classes(t.labels))]
    got_losses, got_grads = port_step_one(model, state, pargs, True)
    # the sanity model: GN body (43 norms), FrozenBN res5 head
    assert sum(isinstance(m, GroupNorm) for m in model.modules()) == 43
    assert "triplet_loss_image" in want_losses
    assert_losses_match(got_losses, want_losses)
    assert set(got_grads) == set(want_grads)
    for name, want in want_grads.items():
        rel = next((v for k, v in GN_STEP_REL_BY_MODULE.items()
                    if name.startswith(k)), GN_STEP_REL)
        err = float((got_grads[name] - want).norm())
        assert err <= rel * float(want.norm()), (
            name, err, float(want.norm()))


def test_train_and_eval_plumbing(tmp_path):
    """Both arms for 3 iterations on the CPU through the loaders,
    ``do_train`` and ``inference``: an AP50 in [0, 1], a run record, the
    DA state's margin, and no kernel launched (CPU tensors)."""
    import logging

    root = psanity.build_synthetic(str(tmp_path), 4, seed=3,
                                   fog=(0.8, 10.0), invert=True)
    os.environ["DA_DETECT_DATA_DIR"] = root
    try:
        for da in (False, True):
            cfg = _narrow(psanity.sanity_cfg(da, 3))
            cfg.MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE = 16
            ap50, state, run = psanity.train_and_eval(
                cfg, da, 3, logging.getLogger("test"),
                test_dataset="sanity_foggy_cocostyle", device="cpu")
            assert 0.0 <= ap50 <= 1.0
            assert state.step == 3 and run["iters"] == 3
            assert run["eval_images"] == 4 and run["steps_per_s"] > 0
            assert run["train_launches"] == {} == run["eval_launches"]
            assert np.isfinite(float(state.da_state.margin_img))
    finally:
        del os.environ["DA_DETECT_DATA_DIR"]


def test_main_ablation_verdict(tmp_path, monkeypatch, capsys):
    """``main(["--ablation", ...])``: the JAX package's verdict line, the
    returned record with both arms, and SystemExit(1) below the gap."""
    sanity_cfg = psanity.sanity_cfg
    monkeypatch.setattr(psanity, "sanity_cfg",
                        lambda da, iters: _narrow(sanity_cfg(da, iters)))
    monkeypatch.setenv("DA_DETECT_DATA_DIR", str(tmp_path))
    argv = ["--ablation", "--iters", "2", "--images", "4", "--device", "cpu",
            "--data-dir", str(tmp_path / "abl")]
    out = psanity.main(argv + ["--min-gap", "-1"])
    verdict = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert verdict["sanity_check"] == "PASS" and verdict["mode"] == "ablation"
    assert set(verdict) == {"sanity_check", "mode", "gap", "min_gap", "da",
                            "source_only", "margin_img"}
    assert {k: out[k] for k in verdict} == verdict
    assert set(out["arms"]) == {"source_only", "da"}
    with pytest.raises(SystemExit):
        psanity.main(argv + ["--min-gap", "2.0"])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1])[
        "sanity_check"] == "FAIL"


@pytest.mark.slow
def test_sanity_f32_trajectory_tracks_jax(tmp_path, monkeypatch):
    """40 triplet-DA steps of the ablation's DA arm at full width in
    float32, from the JAX model's own initial weights, on the same loader
    batches, the sampling budgets above every pool and the DA dropout off
    (``deterministic``): the first two steps' total losses within 1e-4,
    then within the step's chaos (each step within 15%, the last ten
    steps' mean within 5%). Minutes on the CPU."""
    import jax.numpy as jnp

    from da_detect_tpu.data import make_data_loader_da as j_loader
    from da_detect_tpu.engine.trainer import TrainState as JTrainState
    from da_detect_tpu.engine.trainer import make_train_step as j_step
    from da_detect_tpu.solver.optim import make_optimizer as j_optimizer
    from da_detect_tpu_torch.data import make_data_loader_da as p_loader
    from da_detect_tpu_torch.engine.trainer import make_train_step

    steps = 40
    root = psanity.build_synthetic(str(tmp_path), 16, seed=3,
                                   fog=(0.8, 10.0), invert=True)
    monkeypatch.setenv("DA_DETECT_DATA_DIR", root)
    cfgs = []
    for mod in (jsanity, psanity):
        cfg = mod.sanity_cfg(True, 200)
        cfg.MODEL.DA_HEADS.TRIPLET_MAX_MARGIN = 3.0
        cfg.MODEL.ROI_BOX_HEAD.POOLER_RESOLUTION = 7
        cfg.MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE = 256
        cfg.MODEL.ROI_HEADS.POSITIVE_FRACTION = 0.5
        cfg.MODEL.RPN.BATCH_SIZE_PER_IMAGE = 2048
        cfg.TPU.COMPUTE_DTYPE = "float32"
        cfgs.append(cfg)
    jcfg, pcfg = cfgs
    it = iter(j_loader(jcfg, aligned=True, seed=0))
    jbatches = [next(it) for _ in range(steps)]
    loader = p_loader(pcfg, device="cpu", aligned=True, seed=0)
    pbatches = [next(loader) for _ in range(steps)]
    loader.close()
    jmodel = j_build(jcfg)
    key = jax.random.PRNGKey(0)
    v = jax.tree.map(np.asarray, dict(jmodel.init(
        {"params": key, "sampling": key, "dropout": key}, jbatches[0][0],
        jbatches[0][1], JDAState.create(), *jbatches[0][2:], aligned=True,
        method=jmodel.train_forward)))
    tx, _ = j_optimizer(jcfg, v["params"], "cosine")
    da = jcfg.MODEL.DA_HEADS
    jstate = JTrainState(
        step=jnp.zeros([], jnp.int32), params=v["params"],
        frozen=v.get("frozen", {}), opt_state=tx.init(v["params"]),
        da_state=JDAState.create(da.TRIPLET_MARGIN_IMG,
                                 da.TRIPLET_MARGIN_INS), rng=key)
    jstep = j_step(jmodel, tx, aligned=True, donate=False,
                   deterministic=True)
    model = build_detection_model(pcfg)
    load_jax_variables(model, v)
    model = entry.prepare_model(model, torch.device("cpu"))
    state = create_train_state(pcfg, model, 0, "cosine")
    pstep = make_train_step(model, state.optimizer, aligned=True,
                            deterministic=True)
    want, got = [], []
    for jb, pb in zip(jbatches, pbatches):
        jstate, jm = jstep(jstate, *jb)
        state, pm = pstep(state, *pb)
        want.append(float(jm["loss_total"]))
        got.append(float(pm["loss_total"]))
    want, got = np.array(want), np.array(got)
    np.testing.assert_allclose(got[:2], want[:2], rtol=1e-4)
    np.testing.assert_allclose(got, want, rtol=0.15)
    np.testing.assert_allclose(got[-10:].mean(), want[-10:].mean(),
                               rtol=0.05)
    assert want[-10:].mean() < 0.5 * want[0]   # both learn


@pytest.mark.slow
def test_da_ablation_direction(tmp_path):
    """The JAX package's DA-direction gate on the port, unchanged: at 200
    iterations a arm, triplet-DA beats source-only on the channel-inverted
    target by 0.2 AP50 (``tests/test_end_to_end.py``'s twin; on the CPU)."""
    psanity.main(["--ablation", "--iters", "200", "--min-gap", "0.2",
                  "--data-dir", str(tmp_path / "abl"), "--device", "cpu"])
