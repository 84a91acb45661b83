"""Serving export of the port (``engine/serving.py``,
``tools/export_serving.py``) on the CPU: the artifacts round-trip the
eager forward bit for bit in both formats, and the port's artifact agrees
with the JAX package's own ``load_serving`` of a ``stablehlo`` artifact on
the same weights.

Config: the flagship model at canvas 64x96 with 64 -> 16 proposals,
narrowed to stem 16 / width 8 / res2 32, float32 (``tiny_cfgs``), and the
narrowed Cityscapes mask and keypoint YAMLs (``mask_cfgs``,
``keypoint_cfgs``). The RPN and predictor score layers are scaled up in the
numpy variables, so that scores sort apart by far more than float32 noise.

Tolerances: against the eager forward, exact (the exported program runs
the same CPU operators; the kernels' operators run their plain versions);
against JAX's artifact, labels and validity exact, scores rtol 1e-5 and
atol 1e-5 (the JAX package's own serving test), boxes atol 1e-3 pixels,
as the eval parity tests (``test_torch_slice.py``) hold the two packages'
eager forwards: the two frameworks' convolutions round apart by ~1e-6
relative, which box decoding scales to ~1e-4 pixels.
"""

import glob
import json
import os
import subprocess
import sys
import zipfile
from collections import Counter

import jax
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import __graft_entry__ as graft
from da_detect_tpu.engine.serving import export_serving as j_export
from da_detect_tpu.engine.serving import load_serving as j_load
from da_detect_tpu.models import build_detection_model as j_build
from da_detect_tpu_torch.engine.serving import (META_FILE, batch_spec,
                                                export_serving, load_serving,
                                                read_meta)
from da_detect_tpu_torch.entry import make_batch, prepare_model
from da_detect_tpu_torch.layers import DeformConv2d
from da_detect_tpu_torch.models import build_detection_model
from da_detect_tpu_torch.structures import Detections, ImageBatch
from da_detect_tpu_torch.tools import export_serving as export_cli
from da_detect_tpu_torch.utils.weights import load_jax_variables
from tests.torch_harness import (keypoint_cfgs, mask_cfgs, random_variables,
                                 tiny_cfgs)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCORE_SCALES = {"rpn_head/cls_logits/kernel": 30.0,
                "predictor/cls_score/kernel": 30.0}
CPU = torch.device("cpu")
# the flagship eval forward's kernel launches a request on the card
FLAGSHIP_OPS = {"da_detect.nms_keep.default": 2,
                "da_detect.roi_align.default": 1}


@pytest.fixture(scope="module", autouse=True)
def _threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jax_and_port(jcfg, pcfg, seed=1, scales=SCORE_SCALES):
    """(JAX model, numpy variables, JAX batch, port model, port batch) on
    the same weights and batch of one image."""
    jmodel = j_build(jcfg)
    jbatch, _ = graft._batch(jcfg, 1, seed=0)
    shapes = jax.eval_shape(
        lambda: jmodel.init({"params": jax.random.PRNGKey(0)}, jbatch))
    variables = random_variables(shapes, seed=seed, scales=scales)
    model = build_detection_model(pcfg)
    load_jax_variables(model, variables)
    model = prepare_model(model, CPU)
    batch, _ = make_batch(pcfg, 1, seed=0)
    return jmodel, variables, jbatch, model, batch


@pytest.fixture(scope="module")
def flagship(tmp_path_factory):
    """The tiny flagship on JAX's weights, its eager output, and an artifact
    of each format."""
    jcfg, pcfg = tiny_cfgs()
    jmodel, jvars, jbatch, model, batch = _jax_and_port(jcfg, pcfg)
    ref = model(batch)
    assert int(ref.valid.sum()) >= 8
    variables = model.state_dict()
    root = tmp_path_factory.mktemp("serving")
    paths, metas = {}, {}
    for fmt in ("aot", "stablehlo"):
        paths[fmt] = str(root / f"serving_{fmt}.pt2")
        metas[fmt] = export_serving(pcfg, model, variables, paths[fmt],
                                    fmt=fmt)
    return dict(jcfg=jcfg, pcfg=pcfg, jmodel=jmodel, jvars=jvars,
                jbatch=jbatch, model=model, batch=batch, ref=ref,
                variables=variables, paths=paths, metas=metas, root=root)


def _assert_same(got, want):
    assert type(got) is type(want)
    got_t = list(got[0]) + [got[1]] if isinstance(want, tuple) \
        and not isinstance(want, Detections) else list(got)
    want_t = list(want[0]) + [want[1]] if isinstance(want, tuple) \
        and not isinstance(want, Detections) else list(want)
    assert len(got_t) == len(want_t)
    for a, b in zip(got_t, want_t):
        assert a.dtype == b.dtype and a.shape == b.shape
        torch.testing.assert_close(a, b, rtol=0, atol=0)


# -- the JAX package's serving tests, mirrored ------------------------------
@pytest.mark.parametrize("fmt", ["aot", "stablehlo"])
def test_serving_roundtrip_matches_eager(flagship, fmt):
    meta = flagship["metas"][fmt]
    assert meta["canvas"] == [64, 96] and meta["format"] == fmt
    assert meta["platform"] == "cpu" and meta["outputs"] == "detections"
    assert os.path.getsize(flagship["paths"][fmt]) > 1000
    serving = load_serving(flagship["paths"][fmt])
    out = serving(flagship["variables"], flagship["batch"])
    assert isinstance(out, Detections)
    _assert_same(out, flagship["ref"])


def _rewrite_meta(src: str, dst: str, **changes) -> None:
    """Copy artifact ``src`` to ``dst`` with its metadata changed."""
    with zipfile.ZipFile(src) as zin, zipfile.ZipFile(dst, "w") as zout:
        for item in zin.infolist():
            data = zin.read(item.filename)
            if item.filename.endswith(f"extra/{META_FILE}"):
                data = json.dumps({**json.loads(data), **changes}).encode()
            zout.writestr(item, data)


def test_aot_device_guard(flagship):
    path = str(flagship["root"] / "serving_guard.pt2")
    _rewrite_meta(flagship["paths"]["aot"], path, device_kind="GPU v99")
    assert read_meta(path)["device_kind"] == "GPU v99"
    with pytest.raises(RuntimeError, match="GPU v99"):
        load_serving(path)
    # the caller may take the risk; a stablehlo artifact records no guard
    out = load_serving(path, allow_device_mismatch=True)(
        flagship["variables"], flagship["batch"])
    _assert_same(out, flagship["ref"])
    shlo = str(flagship["root"] / "serving_guard_shlo.pt2")
    _rewrite_meta(flagship["paths"]["stablehlo"], shlo,
                  device_kind="GPU v99")
    load_serving(shlo)


def test_export_after_prior_forwards_and_exports(flagship):
    """Exporting twice, between eager forwards, changes neither the eager
    forward (the trace leaves nothing in the model's caches) nor the
    artifact's output."""
    model, batch = flagship["model"], flagship["batch"]
    for _ in range(2):
        model(batch)
    path = str(flagship["root"] / "serving_again.pt2")
    for fmt in ("stablehlo", "aot"):
        export_serving(flagship["pcfg"], model, flagship["variables"], path,
                       fmt=fmt)
        _assert_same(model(batch), flagship["ref"])
    out = load_serving(path)(flagship["variables"], batch)
    _assert_same(out, flagship["ref"])


def test_serving_rejects_structure_mismatch(flagship):
    serving = load_serving(flagship["paths"]["stablehlo"])
    variables, batch = flagship["variables"], flagship["batch"]
    first = next(iter(variables))
    renamed = {("oops." + k if k == first else k): v
               for k, v in variables.items()}
    with pytest.raises(ValueError, match="structure"):
        serving(renamed, batch)
    reshaped = dict(variables, **{first: variables[first][:1]})
    with pytest.raises(ValueError, match="structure"):
        serving(reshaped, batch)
    recast = dict(variables, **{first: variables[first].double()})
    with pytest.raises(ValueError, match="structure"):
        serving(recast, batch)
    with pytest.raises(ValueError, match="structure"):
        serving(variables, ImageBatch(batch.images[:, :, :32], batch.sizes,
                                      batch.orig_sizes, batch.is_source))


def test_export_rejects_masks_plus_keypoints(flagship):
    with pytest.raises(ValueError, match="mutually exclusive"):
        export_serving(flagship["pcfg"], flagship["model"],
                       flagship["variables"],
                       str(flagship["root"] / "x.pt2"), with_masks=True,
                       with_keypoints=True)


def test_serving_is_weight_agnostic(flagship):
    """One artifact serves any checkpoint of the architecture: bumped
    weights change the result, which equals the eager forward's with the
    bumped weights; the artifact holds no parameter."""
    model, batch = flagship["model"], flagship["batch"]
    serving = load_serving(flagship["paths"]["aot"])
    bumped = {k: v + 0.05 if v.dtype == torch.float32 else v
              for k, v in flagship["variables"].items()}
    out = serving(bumped, batch)
    assert not all(torch.equal(a, b) for a, b in zip(out, flagship["ref"]))
    want = torch.func.functional_call(model, bumped, (batch,))
    _assert_same(out, want)
    ep = torch.export.load(flagship["paths"]["aot"])
    assert not ep.state_dict
    assert sum(c.numel() for c in ep.constants.values()) < 10_000


def test_uint8_export_matches_float_path(flagship):
    """A uint8 export (raw pixels, normalized inside the program) gives the
    eager forward's detections on the equivalent normalized canvas."""
    model, pcfg = flagship["model"], flagship["pcfg"]
    spec = batch_spec(pcfg, 1, torch.uint8)
    assert spec.images.dtype == torch.uint8 and spec.images.is_contiguous(
        memory_format=torch.channels_last)
    raw = np.random.RandomState(1).randint(
        0, 256, (1, 64, 96, 3)).astype(np.uint8)
    sizes = torch.tensor([[64, 96]], dtype=torch.int32)
    u8 = ImageBatch(torch.from_numpy(raw).permute(0, 3, 1, 2), sizes, sizes,
                    torch.ones(1, dtype=torch.bool))
    mean = np.asarray(pcfg.INPUT.PIXEL_MEAN, np.float32)
    f32 = ImageBatch(
        torch.from_numpy(raw.astype(np.float32) - mean).permute(0, 3, 1, 2),
        sizes, sizes, u8.is_source)
    ref = model(f32)
    path = str(flagship["root"] / "serving_u8.pt2")
    meta = export_serving(pcfg, model, flagship["variables"], path,
                          fmt="stablehlo", image_dtype=torch.uint8)
    assert meta["image_dtype"] == "uint8"
    _assert_same(load_serving(path)(flagship["variables"], u8), ref)


# -- the port's own --------------------------------------------------------
def test_artifact_matches_jax_serving(flagship, tmp_path):
    """The port's artifact against the JAX package's ``load_serving`` of its
    own ``stablehlo`` artifact, on the same weights and image."""
    path = str(tmp_path / "jax_serving.pkl")
    j_export(flagship["jcfg"], flagship["jmodel"], flagship["jvars"], path,
             fmt="stablehlo")
    want = jax.device_get(j_load(path)(flagship["jvars"], flagship["jbatch"]))
    got = load_serving(flagship["paths"]["aot"])(flagship["variables"],
                                                 flagship["batch"])
    valid = np.asarray(want.valid)
    assert valid.sum() >= 8
    np.testing.assert_array_equal(got.valid.numpy(), valid)
    np.testing.assert_array_equal(got.labels.numpy(), np.asarray(want.labels))
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.boxes.numpy(), np.asarray(want.boxes),
                               rtol=0, atol=1e-3)


class _OpCounter(TorchDispatchMode):
    """Counts the kernels' operators called under it (eager)."""

    def __init__(self):
        super().__init__()
        self.counts = Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if str(func).startswith("da_detect."):
            self.counts[str(func)] += 1
        return func(*args, **(kwargs or {}))


def _graph_ops(ep) -> Counter:
    return Counter(str(n.target) for n in ep.graph.nodes
                   if n.op == "call_function"
                   and str(n.target).startswith("da_detect."))


def test_export_op_census(flagship):
    """One operator node a kernel launch: the graph's nodes equal the eager
    forward's operator calls with the kernels' route (``impl="cuda"``),
    which are its launches on the card."""
    with _OpCounter() as counter:
        flagship["model"](flagship["batch"], impl="cuda")
    assert counter.counts == FLAGSHIP_OPS
    for path in flagship["paths"].values():
        assert _graph_ops(torch.export.load(path)) == FLAGSHIP_OPS


@pytest.mark.parametrize("gather_mode,op", [("four", "row_gather"),
                                            ("quad", "row_gather_bulk")])
def test_export_op_census_deform_conv(gather_mode, op):
    """A deformable conv layer (9 taps, narrowed) exports a gather node a
    tap, as its eager forward calls the gather operator."""
    torch.manual_seed(0)
    layer = DeformConv2d(8, 8, 3, gather_mode=gather_mode).eval()
    with torch.no_grad():
        layer.conv_offset.weight.normal_(0, 0.1)
    x = torch.randn(1, 8, 6, 7).contiguous(memory_format=torch.channels_last)

    class Layer(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.layer = layer

        def forward(self, x):
            return self.layer(x, impl="cuda")

    with torch.no_grad():
        with _OpCounter() as counter:
            want = layer(x, impl="cuda")
        ep = torch.export.export(Layer(), (x,), strict=False)
    assert counter.counts == {f"da_detect.{op}.default": 9}
    assert _graph_ops(ep) == counter.counts
    torch.testing.assert_close(ep.module()(x), want, rtol=0, atol=0)
    torch.testing.assert_close(layer(x, impl="plain"), want, rtol=0, atol=0)


@pytest.mark.parametrize("head", ["masks", "keypoints"])
def test_head_artifacts_match_eager(head, tmp_path):
    _, pcfg = mask_cfgs() if head == "masks" else keypoint_cfgs()
    model = prepare_model(build_detection_model(pcfg, seed=0), CPU)
    with torch.no_grad():
        model.rpn["head"].cls_logits.weight.mul_(30.0)
        model.roi_heads["box"]["predictor"].cls_score.weight.mul_(30.0)
    batch, _ = make_batch(pcfg, 1, seed=0)
    kw = {f"with_{head}": True}
    ref = model(batch, **kw)
    assert int(ref[0].valid.sum()) >= 1
    path = str(tmp_path / f"serving_{head}.pt2")
    meta = export_serving(pcfg, model, model.state_dict(), path, **kw)
    assert meta["outputs"] == head
    out = load_serving(path)(model.state_dict(), batch)
    _assert_same(out, ref)
    ops = _graph_ops(torch.export.load(path))
    # FPN: RPN NMS a level and the box NMS; the box and the head's poolers
    assert ops["da_detect.roi_align_levels.default"] == 2
    assert ops["da_detect.nms_keep.default"] == 6


_FRESH = """
import sys, torch
from da_detect_tpu_torch.engine.serving import load_serving
torch.set_num_threads(1)  # the exporting process's CPU arithmetic
state = torch.load(sys.argv[2], weights_only=False)
out = load_serving(sys.argv[1])(state["variables"], state["batch"])
assert all(torch.equal(a, b) for a, b in zip(out, state["ref"]))
bad = [m for m in sys.modules if m.startswith("da_detect_tpu_torch.models")
       or m.split(".")[0] in ("jax", "da_detect_tpu")]
assert not bad, bad
print("fresh ok")
"""


def test_artifact_loads_without_model_code(flagship, tmp_path):
    state = str(tmp_path / "state.pt")
    torch.save(dict(variables=flagship["variables"], batch=flagship["batch"],
                    ref=tuple(flagship["ref"])), state)
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run(
        [sys.executable, "-c", _FRESH, flagship["paths"]["stablehlo"], state],
        capture_output=True, text=True, env=env, cwd=str(tmp_path),
        timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "fresh ok" in proc.stdout


def test_export_cli(tmp_path):
    """``tools/export_serving.py`` on the CPU: a narrowed flagship YAML with
    a weight file, whose artifact answers as the eager model with those
    weights."""
    yaml = os.path.join(
        REPO, "configs", "da_faster_rcnn",
        "e2e_triplet_da_faster_rcnn_R_50_C4_cityscapes_to_foggy_"
        "cityscapes.yaml")
    opts = ["MODEL.RESNETS.STEM_OUT_CHANNELS", "16",
            "MODEL.RESNETS.WIDTH_PER_GROUP", "8",
            "MODEL.RESNETS.RES2_OUT_CHANNELS", "32",
            "MODEL.RPN.PRE_NMS_TOP_N_TEST", "64",
            "MODEL.RPN.POST_NMS_TOP_N_TEST", "16",
            "TPU.IMAGE_SHAPE", "(64, 96)", "TPU.COMPUTE_DTYPE", "float32",
            "MODEL.OUTPUT_DIR", str(tmp_path / "out")]
    from da_detect_tpu_torch.config import get_cfg
    cfg = get_cfg()
    cfg.merge_from_file(yaml)
    cfg.merge_from_list(opts)
    model = prepare_model(build_detection_model(cfg, seed=7), CPU)
    weights = str(tmp_path / "weights.pth")
    torch.save({"model": model.state_dict()}, weights)
    out = str(tmp_path / "cli.pt2")
    meta = export_cli.main(["--config-file", yaml, "--device", "cpu",
                            "--output", out, "--format", "stablehlo",
                            "--ckpt", weights, "--image-dtype", "uint8",
                            *opts])
    assert meta["format"] == "stablehlo" and meta["image_dtype"] == "uint8"
    raw = torch.from_numpy(np.random.RandomState(2).randint(
        0, 256, (1, 64, 96, 3)).astype(np.uint8)).permute(0, 3, 1, 2)
    sizes = torch.tensor([[64, 96]], dtype=torch.int32)
    batch = ImageBatch(raw, sizes, sizes, torch.ones(1, dtype=torch.bool))
    _assert_same(load_serving(out)(model.state_dict(), batch), model(batch))


ALL_YAMLS = sorted(glob.glob(os.path.join(REPO, "configs", "**", "*.yaml"),
                             recursive=True))


@pytest.mark.slow
@pytest.mark.parametrize("yaml", ALL_YAMLS,
                         ids=[os.path.relpath(p, REPO) for p in ALL_YAMLS])
def test_every_yaml_exports(yaml, tmp_path):
    """Every YAML of the repository exports (narrowed: canvas 64x96, the
    ResNet and FPN widths an eighth, the heads' 32 channels, 64 -> 16
    proposals), and its artifact answers as the eager forward, bit for
    bit."""
    from da_detect_tpu_torch.config import get_cfg

    cfg = get_cfg()
    cfg.merge_from_file(yaml)
    r = cfg.MODEL.RESNETS
    r.NUM_GROUPS, r.WIDTH_PER_GROUP = (4, 8) if r.NUM_GROUPS > 1 else (1, 32)
    r.STEM_OUT_CHANNELS = r.RES2_OUT_CHANNELS = 32
    # an eighth, as res2: FPN's 256 -> 32, a C4 head's res4 1024 -> 128
    cfg.MODEL.BACKBONE.OUT_CHANNELS //= 8
    box = cfg.MODEL.ROI_BOX_HEAD
    box.MLP_HEAD_DIM = box.CONV_HEAD_DIM = 32
    cfg.MODEL.ROI_MASK_HEAD.CONV_LAYERS = (32,) * 4
    cfg.MODEL.ROI_KEYPOINT_HEAD.CONV_LAYERS = (32,) * 8
    cfg.MODEL.RPN.PRE_NMS_TOP_N_TEST = 64
    cfg.MODEL.RPN.POST_NMS_TOP_N_TEST = cfg.MODEL.RPN.FPN_POST_NMS_TOP_N_TEST \
        = 16
    cfg.MODEL.ROI_HEADS.DETECTIONS_PER_IMG = 10
    cfg.TPU.IMAGE_SHAPE = (64, 96)
    cfg.TPU.COMPUTE_DTYPE = "float32"
    model = prepare_model(build_detection_model(cfg, seed=0), CPU)
    batch, _ = make_batch(cfg, 1, seed=0)
    path = str(tmp_path / "serving.pt2")
    export_serving(cfg, model, model.state_dict(), path, fmt="stablehlo")
    _assert_same(load_serving(path)(model.state_dict(), batch), model(batch))
