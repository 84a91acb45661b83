"""Ground rules of the PyTorch port: it imports no JAX and nothing of the JAX
package, its entry points (eval and train) never carry on quietly on the CPU,
its weight loader is strict (the DA heads included), its kernel wrappers
refuse other devices, its kernel builds raise without nvcc, and its config
copy parses every YAML of the repository."""

import ast
import glob
import os

import numpy as np
import pytest
import torch

import da_detect_tpu_torch
from da_detect_tpu_torch import entry, kernels
from da_detect_tpu_torch.config import get_cfg
from da_detect_tpu_torch.ops import gather_cuda, nms_cuda, roi_align_cuda
from da_detect_tpu_torch.utils.weights import (jax_state_dict,
                                               load_jax_variables, torch_name)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_FILES = sorted(
    glob.glob(os.path.join(os.path.dirname(da_detect_tpu_torch.__file__),
                           "**", "*.py"), recursive=True)
    + [os.path.join(REPO, "chip_smoke.py")])
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "da_detect_tpu")
YAMLS = sorted(glob.glob(os.path.join(REPO, "configs", "**", "*.yaml"),
                         recursive=True))


@pytest.fixture(scope="module", autouse=True)
def _threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _imported_roots(path):
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                    "import_module", "__import__") and node.args \
                and isinstance(node.args[0], ast.Constant):
            yield str(node.args[0].value).split(".")[0]


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[os.path.relpath(p, REPO) for p in PORT_FILES])
def test_port_imports_no_jax(path):
    bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN))
    assert not bad, f"{path} imports {bad}"


def test_entry_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        entry.entry()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        entry.resolve_device("cuda")
    assert entry.resolve_device("cpu") == torch.device("cpu")


def test_train_entry_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        entry.train_entry()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        entry.train_entry(cfg=entry.dcn_train_cfg())


def test_weight_loader_raises_on_unknown_key():
    from da_detect_tpu_torch.models import build_detection_model

    cfg = entry.flagship_cfg(canvas=(64, 96), test_tops=(64, 16),
                             dtype="float32")
    model = build_detection_model(cfg)
    with pytest.raises(KeyError, match="no counterpart"):
        load_jax_variables(model, {"params": {"mystery_head": {
            "kernel": np.zeros((3, 3), np.float32)}}})
    with pytest.raises(KeyError, match="no port counterpart"):
        load_jax_variables(model, {"params": {"backbone": {"body": {
            "layer9": {"block0": {"conv1": {
                "kernel": np.zeros((1, 1, 4, 4), np.float32)}}}}}}})
    with pytest.raises(KeyError, match="collections"):
        load_jax_variables(model, {"cache": {}})
    # BatchNorm statistics (FBNet) are taken; this model has none to set
    with pytest.raises(KeyError, match="no port counterpart"):
        load_jax_variables(model, {"batch_stats": {"backbone": {"body": {
            "stem": {"bn1": {"mean": np.zeros(4, np.float32)}}}}}})
    # the DA heads are mapped now: a name under them that the port lacks
    # raises like any other
    with pytest.raises(KeyError, match="no port counterpart"):
        load_jax_variables(model, {"params": {"da_heads": {"imghead": {
            "kernel": np.zeros((1, 1, 4, 4), np.float32)}}}})
    # and every model entry must still be set
    conv1 = model.da_heads.imghead.conv1_da.weight
    with pytest.raises(RuntimeError, match="Missing key"):
        load_jax_variables(model, {"params": {"da_heads": {"imghead": {
            "conv1_da": {"kernel": np.zeros(
                (1, 1, conv1.shape[1], conv1.shape[0]), np.float32)}}}}})
    assert torch_name("feature_extractor/head/layer4/block2/downsample_bn/"
                      "scale") == ("roi_heads.box.feature_extractor.head."
                                   "layer4.2.downsample.1.weight")


def test_weight_loader_maps_da_heads():
    """JAX da_heads variables land on the port's DA heads: 1x1 HWIO convs
    as OIHW, Dense [in, out] as [out, in]. (Eval variables, which carry no
    da_heads, load into a model with DA heads in tests/test_torch_slice.py.)
    """
    from da_detect_tpu_torch.models import build_detection_model

    cfg = entry.flagship_cfg(canvas=(64, 96), test_tops=(64, 16),
                             dtype="float32")
    model = build_detection_model(cfg)
    own = model.state_dict()
    rng = np.random.RandomState(0)
    kernel = rng.randn(1, 1, 1024, 512).astype(np.float32)
    dense = rng.randn(2048, 1024).astype(np.float32)
    state = jax_state_dict({"params": {"da_heads": {
        "imghead": {"conv1_da": {"kernel": kernel}},
        "inshead": {"fc1_da": {"kernel": dense}}}}})
    np.testing.assert_array_equal(
        state["da_heads.imghead.conv1_da.weight"].numpy(),
        kernel.transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(
        state["da_heads.inshead.fc1_da.weight"].numpy(), dense.T)
    assert set(k for k in own if k.startswith("da_heads.")) == {
        f"da_heads.{head}.{layer}.{kind}"
        for head, layers in (("imghead", ("conv1_da", "conv2_da")),
                             ("inshead", ("fc1_da", "fc2_da", "fc3_da")))
        for layer in layers for kind in ("weight", "bias")}


def test_unsupported_configs_raise():
    """The default config (COMPUTE_DTYPE bfloat16, as in the JAX package)
    builds a bfloat16 model with float32 parameters; another compute dtype
    raises. GroupNorm bodies, the mask head, the keypoint head (every
    keypoint YAML), RetinaNet, the VGG-16 body and the C5 bodies build, and
    an unknown CONV_BODY raises KeyError; RetinaNet with the DA heads raises
    ValueError, as in the JAX package."""
    from da_detect_tpu_torch.layers import Conv2d, Linear
    from da_detect_tpu_torch.models import build_detection_model

    cfg = get_cfg()
    assert cfg.TPU.COMPUTE_DTYPE == "bfloat16"
    model = build_detection_model(cfg)
    layers = [m for m in model.modules() if isinstance(m, (Conv2d, Linear))]
    assert layers and all(m.compute_dtype == torch.bfloat16 for m in layers)
    assert all(p.dtype == torch.float32 for p in model.parameters())
    assert all(b.dtype == torch.float32 for b in model.buffers())
    cfg.TPU.COMPUTE_DTYPE = "float16"
    with pytest.raises(NotImplementedError, match="bfloat16 or float32"):
        build_detection_model(cfg)
    for yaml in sorted(glob.glob(os.path.join(REPO, "configs", "**",
                                              "*keypoint*.yaml"),
                                 recursive=True)):
        cfg = get_cfg()
        cfg.merge_from_file(yaml)
        cfg.merge_from_list(["MODEL.RESNETS.WIDTH_PER_GROUP", 8,
                             "MODEL.ROI_KEYPOINT_HEAD.CONV_LAYERS",
                             (16,) * 8])
        head = build_detection_model(cfg).keypoint_head
        assert head.predictor.kps_score_lowres.out_channels == 17, yaml
    from da_detect_tpu_torch.models.retinanet import RetinaNet

    cfg = entry.flagship_cfg(dtype="float32")
    cfg.merge_from_list(["MODEL.BACKBONE.CONV_BODY", "R-50-FPN-RETINANET",
                         "MODEL.RETINANET_ON", True])
    with pytest.raises(ValueError, match="mutually exclusive"):
        build_detection_model(cfg)
    cfg.MODEL.DOMAIN_ADAPTATION_ON = False
    assert isinstance(build_detection_model(cfg), RetinaNet)
    from da_detect_tpu_torch.layers import GroupNorm

    cfg = entry.flagship_cfg(dtype="float32")
    cfg.merge_from_list(["MODEL.BACKBONE.USE_GN", True])
    assert any(isinstance(m, GroupNorm)
               for m in build_detection_model(cfg).modules())
    cfg = entry.flagship_cfg(dtype="float32")
    cfg.merge_from_list(["MODEL.MASK_ON", True])
    assert build_detection_model(cfg).mask_head is not None
    from da_detect_tpu_torch.models.backbone.vgg import VGG16

    cfg = entry.vgg_cfg()
    cfg.merge_from_list(["MODEL.ROI_BOX_HEAD.MLP_HEAD_DIM", 16])
    vgg = build_detection_model(cfg)
    assert isinstance(vgg.backbone, VGG16)
    assert vgg.backbone.conv5_3.compute_dtype == torch.bfloat16
    for body in ("R-50-C5", "R-101-C5", "R-152-C5"):
        cfg = entry.flagship_cfg(dtype="float32")
        cfg.merge_from_list(["MODEL.BACKBONE.CONV_BODY", body,
                             "MODEL.RESNETS.WIDTH_PER_GROUP", 4,
                             "MODEL.ROI_BOX_HEAD.FEATURE_EXTRACTOR",
                             "FPN2MLPFeatureExtractor",
                             "MODEL.ROI_BOX_HEAD.POOLER_SCALES", (1 / 32,),
                             "MODEL.ROI_BOX_HEAD.MLP_HEAD_DIM", 16])
        body_net = build_detection_model(cfg).backbone.body
        assert body_net.stage_names == ["layer1", "layer2", "layer3",
                                        "layer4"]
        assert not body_net.return_all
    cfg = entry.flagship_cfg(dtype="float32")
    cfg.MODEL.BACKBONE.CONV_BODY = "R-34-C4"
    with pytest.raises(KeyError, match="unknown CONV_BODY"):
        build_detection_model(cfg)


# the modules of the slice that ported the VGG-16 body, the derain path and
# the remaining single-card modules: each scanned by test_port_imports_no_jax
NEW_MODULES = ("utils/registry.py", "models/backbone/vgg.py", "ops/ssim.py",
               "models/derain.py", "tools/train_derain.py",
               "layers/deform_pool.py", "models/attention.py",
               "models/da_fpn.py", "structures/boxes.py")


@pytest.mark.parametrize("module", NEW_MODULES)
def test_new_modules_are_scanned(module):
    path = os.path.join(os.path.dirname(da_detect_tpu_torch.__file__),
                        module)
    assert path in PORT_FILES
    assert not set(_imported_roots(path)) & set(FORBIDDEN)


@pytest.mark.parametrize("names", [None, ["roi_align_bwd"]])
def test_kernel_build_raises_without_nvcc(monkeypatch, tmp_path, names):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(kernels, "BUILD_DIR", str(tmp_path / "build"))
    assert {"nms", "roi_align_fwd", "roi_align_bwd", "row_gather",
            "row_gather_bulk", "row_scatter_add"} == set(kernels.SOURCES)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        kernels.build(names)


def test_wrappers_refuse_other_devices():
    meta = dict(device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        nms_cuda.nms_mask_sorted(torch.empty(1, 8, 4, **meta),
                                 torch.empty(1, 8, dtype=torch.bool, **meta),
                                 0.5)
    with pytest.raises(ValueError, match="unsupported device"):
        roi_align_cuda.roi_align(torch.empty(1, 4, 5, 5, **meta),
                                 torch.empty(1, 3, 4, **meta),
                                 spatial_scale=1.0, output_size=2)
    with pytest.raises(ValueError, match="unsupported device"):
        roi_align_cuda.roi_align_backward(
            torch.empty(1, 3, 4, 2, 2, **meta), torch.empty(1, 3, 4, **meta),
            height=5, width=5, spatial_scale=1.0, output_size=2)
    for gather in (gather_cuda.row_gather, gather_cuda.row_gather_bulk):
        with pytest.raises(ValueError, match="unsupported device"):
            gather(torch.empty(6, 8, **meta),
                   torch.empty(4, dtype=torch.int32, **meta))
    with pytest.raises(ValueError, match="unsupported device"):
        gather_cuda.row_scatter_add(torch.empty(4, 8, **meta),
                                    torch.empty(4, dtype=torch.int32, **meta),
                                    6)


@pytest.mark.parametrize("path", YAMLS,
                         ids=[os.path.relpath(p, REPO) for p in YAMLS])
def test_config_copy_parses_yaml(path):
    cfg = get_cfg()
    cfg.merge_from_file(path)
    cfg.freeze()
