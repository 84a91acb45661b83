"""The port's CLIs (``da_detect_tpu_torch/tools``) on the CPU, as
``tests/test_cli_tools.py`` drives the JAX package's: argparse, config
merge, the loader, training, checkpoints, resume, evaluation and the
expected-results gate, on the tiny on-disk triple of
``tests/data_factory.py`` named through a user catalog JSON, with the
flagship model narrowed (stem 16, width 8, res2 32) in float32.

The weight-file loader: a Detectron C2 pickle fabricated as in
``tests/test_weight_loading.py``, and a maskrcnn-benchmark state_dict with
FrozenBN running statistics, load into the port to exactly the values that
``load_jax_variables`` gives from the JAX package's ``load_weight_file`` of
the same file.
"""

import os
import pickle
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import tests.data_factory as factory
from da_detect_tpu.config import get_cfg as j_get_cfg
from da_detect_tpu.models import build_detection_model as j_build
from da_detect_tpu.utils.checkpoint import Checkpointer as JCheckpointer
from da_detect_tpu_torch.config import get_cfg
from da_detect_tpu_torch.models import build_detection_model
from da_detect_tpu_torch.tools import test_net, train_net, train_net_triplet
from da_detect_tpu_torch.utils.checkpoint import load_weight_file
from da_detect_tpu_torch.utils.weights import load_jax_variables
from tests.test_weight_loading import make_c2_blobs
from tests.torch_harness import random_variables, write_user_catalog


@pytest.fixture(scope="module", autouse=True)
def _threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """The tiny triple, its names in a user catalog JSON under
    $DA_DETECT_DATA_DIR."""
    root = str(tmp_path_factory.mktemp("tiny_cli"))
    dirs = factory.make_triplet_datasets(root)
    write_user_catalog(dirs, root)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("DA_DETECT_DATA_DIR", root)
        yield dirs


def _opts(out_dir):
    return [
        "MODEL.OUTPUT_DIR", str(out_dir),
        "MODEL.OUTPUT_SAVE_NAME", "run",
        "MODEL.ROI_BOX_HEAD.NUM_CLASSES", "3",
        "MODEL.RESNETS.STEM_OUT_CHANNELS", "16",
        "MODEL.RESNETS.WIDTH_PER_GROUP", "8",
        "MODEL.RESNETS.RES2_OUT_CHANNELS", "32",
        "MODEL.RPN.PRE_NMS_TOP_N_TRAIN", "200",
        "MODEL.RPN.POST_NMS_TOP_N_TRAIN", "64",
        "MODEL.RPN.PRE_NMS_TOP_N_TEST", "200",
        "MODEL.RPN.POST_NMS_TOP_N_TEST", "64",
        "MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE", "32",
        "TPU.COMPUTE_DTYPE", "float32",
        "TPU.IMAGE_SHAPE", "(128, 160)",
        "TPU.MAX_GT_BOXES", "10",
        "INPUT.MIN_SIZE_TRAIN", "(120,)",
        "INPUT.MAX_SIZE_TRAIN", "160",
        "INPUT.MIN_SIZE_TEST", "120",
        "INPUT.MAX_SIZE_TEST", "160",
        "DATALOADER.STAGE_DIR", str(out_dir / "stage"),
        "DATASETS.SOURCE_TRAIN", "('tiny_clean_cocostyle',)",
        "DATASETS.TARGET_TRAIN", "('tiny_foggy_cocostyle',)",
        "DATASETS.TARGET_TRAIN_negative", "('tiny_rainy_cocostyle',)",
        "DATASETS.TRAIN", "('tiny_clean_cocostyle',)",
        "DATASETS.TEST", "('tiny_foggy_cocostyle',)",
        "SOLVER.IMS_PER_BATCH", "2",
        "SOLVER.MAX_ITER", "2",
        "SOLVER.CHECKPOINT_PERIOD", "2",
        "TEST.IMS_PER_BATCH", "2",
        "TEST.DETECTIONS_PER_IMG", "10",
    ]


CPU = ["--device", "cpu"]
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_train_net_triplet_then_test_net(tiny, tmp_path):
    out = tmp_path / "out"
    state, meters = train_net_triplet.main(
        ["--skip-test"] + CPU + _opts(out)
        + ["MODEL.DOMAIN_ADAPTATION_ON", "True"])
    run_dir = out / "run"
    assert state.step == 2 and (run_dir / "last_checkpoint").exists()
    assert np.isfinite(meters.meters["loss_total"].global_avg)
    assert "triplet_loss_image" in meters.meters  # the negative domain ran
    results = test_net.main(["--ckpt", str(run_dir)] + CPU + _opts(out))
    assert (run_dir / "coco_results.json").exists()
    ap = results["tiny_foggy_cocostyle"]["bbox"]["AP"]
    assert 0.0 <= ap <= 1.0


def test_train_net_source_only(tiny, tmp_path):
    out = tmp_path / "out_src"
    state, meters = train_net.main(["--skip-test"] + CPU + _opts(out)
                                   + ["MODEL.DOMAIN_ADAPTATION_ON", "False"])
    assert state.step == 2 and (out / "run" / "last_checkpoint").exists()
    assert "loss_da_image" not in meters.meters


MASK_YAML = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "configs",
    "cityscapes", "e2e_mask_rcnn_R_50_FPN_1x_cocostyle.yaml")


def test_train_net_mask_then_test_net_segm(tiny, tmp_path):
    """The Cityscapes Mask R-CNN YAML (narrowed: FPN 16, MLP head 32, mask
    convs 16; random weights, no ImageNet file): ``train_net`` source-only
    for 2 steps on the tiny tree's
    polygons (its loader carries the GT masks, ``loss_mask`` is logged),
    then ``test_net`` reports bbox and segm in the COCO protocol and in the
    Cityscapes one."""
    out = tmp_path / "out_mask"
    narrow = ["MODEL.WEIGHT", "", "MODEL.BACKBONE.OUT_CHANNELS", "16",
              "MODEL.ROI_BOX_HEAD.MLP_HEAD_DIM", "32",
              "MODEL.ROI_MASK_HEAD.CONV_LAYERS", "(16, 16, 16, 16)",
              "MODEL.RPN.FPN_POST_NMS_TOP_N_TRAIN", "64",
              "MODEL.RPN.FPN_POST_NMS_TOP_N_TEST", "64"]
    opts = ["--config-file", MASK_YAML] + CPU + _opts(out) + narrow
    state, meters = train_net.main(["--skip-test"] + opts)
    assert state.step == 2 and state.model.mask_head is not None
    assert np.isfinite(meters.meters["loss_mask"].global_avg)
    assert meters.meters["loss_mask"].global_avg > 0
    run_dir = out / "run"
    for style in ("coco", "cityscapes"):
        results = test_net.main(["--ckpt", str(run_dir)] + opts
                                + ["TEST.EVAL_STYLE", style])
        res = results["tiny_foggy_cocostyle"]
        assert set(res) == {"bbox", "segm"}, style
        assert (run_dir / f"{style}_results.json").exists()


@pytest.mark.parametrize("yaml,narrow", [
    ("e2e_mask_rcnn_fbnet_xirb16d_dsmask.yaml",
     ["MODEL.FBNET.SCALE_FACTOR", "0.25"]),
    ("retinanet/retinanet_R-50-FPN_1x.yaml",
     ["MODEL.RETINANET.NUM_CLASSES", "3", "MODEL.BACKBONE.OUT_CHANNELS",
      "16", "MODEL.RETINANET.PRE_NMS_TOP_N", "100"])],
    ids=["fbnet_mask", "retinanet"])
def test_train_net_then_test_net_fbnet_retinanet(tiny, tmp_path, yaml,
                                                 narrow):
    """The FBNet Mask R-CNN and RetinaNet YAMLs (narrowed; random weights,
    no ImageNet file): ``train_net`` source-only for 2 steps, then
    ``test_net`` reports bbox AP (and segm for the mask model)."""
    out = tmp_path / "out_yaml"
    opts = (["--config-file", os.path.join(REPO, "configs", yaml)] + CPU
            + _opts(out) + ["MODEL.WEIGHT", "", "TPU.APPROX_TOPK", "False"]
            + narrow)
    state, meters = train_net.main(["--skip-test"] + opts)
    assert state.step == 2
    assert np.isfinite(meters.meters["loss_total"].global_avg)
    retina = "retinanet" in yaml
    assert ("loss_retina_cls" in meters.meters) == retina
    results = test_net.main(["--ckpt", str(out / "run")] + opts)
    res = results["tiny_foggy_cocostyle"]
    assert set(res) == ({"bbox"} if retina else {"bbox", "segm"})
    assert 0.0 <= res["bbox"]["AP"] <= 1.0


def test_resume_continues_at_the_saved_step(tiny, tmp_path):
    out = tmp_path / "out_resume"
    opts = CPU + _opts(out) + ["MODEL.DOMAIN_ADAPTATION_ON", "True"]
    first, _ = train_net_triplet.main(["--skip-test"] + opts)
    saved = {k: v.clone() for k, v in first.model.state_dict().items()}
    assert first.step == 2
    # a model with other weights, then the checkpoint restores them
    state, meters = train_net_triplet.main(
        ["--skip-test", "--seed", "7"] + opts + ["SOLVER.MAX_ITER", "3"])
    assert state.step == 3
    assert meters.meters["time"].count == 1  # one iteration, the third
    log = (out / "run" / "log_rank0.txt").read_text()
    assert "start training at iteration 2" in log
    files = sorted(p.name for p in (out / "run").iterdir())
    assert "model_0000002.pth" in files and "model_0000003.pth" in files
    ckpt = torch.load(out / "run" / "model_0000002.pth", weights_only=True)
    for k, v in saved.items():
        assert torch.equal(ckpt["model"][k], v), k


@pytest.mark.parametrize("test_period,evals", [(1, 3), (0, 2)])
def test_in_training_eval(tiny, tmp_path, test_period, evals):
    """Without --skip-test: an evaluation every SOLVER.TEST_PERIOD
    iterations, or at each checkpoint when it is 0, and one at the end."""
    out = tmp_path / "out_eval"
    train_net.main(CPU + _opts(out) + ["SOLVER.TEST_PERIOD", str(test_period)])
    log = (out / "run" / "log_rank0.txt").read_text()
    assert log.count("evaluating on tiny_foggy_cocostyle") == evals
    assert (out / "run" / "coco_results.json").exists()


def test_expected_results_gate(tiny, tmp_path):
    """The gate passes a window holding the AP and aborts outside one."""
    out = tmp_path / "out_gate"
    opts = CPU + _opts(out)
    train_net.main(["--skip-test"] + opts)
    run = ["--ckpt", str(out / "run")] + opts
    test_net.main(run + ["TEST.EXPECTED_RESULTS",
                         "(('bbox', 'AP', 0.5, 0.2),)"])
    with pytest.raises(AssertionError, match="bbox > AP50"):
        test_net.main(run + ["TEST.EXPECTED_RESULTS",
                             "(('bbox', 'AP50', 5.0, 0.1),)"])


def test_cli_without_device_needs_the_card(tiny, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_net_triplet.main(["--skip-test"] + _opts(tmp_path / "x"))


# ------------------------------------------------------------ weight files

def _jax_flagship_variables():
    """(JAX variables as numpy, its cfg): the default R-50-C4 at full
    width, random values."""
    cfg = j_get_cfg()
    cfg.TPU.COMPUTE_DTYPE = "float32"
    model = j_build(cfg)
    from tests.test_model_build import make_batch
    batch, _ = make_batch(1, h=64, w=64)
    shapes = jax.eval_shape(
        lambda: model.init({"params": jax.random.PRNGKey(0)}, batch))
    return random_variables(shapes, seed=0)


def _assert_loads_like_jax(path, applied, model):
    """The port model after ``load_weight_file`` against a port model that
    got the JAX package's ``load_weight_file`` result."""
    out = JCheckpointer.load_weight_file(str(path),
                                         _jax_flagship_variables())
    ref = build_detection_model(get_cfg())
    load_jax_variables(ref, out)
    want = ref.state_dict()
    got = model.state_dict()
    for name in applied:
        assert torch.equal(got[name], want[name]), name


def test_c2_pickle_loads_like_jax(tmp_path, monkeypatch):
    blobs = make_c2_blobs(np.random.RandomState(0))
    blobs["pred_w"] = np.zeros((1000, 2048), np.float32)  # the classifier
    path = tmp_path / "R-50.pkl"
    with open(path, "wb") as f:
        pickle.dump({"blobs": blobs}, f)
    monkeypatch.setenv("DA_DETECT_WEIGHTS_DIR", str(tmp_path))
    model = build_detection_model(get_cfg())
    applied = load_weight_file("catalog://ImageNetPretrained/MSRA/R-50",
                               model)
    # the stem, every block of the body and of the res5 head (3 convs and
    # 3 FrozenBN affines, a downsample conv and its affine in each stage's
    # first), and nothing else
    assert len(applied) == 3 + (3 + 4 + 6 + 3) * 9 + 4 * 3
    assert "roi_heads.box.feature_extractor.head.layer4.0.conv1.weight" \
        in applied
    torch.testing.assert_close(
        model.state_dict()["backbone.body.stem.conv1.weight"],
        torch.from_numpy(blobs["conv1_w"]), rtol=0, atol=0)
    _assert_loads_like_jax(path, applied, model)


def test_torch_checkpoint_loads_like_jax(tmp_path):
    """A maskrcnn-benchmark state_dict: FrozenBN with running statistics
    (folded), a "module." prefix, and a key the model lacks."""
    rng = np.random.RandomState(2)
    port = build_detection_model(get_cfg())
    state = {}
    for name, v in port.state_dict().items():
        if name.startswith("da_heads."):
            continue
        if ".bn" in name or "downsample.1" in name:
            prefix, kind = name.rsplit(".", 1)
            if kind == "weight":
                n = v.shape[0]
                state[f"module.{prefix}.weight"] = torch.from_numpy(
                    rng.uniform(0.5, 1.5, n).astype(np.float32))
                state[f"module.{prefix}.bias"] = torch.from_numpy(
                    rng.randn(n).astype(np.float32))
                state[f"module.{prefix}.running_mean"] = torch.from_numpy(
                    rng.randn(n).astype(np.float32))
                state[f"module.{prefix}.running_var"] = torch.from_numpy(
                    rng.uniform(0.5, 2.0, n).astype(np.float32))
            continue
        state[f"module.{name}"] = torch.from_numpy(
            rng.randn(*v.shape).astype(np.float32))
    state["module.some_other_head.weight"] = torch.zeros(3)
    path = tmp_path / "model_final.pth"
    torch.save({"model": state, "iteration": 90000}, path)
    applied = load_weight_file(str(path), port, pool_resolution=14)
    assert "some_other_head.weight" not in applied
    _assert_loads_like_jax(path, applied, port)


def test_train_net_triplet_under_torchrun(tiny, tmp_path):
    """``torchrun --nproc_per_node 2 -m ...train_net_triplet --device
    cpu``: two gloo ranks train 2 steps on their shards (a triple each),
    rank 0 alone writes the checkpoints, each rank evaluates its shard and
    the merge is evaluated once (coco_results.json); every rank logs to
    its own file."""
    out = tmp_path / "out_ddp"
    env = dict(os.environ, OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", "2", "-m",
         "da_detect_tpu_torch.tools.train_net_triplet"] + CPU + _opts(out)
        + ["MODEL.DOMAIN_ADAPTATION_ON", "True", "TPU.MESH_DATA", "2"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    run_dir = out / "run"
    assert sorted(p.name for p in run_dir.iterdir()
                  if p.suffix in (".pth", ".txt", ".json")) == [
        "coco_results.json", "log_rank0.txt", "log_rank1.txt",
        "model_0000002.pth"]
    for rank in (0, 1):
        log = (run_dir / f"log_rank{rank}.txt").read_text()
        assert f"rank {rank} of 2" in log
        assert "evaluating on tiny_foggy_cocostyle" in log
    ckpt = torch.load(run_dir / "model_0000002.pth", weights_only=True)
    assert ckpt["step"] == 2 and len(ckpt["generators"]) == 2
