"""The rest of the port's data and CLI system against the JAX package's, on
the CPU, on the tiny on-disk triple of ``tests/data_factory.py``:

- ``ListDataset``: sizes from a PNG's header (no decode, no PIL), cv2 for
  other formats, and without cv2 a raise naming the file; its samples equal
  the JAX package's (which reads sizes with PIL).
- ``prestage_datasets`` and ``tools/stage_dataset.py``: the same count of
  canvases as the JAX package's for the same config (roles, flips); a rerun
  stages nothing; a loader epoch after it decodes nothing.
- ``train_net_img`` / ``train_net_ins``: the JAX CLIs' effective configs
  (the same loss weights zeroed, DA mode, multistep schedule), and a run.
- ``test_net_batch``: every checkpoint of a directory, oldest first, each
  equal to ``test_net`` on that checkpoint.
- ``--profile``: a ``torch.profiler`` trace of the chosen iterations;
  ``--use-tensorboard``: event files under ``TENSORBOARD_EXPERIMENT``, and
  one warning without tensorboard.

The model is the flagship narrowed as in ``tests/test_torch_cli.py``.
"""

import json
import logging
import os
import sys

import cv2
import numpy as np
import pytest
import torch

import tests.data_factory as factory
from da_detect_tpu.config import get_cfg as j_get_cfg
from da_detect_tpu_torch.config import get_cfg
from da_detect_tpu_torch.data import (image_io, make_data_loader,
                                      make_data_loader_da, prestage_datasets)
from da_detect_tpu_torch.data.datasets import ListDataset
from da_detect_tpu_torch.tools import (stage_dataset, test_net,
                                       test_net_batch, train_core,
                                       train_net_img, train_net_ins,
                                       train_net_triplet)
from tests.test_torch_cli import CPU, _opts
from tests.torch_harness import write_user_catalog


@pytest.fixture(scope="module", autouse=True)
def _threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("tiny_tools"))
    dirs = factory.make_triplet_datasets(root)
    write_user_catalog(dirs, root)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("DA_DETECT_DATA_DIR", root)
        yield dirs


def _images(tmp_path):
    rng = np.random.RandomState(0)
    paths = []
    for i, (h, w) in enumerate([(30, 50), (64, 40)]):
        p = str(tmp_path / f"img{i}.png")
        image_io.write_png(p, rng.randint(0, 255, (h, w, 3), np.uint8))
        paths.append(p)
    jpg = str(tmp_path / "img2.jpg")
    cv2.imwrite(jpg, rng.randint(0, 255, (20, 36, 3), np.uint8))
    return paths + [jpg]


def test_list_dataset_matches_jax(tmp_path):
    from da_detect_tpu.data.datasets import ListDataset as JListDataset

    paths = _images(tmp_path)
    got, want = ListDataset(paths, is_source=False), JListDataset(
        paths, is_source=False)
    assert len(got) == len(want) == 3
    for i in range(3):
        assert got.get_img_info(i) == want.get_img_info(i)
        g, w = got.sample(i), want.sample(i)
        for k in ("path", "image_id", "width", "height", "is_source"):
            assert g[k] == w[k], k
        np.testing.assert_array_equal(g["boxes"], w["boxes"])
        np.testing.assert_array_equal(g["labels"], w["labels"])
    assert [got.get_img_info(i)["width"] for i in range(3)] == [50, 40, 36]


def test_list_dataset_without_cv2(tmp_path, monkeypatch):
    """A PNG's size comes from its header (no decode); another format
    needs cv2, and without it the error names the file."""
    paths = _images(tmp_path)
    monkeypatch.setattr(image_io, "cv2", None)
    ds = ListDataset(paths)
    assert ds.get_img_info(1)["height"] == 64
    with pytest.raises(ValueError, match="img2.jpg"):
        ds.get_img_info(2)


def _stage_opts(out, extra=()):
    return _opts(out) + ["MODEL.DOMAIN_ADAPTATION_ON", "True",
                         "DATALOADER.STAGE_CACHE", "True"] + list(extra)


def _cfgs(out):
    cfgs = []
    for get in (j_get_cfg, get_cfg):
        cfg = get()
        cfg.merge_from_list(_stage_opts(out))
        cfgs.append(cfg)
    jcfg, pcfg = cfgs
    jcfg.DATALOADER.STAGE_DIR = str(out / "stage_jax")
    return jcfg, pcfg


@pytest.mark.parametrize("is_train", [True, False], ids=["train", "eval"])
def test_prestage_counts_match_jax(tiny, tmp_path, is_train):
    from da_detect_tpu.data.build import prestage_datasets as j_prestage

    jcfg, pcfg = _cfgs(tmp_path)
    want = j_prestage(jcfg, is_train=is_train)
    got = prestage_datasets(pcfg, is_train=is_train)
    # train: TRAIN, SOURCE_TRAIN, TARGET_TRAIN, TARGET_TRAIN_negative, 2
    # flips; TRAIN and SOURCE_TRAIN share their images
    assert got == want == (8 * 3 * 2 if is_train else 8)
    assert prestage_datasets(pcfg, is_train=is_train) == 0


def test_warm_loader_epoch_decodes_nothing(tiny, tmp_path):
    """After ``stage_dataset``, two epochs of the triplet loader and one of
    the source-only loader read every canvas from the cache."""
    out = tmp_path / "warm"
    n = stage_dataset.main(CPU + _stage_opts(out))
    assert n == 48
    assert stage_dataset.main(CPU + _stage_opts(out)) == 0
    cfg = get_cfg()
    cfg.merge_from_list(_stage_opts(out))
    for make in ("da", "source_only"):
        if make == "da":
            loader = make_data_loader_da(cfg, device="cpu", seed=0)
            steps = 16
        else:
            loader, _ = make_data_loader(cfg, is_train=True, device="cpu",
                                         seed=0)
            steps = 8
        for _ in range(steps):
            next(loader)
        stats = loader.stats
        loader.close()
        assert stats.get("decode_s", 0.0) == 0.0, (make, stats)
        assert stats["stage_misses"] == 0 and stats["stage_hits"] > 0


def test_stage_cli_without_cache_stages_nothing(tiny, tmp_path):
    opts = _stage_opts(tmp_path) + ["DATALOADER.STAGE_CACHE", "False"]
    assert stage_dataset.main(CPU + opts) == 0
    assert stage_dataset.main(CPU + ["--eval"] + _stage_opts(tmp_path)) == 8


@pytest.mark.parametrize("tool,zeroed", [
    ("img", ("DA_INS_LOSS_WEIGHT", "DA_CST_LOSS_WEIGHT")),
    ("ins", ("DA_IMG_LOSS_WEIGHT", "DA_CST_LOSS_WEIGHT"))])
def test_ablation_cli_configs_match_jax(tiny, tmp_path, monkeypatch, tool,
                                        zeroed):
    """The img/ins CLIs hand ``run_training`` the JAX CLIs' config (the
    named DA loss weights 0, the user's options after), DA mode and the
    multistep schedule; then a real 1-step run trains."""
    import importlib

    jmod = importlib.import_module(f"da_detect_tpu.tools.train_net_{tool}")
    pmod = {"img": train_net_img, "ins": train_net_ins}[tool]
    seen = {}

    def capture(name):
        def run(cfg, logger, **kw):
            seen[name] = (cfg, kw)
        return run

    monkeypatch.setattr(jmod, "run_training", capture("jax"))
    monkeypatch.setattr(train_core, "run_training", capture("port"))
    opts = _opts(tmp_path / "cfg") + ["MODEL.DOMAIN_ADAPTATION_ON", "True"]
    jmod.main(opts)
    pmod.main(CPU + opts)
    (jcfg, jkw), (pcfg, pkw) = seen["jax"], seen["port"]
    for key in ("DA_IMG_LOSS_WEIGHT", "DA_INS_LOSS_WEIGHT",
                "DA_CST_LOSS_WEIGHT", "DA_TRIPLET_IMG_WEIGHT"):
        assert pcfg.MODEL.DA_HEADS[key] == jcfg.MODEL.DA_HEADS[key], key
    for key in zeroed:
        assert pcfg.MODEL.DA_HEADS[key] == 0.0
    assert pcfg.MODEL.OUTPUT_DIR == jcfg.MODEL.OUTPUT_DIR
    assert (pkw["mode"], pkw["schedule_kind"]) == (
        jkw["mode"], jkw["schedule_kind"]) == ("da", "multistep")
    monkeypatch.undo()
    monkeypatch.setenv("DA_DETECT_DATA_DIR",
                       os.path.dirname(tiny["clean"][0]))
    state, meters = pmod.main(["--skip-test"] + CPU + _opts(
        tmp_path / "run") + ["MODEL.DOMAIN_ADAPTATION_ON", "True",
                             "SOLVER.MAX_ITER", "1"])
    assert state.step == 1 and np.isfinite(
        meters.meters["loss_total"].global_avg)


def test_test_net_batch_evaluates_every_checkpoint(tiny, tmp_path):
    out = tmp_path / "batch"
    opts = CPU + _opts(out) + ["MODEL.DOMAIN_ADAPTATION_ON", "True",
                               "SOLVER.CHECKPOINT_PERIOD", "1"]
    train_net_triplet.main(["--skip-test"] + opts)
    run_dir = out / "run"
    results = test_net_batch.main(["--ckpt-dir", str(run_dir)] + opts)
    assert list(results) == [1, 2]
    newest = test_net.main(["--ckpt", str(run_dir)] + opts)
    assert json.dumps(results[2], sort_keys=True, default=str) == json.dumps(
        newest, sort_keys=True, default=str)
    ap = [r["tiny_foggy_cocostyle"]["bbox"]["AP"] for r in results.values()]
    assert all(0.0 <= a <= 1.0 for a in ap)


def test_profile_leaves_a_trace(tiny, tmp_path):
    """``--profile DIR``: iterations 10-20 traced (here the run's 11th,
    its last), one chrome trace file with the step's ops."""
    out = tmp_path / "prof"
    prof = tmp_path / "trace"
    state, _ = train_net_triplet.main(
        ["--skip-test", "--profile", str(prof)] + CPU + _opts(out)
        + ["MODEL.DOMAIN_ADAPTATION_ON", "True", "SOLVER.MAX_ITER", "11",
           "SOLVER.CHECKPOINT_PERIOD", "100"])
    assert state.step == 11
    assert os.listdir(prof) == ["trace_10-10.json"]
    with open(prof / "trace_10-10.json") as f:
        trace = json.load(f)
    names = {e.get("name", "") for e in trace["traceEvents"]}
    assert any("conv" in n for n in names)


def test_use_tensorboard_writes_scalars(tiny, tmp_path):
    out = tmp_path / "tb"
    tb = tmp_path / "tb_logs"
    train_net_triplet.main(
        ["--skip-test", "--use-tensorboard", "--log-period", "1"] + CPU
        + _opts(out) + ["MODEL.DOMAIN_ADAPTATION_ON", "True",
                        "TENSORBOARD_EXPERIMENT", str(tb)])
    from tensorboard.backend.event_processing.event_accumulator import \
        EventAccumulator

    files = os.listdir(tb)
    assert files and all(f.startswith("events.out.tfevents") for f in files)
    acc = EventAccumulator(str(tb))
    acc.Reload()
    steps = [e.step for e in acc.Scalars("loss_total")]
    assert steps == [0, 1]
    assert "loss_da_image" in acc.Tags()["scalars"]


def test_use_tensorboard_without_tensorboard_warns(tiny, tmp_path,
                                                   monkeypatch, caplog):
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    with caplog.at_level(logging.WARNING):
        state, meters = train_net_triplet.main(
            ["--skip-test", "--use-tensorboard"] + CPU
            + _opts(tmp_path / "notb")
            + ["MODEL.DOMAIN_ADAPTATION_ON", "True",
               "TENSORBOARD_EXPERIMENT", str(tmp_path / "none")])
    warnings = [r for r in caplog.records if "tensorboard" in r.message]
    assert len(warnings) == 1 and warnings[0].levelno == logging.WARNING
    assert state.step == 2 and meters.meters["loss_total"].count == 2
    assert not os.path.exists(tmp_path / "none")
