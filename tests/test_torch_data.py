"""The port's data path (``da_detect_tpu_torch/data``) against the JAX
package's, on the tiny on-disk triple of ``tests/data_factory.py`` (120x160
PNGs) and a small mixed-orientation set.

Tolerances: the PNG reader equals ``cv2.imread`` bit for bit; geometry
(resize sizes, boxes, canvases), datasets' samples, and every batch's boxes,
labels, valid, sizes, orig_sizes, is_source and image ids equal the JAX
loader's exactly; pixels within one uint8 level, because the port resizes
with ``torch.nn.functional.interpolate`` where the JAX package calls
``cv2.resize`` (by design; ``RESIZE_OFF_BY_ONE`` bounds the share of pixels
that differ). Staged, packed and pooled loaders equal the plain one bit for
bit.
"""

import json
import os
import stat

import cv2
import numpy as np
import pytest
import torch

import tests.data_factory as factory
from da_detect_tpu.config import get_cfg as j_get_cfg
from da_detect_tpu.data import build as j_build
from da_detect_tpu.data import transforms as j_tf
from da_detect_tpu.data.datasets import COCODataset as JCOCODataset
from da_detect_tpu_torch.config import get_cfg
from da_detect_tpu_torch.data import build, image_io, staging, transforms
from da_detect_tpu_torch.data.datasets import COCODataset
from tests.torch_harness import register_port_tiny_catalog

# share of pixels that the torch resize puts one level off cv2's (the
# largest measured here is 0.27; any pixel two levels off fails)
RESIZE_OFF_BY_ONE = 0.35

CPU = torch.device("cpu")


@pytest.fixture(scope="module", autouse=True)
def _threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    dirs = factory.make_triplet_datasets(str(tmp_path_factory.mktemp("tiny")))
    factory.register_tiny_catalog(dirs)
    with pytest.MonkeyPatch.context() as mp:
        register_port_tiny_catalog(dirs, mp)
        yield dirs


@pytest.fixture(scope="module")
def mixed(tmp_path_factory):
    """Five images, landscape and portrait, one box each."""
    root = tmp_path_factory.mktemp("mixed")
    images, anns = [], []
    rng = np.random.RandomState(3)
    for i, (h, w) in enumerate([(80, 120), (120, 80), (80, 120), (120, 80),
                                (80, 120)]):
        img = rng.randint(0, 255, (h, w, 3)).astype(np.uint8)
        cv2.imwrite(str(root / f"im_{i}.png"), img)
        images.append({"id": i + 1, "file_name": f"im_{i}.png", "height": h,
                       "width": w})
        anns.append({"id": i + 1, "image_id": i + 1, "category_id": 1,
                     "bbox": [10, 10 + i, 30, 20], "area": 600,
                     "iscrowd": 0})
    ann = root / "ann.json"
    ann.write_text(json.dumps({"images": images, "annotations": anns,
                               "categories": [{"id": 1, "name": "thing"}]}))
    return str(root), str(ann)


def _patch_catalogs(monkeypatch, name, img_dir, ann):
    """``name`` in both packages' catalogs, undone with ``monkeypatch``."""
    from da_detect_tpu.config.catalog import DatasetCatalog as JCatalog
    from da_detect_tpu_torch.config.catalog import DatasetCatalog

    for catalog in (JCatalog, DatasetCatalog):
        original = catalog.get

        def get(n, original=original):
            if n != name:
                return original(n)
            return {"factory": "COCODataset",
                    "args": {"root": img_dir, "ann_file": ann}}

        monkeypatch.setattr(catalog, "get", staticmethod(get))


def _cfgs(**opts):
    """(JAX cfg, port cfg) with the same options, staging off."""
    out = []
    for cfg in (j_get_cfg(), get_cfg()):
        cfg.TPU.IMAGE_SHAPE = (0, 0)
        cfg.TPU.MAX_GT_BOXES = 5
        cfg.INPUT.MIN_SIZE_TRAIN = (96, 112)
        cfg.INPUT.MAX_SIZE_TRAIN = 150
        cfg.INPUT.MIN_SIZE_TEST = 100
        cfg.INPUT.MAX_SIZE_TEST = 140
        cfg.DATALOADER.SIZE_DIVISIBILITY = 32
        cfg.DATALOADER.NUM_WORKERS = 0
        cfg.DATALOADER.STAGE_CACHE = False
        cfg.SOLVER.IMS_PER_BATCH = 2
        cfg.TEST.IMS_PER_BATCH = 3
        cfg.DATASETS.TRAIN = ("tiny_clean_cocostyle",)
        cfg.DATASETS.TEST = ("tiny_foggy_cocostyle",)
        cfg.DATASETS.SOURCE_TRAIN = ("tiny_clean_cocostyle",)
        cfg.DATASETS.TARGET_TRAIN = ("tiny_foggy_cocostyle",)
        cfg.DATASETS.TARGET_TRAIN_negative = ("tiny_rainy_cocostyle",)
        cfg.merge_from_list([x for kv in opts.items() for x in kv])
        out.append(cfg)
    return tuple(out)


# ------------------------------------------------------------ image io

_FILTERS = {"default": [], "all": [cv2.IMWRITE_PNG_FILTER,
                                    cv2.IMWRITE_PNG_ALL_FILTERS]}
_FILTERS.update({name.lower(): [cv2.IMWRITE_PNG_FILTER,
                                getattr(cv2, f"IMWRITE_PNG_FILTER_{name}")]
                 for name in ("NONE", "SUB", "UP", "AVG", "PAETH")})


def _test_image(channels):
    rng = np.random.RandomState(channels)
    yy, xx = np.mgrid[:37, :53]
    img = ((yy * 3 + xx * 5)[..., None] % 256
           + rng.randint(0, 9, (37, 53, channels))).astype(np.uint8)
    return img[..., 0] if channels == 1 else img


@pytest.mark.parametrize("filters", sorted(_FILTERS))
@pytest.mark.parametrize("channels", [1, 3, 4])
def test_png_reader_matches_cv2(tmp_path, channels, filters):
    path = str(tmp_path / "x.png")
    assert cv2.imwrite(path, _test_image(channels), _FILTERS[filters])
    got = image_io.load_image_bgr(path, "png")
    want = cv2.imread(path, cv2.IMREAD_COLOR)
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)


def test_png_reader_decodes_every_filter_in_one_image(tmp_path):
    """cv2's adaptive choice mixes the five filters row by row."""
    path = str(tmp_path / "x.png")
    rng = np.random.RandomState(0)
    img = cv2.GaussianBlur(rng.randint(0, 255, (90, 140, 3), np.uint8),
                           (5, 5), 2)
    cv2.imwrite(path, img, _FILTERS["all"])
    raw = image_io.read_png(path)
    np.testing.assert_array_equal(image_io.png_to_bgr(raw), img)


@pytest.mark.parametrize("grey", [False, True])
def test_png_writer_round_trips(tmp_path, grey):
    img = _test_image(1 if grey else 3)
    path = str(tmp_path / "w.png")
    image_io.write_png(path, img)
    back = image_io.read_png(path)
    np.testing.assert_array_equal(back[..., 0] if grey else back[..., ::-1],
                                  img)
    want = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    np.testing.assert_array_equal(want, img)


def test_non_png_without_cv2_raises_naming_the_file(tmp_path):
    path = str(tmp_path / "x.jpg")
    cv2.imwrite(path, _test_image(3))
    with pytest.raises(ValueError, match="x.jpg"):
        image_io.load_image_bgr(path, "png")
    assert image_io.DECODER == "cv2"  # cv2 is importable here


# ------------------------------------------------------------ transforms

def test_geometry_matches_jax():
    for h, w in [(120, 160), (160, 120), (1024, 2048), (375, 1242),
                 (600, 1200), (33, 99)]:
        for min_size in (96, 120, 600, 800):
            for max_size in (None, 150, 1200, 1333):
                assert transforms.compute_resize_hw(h, w, min_size, max_size) \
                    == j_tf.compute_resize_hw(h, w, min_size, max_size)
    rng = np.random.RandomState(0)
    boxes = rng.uniform(0, 150, (7, 4)).astype(np.float32)
    for hflip in (False, True):
        for args in [(120, 160, 96, 128), (1024, 2048, 600, 1200)]:
            np.testing.assert_array_equal(
                transforms.transform_boxes(boxes, *args, hflip),
                j_tf.transform_boxes(boxes, *args, hflip))
    for is_train in (False, True):
        for shape in ((0, 0), (608, 1216)):
            jcfg, pcfg = _cfgs()
            jcfg.TPU.IMAGE_SHAPE = pcfg.TPU.IMAGE_SHAPE = shape
            assert transforms.canvas_for(pcfg, is_train) \
                == j_tf.canvas_for(jcfg, is_train)


@pytest.mark.parametrize("src,dst", [((240, 320), (150, 200)),
                                     ((240, 320), (96, 128)),
                                     ((120, 160), (160, 213))])
def test_resize_within_one_level_of_cv2(src, dst):
    rng = np.random.RandomState(1)
    img = cv2.GaussianBlur(rng.randint(0, 255, src + (3,), np.uint8),
                           (3, 3), 1)
    got = transforms.resize_u8(img, *dst).astype(int)
    want = cv2.resize(img, dst[::-1], interpolation=cv2.INTER_LINEAR)
    diff = np.abs(got - want)
    assert diff.max() <= 1
    assert (diff > 0).mean() <= RESIZE_OFF_BY_ONE


# ------------------------------------------------------------ datasets

def test_coco_dataset_samples_match_jax(tiny):
    img_dir, ann = tiny["clean"]
    for remove in (True, False):
        mine = COCODataset(ann, img_dir, remove, is_source=False)
        ref = JCOCODataset(ann, img_dir, remove, is_source=False)
        assert len(mine) == len(ref) and mine.ids == ref.ids
        for i in range(len(ref)):
            assert mine.get_img_info(i) == ref.get_img_info(i)
            a, b = mine.sample(i), ref.sample(i)
            assert a.keys() == b.keys()
            for k in a:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)


# ------------------------------------------------------------ loaders

def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else \
        np.asarray(x)


def _assert_batch_matches(got, want, what=""):
    """One port (ImageBatch, Targets, ...) tuple against the JAX one."""
    assert len(got) == len(want), what
    for g, w in zip(got, want):
        if hasattr(w, "images"):
            np.testing.assert_array_equal(_np(g.sizes), np.asarray(w.sizes))
            np.testing.assert_array_equal(_np(g.orig_sizes),
                                          np.asarray(w.orig_sizes))
            np.testing.assert_array_equal(_np(g.is_source),
                                          np.asarray(w.is_source))
            img = _np(g.images.permute(0, 2, 3, 1)).astype(int)
            ref = np.asarray(w.images).astype(int)
            assert img.shape == ref.shape, what
            assert np.abs(img - ref).max() <= 1, what
        elif hasattr(w, "boxes"):
            np.testing.assert_array_equal(_np(g.boxes), np.asarray(w.boxes))
            np.testing.assert_array_equal(_np(g.labels), np.asarray(w.labels))
            np.testing.assert_array_equal(_np(g.valid), np.asarray(w.valid))
        else:
            assert list(g) == list(w), what  # image ids


def _drain(loader, n=None):
    out = []
    for item in loader:
        out.append(item)
        if n is not None and len(out) == n:
            break
    loader.close()
    return out


@pytest.mark.parametrize("is_train", [True, False])
@pytest.mark.parametrize("data", ["tiny", "mixed"])
def test_loader_matches_jax(request, is_train, data):
    """Every batch of a train epoch (shuffled, two orientation buckets, the
    partial buckets at the end) and of the eval pass (the last batch
    padded with its last sample and id None)."""
    opts = {}
    if data == "tiny":
        request.getfixturevalue("tiny")
    else:
        _patch_catalogs(request.getfixturevalue("monkeypatch"),
                        "mixed_cocostyle", *request.getfixturevalue("mixed"))
        opts = {"DATASETS.TRAIN": "('mixed_cocostyle',)",
                "DATASETS.TEST": "('mixed_cocostyle',)"}
    jcfg, pcfg = _cfgs(**opts)
    want = list(j_build.make_data_loader(jcfg, is_train=is_train, seed=5,
                                         infinite=False)[0])
    got = _drain(build.make_data_loader(pcfg, is_train=is_train, device=CPU,
                                        seed=5, infinite=False)[0])
    assert len(got) == len(want) > 1
    for i, (g, w) in enumerate(zip(got, want)):
        _assert_batch_matches(g, w, f"batch {i}")
    if not is_train:  # a padded batch
        assert any(ids[-1] is None for _, ids in got)


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("negative", [True, False])
def test_da_loader_matches_jax(tiny, aligned, negative):
    """Two epochs of triples (8 images, 1 triple a step)."""
    opts = {} if negative else {"DATASETS.TARGET_TRAIN_negative": "()"}
    jcfg, pcfg = _cfgs(**opts)
    steps = 8
    want = _drain(j_build.make_data_loader_da(jcfg, aligned=aligned, seed=3),
                  steps)
    got = _drain(build.make_data_loader_da(pcfg, device=CPU, aligned=aligned,
                                           seed=3), steps)
    assert len(got[0]) == (6 if negative else 4)
    for i, (g, w) in enumerate(zip(got, want)):
        _assert_batch_matches(g, w, f"step {i}")
        if aligned:  # the positive and negative carry the source's targets
            for t in got[0][3::2]:
                torch.testing.assert_close(t.boxes, got[0][1].boxes)


def _batches_equal(a, b):
    for x, y in zip(a, b):
        for f in ("images", "sizes", "orig_sizes", "is_source", "boxes",
                  "labels", "valid"):
            if hasattr(x, f):
                assert torch.equal(getattr(x, f), getattr(y, f)), f


def test_stage_cache_warm_epoch_is_bit_exact(tiny, tmp_path):
    _, pcfg = _cfgs(**{"DATALOADER.STAGE_CACHE": True,
                       "DATALOADER.STAGE_DIR": str(tmp_path / "stage")})
    runs = []
    for _ in range(2):
        loader, _ = build.make_data_loader(pcfg, is_train=True, device=CPU,
                                           seed=1, infinite=False)
        runs.append(_drain(loader))
        stats = loader.stats
    assert stats["stage_misses"] == 0 and stats["stage_hits"] == 8
    assert "decode_s" not in stats
    for a, b in zip(*runs):
        _batches_equal(a, b)


def test_stage_directory_is_per_user_and_keys_on_the_prep(tmp_path,
                                                          monkeypatch):
    monkeypatch.setattr(staging.tempfile, "gettempdir",
                        lambda: str(tmp_path))
    root = staging.default_stage_dir()
    assert os.path.basename(root) == f"da_detect_stage-{os.getuid()}"
    assert stat.S_IMODE(os.stat(root).st_mode) == 0o700
    os.chmod(root, 0o777)
    with pytest.raises(PermissionError):
        staging.default_stage_dir()
    os.chmod(root, 0o700)
    # a canvas staged by one prep is a miss for another
    img = str(tmp_path / "x.png")
    image_io.write_png(img, np.zeros((4, 4, 3), np.uint8))
    canvas = np.ones((4, 4, 3), np.uint8)
    staging.StageCache(str(tmp_path / "c"), "torch_u8").put(img, ("k",),
                                                            canvas)
    assert staging.StageCache(str(tmp_path / "c"), "torch_u8").get(
        img, ("k",)) is not None
    assert staging.StageCache(str(tmp_path / "c"), "u8").get(
        img, ("k",)) is None
    _, pcfg = _cfgs(**{"DATALOADER.STAGE_CACHE": True})
    assert staging.make_stage_cache(pcfg).prep == "torch_u8"


@pytest.mark.parametrize("is_train", [True, False])
def test_packed_loader_equals_unpacked(tiny, is_train):
    _, pcfg = _cfgs()
    got = [_drain(build.make_data_loader(pcfg, is_train=is_train, device=CPU,
                                         seed=2, infinite=False,
                                         packed=packed)[0])
           for packed in (False, True)]
    for a, b in zip(*got):
        _batches_equal(a, b)
        assert b[0].images.is_contiguous(memory_format=torch.channels_last)
    da = [_drain(build.make_data_loader_da(pcfg, device=CPU, seed=2,
                                           packed=packed), 3)
          for packed in (False, True)]
    for a, b in zip(*da):
        _batches_equal(a, b)


def test_worker_pool_is_deterministic(tiny, monkeypatch):
    """Four decode workers (through the PNG reader) give the serial loader's
    batches bit for bit."""
    monkeypatch.setattr(image_io, "DECODER", "png")
    runs = []
    for workers in (0, 4):
        _, pcfg = _cfgs(**{"DATALOADER.NUM_WORKERS": workers})
        loader = build.make_data_loader_da(pcfg, device=CPU, seed=4)
        runs.append(_drain(loader, 4))
        assert loader.stats["decoder"] == "png"
    for a, b in zip(*runs):
        _batches_equal(a, b)


def test_a_failing_producer_raises_in_the_consumer(mixed, monkeypatch,
                                                  tmp_path):
    """An image missing on disk: the producer's error reaches the
    consumer, not a silently short epoch."""
    img_dir, ann = mixed
    with open(ann) as f:
        broken = json.load(f)
    broken["images"][2]["file_name"] = "missing.png"
    path = tmp_path / "broken.json"
    path.write_text(json.dumps(broken))
    _patch_catalogs(monkeypatch, "broken_cocostyle", img_dir, str(path))
    _, pcfg = _cfgs(**{"DATASETS.TEST": "('broken_cocostyle',)"})
    loader, _ = build.make_data_loader(pcfg, is_train=False, device=CPU)
    with pytest.raises(RuntimeError, match="producer failed") as e:
        _drain(loader)
    assert isinstance(e.value.__cause__, FileNotFoundError)


def test_loader_without_a_device_needs_the_card(tiny):
    _, pcfg = _cfgs()
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build.make_data_loader(pcfg, is_train=True)


def test_float32_transport_is_the_uint8_canvas_normalized(tiny):
    """``TPU.TRANSPORT_PIXELS: float32`` normalizes on the host what the
    uint8 transport's ``ImageBatch.normalized`` normalizes on the device:
    the same values, padding 0."""
    _, pcfg = _cfgs()
    u8 = _drain(build.make_data_loader(pcfg, is_train=False, device=CPU)[0])
    pcfg.TPU.TRANSPORT_PIXELS = "float32"
    f32 = _drain(build.make_data_loader(pcfg, is_train=False, device=CPU)[0])
    mean, std = pcfg.INPUT.PIXEL_MEAN, pcfg.INPUT.PIXEL_STD
    for (a, _), (b, _) in zip(u8, f32):
        assert b.images.dtype == torch.float32
        assert torch.equal(a.normalized(mean, std), b.images)
