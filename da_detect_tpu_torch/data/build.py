"""Data loaders (port of ``da_detect_tpu/data/build.py``; reference
data/build.py:232-420).

``make_data_loader``: the single-domain train or eval loader.
``prestage_datasets``: every canvas of the configured datasets into the
staging cache ahead of training (``tools/stage_dataset.py``).
``make_data_loader_da``: the triplet loader (the reference's Dataset_triplet
+ BatchCollator_triplet, build.py:23-62): one index fetches the same image
from the source, positive and negative datasets; the positive and negative
reuse the source's annotations with is_source False (the domains are
pixel-aligned renderings), and the three get the same geometry.

Batches are fixed-shape (``ImageBatch``, ``Targets``), made on a producer
thread (its images decoded and prepped by a worker pool of
``DATALOADER.NUM_WORKERS`` threads) and sent to the device ahead of the
consumer (``TPU.PREFETCH`` batches) by ``transport.Transport``: one packed
copy a step (``TPU.PACKED_TRANSPORT``) or a copy a tensor. Aspect-ratio
grouping becomes two orientation buckets: landscape batches take the canvas
(H, W), portrait ones (W, H). A train loader ``with_masks`` (``MASK_ON``)
also carries each GT's polygons rasterized in its original box's frame
(``Targets.masks``, 112 x 112, mirrored with a flipped image), made from the
annotations whether the canvas was decoded or staged. A train loader
``with_keypoints`` (``KEYPOINT_ON``) carries each GT's keypoints
(``Targets.keypoints``, [G, K, 3]): scaled to the resized image by the
dims its boxes use (the decoded file's on a decode, the annotation's on a
staging hit, which only a file that agrees with its annotation can make),
mirrored with a flipped image (x -> w - x - 1, the person-17 left and right
keypoints swapped), rows with visibility 0 set to 0.

The random draws are the JAX package's, in its order: each batch's geometry
from ``RandomState(hash((seed, tuple(indices))))`` (``draw_params``), each
epoch's shuffle from ``RandomState(seed + epoch)``; so one seed gives the
same images, flips and scales in both packages.

Data-parallel runs: each loader takes this process's ``rank`` of ``world``
(default ``utils.comm``'s) and reads its shard of every epoch's order,
``order[rank::world]``, as the JAX package's process ``rank`` does (the
reference's DistributedSampler): the same batches. The triplet loader gives
every process k = IMS_PER_BATCH // 2 triples a step, so a step's global
batch holds world * k triples; an eval loader's shards partition the
dataset.
"""

from __future__ import annotations

import queue
import threading
import time
from collections import defaultdict
from concurrent.futures import ThreadPoolExecutor
from typing import Sequence

import numpy as np
import torch

from ..config.catalog import DatasetCatalog
from ..entry import resolve_device
from ..structures.image_batch import MASK_RESOLUTION, ImageBatch, Targets
from ..utils import comm
from . import datasets as D
from . import image_io
from .staging import make_stage_cache
from .transforms import (canvas_for, compute_resize_hw, normalize_and_pad,
                         rasterize_polygons, resize_flip_pad_u8,
                         transform_boxes)
from .transport import Transport

# COCO person-17 left/right swap for horizontal flips (reference
# structures/keypoint.py PersonKeypoints.FLIP_MAP)
_PERSON_KP_FLIP_INDS = (0, 2, 1, 4, 3, 6, 5, 8, 7, 10, 9, 12, 11, 14, 13,
                        16, 15)


def build_dataset(names: Sequence[str], is_train: bool,
                  is_source: bool = True):
    ds = []
    for name in names:
        data = DatasetCatalog.get(name)
        args = dict(data["args"])
        if data["factory"] == "COCODataset":
            args["remove_images_without_annotations"] = is_train
            args["is_source"] = is_source
        elif data["factory"] == "PascalVOCDataset":
            args["use_difficult"] = not is_train
        else:
            raise NotImplementedError(
                f"dataset {name}: factory {data['factory']} is not ported "
                "(the port reads COCO-style and Pascal VOC datasets)")
        ds.append(getattr(D, data["factory"])(**args))
    if len(ds) == 1:
        return ds[0]
    return D.ConcatDataset(ds)


class _SampleProcessor:
    def __init__(self, cfg, is_train: bool, with_masks: bool = False,
                 with_keypoints: bool = False):
        self.is_train = is_train
        self.with_masks = with_masks
        self.with_keypoints = with_keypoints
        self.num_keypoints = cfg.MODEL.ROI_KEYPOINT_HEAD.NUM_CLASSES
        self.transport = cfg.TPU.TRANSPORT_PIXELS
        if self.transport not in ("uint8", "float32"):
            raise ValueError(f"TPU.TRANSPORT_PIXELS must be uint8 or "
                             f"float32, got {self.transport!r}")
        self.decoder = image_io.DECODER
        self.stage = make_stage_cache(cfg)
        # seconds a stage, summed over workers (the loader's stats)
        self.stats: dict[str, float] = defaultdict(float)
        self._stats_lock = threading.Lock()
        self.min_sizes = (tuple(cfg.INPUT.MIN_SIZE_TRAIN) if is_train
                          else (cfg.INPUT.MIN_SIZE_TEST,))
        self.max_size = (cfg.INPUT.MAX_SIZE_TRAIN if is_train
                         else cfg.INPUT.MAX_SIZE_TEST)
        self.flip_prob = 0.5 if is_train else 0.0
        self.pixel_mean = tuple(cfg.INPUT.PIXEL_MEAN)
        self.pixel_std = tuple(cfg.INPUT.PIXEL_STD)
        self.to_bgr255 = cfg.INPUT.TO_BGR255
        self.canvas = canvas_for(cfg, is_train)
        self.max_gt = cfg.TPU.MAX_GT_BOXES

    def draw_params(self, rng: np.random.RandomState):
        return dict(min_size=int(rng.choice(self.min_sizes)),
                    hflip=bool(rng.rand() < self.flip_prob))

    def canvas_hw(self, sample):
        if sample["height"] > sample["width"]:
            return ((self.canvas[1], self.canvas[0])
                    if self.canvas[0] < self.canvas[1] else self.canvas)
        return self.canvas

    def _tick(self, key: str, t0: float):
        with self._stats_lock:
            self.stats[key] += time.perf_counter() - t0

    def _stage_key(self, params, canvas_hw) -> tuple:
        """Everything that affects the prepped pixels."""
        return (params["min_size"], self.max_size, bool(params["hflip"]),
                tuple(canvas_hw), self.pixel_mean, self.pixel_std,
                self.to_bgr255)

    def __call__(self, sample, params, canvas_hw):
        stage_key = self._stage_key(params, canvas_hw)
        mh, mw = int(sample["height"]), int(sample["width"])
        img = None
        if self.stage is not None:
            t0 = time.perf_counter()
            img = self.stage.get(sample["path"], stage_key)
            self._tick("stage_read_s", t0)
            if img is not None:
                # hit: geometry from the annotation's dims, no decode
                h, w = mh, mw
                rh, rw = compute_resize_hw(h, w, params["min_size"],
                                           self.max_size)
                boxes = transform_boxes(sample["boxes"], h, w, rh, rw,
                                        params["hflip"])
        if img is None:
            t0 = time.perf_counter()
            raw = image_io.load_image_bgr(sample["path"], self.decoder)
            self._tick("decode_s", t0)
            h, w = raw.shape[:2]
            t0 = time.perf_counter()
            rh, rw = compute_resize_hw(h, w, params["min_size"],
                                       self.max_size)
            boxes = transform_boxes(sample["boxes"], h, w, rh, rw,
                                    params["hflip"])
            img = resize_flip_pad_u8(raw, canvas_hw, rh, rw, params["hflip"])
            if self.transport == "float32":
                img = normalize_and_pad(img, rh, rw, self.pixel_mean,
                                        self.to_bgr255, self.pixel_std)
            self._tick("prep_s", t0)
            # stage only a file that agrees with its annotation's dims: a hit
            # takes its geometry from them
            if self.stage is not None and (h, w) == (mh, mw):
                t0 = time.perf_counter()
                self.stage.put(sample["path"], stage_key, img)
                self._tick("stage_write_s", t0)
        g = self.max_gt
        n = min(len(boxes), g)
        pb = np.zeros((g, 4), np.float32)
        pl = np.zeros((g,), np.int64)
        pv = np.zeros((g,), bool)
        pb[:n] = boxes[:n]
        pl[:n] = sample["labels"][:n]
        pv[:n] = True
        out = dict(image=img, sizes=np.asarray([rh, rw], np.int32),
                   orig=np.asarray([mh, mw], np.int32), boxes=pb, labels=pl,
                   valid=pv, is_source=bool(sample["is_source"]),
                   image_id=sample["image_id"])
        if self.with_masks:
            # rasterized in the ORIGINAL GT box's frame (the polygons are
            # in original-image coordinates; a box-frame mask does not
            # change with the resize), then mirrored for the flip
            m = MASK_RESOLUTION
            masks = np.zeros((g, m, m), np.float32)
            for i in range(n):
                segs = sample["segmentations"][i]
                if segs and isinstance(segs, list):
                    mask = rasterize_polygons(segs, sample["boxes"][i], m)
                    masks[i] = mask[:, ::-1] if params["hflip"] else mask
            out["masks"] = masks
        if self.with_keypoints:
            k = self.num_keypoints
            kps = np.zeros((g, k, 3), np.float32)
            sx, sy = rw / max(w, 1), rh / max(h, 1)
            for i in range(n):
                raw = sample.get("keypoints", [None] * (i + 1))[i]
                if raw is None:
                    continue
                kp = np.asarray(raw, np.float32).reshape(-1, 3)[:k]
                kp[:, 0] *= sx
                kp[:, 1] *= sy
                if params["hflip"]:
                    kp[:, 0] = rw - kp[:, 0] - 1
                    if len(kp) == len(_PERSON_KP_FLIP_INDS):
                        kp = kp[list(_PERSON_KP_FLIP_INDS)]
                kp[kp[:, 2] == 0] = 0.0
                kps[i, :len(kp)] = kp
            out["keypoints"] = kps
        return out


def _stack(processed) -> tuple[ImageBatch, Targets]:
    """CPU tensors; images NHWC memory viewed as NCHW (channels-last); the
    masks and keypoints when the samples carry them."""
    def cat(key):
        return torch.from_numpy(np.stack([p[key] for p in processed]))

    batch = ImageBatch(images=cat("image").permute(0, 3, 1, 2),
                       sizes=cat("sizes"), orig_sizes=cat("orig"),
                       is_source=torch.tensor([p["is_source"]
                                               for p in processed]))
    targets = Targets(boxes=cat("boxes"), labels=cat("labels"),
                      valid=cat("valid"),
                      masks=cat("masks") if "masks" in processed[0] else None,
                      keypoints=(cat("keypoints")
                                 if "keypoints" in processed[0] else None))
    return batch, targets


class _Prefetcher:
    """Background-thread batch producer (in place of DataLoader workers).

    The producer runs ``gen_fn`` and starts each batch's copy to the device
    (``Transport.send``); ``__next__`` finishes it on the consumer's thread
    (``Transport.receive``). No in-band sentinel (a full queue at the
    generator's end would drop it): a done flag; puts are bounded so that
    ``close`` can always stop the producer."""

    def __init__(self, gen_fn, transport: Transport, depth: int = 2,
                 pool: ThreadPoolExecutor | None = None, proc=None):
        self.q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = False
        self._done = False
        self._error = None
        self._pool = pool
        self._proc = proc
        self._transport = transport

        def run():
            try:
                for item in gen_fn():
                    if not self._put(item):
                        return
            except Exception as e:  # re-raised by the consumer
                self._error = e
            finally:
                self._done = True

        self.t = threading.Thread(target=run, daemon=True)
        self.t.start()

    def _put(self, item) -> bool:
        while not self._stop:
            try:
                self.q.put(item, timeout=0.2)
                return True
            except queue.Full:
                continue
        return False

    def __iter__(self):
        return self

    def __next__(self):
        while True:
            try:
                batch, extra = self.q.get(timeout=0.2)
                out = self._transport.receive(batch)
                return out if extra is None else (out[0], extra)
            except queue.Empty:
                if self._done and self.q.empty():
                    if self._error is not None:
                        raise RuntimeError("the loader's producer failed") \
                            from self._error
                    raise StopIteration
                if self._stop:
                    raise StopIteration

    @property
    def stats(self) -> dict:
        """Seconds a stage since the loader started, summed over workers:
        decode_s, prep_s, stage_read_s, stage_write_s, stack_s, pack_s,
        put_s (the copy's dispatch; the copy itself overlaps the device);
        ``batches``, ``bytes`` (one packed step's copy), the staging hits
        and misses, and which ``decoder`` ran."""
        s = dict(self._proc.stats)
        s.update(self._transport.stats)
        s["decoder"] = self._proc.decoder
        if self._proc.stage is not None:
            s["stage_hits"] = self._proc.stage.hits
            s["stage_misses"] = self._proc.stage.misses
        return s

    def close(self):
        """Stop the producer and release the queued batches."""
        self._stop = True
        while True:
            try:
                self.q.get_nowait()
            except queue.Empty:
                break
        self.t.join(timeout=2.0)
        if self._pool is not None:
            self._pool.shutdown(wait=False)


def _make_pool(cfg) -> ThreadPoolExecutor | None:
    """Decode and prep workers: DATALOADER.NUM_WORKERS threads (zlib, the
    numpy passes and the resize release the interpreter lock); 0 or 1
    keeps the producer's own thread."""
    n = int(cfg.DATALOADER.NUM_WORKERS)
    return ThreadPoolExecutor(max_workers=n) if n > 1 else None


def _run_jobs(pool, proc, jobs):
    """jobs: (sample or None, params, canvas) in a fixed order; the params
    are drawn before submission, so the workers' scheduling cannot change
    the augmentation."""
    if pool is None:
        return [proc(s, p, c) if s is not None else None for s, p, c in jobs]
    return list(pool.map(
        lambda j: proc(j[0], j[1], j[2]) if j[0] is not None else None, jobs))


def _transport(cfg, device, packed: bool) -> Transport:
    return Transport(resolve_device(device), packed=packed,
                     depth=cfg.TPU.PREFETCH)


def _shard(rank, world) -> tuple[int, int]:
    return (comm.get_rank() if rank is None else rank,
            comm.get_world_size() if world is None else world)


def make_data_loader(cfg, *, is_train: bool, device=None, dataset_names=None,
                     is_source: bool = True, with_masks: bool = False,
                     with_keypoints: bool = False, shuffle: bool | None = None,
                     seed: int = 0, infinite: bool | None = None,
                     hflip: bool = False, packed: bool = False,
                     rank: int | None = None, world: int | None = None):
    """Single-domain loader on ``device`` (None: the card). Returns
    (loader, dataset). Train: the loader yields (ImageBatch, Targets), the
    targets with GT masks under ``with_masks`` and GT keypoints under
    ``with_keypoints``;
    eval: (ImageBatch, image ids), the last batch padded with its last
    sample under id None. ``hflip`` flips every image (the TTA flip
    pass); ``packed``: one copy a batch (see transport.py); ``rank`` of
    ``world``: the shard this process reads."""
    rank, world = _shard(rank, world)
    if dataset_names is None:
        dataset_names = cfg.DATASETS.TRAIN if is_train else cfg.DATASETS.TEST
    transport = _transport(cfg, device, packed)
    dataset = build_dataset(dataset_names, is_train, is_source)
    proc = _SampleProcessor(cfg, is_train, with_masks and is_train,
                            with_keypoints and is_train)
    if hflip:
        proc.flip_prob = 1.0
    batch_size = (cfg.SOLVER.IMS_PER_BATCH if is_train
                  else cfg.TEST.IMS_PER_BATCH)
    shuffle = is_train if shuffle is None else shuffle
    infinite = is_train if infinite is None else infinite
    pool = _make_pool(cfg)

    def generate():
        epoch = 0
        while True:
            order = np.arange(len(dataset))
            if shuffle:
                np.random.RandomState(seed + epoch).shuffle(order)
            order = order[rank::world]
            if is_train:
                # aspect-ratio grouping: two orientation buckets
                buckets = {True: [], False: []}
                for idx in order:
                    info = dataset.get_img_info(int(idx))
                    portrait = info["height"] > info["width"]
                    buckets[portrait].append(int(idx))
                    if len(buckets[portrait]) == batch_size:
                        yield from _emit(buckets[portrait])
                        buckets[portrait] = []
                if not infinite:
                    for lst in buckets.values():
                        if lst:
                            yield from _emit(lst)
                    break
                epoch += 1
            else:
                # a batch shares one canvas: bucket by orientation too
                by_orient = {True: [], False: []}
                for idx in order:
                    info = dataset.get_img_info(int(idx))
                    by_orient[info["height"] > info["width"]].append(int(idx))
                for lst in by_orient.values():
                    for i in range(0, len(lst), batch_size):
                        yield from _emit(lst[i:i + batch_size],
                                         pad_to=batch_size)
                break

    def _emit(indices, pad_to=None):
        rng = np.random.RandomState(hash((seed, tuple(indices))) % (2 ** 31))
        jobs, ids = [], []
        for idx in indices:
            s = dataset.sample(idx)
            jobs.append((s, proc.draw_params(rng), proc.canvas_hw(s)))
            ids.append(s["image_id"])
        processed = _run_jobs(pool, proc, jobs)
        while pad_to and len(processed) < pad_to:
            processed.append(processed[-1])
            ids.append(None)
        t0 = time.perf_counter()
        batch, targets = _stack(processed)
        proc._tick("stack_s", t0)
        with proc._stats_lock:
            proc.stats["batches"] += 1
        if is_train:
            yield transport.send((batch, targets)), None
        else:
            yield transport.send((batch,)), ids

    return _Prefetcher(generate, transport, depth=cfg.TPU.PREFETCH,
                       pool=pool, proc=proc), dataset


def make_data_loader_da(cfg, *, device=None, aligned: bool = True,
                        seed: int = 0, packed: bool = False,
                        rank: int | None = None, world: int | None = None):
    """Triplet loader on ``device`` (None: the card): yields (batch_s,
    targets_s, batch_p, targets_p[, batch_n, targets_n]) with k =
    IMS_PER_BATCH // 2 images a domain (the reference halves the batch for
    DA, build.py:241-246), k per process. ``aligned``: the same index in
    every domain, the source's boxes, labels and dims on the others;
    otherwise the positive and negative images are drawn at random, each
    with its own annotations. ``rank`` of ``world``: the shard this process
    reads."""
    rank, world = _shard(rank, world)
    transport = _transport(cfg, device, packed)
    ds_s = build_dataset(cfg.DATASETS.SOURCE_TRAIN, True, True)
    ds_p = build_dataset(cfg.DATASETS.TARGET_TRAIN, True, False)
    ds_n = (build_dataset(cfg.DATASETS.TARGET_TRAIN_negative, True, False)
            if cfg.DATASETS.TARGET_TRAIN_negative else None)
    proc = _SampleProcessor(cfg, True)
    k = max(cfg.SOLVER.IMS_PER_BATCH // 2, 1)
    n = len(ds_s)
    if aligned:
        n = min(n, len(ds_p), *([len(ds_n)] if ds_n else []))
    pool = _make_pool(cfg)

    def generate():
        epoch = 0
        while True:
            rng = np.random.RandomState(seed + epoch)
            order = rng.permutation(n)[rank::world]
            for i in range(0, len(order) - k + 1, k):
                jobs = []
                for idx in order[i:i + k]:
                    s = ds_s.sample(int(idx))
                    if aligned:
                        p = ds_p.sample(int(idx))
                        g = ds_n.sample(int(idx)) if ds_n else None
                    else:
                        p = ds_p.sample(int(rng.randint(len(ds_p))))
                        g = (ds_n.sample(int(rng.randint(len(ds_n))))
                             if ds_n else None)
                    # positive and negative take the source's annotations
                    # (Dataset_triplet, reference build.py:40-47)
                    for other in (p, g):
                        if other is not None and aligned:
                            other["boxes"] = s["boxes"]
                            other["labels"] = s["labels"]
                            other["height"] = s["height"]
                            other["width"] = s["width"]
                    params = proc.draw_params(rng)  # shared geometry
                    canvas = proc.canvas_hw(s)
                    jobs += [(x, params, canvas) for x in (s, p, g)]
                results = _run_jobs(pool, proc, jobs)
                t0 = time.perf_counter()
                out = []
                for d in range(3 if ds_n else 2):
                    out += _stack(results[d::3])
                proc._tick("stack_s", t0)
                with proc._stats_lock:
                    proc.stats["batches"] += 1
                yield transport.send(tuple(out)), None
            epoch += 1

    return _Prefetcher(generate, transport, depth=cfg.TPU.PREFETCH,
                       pool=pool, proc=proc)


def prestage_datasets(cfg, dataset_names=None, *, is_train: bool = True,
                      include_da: bool = True) -> int:
    """Offline staging: decode and prep every (image, geometry) variant of
    the configured datasets into the staging cache (``staging.py``), so that
    training starts warm: with flip probability 0.5 and one MIN_SIZE_TRAIN
    two canvases an image. The roles, flips and count are the JAX
    package's: ``dataset_names`` (sources), or the TEST datasets for
    ``is_train`` False, else TRAIN and, with ``include_da``, SOURCE_TRAIN,
    TARGET_TRAIN and TARGET_TRAIN_negative. Returns the canvases prepped (0
    with ``DATALOADER.STAGE_CACHE`` off); already staged ones are skipped."""
    proc = _SampleProcessor(cfg, is_train)
    if proc.stage is None:
        return 0
    roles: list[tuple] = []
    if dataset_names is not None:
        roles.append((tuple(dataset_names), True))
    elif not is_train:
        roles.append((tuple(cfg.DATASETS.TEST), True))
    else:
        if cfg.DATASETS.TRAIN:
            roles.append((tuple(cfg.DATASETS.TRAIN), True))
        if include_da and cfg.DATASETS.SOURCE_TRAIN:
            roles.append((tuple(cfg.DATASETS.SOURCE_TRAIN), True))
            roles.append((tuple(cfg.DATASETS.TARGET_TRAIN), False))
            if cfg.DATASETS.TARGET_TRAIN_negative:
                roles.append((tuple(cfg.DATASETS.TARGET_TRAIN_negative),
                              False))
    flips = (False, True) if proc.flip_prob > 0 else (False,)
    n = 0
    pool = _make_pool(cfg)
    try:
        for names, is_source in roles:
            dataset = build_dataset(names, is_train, is_source)
            jobs = []
            for idx in range(len(dataset)):
                s = dataset.sample(idx)
                canvas = proc.canvas_hw(s)
                for ms in proc.min_sizes:
                    for flip in flips:
                        params = dict(min_size=ms, hflip=flip)
                        # images shared across roles, and reruns
                        if proc.stage.has(s["path"],
                                          proc._stage_key(params, canvas)):
                            continue
                        jobs.append((s, params, canvas))
            _run_jobs(pool, proc, jobs)
            n += len(jobs)
    finally:
        if pool is not None:
            pool.shutdown(wait=False)
    return n
