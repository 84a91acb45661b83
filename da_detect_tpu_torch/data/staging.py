"""Prepped-canvas staging cache (port of ``da_detect_tpu/data/staging.py``):
decode a training image once.

Training revisits the same few thousand images every epoch. The cache keeps
the post-prep canvas (resized, flipped, padded: exactly what the sample
processor makes) on disk, keyed by the image file's identity, every
parameter that affects the pixels, and a tag of the prep that made it
(``PREP_TAGS``): the port resizes with PyTorch, the JAX package with cv2, so
a directory shared with the JAX package never serves one's canvas to the
other. Epochs after the first skip decode and prep; a hit is one read.

One ``.npy`` a (image, geometry) under the cache root, written atomically
(tmp + ``os.replace``) so workers and processes can share a directory; a
torn or corrupt file reads as a miss and is rewritten. Hits are bit-exact
with the cold path in uint8 and float32; ``float16`` storage rounds float
canvases (<= 0.0625 on BGR255 - mean values, below the bfloat16 compute
rounding).

The default root is per user: ``da_detect_stage-<uid>`` under the temp
directory, created with mode 0700; an existing one owned by another user, or
open to others, is refused (another user could plant canvases there).
"""

from __future__ import annotations

import hashlib
import os
import stat
import tempfile
from typing import Optional

import numpy as np

_FORMAT_VERSION = 1

# transport -> the tag of the prep that makes its canvases
PREP_TAGS = {"uint8": "torch_u8", "float32": "f32"}


def default_stage_dir() -> str:
    """A per-user directory (mode 0700) under the temp directory."""
    root = os.path.join(tempfile.gettempdir(),
                        f"da_detect_stage-{os.getuid()}")
    os.makedirs(root, mode=0o700, exist_ok=True)
    st = os.stat(root)
    if st.st_uid != os.getuid() or st.st_mode & (stat.S_IRWXG | stat.S_IRWXO):
        raise PermissionError(
            f"stage directory {root} is owned by uid {st.st_uid} or open to "
            f"others (mode {stat.S_IMODE(st.st_mode):o}); set "
            "DATALOADER.STAGE_DIR or remove it")
    return root


class StageCache:
    """Disk-backed prepped-canvas cache.

    ``dtype``: storage dtype (uint8 canvases are always stored as uint8).
    ``prep``: the tag of the prep whose canvases this cache holds.
    ``get``/``put`` never raise on I/O problems: a broken cache costs a
    re-decode, never a training run.
    """

    def __init__(self, root: str, prep: str, dtype: str = "float32"):
        self.root = root
        self.prep = prep
        self.dtype = np.dtype(dtype)
        os.makedirs(root, exist_ok=True)
        self.hits = 0
        self.misses = 0

    def _path(self, image_path: str, key_parts: tuple) -> str:
        try:
            st = os.stat(image_path)
            ident = (image_path, st.st_mtime_ns, st.st_size)
        except OSError:
            ident = (image_path,)
        raw = repr((_FORMAT_VERSION, self.prep, ident, key_parts,
                    self.dtype.str))
        h = hashlib.sha1(raw.encode()).hexdigest()
        return os.path.join(self.root, h[:2], h + ".npy")

    def has(self, image_path: str, key_parts: tuple) -> bool:
        """Whether a canvas is stored (no read, no hit or miss counted)."""
        return os.path.exists(self._path(image_path, key_parts))

    def get(self, image_path: str, key_parts: tuple) -> Optional[np.ndarray]:
        """The canvas on a hit (uint8 as stored, else float32), or None."""
        p = self._path(image_path, key_parts)
        try:
            arr = np.load(p, mmap_mode="r")
            # an owned copy: asarray would alias the memmap and pin its file
            if arr.dtype == np.uint8:
                out = np.array(arr, copy=True)
            else:
                out = np.array(arr, np.float32, copy=True)
            self.hits += 1
            return out
        except (OSError, ValueError, EOFError):
            self.misses += 1
            return None

    def put(self, image_path: str, key_parts: tuple,
            canvas: np.ndarray) -> None:
        p = self._path(image_path, key_parts)
        try:
            os.makedirs(os.path.dirname(p), exist_ok=True)
            fd, tmp = tempfile.mkstemp(dir=os.path.dirname(p), suffix=".tmp")
            try:
                with os.fdopen(fd, "wb") as f:
                    np.save(f, canvas.astype(self.dtype, copy=False))
                os.replace(tmp, p)
            except BaseException:
                try:
                    os.unlink(tmp)
                except OSError:
                    pass
                raise
        except OSError:
            pass  # full or read-only disk: this entry is not cached


def make_stage_cache(cfg) -> Optional[StageCache]:
    """The cache from config (``DATALOADER.STAGE_CACHE`` / ``STAGE_DIR`` /
    ``STAGE_DTYPE``, ``TPU.TRANSPORT_PIXELS``); None when disabled."""
    if not cfg.DATALOADER.STAGE_CACHE:
        return None
    transport = cfg.TPU.TRANSPORT_PIXELS
    dtype = "uint8" if transport == "uint8" else cfg.DATALOADER.STAGE_DTYPE
    root = cfg.DATALOADER.STAGE_DIR or default_stage_dir()
    try:
        return StageCache(root, PREP_TAGS[transport], dtype)
    except OSError:
        return None
