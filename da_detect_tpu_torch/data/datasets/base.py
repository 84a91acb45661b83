"""Dataset base protocol and path-list dataset (port of
``da_detect_tpu/data/datasets/base.py``).

``AbstractDataset`` (reference data/datasets/abstract.py:1-69) documents the
host-sample dict every dataset returns to the fixed-shape loader (see
``coco.py::COCODataset.sample``). ``init_maps`` mirrors the reference's
``initMaps`` class<->index mapping (abstract.py:38-60), background at 0.
``ListDataset`` (reference data/datasets/list_dataset.py:11-36) wraps a list
of image paths for label-free inference.
"""

from __future__ import annotations

import os

import numpy as np

from ..image_io import image_size

# fields every host sample must carry for the fixed-shape loader
SAMPLE_FIELDS = ("path", "image_id", "width", "height", "boxes", "labels",
                 "is_source")


class AbstractDataset:
    """Common interface for host-side datasets.

    A dataset implements ``__len__``, ``get_img_info(index) -> dict`` (at
    least width/height, WITHOUT decoding the image: the orientation buckets
    call it for every record up front), and ``sample(index) -> dict`` with
    the ``SAMPLE_FIELDS`` keys: numpy ``boxes [N,4]`` xyxy, ``labels [N]``
    contiguous ints (background=0), and the DA domain flag ``is_source``.
    """

    CLASSES: tuple = ()

    def __init__(self):
        self.name_to_id = None
        self.id_to_name = None

    def init_maps(self):
        """Class-name<->index maps; index 0 must be ``__background__``."""
        if not self.CLASSES or self.CLASSES[0] != "__background__":
            raise ValueError("CLASSES must start with '__background__'")
        self.name_to_id = {c: i for i, c in enumerate(self.CLASSES)}
        self.id_to_name = {i: c for i, c in enumerate(self.CLASSES)}

    def __len__(self):
        raise NotImplementedError

    def get_img_info(self, index):
        raise NotImplementedError

    def sample(self, index):
        raise NotImplementedError


class ListDataset(AbstractDataset):
    """A list of image paths for label-free inference, with the reference's
    dummy whole-image target (``BoxList([[0, 0, w, h]])``). Sizes are read
    without PIL (``image_io.image_size``: a PNG's header, cv2 for other
    formats), once an image, when first asked."""

    def __init__(self, image_paths, is_source: bool = True):
        super().__init__()
        self.image_paths = list(image_paths)
        self.is_source = is_source
        self._sizes = [None] * len(self.image_paths)

    def __len__(self):
        return len(self.image_paths)

    def _size(self, index):
        if self._sizes[index] is None:
            self._sizes[index] = image_size(self.image_paths[index])
        return self._sizes[index]

    def get_img_info(self, index):
        w, h = self._size(index)
        return dict(id=index, width=w, height=h,
                    file_name=os.path.basename(self.image_paths[index]))

    def sample(self, index):
        w, h = self._size(index)
        return dict(
            path=self.image_paths[index],
            image_id=index,
            width=w,
            height=h,
            boxes=np.asarray([[0.0, 0.0, w, h]], np.float32),
            labels=np.zeros((1,), np.int32),
            is_source=self.is_source,
        )
