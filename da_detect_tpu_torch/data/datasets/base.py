"""Dataset base protocol (port of ``da_detect_tpu/data/datasets/base.py``).

``AbstractDataset`` (reference data/datasets/abstract.py:1-69) documents the
host-sample dict every dataset returns to the fixed-shape loader (see
``coco.py::COCODataset.sample``). ``init_maps`` mirrors the reference's
``initMaps`` class<->index mapping (abstract.py:38-60), background at 0.
"""

from __future__ import annotations

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
