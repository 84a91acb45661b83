"""Fixed-capacity box container (port of ``da_detect_tpu/structures/boxes.py``;
the reference's ``BoxList``).

``Boxes`` is a padded struct of tensors: a fixed capacity N of xyxy rows
[..., N, 4] float32 in the (padded) input image's frame, a validity mask
[..., N] and a dict of per-box fields [..., N, ...]. Every method returns a
new ``Boxes`` and keeps the mask; the geometry is ``ops/box_ops.py``'s.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from ..ops import box_ops


@dataclasses.dataclass
class Boxes:
    xyxy: torch.Tensor                 # [..., N, 4] float32
    valid: torch.Tensor                # [..., N] bool
    fields: Dict[str, torch.Tensor] = dataclasses.field(default_factory=dict)

    # -- construction ------------------------------------------------------
    @classmethod
    def empty(cls, capacity: int, batch_shape: tuple = (), device=None,
              **fields) -> "Boxes":
        shape = (*batch_shape, capacity)
        return cls(xyxy=torch.zeros((*shape, 4), device=device),
                   valid=torch.zeros(shape, dtype=torch.bool, device=device),
                   fields=dict(fields))

    @property
    def capacity(self) -> int:
        return self.xyxy.shape[-2]

    def num_valid(self) -> torch.Tensor:
        return self.valid.sum(-1)

    def replace(self, **changes) -> "Boxes":
        return dataclasses.replace(self, **changes)

    # -- fields ------------------------------------------------------------
    def with_fields(self, **new_fields) -> "Boxes":
        return self.replace(fields={**self.fields, **new_fields})

    def get_field(self, name: str) -> torch.Tensor:
        return self.fields[name]

    def has_field(self, name: str) -> bool:
        return name in self.fields

    # -- geometry (BoxList.resize / transpose / clip / area) ---------------
    def area(self, legacy_plus1: bool = True) -> torch.Tensor:
        return torch.where(self.valid,
                           box_ops.box_area(self.xyxy, legacy_plus1), 0.0)

    def scale(self, scale_y, scale_x) -> "Boxes":
        return self.replace(
            xyxy=box_ops.scale_boxes(self.xyxy, scale_y, scale_x))

    def hflip(self, image_width) -> "Boxes":
        """Horizontal flip within a frame ``image_width`` wide (BoxList's
        ``transpose(FLIP_LEFT_RIGHT)``)."""
        return self.replace(xyxy=box_ops.hflip_boxes(self.xyxy, image_width))

    def clip_to_image(self, height, width) -> "Boxes":
        return self.replace(xyxy=box_ops.clip_boxes(self.xyxy, height, width))

    def prune_small(self, min_size: float,
                    legacy_plus1: bool = True) -> "Boxes":
        keep = box_ops.min_size_mask(self.xyxy, min_size, legacy_plus1)
        return self.replace(valid=self.valid & keep)

    # -- gather (BoxList.__getitem__ with index tensors) -------------------
    def take(self, indices: torch.Tensor,
             indices_valid: torch.Tensor | None = None) -> "Boxes":
        """Rows along the box axis; ``indices`` [..., K] integer. A field of
        more dims than the mask is taken along the same axis."""
        indices = indices.long()
        axis = indices.dim() - 1
        xyxy = torch.gather(self.xyxy, axis, indices[..., None].expand(
            *indices.shape, 4))
        valid = torch.gather(self.valid, axis, indices)
        if indices_valid is not None:
            valid = valid & indices_valid
        fields = {}
        for k, v in self.fields.items():
            idx = indices
            if v.dim() > valid.dim():
                extra = v.shape[valid.dim():]
                idx = indices.reshape(indices.shape + (1,) * len(extra)
                                      ).expand(*indices.shape, *extra)
            fields[k] = torch.gather(v, axis, idx)
        return Boxes(xyxy=xyxy, valid=valid, fields=fields)


def concat_boxes(boxes: list) -> Boxes:
    """Concatenate along the capacity axis (``cat_boxlist``)."""
    keys = set(boxes[0].fields)
    if not all(set(b.fields) == keys for b in boxes):
        raise ValueError("field mismatch in concat_boxes")
    axis = boxes[0].valid.dim() - 1
    return Boxes(
        xyxy=torch.cat([b.xyxy for b in boxes], dim=-2),
        valid=torch.cat([b.valid for b in boxes], dim=-1),
        fields={k: torch.cat([b.fields[k] for b in boxes], dim=axis)
                for k in keys})
