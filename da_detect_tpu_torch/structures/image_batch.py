"""Static-shape image batch + padded targets (port of
``da_detect_tpu/structures/image_batch.py``).

Every batch is one fixed canvas. Images are logical NCHW ``[B, 3, H, W]``
held in ``torch.channels_last`` memory, so the convolutions and the ROIAlign
kernel read channels as the contiguous axis. A numpy ``[B, H, W, 3]`` canvas
becomes such a tensor with ``torch.from_numpy(x).permute(0, 3, 1, 2)`` and no
copy. The batch layout convention is the JAX package's: sources first.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass
class ImageBatch:
    # [B, 3, H, W]: float (already normalized on host, Caffe2 BGR-255
    # convention) OR uint8 raw pixels, normalized on the device by
    # `normalized()`
    images: torch.Tensor
    sizes: torch.Tensor       # [B, 2] int32 (valid h, w) within the canvas
    orig_sizes: torch.Tensor  # [B, 2] int32 original (pre-resize) h, w
    is_source: torch.Tensor   # [B] bool — domain flag per image

    def normalized(self, pixel_mean, pixel_std=(1.0, 1.0, 1.0),
                   to_bgr255: bool = True) -> torch.Tensor:
        """float32 normalized canvas. uint8 pixels get the host pipeline's
        affine in f32, and the canvas padding is forced to exact 0.0 (the
        host path pads after normalizing). Float images pass through."""
        imgs = self.images
        if imgs.dtype != torch.uint8:
            return imgs
        x = imgs.float()
        if not to_bgr255:
            x = x.flip(1) / 255.0  # torch convention: RGB 0-1
        mean = torch.tensor(pixel_mean, dtype=torch.float32,
                            device=x.device).view(1, -1, 1, 1)
        std = torch.tensor(pixel_std, dtype=torch.float32,
                           device=x.device).view(1, -1, 1, 1)
        x = (x - mean) / std
        h, w = imgs.shape[2], imgs.shape[3]
        sizes = self.sizes.to(x.device)
        yy = torch.arange(h, device=x.device)[None, :, None]
        xx = torch.arange(w, device=x.device)[None, None, :]
        mask = ((yy < sizes[:, 0, None, None])
                & (xx < sizes[:, 1, None, None]))
        return (x * mask[:, None]).contiguous(
            memory_format=torch.channels_last)

    def to(self, device) -> "ImageBatch":
        return ImageBatch(**{f.name: getattr(self, f.name).to(device)
                             for f in dataclasses.fields(self)})


# M, the side of the GT masks' box frame (``Targets.masks``)
MASK_RESOLUTION = 112


@dataclasses.dataclass
class Targets:
    """Padded ground-truth boxes per image (capacity G = TPU.MAX_GT_BOXES).

    ``masks`` (MASK_ON training only): each instance's binary mask
    rasterized in its own GT box's frame at a fixed resolution M
    (MASK_RESOLUTION),
    [B, G, M, M] float32; the mask loss resamples them into the proposals'
    frames (``models/mask_head.py::project_gt_masks``). None: no masks (the
    DA loaders carry none).

    ``keypoints`` (KEYPOINT_ON training only): each instance's K keypoints
    as (x, y, visibility) in the resized/padded frame, [B, G, K, 3]
    float32, rows with visibility 0 all zeros. None: no keypoints."""

    boxes: torch.Tensor   # [B, G, 4] float32 xyxy in the resized/padded frame
    labels: torch.Tensor  # [B, G] int64 (1..C-1; 0 reserved for background)
    valid: torch.Tensor   # [B, G] bool
    masks: Optional[torch.Tensor] = None  # [B, G, M, M] float32, box frame
    keypoints: Optional[torch.Tensor] = None  # [B, G, K, 3] float32

    def to(self, device) -> "Targets":
        return Targets(**{f.name: None if getattr(self, f.name) is None
                          else getattr(self, f.name).to(device)
                          for f in dataclasses.fields(self)})
