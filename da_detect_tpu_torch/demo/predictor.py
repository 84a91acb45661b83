"""Single-image serving (port of ``da_detect_tpu/demo/predictor.py``;
reference demo/predictor.py COCODemo:14-447).

``COCODemo(cfg)`` builds the model of ``cfg`` on the card (``device="cpu"``
for the CPU's plain versions), with random weights from seed 0 or the
weights of ``weight`` / ``MODEL.WEIGHT`` (``utils.checkpoint
.load_weight_file``). ``compute_prediction(img_bgr)`` -> detections above
the confidence threshold in the original image's coordinates;
``run_on_opencv_image(img_bgr)`` -> the image with them drawn.

Preparation is the port's loader's: the short side resized to
``INPUT.MIN_SIZE_TEST`` (the long one at most ``MAX_SIZE_TEST``), padded
into the eval canvas, its portrait transpose for a portrait image, uint8
pixels normalized on the device (``TPU.TRANSPORT_PIXELS``, or float32
normalized on the host). The forward runs the mask head (``MASK_ON``) or
else the keypoint head (``KEYPOINT_ON``) over the final detections.

The overlays (per-class coloured boxes, mask contours, the mask
probability heatmap montage, person-17 keypoint skeletons with the two
virtual bones, class names) draw with OpenCV; without ``cv2`` they raise
and name it.
"""

from __future__ import annotations

import numpy as np
import torch

from ..data.masker import paste_masks
from ..data.transforms import (canvas_for, compute_resize_hw,
                               normalize_and_pad, resize_flip_pad_u8)
from ..entry import prepare_model, resolve_device
from ..models import build_detection_model
from ..structures.image_batch import ImageBatch
from ..utils.checkpoint import load_weight_file

try:
    import cv2
except Exception:  # pragma: no cover - a machine without OpenCV
    cv2 = None

CITYSCAPES_CATEGORIES = ["__background__", "person", "rider", "car", "truck",
                         "bus", "train", "motorcycle", "bicycle"]

# COCO person-17 skeleton (reference structures/keypoint.py kp_connections)
PERSON_KP_CONNECTIONS = [
    (1, 2), (1, 0), (2, 0), (2, 4), (1, 3), (6, 8), (8, 10), (5, 7), (7, 9),
    (12, 14), (14, 16), (11, 13), (13, 15), (6, 5), (12, 11),
]


def require_cv2():
    """The ``cv2`` module, or a RuntimeError that names it."""
    if cv2 is None:
        raise RuntimeError("the demo's overlays and image files need OpenCV "
                           "(the cv2 module, package opencv-python), which "
                           "this Python cannot import")
    return cv2


class COCODemo:
    def __init__(self, cfg, confidence_threshold: float = 0.7,
                 weight: str | None = None, categories=None,
                 show_mask_heatmaps: bool = False, masks_per_dim: int = 2,
                 device=None):
        self.cfg = cfg
        self.confidence_threshold = confidence_threshold
        self.categories = categories or CITYSCAPES_CATEGORIES
        self.show_mask_heatmaps = show_mask_heatmaps
        self.masks_per_dim = masks_per_dim
        self.with_masks = bool(cfg.MODEL.MASK_ON)
        self.with_keypoints = bool(cfg.MODEL.KEYPOINT_ON) \
            and not self.with_masks
        self.device = resolve_device(device)
        model = build_detection_model(cfg)
        weight = weight or cfg.MODEL.WEIGHT
        if weight:
            load_weight_file(weight, model,
                             cfg.MODEL.ROI_BOX_HEAD.POOLER_RESOLUTION)
        self.model = prepare_model(model, self.device)
        self.canvas = canvas_for(cfg, is_train=False)

    def prepare(self, original_bgr: np.ndarray) -> ImageBatch:
        """An image (uint8 BGR [H, W, 3]) as a batch of one on the model's
        device: resized, padded into the canvas of its orientation."""
        h0, w0 = original_bgr.shape[:2]
        rh, rw = compute_resize_hw(h0, w0, self.cfg.INPUT.MIN_SIZE_TEST,
                                   self.cfg.INPUT.MAX_SIZE_TEST)
        canvas = self.canvas if rh <= rw else (self.canvas[1],
                                               self.canvas[0])
        img = resize_flip_pad_u8(original_bgr, canvas, rh, rw, False)
        if self.cfg.TPU.TRANSPORT_PIXELS == "float32":
            img = normalize_and_pad(img, rh, rw, self.cfg.INPUT.PIXEL_MEAN,
                                    self.cfg.INPUT.TO_BGR255,
                                    self.cfg.INPUT.PIXEL_STD)
        return ImageBatch(
            images=torch.from_numpy(img)[None].permute(0, 3, 1, 2),
            sizes=torch.tensor([[rh, rw]], dtype=torch.int32),
            orig_sizes=torch.tensor([[h0, w0]], dtype=torch.int32),
            is_source=torch.ones(1, dtype=torch.bool)).to(self.device)

    def predict(self, batch: ImageBatch):
        """The forward on a prepared batch of one, thresholded and rescaled
        to its original image: (boxes, scores, labels) numpy, and with the
        mask head (masks: full-frame bool [D, H, W], the probabilities
        [D, Hm, Wm]), or with the keypoint head the keypoints [D, K, 3]
        (x, y, score)."""
        out = self.model(batch, with_masks=self.with_masks,
                         with_keypoints=self.with_keypoints)
        dets, extra = out if (self.with_masks or self.with_keypoints) \
            else (out, None)
        (rh, rw), (h0, w0) = (batch.sizes[0].tolist(),
                              batch.orig_sizes[0].tolist())
        keep = (dets.valid[0] & (dets.scores[0] >= self.confidence_threshold)
                ).cpu().numpy()
        scale = np.array([w0 / rw, h0 / rh, w0 / rw, h0 / rh], np.float32)
        boxes = dets.boxes[0].cpu().numpy()[keep] * scale
        scores = dets.scores[0].cpu().numpy()[keep]
        labels = dets.labels[0].cpu().numpy()[keep]
        if self.with_masks:
            probs = extra[0].cpu().numpy()[keep]
            return (boxes, scores, labels, paste_masks(probs, boxes,
                                                       (h0, w0)), probs)
        if self.with_keypoints:
            kps = extra[0].cpu().numpy()[keep].astype(np.float32)
            kps[..., 0] *= w0 / rw
            kps[..., 1] *= h0 / rh
            return boxes, scores, labels, kps
        return boxes, scores, labels

    def compute_prediction(self, original_bgr: np.ndarray):
        """(boxes, scores, labels[, masks, probabilities | keypoints]) of
        an image, in its own coordinates (``predict``)."""
        return self.predict(self.prepare(original_bgr))

    # -- overlays (reference demo/predictor.py:264-447) -------------------

    def compute_colors_for_labels(self, labels: np.ndarray) -> list:
        """A fixed colour a class (the reference's palette)."""
        palette = np.array([2 ** 25 - 1, 2 ** 15 - 1, 2 ** 21 - 1],
                           np.int64)
        return (np.asarray(labels, np.int64)[:, None] * palette
                % 255).astype(np.uint8).tolist()

    def overlay_boxes(self, image, boxes, labels):
        cv = require_cv2()
        for box, color in zip(boxes, self.compute_colors_for_labels(labels)):
            x1, y1, x2, y2 = (int(v) for v in box)
            cv.rectangle(image, (x1, y1), (x2, y2),
                         tuple(int(c) for c in color), 2)
        return image

    def overlay_mask(self, image, masks, labels):
        """Each instance's contours in its class's colour."""
        cv = require_cv2()
        for mask, color in zip(masks, self.compute_colors_for_labels(labels)):
            contours, _ = cv.findContours(mask.astype(np.uint8),
                                          cv.RETR_TREE,
                                          cv.CHAIN_APPROX_SIMPLE)
            cv.drawContours(image, contours, -1,
                            tuple(int(c) for c in color), 3)
        return image

    def create_mask_montage(self, mask_probs):
        """The first masks_per_dim ** 2 probability maps in a grid,
        JET colormap."""
        cv = require_cv2()
        d = self.masks_per_dim
        hm, wm = mask_probs.shape[-2:] if len(mask_probs) else (14, 14)
        probs = np.zeros((d * d, hm, wm), np.float32)
        if len(mask_probs):
            probs[:min(len(mask_probs), d * d)] = \
                mask_probs[:d * d].reshape(-1, hm, wm)
        rows = [np.concatenate(list(probs[y * d:(y + 1) * d]), axis=1)
                for y in range(d)]
        montage = (np.concatenate(rows, axis=0) * 255).astype(np.uint8)
        return cv.applyColorMap(montage, cv.COLORMAP_JET)

    def overlay_keypoints(self, image, keypoints, kp_thresh: float = 0.0,
                          alpha: float = 0.7):
        """Each person's skeleton and joints in rainbow colours,
        alpha-blended, with the person-17 virtual bones mid-shoulder to
        nose and mid-shoulder to mid-hip (reference vis_keypoints)."""
        cv = require_cv2()
        n_lines = len(PERSON_KP_CONNECTIONS)
        grad = np.linspace(0, 255, n_lines + 2).astype(np.uint8)[None]
        colors = [tuple(int(v) for v in c)
                  for c in cv.applyColorMap(grad, cv.COLORMAP_RAINBOW)[0]]
        canvas = image.copy()
        for kp in keypoints:
            if kp.shape[0] >= 17:
                mid_sh = (kp[5, :2] + kp[6, :2]) / 2
                sc_sh = min(kp[5, 2], kp[6, 2])
                mid_hip = (kp[11, :2] + kp[12, :2]) / 2
                sc_hip = min(kp[11, 2], kp[12, 2])
                if sc_sh > kp_thresh and kp[0, 2] > kp_thresh:
                    cv.line(canvas, tuple(mid_sh.astype(int)),
                            tuple(kp[0, :2].astype(int)), colors[n_lines],
                            2, cv.LINE_AA)
                if sc_sh > kp_thresh and sc_hip > kp_thresh:
                    cv.line(canvas, tuple(mid_sh.astype(int)),
                            tuple(mid_hip.astype(int)), colors[n_lines + 1],
                            2, cv.LINE_AA)
            for li, (i1, i2) in enumerate(PERSON_KP_CONNECTIONS):
                if i1 >= kp.shape[0] or i2 >= kp.shape[0]:
                    continue
                p1 = tuple(kp[i1, :2].astype(int))
                p2 = tuple(kp[i2, :2].astype(int))
                if kp[i1, 2] > kp_thresh and kp[i2, 2] > kp_thresh:
                    cv.line(canvas, p1, p2, colors[li], 2, cv.LINE_AA)
                if kp[i1, 2] > kp_thresh:
                    cv.circle(canvas, p1, 3, colors[li], -1, cv.LINE_AA)
                if kp[i2, 2] > kp_thresh:
                    cv.circle(canvas, p2, 3, colors[li], -1, cv.LINE_AA)
        return cv.addWeighted(image, 1.0 - alpha, canvas, alpha, 0)

    def overlay_class_names(self, image, boxes, scores, labels):
        cv = require_cv2()
        for box, score, label in zip(boxes, scores, labels):
            x1, y1 = int(box[0]), int(box[1])
            name = (self.categories[label] if label < len(self.categories)
                    else str(int(label)))
            cv.putText(image, f"{name}: {score:.2f}", (x1, max(y1 - 4, 10)),
                       cv.FONT_HERSHEY_SIMPLEX, 0.5, (255, 0, 0), 1)
        return image

    def run_on_opencv_image(self, original_bgr: np.ndarray) -> np.ndarray:
        """The image with its detections drawn (or, with
        ``show_mask_heatmaps``, the mask probability montage)."""
        require_cv2()
        pred = self.compute_prediction(original_bgr)
        boxes, scores, labels = pred[0], pred[1], pred[2]
        if self.with_masks and self.show_mask_heatmaps:
            return self.create_mask_montage(pred[4])
        out = self.overlay_boxes(original_bgr.copy(), boxes, labels)
        if self.with_masks:
            out = self.overlay_mask(out, pred[3], labels)
        if self.with_keypoints:
            out = self.overlay_keypoints(out, pred[3])
        return self.overlay_class_names(out, boxes, scores, labels)
