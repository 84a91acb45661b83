"""Anchor generation (port of ``da_detect_tpu/models/anchors.py``).

Detectron-legacy cell anchors (the rounded sqrt/ratio enumeration with the +1
pixel convention) shifted over the feature grid. Everything is static given
the config and the canvas, so anchors are computed with numpy on the host.
"""

from __future__ import annotations

import numpy as np


def _whctrs(anchor):
    w = anchor[2] - anchor[0] + 1
    h = anchor[3] - anchor[1] + 1
    return w, h, anchor[0] + 0.5 * (w - 1), anchor[1] + 0.5 * (h - 1)


def _mkanchors(ws, hs, x_ctr, y_ctr):
    ws = ws[:, None]
    hs = hs[:, None]
    return np.hstack([x_ctr - 0.5 * (ws - 1), y_ctr - 0.5 * (hs - 1),
                      x_ctr + 0.5 * (ws - 1), y_ctr + 0.5 * (hs - 1)])


def _ratio_enum(anchor, ratios):
    w, h, x_ctr, y_ctr = _whctrs(anchor)
    size = w * h
    size_ratios = size / ratios
    ws = np.round(np.sqrt(size_ratios))
    hs = np.round(ws * ratios)
    return _mkanchors(ws, hs, x_ctr, y_ctr)


def _scale_enum(anchor, scales):
    w, h, x_ctr, y_ctr = _whctrs(anchor)
    return _mkanchors(w * scales, h * scales, x_ctr, y_ctr)


def generate_cell_anchors(stride: int, sizes, aspect_ratios) -> np.ndarray:
    """[A, 4] anchors for one stride (sizes given in absolute pixels)."""
    scales = np.array(sizes, dtype=np.float64) / stride
    ratios = np.array(aspect_ratios, dtype=np.float64)
    base = np.array([0, 0, stride - 1, stride - 1], dtype=np.float64)
    ratio_anchors = _ratio_enum(base, ratios)
    anchors = np.vstack([_scale_enum(ratio_anchors[i, :], scales)
                         for i in range(ratio_anchors.shape[0])])
    return anchors.astype(np.float32)


def grid_anchors(cell: np.ndarray, stride: int, fh: int, fw: int) -> np.ndarray:
    """Shift cell anchors over an fh x fw grid -> [fh*fw*A, 4]: row-major
    grid, A anchors a cell, the order of an [H, W, A] head output flatten."""
    shift_x = np.arange(fw, dtype=np.float32) * stride
    shift_y = np.arange(fh, dtype=np.float32) * stride
    sx, sy = np.meshgrid(shift_x, shift_y)
    shifts = np.stack([sx.ravel(), sy.ravel(), sx.ravel(), sy.ravel()], axis=1)
    out = (shifts[:, None, :] + cell[None, :, :]).reshape(-1, 4)
    return out.astype(np.float32)


class AnchorGenerator:
    """Per-level anchors for a fixed canvas: one stride and every size on it
    (the C4 layout), or one stride a level with that level's size (FPN)."""

    def __init__(self, sizes, aspect_ratios, strides):
        if len(strides) == 1:
            self.cells = [generate_cell_anchors(strides[0], sizes,
                                                aspect_ratios)]
        else:
            if len(strides) != len(sizes):
                raise ValueError("FPN anchors need one size per stride, got "
                                 f"{len(sizes)} sizes for {len(strides)} "
                                 "strides")
            self.cells = [
                generate_cell_anchors(
                    s, (sz,) if np.isscalar(sz) else sz, aspect_ratios)
                for s, sz in zip(strides, sizes)]
        self.strides = tuple(strides)

    @property
    def num_anchors_per_location(self) -> int:
        return self.cells[0].shape[0]

    def anchors_for_shapes(self, feature_shapes) -> list[np.ndarray]:
        """feature_shapes: [(fh, fw), ...] per level -> [N_l, 4] per level."""
        return [grid_anchors(c, s, fh, fw)
                for c, s, (fh, fw) in zip(self.cells, self.strides,
                                          feature_shapes)]


def make_anchor_generator(cfg) -> AnchorGenerator:
    rpn = cfg.MODEL.RPN
    return AnchorGenerator(rpn.ANCHOR_SIZES, rpn.ASPECT_RATIOS,
                           rpn.ANCHOR_STRIDE)


def retinanet_octave_sizes(cfg) -> tuple:
    """Per level, ``size * OCTAVE ** (i / SCALES_PER_OCTAVE)`` for i below
    ``SCALES_PER_OCTAVE``: the sizes of the RetinaNet anchor generator and
    of the model's anchors."""
    r = cfg.MODEL.RETINANET
    octave, spo = r.OCTAVE, r.SCALES_PER_OCTAVE
    return tuple(
        tuple(size * octave ** (i / float(spo)) for i in range(spo))
        for size in r.ANCHOR_SIZES)


def make_anchor_generator_retinanet(cfg) -> AnchorGenerator:
    r = cfg.MODEL.RETINANET
    return AnchorGenerator(retinanet_octave_sizes(cfg), r.ASPECT_RATIOS,
                           r.ANCHOR_STRIDES)
