"""The hand-written kernels' forward launches as PyTorch operators
(``torch.library``, namespace ``da_detect``), so that ``torch.export`` can
trace the eval forward through them (a ``ctypes`` launch needs a real
pointer; a traced tensor has none) and an exported program calls them.

One operator a forward launch that the eval forward makes:

- ``nms_keep(boxes, valid, iou_threshold, max_keep)``: the NMS keep mask
  over score-sorted boxes (``max_keep`` 0: the whole mask);
- ``roi_align(features, rois, spatial_scale, output_size, sampling_ratio,
  max_samples)``: ROIAlign from one map;
- ``roi_align_levels(features, rois, levels, scales, ...)``: ROIAlign from
  up to four FPN levels in one launch;
- ``row_gather(table, idx)`` and ``row_gather_bulk(table, idx)``: the row
  gathers.

Each has three implementations. On CUDA it is the kernel's launch in its
wrapper module (``nms_cuda``, ``roi_align_cuda``, ``gather_cuda``): the
current stream, one count in ``kernels.LAUNCHES``. On the CPU it is the
plain version (``ops/nms.py``, ``ops/roi_align.py``, ``ops/gather.py``).
The fake implementation gives the output's shape, dtype and strides. The
wrappers check their inputs before they call an operator, so nothing else
reaches it: a tensor on another device raises there. The operators have no
autograd: training reaches the forward kernels through the wrappers'
autograd functions, and their backward kernels as before.

The operators are registered with ``torch.library.Library`` ``define`` and
``impl``: a call is one trip through the dispatcher to the Python kernel,
without ``custom_op``'s Python layers. Importing this module (``ops``
imports it) registers them and builds no kernel.
"""

from __future__ import annotations

import torch

from . import gather, gather_cuda, nms, nms_cuda, roi_align, roi_align_cuda

NAMESPACE = "da_detect"
LIB = torch.library.Library(NAMESPACE, "DEF")
LIB.define("nms_keep(Tensor boxes, Tensor valid, float iou_threshold, "
           "int max_keep) -> Tensor")
LIB.define("roi_align(Tensor features, Tensor rois, float spatial_scale, "
           "int output_size, int sampling_ratio, int max_samples) -> Tensor")
LIB.define("roi_align_levels(Tensor[] features, Tensor rois, Tensor levels, "
           "float[] scales, int output_size, int sampling_ratio, "
           "int max_samples) -> Tensor")
LIB.define("row_gather(Tensor table, Tensor idx) -> Tensor")
LIB.define("row_gather_bulk(Tensor table, Tensor idx) -> Tensor")


def _register(name: str, cuda, cpu, fake) -> None:
    LIB.impl(name, cuda, "CUDA")
    LIB.impl(name, cpu, "CPU")
    torch.library.register_fake(f"{NAMESPACE}::{name}", fake, lib=LIB)


# -- NMS -------------------------------------------------------------------
def _nms_cpu(boxes, valid, iou_threshold, max_keep):
    # contiguous: the plain mask is a view of its padded work
    return nms.nms_mask_sorted(boxes, valid, iou_threshold,
                               max_keep or None).contiguous()


def _nms_fake(boxes, valid, iou_threshold, max_keep):
    return boxes.new_empty(boxes.shape[:2], dtype=torch.bool)


_register("nms_keep", nms_cuda.launch, _nms_cpu, _nms_fake)


# -- ROIAlign forward ------------------------------------------------------
def _pooled_fake(features, rois, output_size):
    """[B, R, C, P, P] of the features' dtype: on the card the kernel's
    [B, R, P, P, C] memory, on the CPU the plain version's contiguous
    result."""
    b, c = features.shape[:2]
    r, p = rois.shape[1], output_size
    if features.device.type == "cuda":
        return features.new_empty((b, r, p, p, c)).permute(0, 1, 4, 2, 3)
    return features.new_empty((b, r, c, p, p))


def _roi_cuda(features, rois, spatial_scale, output_size, sampling_ratio,
              max_samples):
    return roi_align_cuda.launch_pool([features], rois, None,
                                      [spatial_scale], output_size,
                                      sampling_ratio, max_samples)


def _roi_cpu(features, rois, spatial_scale, output_size, sampling_ratio,
             max_samples):
    return roi_align.roi_align(features, rois, spatial_scale=spatial_scale,
                               output_size=output_size,
                               sampling_ratio=sampling_ratio,
                               max_samples=max_samples)


def _roi_fake(features, rois, spatial_scale, output_size, sampling_ratio,
              max_samples):
    return _pooled_fake(features, rois, output_size)


_register("roi_align", _roi_cuda, _roi_cpu, _roi_fake)


def _levels_cuda(features, rois, levels, scales, output_size,
                 sampling_ratio, max_samples):
    return roi_align_cuda.launch_pool(features, rois, levels, scales,
                                      output_size, sampling_ratio,
                                      max_samples)


def _levels_cpu(features, rois, levels, scales, output_size, sampling_ratio,
                max_samples):
    return roi_align.roi_align_levels(
        features, rois, levels, scales=scales, output_size=output_size,
        sampling_ratio=sampling_ratio, max_samples=max_samples)


def _levels_fake(features, rois, levels, scales, output_size,
                 sampling_ratio, max_samples):
    return _pooled_fake(features[0], rois, output_size)


_register("roi_align_levels", _levels_cuda, _levels_cpu, _levels_fake)


# -- row gathers -----------------------------------------------------------
def _gather_fake(table, idx):
    return table.new_empty((idx.shape[0], table.shape[1]))


for _name in (gather_cuda.GATHER, gather_cuda.BULK):
    _register(_name,
              lambda table, idx, _n=_name: gather_cuda.launch(_n, table, idx),
              gather.row_gather, _gather_fake)
