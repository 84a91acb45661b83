"""The kernels' operators (``ops/library.py``) on the CPU: each passes
``torch.library.opcheck`` (schema, fake implementation against the CPU
implementation, autograd registration, tracing with dynamic shapes); the
wrappers reach them for a CPU tensor that needs no gradient, with the plain
versions' results bit for bit, and keep the plain versions' autograd where
one is needed."""

from collections import Counter

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from da_detect_tpu_torch.ops import gather, gather_cuda, library, nms
from da_detect_tpu_torch.ops import nms_cuda, roi_align, roi_align_cuda


def _boxes(rng, b, n, side=40.0):
    xy = rng.uniform(0, 60, (b, n, 2))
    wh = rng.uniform(2, side, (b, n, 2))
    return torch.from_numpy(np.concatenate([xy, xy + wh], -1)
                            .astype(np.float32))


def _map(rng, b, c, h, w, dtype=torch.float32):
    x = torch.from_numpy(rng.randn(b, h, w, c).astype(np.float32))
    return x.to(dtype).permute(0, 3, 1, 2)


def _cases():
    rng = np.random.RandomState(0)
    boxes = _boxes(rng, 2, 70)
    valid = torch.from_numpy(rng.rand(2, 70) > 0.2)
    feats = _map(rng, 2, 8, 12, 16)
    rois = _boxes(rng, 2, 5, 20.0) / 4
    levels = torch.from_numpy(rng.randint(0, 2, (2, 5)))
    small = _map(rng, 2, 8, 6, 8)
    table = torch.from_numpy(rng.randn(20, 8).astype(np.float32))
    idx = torch.from_numpy(rng.randint(-3, 24, 30).astype(np.int32))
    ops = torch.ops.da_detect
    return {
        "nms_keep": (ops.nms_keep, (boxes, valid, 0.5, 0)),
        "nms_keep_max_keep": (ops.nms_keep, (boxes, valid, 0.5, 4)),
        "roi_align": (ops.roi_align, (feats, rois, 0.5, 3, 2, 8)),
        "roi_align_bf16": (ops.roi_align,
                           (feats.to(torch.bfloat16), rois, 0.5, 3, 0, 4)),
        "roi_align_levels": (ops.roi_align_levels,
                             ([feats, small], rois, levels, [0.5, 0.25], 3,
                              0, 8)),
        "row_gather": (ops.row_gather, (table, idx)),
        "row_gather_bulk": (ops.row_gather_bulk, (table[:, :4], idx)),
    }


CASES = _cases()


@pytest.mark.parametrize("case", sorted(CASES))
def test_opcheck(case):
    op, args = CASES[case]
    results = torch.library.opcheck(op, args)
    assert set(results.values()) == {"SUCCESS"}, results


def test_one_operator_a_forward_kernel_launch():
    assert library.NAMESPACE == "da_detect"
    defined = {name for name in dir(torch.ops.da_detect)
               if isinstance(getattr(torch.ops.da_detect, name),
                             torch._ops.OpOverloadPacket)}
    assert defined == {"nms_keep", "roi_align", "roi_align_levels",
                       "row_gather", "row_gather_bulk"}


class _Calls(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.counts = Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if str(func).startswith("da_detect."):
            self.counts[str(func).split(".")[1]] += 1
        return func(*args, **(kwargs or {}))


def test_wrappers_reach_the_operators_on_the_cpu():
    """A wrapper on CPU tensors that need no gradient calls its operator,
    whose result is the plain version's."""
    rng = np.random.RandomState(1)
    boxes, valid = _boxes(rng, 2, 300), torch.ones(2, 300, dtype=torch.bool)
    feats = _map(rng, 1, 8, 12, 16).contiguous(
        memory_format=torch.channels_last)
    rois = _boxes(rng, 1, 6, 20.0) / 4
    levels = torch.from_numpy(rng.randint(0, 2, (1, 6)))
    table = torch.from_numpy(rng.randn(20, 8).astype(np.float32))
    idx = torch.from_numpy(rng.randint(0, 20, 25).astype(np.int32))
    kw = dict(output_size=3, sampling_ratio=2)
    pairs = [
        (lambda: nms_cuda.nms_mask_sorted(boxes, valid, 0.5, 7),
         lambda: nms.nms_mask_sorted(boxes, valid, 0.5, 7)),
        (lambda: roi_align_cuda.roi_align(feats, rois, spatial_scale=0.5,
                                          **kw),
         lambda: roi_align.roi_align(feats, rois, spatial_scale=0.5, **kw)),
        (lambda: roi_align_cuda.roi_align_levels(
            [feats, feats[:, :, ::2, ::2]], rois, levels,
            scales=[0.5, 0.25], **kw),
         lambda: roi_align.roi_align_levels(
            [feats, feats[:, :, ::2, ::2]], rois, levels,
            scales=[0.5, 0.25], **kw)),
        (lambda: gather_cuda.row_gather(table, idx),
         lambda: gather.row_gather(table, idx)),
        (lambda: gather_cuda.row_gather_bulk(table, idx),
         lambda: gather.row_gather(table, idx)),
    ]
    with _Calls() as calls:
        got = [wrapper() for wrapper, _ in pairs]
    assert calls.counts == {"nms_keep": 1, "roi_align": 1,
                            "roi_align_levels": 1, "row_gather": 1,
                            "row_gather_bulk": 1}
    for out, (_, plain) in zip(got, pairs):
        torch.testing.assert_close(out, plain(), rtol=0, atol=0)


def test_wrappers_keep_autograd_on_the_cpu():
    """Where a gradient is needed the CPU wrappers run the plain versions
    under autograd (no operator), with the plain versions' gradients."""
    rng = np.random.RandomState(2)
    feats = _map(rng, 1, 8, 12, 16).contiguous(
        memory_format=torch.channels_last)
    rois = _boxes(rng, 1, 6, 20.0) / 4
    table = torch.from_numpy(rng.randn(20, 8).astype(np.float32))
    idx = torch.from_numpy(rng.randint(0, 20, 25).astype(np.int32))
    grads = []
    for fn in (lambda f, t: (roi_align_cuda.roi_align(
                   f, rois, spatial_scale=0.5, output_size=3).sum()
               + gather_cuda.row_gather(t, idx).square().sum()),
               lambda f, t: (roi_align.roi_align(
                   f, rois, spatial_scale=0.5, output_size=3).sum()
               + gather.row_gather(t, idx).square().sum())):
        f = feats.clone().requires_grad_()
        t = table.clone().requires_grad_()
        with _Calls() as calls:
            fn(f, t).backward()
        assert not calls.counts
        grads.append((f.grad, t.grad))
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
