"""Every YAML under ``configs/`` goes under the port's mesh: built on the
``meta`` device (shapes only, no memory), ``parallel.parallelize`` puts it
under a (data=1, space=2) mesh, with its backbone on row shards, and under
a (data=1, model=2) mesh, with its wide leaves split (JAX ``shard_model``'s
rule at 256 channels). A mesh without process groups places and swaps, and
runs nothing. This is the check that no configuration the JAX package runs
under ``TPU.MESH_SPATIAL`` or ``TPU.MESH_MODEL`` is refused by the port.
"""

import glob
import os

import pytest
import torch

from da_detect_tpu_torch import parallel
from da_detect_tpu_torch.config import get_cfg
from da_detect_tpu_torch.layers import DeformConv2d
from da_detect_tpu_torch.models import build_detection_model
from da_detect_tpu_torch.parallel.spatial import (MeshConv2d,
                                                  MeshDeformConv2d)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
YAMLS = sorted(os.path.relpath(p, REPO) for p in glob.glob(
    os.path.join(REPO, "configs", "**", "*.yaml"), recursive=True))


def _meta_model(yaml: str):
    cfg = get_cfg()
    cfg.merge_from_file(os.path.join(REPO, yaml))
    with torch.device("meta"):
        return build_detection_model(cfg)


def test_sweep_covers_every_config():
    assert len(YAMLS) == 78
    assert sum("fbnet" in y for y in YAMLS) == 7


@pytest.mark.parametrize("yaml", YAMLS)
def test_parallelize_accepts_config(yaml):
    """Under space=2 every convolution of the backbone computes on row
    shards and its parameters are the space-partial ones; under model=2
    ``split_plan(model, 2)`` splits some leaves, each module holding one
    keeps half of it (grouped and depthwise convs on group boundaries)."""
    model = _meta_model(yaml)
    parallel.parallelize(model, parallel.Mesh(2, 0, spatial=2))
    convs = [m for m in model.backbone.modules()
             if isinstance(m, (torch.nn.Conv2d, DeformConv2d))]
    assert convs and all(isinstance(m, (MeshConv2d, MeshDeformConv2d))
                         and m._rows for m in convs)
    assert len(model._space_partial) == len(
        [p for p in model.backbone.parameters() if p.requires_grad]) > 0

    model = _meta_model(yaml)
    whole = {n: tuple(p.shape) for n, p in model.named_parameters()}
    plan = parallel.split_plan(model, 2)
    assert plan
    parallel.parallelize(model, parallel.Mesh(2, 0, model=2))
    assert model._tp_plan == plan
    for n, p in model.named_parameters():
        want = list(whole[n])
        if n in plan:
            want[plan[n]] //= 2
        assert tuple(p.shape) == tuple(want), n
