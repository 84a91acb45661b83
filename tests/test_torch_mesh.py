"""The port's (data, space, model) mesh (``da_detect_tpu_torch/parallel``:
``mesh.py``, ``spatial.py``, ``tensor.py``) against the JAX package's
``parallel/mesh.py`` and its 1-device step.

(a) mesh folding and (b) batch placement against JAX's ``make_mesh`` and
``shard_batch`` on conftest's 8 CPU devices; (c) ``split_plan`` leaf for
leaf against JAX ``shard_model``'s ``params`` placement; (d) the tiny
flagship triplet step, 3 steps, under (data=2, space=2), (data=2, model=2)
and (data=1, space=2, model=2) on 4 gloo ranks, held to JAX's 1-device step
on the same global batch with the JAX tests' tolerances
(tests/test_spatial_partition.py, tests/test_tensor_parallel.py) and to the
port's single process with tests/test_torch_ddp.py's bounds; (e) the
narrowed FPN-DCN's eval forward (depth 50, grouped and deformable convs)
under three meshes against JAX's ``__call__``; (f) a checkpoint written
under model=2 against one process's, and its resume; (g) DDP over the whole
world under model=2 fails (d)'s comparison; (h) FBNet: SAME padding and a
conv on row shards, the trunks on row shards against one process, and the
narrowed FBNet Mask R-CNN (tests/test_torch_fbnet.py::fbnet_cfgs) under
three meshes: its eval forward against JAX's on one device and on JAX's
own space mesh, its source-only step against one process and against the
gradients of JAX's ``train_forward`` (the JAX trainer cannot step FBNet),
with tests/test_torch_fbnet.py's tolerances.

The ranks import no JAX (``tests/torch_mesh_ranks.py``); one module-scoped
spawn of 4 ranks runs every piece. The step's budgets (from
tests/test_torch_ddp.py) exceed every candidate pool, so each sampler takes
what the single step's takes; dropout is off. The model split uses
``min_channels`` 32 (the narrowed widths; JAX's rule with the same
threshold) so that most of the body is split, and the DCN forward 16.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from da_detect_tpu.config import get_cfg as j_get_cfg
from da_detect_tpu.engine.trainer import TrainState as JTrainState
from da_detect_tpu.engine.trainer import make_train_step as j_make_train_step
from da_detect_tpu.models import build_detection_model as j_build_model
from da_detect_tpu.models.da import DAState as JDAState
from da_detect_tpu.parallel import make_mesh as j_make_mesh
from da_detect_tpu.parallel import replicate as j_replicate
from da_detect_tpu.parallel import shard_batch as j_shard_batch
from da_detect_tpu.parallel import shard_model as j_shard_model
from da_detect_tpu.solver.optim import make_optimizer as j_make_optimizer
from da_detect_tpu_torch import parallel
from da_detect_tpu_torch.config import get_cfg
from da_detect_tpu_torch.engine.trainer import (create_train_state,
                                                make_train_step)
from da_detect_tpu_torch.entry import DCN_YAML, make_batch, prepare_model
from da_detect_tpu_torch.models import build_detection_model
from da_detect_tpu_torch.parallel.spatial import row_range
from da_detect_tpu_torch.utils.weights import (jax_state_dict,
                                               load_jax_variables,
                                               torch_name)
from tests.test_torch_ddp import (SCORE_SCALES, _global_batch, _plain,
                                  _step_cfgs, _to_port)
from tests.torch_harness import (assert_grads_match, assert_losses_match,
                                 assert_twins, cfg_fc6_chw, mask_batches,
                                 port_step_one, random_variables, tiny_cfgs)
from tests.test_torch_cli import tiny  # noqa: F401 (the fixture)
from tests.test_torch_fbnet import MASK_YAML as FBNET_YAML
from tests.test_torch_fbnet import _variables as fbnet_jax_variables
from tests.test_torch_fbnet import fbnet_cfgs
from tests.torch_mesh_ranks import SAME_PAD_HEIGHTS, rank_work

WORLD, STEPS = 4, 3
STEP_MIN, DCN_MIN = 32, 16
# JAX's tolerances: (rtol, atol) after step 1 and after STEPS steps
JAX_TOL = {"space": ((1e-4, 1e-6), (3e-4, 3e-6)),
           "model": ((1e-3, 1e-5), (3e-3, 3e-5)),
           "space_model": ((1e-3, 1e-5), (3e-3, 3e-5))}
MESHES = (("space", 2, 1), ("model", 1, 2), ("space_model", 2, 2))
DCN_MESHES = (("space", 2, 1), ("model", 1, 2), ("space_model", 2, 2))
# FBNet: the Mask R-CNN's eval forward and its source-only step; the model
# split at 32 channels (most expansions and depthwise convs of the narrowed
# widths)
FBNET_MESHES = DCN_MESHES
FBNET_STEP_MESHES = (("space", 2, 1), ("model", 1, 2))
FBNET_MIN = 32
# the mesh's scores against JAX's: two roundings of test_torch_fbnet.py's
# 1e-5. The predictor's class weights are spread x30, so a float32 rounding
# of a logit moves a mid-range score by ~1e-5: the port's single process is
# 9.5e-6 off JAX's one device on these inputs, JAX's space mesh 4.8e-6 off
# it, the port's space mesh 9.5e-6 off the port's single process and up to
# 1.25e-5 off either JAX run
FBNET_JAX_SCORE_ATOL = 2e-5
SAME_PAD_CASES = [(k, s) for k in (3, 5, 7) for s in (1, 2)]
MARGIN_ATOL = 1e-6
# the port's single process: tests/test_torch_ddp.py's bounds
LOSS_RTOL, PARAM_REL = 1e-4, 1e-3
CPU = torch.device("cpu")
DCN_SCALES = {"rpn_head/cls_logits/kernel": 30.0,
              "predictor/cls_score/kernel": 30.0,
              "rpn_head/bbox_pred/kernel": 0.1,
              "predictor/bbox_pred/kernel": 0.1,
              "conv_offset/kernel": 0.1}


@pytest.fixture(scope="module", autouse=True)
def _threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ------------------------------------------------------ (a) (b) (c)

@pytest.mark.parametrize("spatial,model", [(1, 1), (2, 1), (4, 1), (1, 2),
                                           (2, 2), (1, 4)])
def test_mesh_folds_as_jax(spatial, model):
    """The ranks' grid, axis names and sizes equal JAX ``make_mesh(8)``'s
    devices (ids); model varies fastest, then space."""
    want = j_make_mesh(8, spatial=spatial, model=model)
    got = parallel.make_mesh(8, spatial=spatial, model=model)
    assert got.axis_names == want.axis_names
    assert got.shape == dict(want.shape)
    ids = np.vectorize(lambda d: d.id)(want.devices)
    np.testing.assert_array_equal(got.devices, ids)
    for r in range(8):
        mesh = parallel.make_mesh(8, spatial=spatial, model=model, rank=r)
        d, s, m = mesh.coords
        assert mesh.grid[d, s, m] == r
    assert parallel.model_axis_size(got) == model
    assert parallel.data_axis_size(got) == 8 // (spatial * model)


def test_make_mesh_not_divisible():
    for kw in (dict(spatial=3), dict(spatial=3, model=2)):
        with pytest.raises(ValueError, match="not divisible"):
            j_make_mesh(8, **kw)
        with pytest.raises(ValueError, match="not divisible"):
            parallel.make_mesh(8, **kw)
    with pytest.raises(ValueError, match="not divisible"):
        parallel.check_divisible(
            6, parallel.data_axis_size(parallel.make_mesh(8, spatial=2)))


@pytest.mark.parametrize("spatial,model", [(4, 1), (2, 2)])
def test_shard_batch_places_as_jax(spatial, model):
    """Rank r's rows of every field equal JAX's addressable shard on device
    r: images over data and space (H), the rest over data."""
    jcfg, pcfg = tiny_cfgs()
    jbatch, jtargets = graft._batch(jcfg, 4, seed=0)
    pbatch, ptargets = make_batch(pcfg, 4, seed=0)
    mesh = j_make_mesh(8, spatial=spatial, model=model)
    jb, jt = j_shard_batch((jbatch, jtargets), mesh)
    for r in range(8):
        b, t = parallel.shard_batch(
            (pbatch, ptargets), parallel.make_mesh(8, spatial, model, rank=r))

        def on(arr):
            return np.asarray(next(s.data for s in arr.addressable_shards
                                   if s.device.id == r))
        np.testing.assert_array_equal(b.images.permute(0, 2, 3, 1).numpy(),
                                      on(jb.images))
        for f in ("sizes", "orig_sizes", "is_source"):
            np.testing.assert_array_equal(getattr(b, f).numpy(),
                                          on(getattr(jb, f)))
        for f in ("boxes", "labels", "valid"):
            np.testing.assert_array_equal(getattr(t, f).numpy(),
                                          on(getattr(jt, f)))
    # the backbone's own cut of a data slice's canvases is the same rows
    h = pbatch.images.shape[2]
    assert [row_range(h, spatial, s) for s in range(spatial)] == [
        (s * h // spatial, (s + 1) * h // spatial) for s in range(spatial)]


def _dcn_cfgs(canvas=(128, 96)):
    """(JAX cfg, port cfg): the X-101-32x8d-FPN-DCN YAML at depth 50 (its
    grouping and deformable stages kept), narrowed as
    tests/test_torch_slice_dcn.py narrows it, at ``canvas``."""
    cfgs = []
    for cfg in (j_get_cfg(), get_cfg()):
        cfg.merge_from_file(DCN_YAML)
        cfg.MODEL.BACKBONE.CONV_BODY = "R-50-FPN"
        r = cfg.MODEL.RESNETS
        r.STEM_OUT_CHANNELS, r.NUM_GROUPS, r.WIDTH_PER_GROUP = 8, 4, 2
        r.RES2_OUT_CHANNELS = 16
        cfg.MODEL.BACKBONE.OUT_CHANNELS = 16
        cfg.MODEL.ROI_BOX_HEAD.MLP_HEAD_DIM = 32
        cfg.MODEL.RPN.PRE_NMS_TOP_N_TEST = 64
        cfg.MODEL.RPN.POST_NMS_TOP_N_TEST = 32
        cfg.MODEL.RPN.FPN_POST_NMS_TOP_N_TEST = 48
        cfg.TPU.IMAGE_SHAPE = canvas
        cfg.TPU.COMPUTE_DTYPE = "float32"
        cfg.TPU.APPROX_TOPK = False
        cfgs.append(cfg)
    return tuple(cfgs)


def _jax_params_shapes(jcfg, train: bool):
    jmodel = j_build_model(jcfg)
    if train:
        jb = _global_batch(jcfg)
        return jax.eval_shape(lambda: jmodel.init(
            {"params": jax.random.PRNGKey(0),
             "sampling": jax.random.PRNGKey(1),
             "dropout": jax.random.PRNGKey(2)}, jb[0], jb[1],
            JDAState.create(), *jb[2:], aligned=True,
            method=jmodel.train_forward))
    jb, _ = graft._batch(jcfg, 1, seed=0)
    return jax.eval_shape(lambda: jmodel.init(
        {"params": jax.random.PRNGKey(0)}, jb))


@pytest.mark.parametrize("case,min_channels", [
    ("flagship", 256), ("flagship", STEP_MIN), ("dcn", DCN_MIN),
    ("fbnet", 256), ("fbnet", FBNET_MIN)])
def test_split_plan_equals_jax_shard_model(case, min_channels):
    """``split_plan`` splits exactly the ``params`` leaves JAX
    ``shard_model`` puts on the model axis (through ``utils/weights.py``'s
    names), each on JAX's trailing axis; more than 10 leaves split at the
    narrowed widths and no narrow leaf."""
    if case == "flagship":
        jcfg, pcfg = _step_cfgs()
        shapes = _jax_params_shapes(jcfg, train=True)
    elif case == "fbnet":
        jcfg, pcfg = fbnet_cfgs(FBNET_YAML)
        (jb, jt), _ = mask_batches(jcfg, pcfg)
        jmodel = j_build_model(jcfg)
        shapes = jax.eval_shape(lambda: jmodel.init(
            {"params": jax.random.PRNGKey(0),
             "sampling": jax.random.PRNGKey(1),
             "dropout": jax.random.PRNGKey(2)}, jb, jt, JDAState.create(),
            method=jmodel.train_forward))
    else:
        jcfg, pcfg = _dcn_cfgs()
        shapes = _jax_params_shapes(jcfg, train=True)
    params = jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype),
                          shapes["params"])
    placed = j_shard_model(params, j_make_mesh(8, model=2), min_channels)
    want = {}
    for path, leaf in jax.tree_util.tree_leaves_with_path(placed):
        key = "/".join(str(getattr(k, "key", k)) for k in path)
        if "model" in tuple(leaf.sharding.spec):
            want[torch_name(key)] = leaf.shape
    model = build_detection_model(pcfg)
    plan = parallel.split_plan(model, 2, min_channels)
    assert set(plan) == set(want)
    own = dict(model.named_parameters())
    for name, dim in plan.items():
        assert own[name].shape[dim] == want[name][-1]
        assert own[name].shape[dim] >= min_channels
    if min_channels < 256:
        assert len(plan) > 10
    narrow = [n for n, p in own.items() if p.dim() and n in plan
              and p.shape[plan[n]] < min_channels]
    assert not narrow


def test_grouped_split_needs_model_to_divide_the_groups():
    _, pcfg = _dcn_cfgs()
    model = build_detection_model(pcfg)
    with pytest.raises(ValueError, match="groups cannot split"):
        parallel.shard_model(model, parallel.make_mesh(8, model=8), 16)


# ------------------------------------------------------ (d) - (g)

# the FBNet trunks on row shards: (label, YAML, canvas). 100 rows are 50
# at stride 2, 25, 13 and 7; 90 rows are 45, 23, 12 and 6: the stride-2
# SAME pads of an even side (0 before, k - 2 after at k 3; 2/3 at k 7) and
# of an odd one (split evenly), and maps split unevenly over 2 ranks
FBNET_BODIES = (
    ("fbnet_default", "configs/e2e_faster_rcnn_fbnet.yaml", (100, 64)),
    ("fbnet_xirb16d_dsmask", FBNET_YAML, (90, 48)),
    ("fbnet_cham_v1a", "configs/e2e_faster_rcnn_fbnet_chamv1a_600.yaml",
     (100, 64)))


def _body_cfgs() -> dict:
    """Backbones whose layers (d) and (e) do not reach, at canvases whose
    maps split unevenly over 2 space ranks (200 rows: 25 at stride 8, 13
    at 16, 7 at 32, 4 at 64, 2 at 128): a GroupNorm body and FPN (the GN
    Mask R-CNN YAML, narrowed as tests/torch_harness.py::mask_cfgs does),
    RetinaNet's FPN with P6/P7, VGG-16 (72 rows: 9 at stride 8), and the
    three FBNet trunks (FBNET_BODIES; widths at SCALE_FACTOR 0.5, as
    tests/test_torch_fbnet.py::fbnet_cfgs narrows them; cham_v1a's
    depthwise kernels 7 and 5)."""
    from da_detect_tpu_torch.entry import vgg_cfg
    from tests.torch_harness import MASK_GN_YAML, mask_cfgs

    _, gn = mask_cfgs(MASK_GN_YAML)
    retina = get_cfg()
    retina.merge_from_file("configs/retinanet/retinanet_R-50-FPN_1x.yaml")
    r = retina.MODEL.RESNETS
    r.STEM_OUT_CHANNELS, r.WIDTH_PER_GROUP, r.RES2_OUT_CHANNELS = 16, 8, 32
    retina.MODEL.BACKBONE.OUT_CHANNELS = 32
    vgg = vgg_cfg("float32")
    cfgs = {"gn": (gn, (200, 64)), "retinanet": (retina, (200, 64)),
            "vgg": (vgg, (72, 48))}
    for label, yaml, canvas in FBNET_BODIES:
        cfg = get_cfg()
        cfg.merge_from_file(yaml)
        cfg.MODEL.FBNET.SCALE_FACTOR = 0.5
        cfgs[label] = (cfg, canvas)
    for cfg, canvas in cfgs.values():
        cfg.TPU.IMAGE_SHAPE = canvas
        cfg.TPU.COMPUTE_DTYPE = "float32"
    return {label: cfg for label, (cfg, _) in cfgs.items()}


def _jax_run(jcfg, variables, jbatch, steps):
    """JAX's 1-device train steps on the global batch: each step's losses
    and DAState, the parameters after step 1 and after ``steps``, under
    the port's names."""
    jmodel = j_build_model(jcfg)
    tx, _ = j_make_optimizer(jcfg, variables["params"], "cosine")
    st = JTrainState(
        step=jnp.zeros([], jnp.int32), params=variables["params"],
        frozen=variables["frozen"], opt_state=tx.init(variables["params"]),
        da_state=JDAState.create(jcfg.MODEL.DA_HEADS.TRIPLET_MARGIN_IMG,
                                 jcfg.MODEL.DA_HEADS.TRIPLET_MARGIN_INS),
        rng=jax.random.PRNGKey(0))
    jstep = j_make_train_step(jmodel, tx, aligned=True, donate=False,
                              deterministic=True)
    losses, states, first = [], [], None

    def names(params):
        return jax_state_dict({"params": jax.device_get(params)},
                              cfg_fc6_chw(jcfg))

    for i in range(steps):
        st, metrics = jstep(st, *jbatch)
        losses.append({k: float(v) for k, v in metrics.items()})
        states.append({k: float(getattr(st.da_state, k))
                       for k in ("margin_img", "margin_ins",
                                 "last_triplet_img", "last_triplet_ins")})
        if i == 0:
            first = names(st.params)
    return dict(losses=losses, da_states=states, first=first,
                params=names(st.params))


def _single_run(pcfg, variables, batch, steps):
    model = build_detection_model(pcfg)
    load_jax_variables(model, variables)
    model = prepare_model(model, CPU)
    state = create_train_state(pcfg, model, 0, "cosine")
    step = make_train_step(model, state.optimizer, aligned=True,
                           deterministic=True)
    losses, states, first = [], [], None
    for i in range(steps):
        state, metrics = step(state, *batch)
        losses.append({k: float(v) for k, v in metrics.items()})
        states.append({f.name: float(getattr(state.da_state, f.name))
                       for f in dataclasses.fields(state.da_state)})
        if i == 0:
            first = {n: p.detach().clone()
                     for n, p in model.named_parameters()}
    return dict(losses=losses, da_states=states, first=first,
                params={n: p.detach().clone()
                        for n, p in model.named_parameters()}, state=state)


def _fbnet_jax(jmodel, variables, jb_eval, jb, jt) -> dict:
    """JAX's FBNet Mask R-CNN: its eval forward with masks on one device
    and on a (data=2, space=2) mesh of conftest's CPU devices (GSPMD's
    halos), and the losses and gradients of its source-only
    ``train_forward`` applied directly, under the port's names."""
    fn = jax.jit(lambda v, b: jmodel.apply(v, b, with_masks=True))
    mesh = j_make_mesh(4, spatial=2)
    evals = {"one_device": jax.device_get(fn(variables, jb_eval)),
             "space_mesh": jax.device_get(fn(j_replicate(variables, mesh),
                                             j_shard_batch(jb_eval, mesh)))}

    def loss_fn(params):
        losses, _ = jmodel.apply(
            {"params": params, "batch_stats": variables["batch_stats"]}, jb,
            jt, JDAState.create(), method=jmodel.train_forward,
            deterministic=True, rngs={"sampling": jax.random.PRNGKey(3)})
        return sum(losses.values()), losses

    (_, losses), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        variables["params"])
    return dict(evals=evals, losses={k: float(v) for k, v in losses.items()},
                grads=jax_state_dict({"params": grads}))


def _fbnet_single(pcfg, variables, eval_batch, step_batch) -> dict:
    """The port's FBNet Mask R-CNN in one process: its eval forward with
    masks and one source-only step's losses and gradients."""
    model = build_detection_model(pcfg)
    load_jax_variables(model, variables)
    model = prepare_model(model, CPU)
    with torch.no_grad():
        dets, probs = model(eval_batch, with_masks=True)
    state = create_train_state(pcfg, model, 0, "multistep")
    losses, grads = port_step_one(model, state, step_batch, aligned=False)
    return dict(dets=dets, probs=probs, losses=losses, grads=grads)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    root = tmp_path_factory.mktemp("mesh")
    jcfg, pcfg = _step_cfgs()
    jbatch = _global_batch(jcfg)
    shapes = _jax_params_shapes(jcfg, train=True)
    variables = _plain(random_variables(shapes, seed=1, scales=SCORE_SCALES))
    batch = _to_port(jbatch)
    want = _jax_run(jcfg, variables, jbatch, STEPS)
    single = _single_run(pcfg, variables, batch, STEPS)

    djcfg, dpcfg = _dcn_cfgs()
    djbatch, _ = graft._batch(djcfg, 2, seed=0)
    dvars = _plain(random_variables(
        _jax_params_shapes(djcfg, train=False), seed=1, scales=DCN_SCALES))
    dwant = jax.device_get(jax.jit(j_build_model(djcfg).apply)(dvars,
                                                               djbatch))
    dbatch, _ = make_batch(dpcfg, 2, seed=0)
    dmodel = build_detection_model(dpcfg)
    load_jax_variables(dmodel, dvars)
    with torch.no_grad():
        dsingle = prepare_model(dmodel, CPU)(dbatch)

    fjcfg, fpcfg = fbnet_cfgs(FBNET_YAML)
    fjmodel = j_build_model(fjcfg)
    (fjb, fjt), (fpb, fpt) = mask_batches(fjcfg, fpcfg)
    fvars = fbnet_jax_variables(fjmodel, (fjb, fjt))
    (fjb_eval, _), (fpb_eval, _) = mask_batches(fjcfg, fpcfg, seed=7)
    fwant = _fbnet_jax(fjmodel, fvars, fjb_eval, fjb, fjt)
    fsingle = _fbnet_single(fpcfg, fvars, fpb_eval, (fpb, fpt))

    bodies = _body_cfgs()
    body_images = {k: torch.randn((1, 3) + tuple(c.TPU.IMAGE_SHAPE),
                                  generator=torch.Generator().manual_seed(3)
                                  ).contiguous(
                                      memory_format=torch.channels_last)
                   for k, c in bodies.items()}
    spec = dict(
        bodies=bodies, body_images=body_images,
        step=dict(cfg=pcfg, variables=variables, batch=batch, steps=STEPS,
                  min_channels=STEP_MIN),
        dcn=dict(cfg=dpcfg, variables=dvars, batch=dbatch,
                 min_channels=DCN_MIN),
        fbnet=dict(cfg=fpcfg, variables=fvars, batch=fpb_eval,
                   min_channels=FBNET_MIN, with_masks=True),
        fbnet_step=dict(cfg=fpcfg, variables=fvars, batch=(fpb, fpt),
                        min_channels=FBNET_MIN),
        meshes=MESHES, dcn_meshes=DCN_MESHES, fbnet_meshes=FBNET_MESHES,
        fbnet_step_meshes=FBNET_STEP_MESHES, same_pad_cases=SAME_PAD_CASES,
        ckpt_dir=str(root / "ckpt"))
    ranks = parallel.spawn(rank_work, WORLD, spec, tmp_dir=str(root))
    return dict(want=want, single=single, ranks=ranks, variables=variables,
                pcfg=pcfg, dwant=dwant, dsingle=dsingle, root=root,
                bodies=bodies, body_images=body_images, fwant=fwant,
                fsingle=fsingle)


def test_ranks_import_no_jax(run):
    assert [r["jax_imported"] for r in run["ranks"]] == [False] * WORLD


def test_replicate_makes_every_rank_rank_zeros(run):
    for r in run["ranks"]:
        assert torch.equal(r["replicated"], torch.zeros(3))


def test_split_layers_match_one_process(run):
    """A conv, BatchNorm, transposed conv (split on its ``[in, out]``
    dim 1), GroupNorm and linear layer split over model=2: the output, the
    input's gradient (all-reduced over model) and each parameter's
    gradient (gathered whole) against the unsplit stack's."""
    from tests.torch_mesh_ranks import layer_pass

    want = layer_pass()
    for r in run["ranks"]:
        got = r["layers"]
        assert got["plan"]["convt.weight"] == 1 and len(got["plan"]) == 10
        torch.testing.assert_close(got["y"], want["y"], rtol=1e-5,
                                   atol=1e-5)
        torch.testing.assert_close(got["x_grad"], want["x_grad"], rtol=1e-5,
                                   atol=1e-5)
        for n, g in want["grads"].items():
            torch.testing.assert_close(got["grads"][n], g, rtol=1e-5,
                                       atol=1e-5, msg=n)


def test_replicated_gradients_averaged_over_the_slice(run):
    """Under (data=2, model=2), gradients that differ by rank: a split
    leaf's slice stays the rank's own; a replicated leaf's becomes its
    model group's mean, the same bits on both ranks (DDP then averages
    over data)."""
    for r, got in enumerate(run["ranks"]):
        g = got["grad_mean"]
        assert set(g["plan"]) == {"wide.weight", "wide.bias"}
        mate = r ^ 1  # the other rank of its model group
        for n, grad in g["grads"].items():
            want = r + 1.0 if n in g["plan"] else (r + mate + 2) / 2
            assert torch.equal(grad, torch.full_like(grad, want)), n


def _close(got: dict, want: dict, rtol: float, atol: float) -> list:
    """The leaves of ``got`` off ``want`` beyond rtol/atol."""
    return [n for n, w in want.items() if not np.allclose(
        np.asarray(got[n]), np.asarray(w), rtol=rtol, atol=atol)]


def _within_bound(got: dict, single: dict, init: dict) -> float:
    """The largest share of test_torch_ddp's bound (PARAM_REL of the
    leaf's largest change, plus an ulp of its weights) a leaf uses."""
    worst = 0.0
    for name, p in single.items():
        change = float((p - init[name]).abs().max())
        ulp = 1.2e-7 * float(init[name].abs().max())
        err = float((got[name] - p).abs().max())
        worst = max(worst, err / (PARAM_REL * change + ulp + 1e-30))
    return worst


@pytest.mark.parametrize("label", [m[0] for m in MESHES])
def test_mesh_step_matches_jax_and_single_process(run, label):
    ranks = [r[label] for r in run["ranks"]]
    want, single = run["want"], run["single"]
    (rtol1, atol1), (rtoln, atoln) = JAX_TOL[label]
    got = ranks[0]
    assert len(got["plan"]) > 10 if "model" in label else not got["plan"]
    for i in range(STEPS):
        for r in ranks[1:]:
            assert r["losses"][i] == got["losses"][i]
            assert r["da_states"][i] == got["da_states"][i]
        w = want["losses"][i]
        assert set(got["losses"][i]) == set(w)
        rtol, atol = (rtol1, atol1) if i == 0 else (rtoln, atoln)
        for k, v in w.items():
            assert abs(got["losses"][i][k] - v) <= atol + rtol * abs(v), \
                (i, k, got["losses"][i][k], v)
            s = single["losses"][i][k]
            assert abs(got["losses"][i][k] - s) <= LOSS_RTOL * abs(s), \
                (i, k)
        for k in ("margin_img", "margin_ins"):
            assert abs(got["da_states"][i][k]
                       - want["da_states"][i][k]) <= MARGIN_ATOL
    # replicated and gathered parameters: every rank bit for bit alike
    for r in ranks[1:]:
        for n, p in got["params"].items():
            assert torch.equal(r["params"][n], p), n
    trained = {n: p for n, p in got["first"].items() if n in want["first"]}
    assert not _close(trained, want["first"], rtol1, atol1)
    trained = {n: p for n, p in got["params"].items()
               if n in want["params"]}
    assert not _close(trained, want["params"], rtoln, atoln)
    init = jax_state_dict({"params": run["variables"]["params"]},
                          cfg_fc6_chw(run["pcfg"]))
    init = {n: init.get(n, single["params"][n]) for n in single["params"]}
    assert _within_bound(got["params"], single["params"], init) <= 1.0


def test_model_ranks_hold_their_slices(run):
    """Under model=2 each rank keeps the slice of every split leaf on its
    dim, the two slices of a leaf differ and make up the whole."""
    ranks = [r["model"] for r in run["ranks"]]
    plan = ranks[0]["plan"]
    for name, dim in plan.items():
        whole = ranks[0]["params"][name]
        a, b = ranks[0]["local"][name], ranks[1]["local"][name]
        assert a.shape[dim] * 2 == whole.shape[dim]
        torch.testing.assert_close(torch.cat([a, b], dim), whole, rtol=0,
                                   atol=0)
        assert not torch.equal(a, b)
    for name, p in ranks[0]["local"].items():
        if name not in plan:
            assert torch.equal(p, ranks[1]["local"][name]), name


@pytest.mark.parametrize("label", [m[0] for m in DCN_MESHES])
def test_dcn_eval_forward_under_mesh_matches_jax(run, label):
    """The narrowed FPN-DCN (grouped and deformable convs) on 4 ranks: the
    ranks of each data slice alike, the slices' detections together JAX's
    on the whole batch (twins: same label, box within 1e-3 px, score
    within 1e-5) and the single process's."""
    ranks = [r[f"dcn_{label}"] for r in run["ranks"]]
    if label != "space":
        assert len(ranks[0]["plan"]) > 10
    spatial, model = next((s, m) for lab, s, m in DCN_MESHES if lab == label)
    inner = spatial * model
    slices = [ranks[d * inner]["dets"] for d in range(WORLD // inner)]
    for d in range(WORLD // inner):
        for r in ranks[d * inner + 1:(d + 1) * inner]:
            for a, b in zip(r["dets"], slices[d]):
                assert torch.equal(a, b)
    dets = type(slices[0])(*[torch.cat(f) for f in zip(*slices)])
    want = run["dwant"]
    assert np.asarray(want.valid).sum(axis=1).min() >= 8
    assert_twins(dets, want)
    single = run["dsingle"]
    np.testing.assert_array_equal(dets.valid.numpy(), single.valid.numpy())
    np.testing.assert_allclose(dets.boxes.numpy(), single.boxes.numpy(),
                               rtol=0, atol=1e-3)
    np.testing.assert_allclose(dets.scores.numpy(), single.scores.numpy(),
                               rtol=0, atol=1e-5)


@pytest.mark.parametrize("label", ["gn", "retinanet", "vgg"]
                         + [b[0] for b in FBNET_BODIES])
def test_backbone_on_row_shards_matches_single_process(run, label):
    """GroupNorm (sums over space), the FPN's upsample after uneven splits,
    P6/P7, the max pools and FBNet's SAME padding (kernels 3, 5 and 7) on
    row shards: the gathered maps and, for a random projection of them,
    the backbone's gradients (partial sums summed over space) against one
    process's."""
    from tests.torch_mesh_ranks import backbone_pass

    want = backbone_pass(run["bodies"][label], run["body_images"][label])
    for r in run["ranks"]:
        got = r[f"body_{label}"]
        assert len(got["feats"]) == len(want["feats"])
        for a, b in zip(got["feats"], want["feats"]):
            # rounding apart: each map within 1e-5 of its largest value
            assert a.shape == b.shape
            scale = float(b.abs().max())
            assert float((a - b).abs().max()) <= 1e-5 * scale, label
        assert set(got["grads"]) == set(want["grads"])
        for n, g in want["grads"].items():
            scale = float(g.abs().max())
            err = float((got["grads"][n] - g).abs().max())
            assert err <= 1e-4 * scale + 1e-7, (n, err, scale)


@pytest.mark.parametrize("k,s", SAME_PAD_CASES)
def test_same_pad_then_conv_on_row_shards_matches_one_process(run, k, s):
    """``MeshRowOps.same_pad`` (W padded locally, SAME's H pads from the
    global height as zero rows, the rows between ranks fetched) then the
    unpadded conv, which fetches nothing more: one process's output, and
    its input's and kernel's gradients, on 12 and 13 rows."""
    from tests.torch_mesh_ranks import same_pad_pass

    want = same_pad_pass(k, s)
    for h in SAME_PAD_HEIGHTS:
        w = want[h]
        scale = float(w["y"].abs().max())
        for q in (0, 1):  # the two space ranks of data slice 0
            got = run["ranks"][q]["same_pad"][(k, s)][h]
            assert float((got["y"] - w["y"]).abs().max()) <= 1e-5 * scale
            torch.testing.assert_close(got["w_grad"], w["w_grad"],
                                       rtol=1e-5, atol=1e-5)
        x_grad = torch.cat([run["ranks"][q]["same_pad"][(k, s)][h]["x_grad"]
                            for q in (0, 1)], dim=2)
        torch.testing.assert_close(x_grad, w["x_grad"], rtol=1e-5, atol=1e-5)


def _fbnet_eval_matches(dets, probs, jout, score_atol: float = 1e-5):
    """tests/test_torch_fbnet.py's eval comparison: as many valid
    detections an image, twins (box within 1e-3 px, score within
    ``score_atol``), mask probabilities on the valid detections to
    1e-5."""
    jdets, jprobs = jout
    valid = np.asarray(jdets.valid)
    assert valid.sum() >= 4
    np.testing.assert_array_equal(dets.valid.sum(1).numpy(), valid.sum(1))
    assert_twins(dets, jdets, score_atol=score_atol)
    np.testing.assert_allclose(probs.numpy()[valid],
                               np.asarray(jprobs)[valid], rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("label", [m[0] for m in FBNET_MESHES])
def test_fbnet_eval_forward_under_mesh_matches_jax(run, label):
    """The narrowed FBNet Mask R-CNN's eval forward with masks on 4 ranks
    (the trunk on row shards under space, its expansions and depthwise
    convs split on channels and groups under model): the ranks of a data
    slice alike; the slices' detections and masks together JAX's on one
    device and JAX's on its own (data=2, space=2) mesh (scores within
    FBNET_JAX_SCORE_ATOL), and the port's single process (scores within
    1e-5)."""
    ranks = [r[f"fbnet_{label}"] for r in run["ranks"]]
    spatial, model = next((s, m) for lab, s, m in FBNET_MESHES
                          if lab == label)
    if model > 1:
        assert len(ranks[0]["plan"]) > 10
    inner = spatial * model
    slices = [ranks[d * inner] for d in range(WORLD // inner)]
    for d in range(WORLD // inner):
        for r in ranks[d * inner + 1:(d + 1) * inner]:
            for a, b in zip(r["dets"], slices[d]["dets"]):
                assert torch.equal(a, b)
            assert torch.equal(r["probs"], slices[d]["probs"])
    dets = type(slices[0]["dets"])(*[torch.cat(f) for f in zip(
        *[s["dets"] for s in slices])])
    probs = torch.cat([s["probs"] for s in slices])
    for jout in run["fwant"]["evals"].values():
        _fbnet_eval_matches(dets, probs, jout, FBNET_JAX_SCORE_ATOL)
    single = run["fsingle"]
    _fbnet_eval_matches(dets, probs, (single["dets"], single["probs"]))


@pytest.mark.parametrize("label", [m[0] for m in FBNET_STEP_MESHES])
def test_fbnet_source_step_under_mesh_matches_jax(run, label):
    """One source-only step of the narrowed FBNet Mask R-CNN on 4 ranks,
    one image a data slice: every rank's global losses alike and those of
    JAX's ``train_forward`` and of one process; every gradient the step
    applies (whole; under space the trunk's partial sums summed) equal on
    every rank, against JAX's and one process's with
    ``torch_harness.assert_grads_match``'s bounds."""
    ranks = [r[f"fbnet_step_{label}"] for r in run["ranks"]]
    got = ranks[0]
    if label == "model":
        assert len(got["plan"]) > 10
    for r in ranks[1:]:
        assert r["losses"] == got["losses"]
        for n, g in got["grads"].items():
            assert torch.equal(r["grads"][n], g), n
    want, single = run["fwant"], run["fsingle"]
    assert want["losses"]["loss_mask"] > 0
    assert_losses_match(got["losses"], want["losses"])
    assert_losses_match(got["losses"], single["losses"])
    assert set(got["grads"]) == set(want["grads"]) == set(single["grads"])
    assert_grads_match(got["grads"], want["grads"])
    assert_grads_match(got["grads"], single["grads"])


def test_model_split_checkpoint_equals_single_process(run, tmp_path):
    """A run under model=2 that saves after step 1 and trains on takes the
    same steps, bit for bit, as (d)'s run that never saves. Its last
    checkpoint holds one process's keys and shapes, and values within the
    step bound of its steps; its momentum is whole; a fresh split model
    resumes it exactly."""
    from da_detect_tpu_torch.utils.checkpoint import Checkpointer

    got = [r["checkpoint"] for r in run["ranks"]]
    for g, unsaved in zip(got, (r["model"] for r in run["ranks"])):
        assert g["losses"] == unsaved["losses"]
        for n, p in unsaved["params"].items():
            assert torch.equal(g["params"][n], p), n
    assert all(g["start"] == STEPS and g["resumed_model"]
               and g["resumed_momentum"] for g in got)
    saved = torch.load(got[0]["path"], weights_only=True)
    single = run["single"]
    model = single["state"].model
    path = Checkpointer(str(tmp_path)).save(STEPS, single["state"])
    ref = torch.load(path, weights_only=True)
    assert set(saved["model"]) == set(ref["model"])
    for k, v in ref["model"].items():
        assert saved["model"][k].shape == v.shape, k
    init = jax_state_dict({"params": run["variables"]["params"]},
                          cfg_fc6_chw(run["pcfg"]))
    params = dict(model.named_parameters())
    init = {n: init.get(n, params[n].detach()) for n in params}
    assert _within_bound({n: saved["model"][n] for n in params},
                         {n: ref["model"][n] for n in params}, init) <= 1.0
    for k, v in ref["model"].items():
        if k not in params:  # buffers: FrozenBN, whole on every rank
            assert torch.equal(saved["model"][k], v), k
    mom, ref_mom = saved["optimizer"]["state"], ref["optimizer"]["state"]
    assert set(mom) == set(ref_mom)
    for i, st in ref_mom.items():
        assert mom[i]["momentum_buffer"].shape == \
            st["momentum_buffer"].shape
    plan = run["ranks"][0]["model"]["plan"]
    for name, dim in plan.items():
        assert got[0]["local_shapes"][name][dim] * 2 == \
            saved["model"][name].shape[dim]


# the CLI cases: (trainer, the YAML and its narrowing; None: the flagship
# triplet-DA defaults)
FBNET_CLI = ("train_net", ["--config-file", FBNET_YAML],
             ["MODEL.WEIGHT", "", "MODEL.FBNET.SCALE_FACTOR", "0.25"])


@pytest.mark.parametrize("key,case", [
    pytest.param("TPU.MESH_SPATIAL", None, id="TPU.MESH_SPATIAL"),
    pytest.param("TPU.MESH_MODEL", None, id="TPU.MESH_MODEL"),
    pytest.param("TPU.MESH_SPATIAL", FBNET_CLI, id="fbnet-TPU.MESH_SPATIAL")])
def test_cli_train_and_eval_under_torchrun_mesh(tiny, tmp_path, key, case):
    """``torchrun --nproc_per_node 2`` of ``train_net_triplet`` (2 steps,
    then its eval) and of ``test_net`` on its checkpoint, ``--device cpu``,
    with ``key`` 2: one data slice of two gloo ranks (the C4 map of the
    128x160 canvas on row shards, or the wide leaves split); rank 0 writes
    one whole checkpoint, both evaluate, the merge is evaluated once. The
    FBNet case: ``train_net`` source-only on the xirb16d_dsmask Mask R-CNN
    YAML (widths at SCALE_FACTOR 0.25), its trunk on row shards."""
    import os
    import subprocess
    import sys

    from tests.test_torch_cli import CPU as CPU_ARGS
    from tests.test_torch_cli import REPO, _opts

    out = tmp_path / "out"
    env = dict(os.environ, OMP_NUM_THREADS="1")
    trainer, yaml, narrow = case or (
        "train_net_triplet", [], ["MODEL.DOMAIN_ADAPTATION_ON", "True"])
    opts = yaml + CPU_ARGS + _opts(out) + narrow + [key, "2"]
    run_dir = out / "run"
    for cli, extra in ((trainer, []),
                       ("test_net", ["--ckpt", str(run_dir)])):
        proc = subprocess.run(
            [sys.executable, "-m", "torch.distributed.run", "--standalone",
             "--nproc_per_node", "2", "-m",
             f"da_detect_tpu_torch.tools.{cli}"] + extra + opts,
            cwd=REPO, env=env, capture_output=True, text=True, timeout=600)
        assert proc.returncode == 0, proc.stderr[-4000:]
        for rank in (0, 1):
            log = (run_dir / f"log_rank{rank}.txt").read_text()
            assert f"rank {rank} of 2" in log
            assert "evaluating on tiny_foggy_cocostyle" in log
    # the checkpoint holds one process's names and whole shapes
    ckpt = torch.load(run_dir / "model_0000002.pth", weights_only=True)
    single = get_cfg()
    if yaml:
        single.merge_from_file(yaml[1])
    single.merge_from_list(_opts(out)[4:] + narrow)
    shapes = {n: tuple(v.shape) for n, v in
              build_detection_model(single).state_dict().items()}
    assert {n: tuple(v.shape) for n, v in ckpt["model"].items()} == shapes
    assert (run_dir / "coco_results.json").exists()


def test_ddp_over_the_whole_world_under_model_split_fails(run):
    """DDP over every rank (not the data group) under (data=2, model=2)
    mixes the two model ranks' slices: step 1's parameters miss JAX's far
    beyond the model tolerance."""
    want = run["want"]["first"]
    got = run["ranks"][0]["trap"]["first"]
    (rtol, atol), _ = JAX_TOL["model"]
    bad = _close({n: got[n] for n in want}, want, rtol, atol)
    assert len(bad) > 10
