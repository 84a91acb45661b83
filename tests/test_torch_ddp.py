"""Data-parallel training and evaluation of the port (DDP, ``parallel/``)
against the JAX package's step on the same global batch.

Two ranks run with gloo on the CPU, spawned with ``torch.multiprocessing``
and a ``file://`` store under the test's temporary directory; they import
no JAX (``tests/torch_ddp_ranks.py`` holds their work). The JAX side is the
1-device train step on the global batch of two triples (its 8-device step
equals it, ``tests/test_multichip_step.py``).

The global batch is made for the normalizers to differ between the ranks:
rank 0's source has 8 valid GT boxes, rank 1's 2; rank 0's positive is a
pixel copy of its source (its image hinge is 0), rank 1's another image.
So the RPN's sampled anchors, the box head's source rows, the valid
instances and the image triplet loss all differ by rank, and DDP around
each rank's own normalization fails the comparison (checked).

Budgets above every candidate pool (RPN 1024 of 360 anchors, ROI 64 at
fraction 0.5 of 16 proposals and 8 GT) make both samplers take every
candidate whatever their draws; dropout is off. AdvGRL, the image and the
instance triplet are on (aligned).

Tolerances: each step's losses rtol 1e-4 (as test_multichip_step.py);
DAState: the margins atol 1e-6, the last triplet losses rtol 1e-4 (losses);
after 2 steps each parameter's change within 1e-3 of its
leaf's largest change plus one float32 ulp of its weights; the two ranks'
parameters and DAState bit for bit equal. Eval: the merged predictions
equal the single process's bit for bit, and so do the COCO numbers.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
import tests.data_factory as factory
from da_detect_tpu.data import build as j_build
from da_detect_tpu.engine.trainer import TrainState as JTrainState
from da_detect_tpu.engine.trainer import make_train_step as j_make_train_step
from da_detect_tpu.models import build_detection_model as j_build_model
from da_detect_tpu.models.da import DAState as JDAState
from da_detect_tpu.solver.optim import make_optimizer as j_make_optimizer
from da_detect_tpu_torch import entry, parallel
from da_detect_tpu_torch.data import build
from da_detect_tpu_torch.engine.inference import inference
from da_detect_tpu_torch.engine.trainer import create_train_state
from da_detect_tpu_torch.models import build_detection_model
from da_detect_tpu_torch.tools import train_net_triplet
from da_detect_tpu_torch.utils import comm
from da_detect_tpu_torch.utils.weights import jax_state_dict
from tests.test_torch_data import _assert_batch_matches, _cfgs, _drain
from tests.torch_ddp_ranks import rank_work
from tests.torch_harness import (cfg_fc6_chw, keypoint_batches,
                                 keypoint_cfgs, mask_batches, mask_cfgs,
                                 random_variables,
                                 register_port_tiny_catalog, tiny_cfgs)

WORLD, STEPS = 2, 2
LOSS_RTOL, STATE_ATOL, PARAM_REL = 1e-4, 1e-6, 1e-3
SCORE_SCALES = {"rpn_head/cls_logits/kernel": 30.0,
                "predictor/cls_score/kernel": 30.0}
CPU = torch.device("cpu")


@pytest.fixture(scope="module", autouse=True)
def _threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _step_cfgs():
    jcfg, pcfg = tiny_cfgs()
    for cfg in (jcfg, pcfg):
        cfg.merge_from_list([
            "MODEL.RPN.PRE_NMS_TOP_N_TRAIN", 64,
            "MODEL.RPN.POST_NMS_TOP_N_TRAIN", 16,
            "TPU.MAX_GT_BOXES", 8,
            "MODEL.RPN.BATCH_SIZE_PER_IMAGE", 1024,
            "MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE", 64,
            "MODEL.ROI_HEADS.POSITIVE_FRACTION", 0.5,
            "MODEL.DA_HEADS.TRIPLET_MAX_MARGIN", 3.0,
            "MODEL.DA_HEADS.TRIPLET_MARGIN_IMG", -0.5,
            "MODEL.DA_HEADS.DA_ADV_GRL", True,
            "MODEL.DA_HEADS.DA_TRIPLET_INS_WEIGHT", 1.0,
            # steps large enough to move every leaf past float32 rounding
            "SOLVER.BASE_LR", 0.01, "SOLVER.WARMUP_FACTOR", 1.0])
    return jcfg, pcfg


def _global_batch(jcfg):
    """Two triples (numpy, JAX layout): triple 0 the source with all 8 GT
    boxes, its positive a pixel copy and its negative the copy + 200;
    triple 1 a source with 2 GT boxes and other images as positive and
    negative. Every domain carries its triple's source targets."""
    b0, t0 = graft._batch(jcfg, 1, seed=0)
    b1, t1 = graft._batch(jcfg, 1, seed=1)
    p1, _ = graft._batch(jcfg, 1, seed=2, is_source=False)
    n1, _ = graft._batch(jcfg, 1, seed=3, is_source=False)
    t0 = t0.replace(valid=jnp.ones_like(t0.valid))
    t1 = t1.replace(valid=jnp.arange(t1.valid.shape[1])[None] < 2)

    def cat(a, b):
        return jax.tree.map(lambda x, y: jnp.concatenate([x, y]), a, b)

    p0 = b0.replace(is_source=jnp.zeros_like(b0.is_source))
    n0 = p0.replace(images=b0.images + 200.0)
    t = cat(t0, t1)
    return (cat(b0, b1), t, cat(p0, p1), t, cat(n0, n1), t)


def _to_port(jbatch):
    """The JAX batch tuple as the port's (NCHW views, torch tensors)."""
    from da_detect_tpu_torch.structures.image_batch import ImageBatch, Targets

    out = []
    for x in jbatch:
        if hasattr(x, "images"):
            out.append(ImageBatch(
                images=torch.from_numpy(np.array(x.images)).permute(
                    0, 3, 1, 2),
                sizes=torch.from_numpy(np.array(x.sizes)),
                orig_sizes=torch.from_numpy(np.array(x.orig_sizes)),
                is_source=torch.from_numpy(np.array(x.is_source))))
        else:
            out.append(Targets(boxes=torch.from_numpy(np.array(x.boxes)),
                               labels=torch.from_numpy(np.array(x.labels)),
                               valid=torch.from_numpy(np.array(x.valid))))
    return tuple(out)


def _jax_run(jcfg, variables, jbatch, aligned=True):
    """STEPS JAX train steps on the global batch: each step's losses and
    DAState, and the final parameters under the port's names."""
    jmodel = j_build_model(jcfg)
    tx, _ = j_make_optimizer(jcfg, variables["params"], "cosine")
    st = JTrainState(
        step=jnp.zeros([], jnp.int32), params=variables["params"],
        frozen=variables["frozen"], opt_state=tx.init(variables["params"]),
        da_state=JDAState.create(jcfg.MODEL.DA_HEADS.TRIPLET_MARGIN_IMG,
                                 jcfg.MODEL.DA_HEADS.TRIPLET_MARGIN_INS),
        rng=jax.random.PRNGKey(0))
    jstep = j_make_train_step(jmodel, tx, aligned=aligned, donate=False,
                              deterministic=True)
    losses, states = [], []
    for _ in range(STEPS):
        st, metrics = jstep(st, *jbatch)
        losses.append({k: float(v) for k, v in metrics.items()})
        states.append({k: float(getattr(st.da_state, k))
                       for k in ("margin_img", "margin_ins",
                                 "last_triplet_img", "last_triplet_ins")})
    return dict(losses=losses, da_states=states,
                params=jax_state_dict({"params": jax.device_get(st.params)},
                                      cfg_fc6_chw(jcfg)))


def _plain(tree):
    if hasattr(tree, "items"):
        return {k: _plain(v) for k, v in tree.items()}
    return np.asarray(tree)


def _eval_cfg():
    _, pcfg = tiny_cfgs()
    pcfg.merge_from_list([
        "TPU.IMAGE_SHAPE", (128, 160), "INPUT.MIN_SIZE_TEST", 120,
        "INPUT.MAX_SIZE_TEST", 160, "TEST.IMS_PER_BATCH", 1,
        "DATASETS.TEST", ("tiny_foggy_cocostyle",),
        "DATALOADER.NUM_WORKERS", 0, "DATALOADER.STAGE_CACHE", False])
    return pcfg


def _source_spec(cfgs, batches):
    """A source-only case: ``cfgs`` (JAX, port) with every proposal of
    every level kept (the batch-wide FPN top-n above both images'
    survivors) and sampled (ROI batch 256 of at most 168 candidates an
    image), on the 2 images of ``batches(jcfg, pcfg)``: image 0 with its 8
    GT boxes, image 1 with 2, so each rank's positive rows, and the mask
    loss's pixel count or the keypoint loss's visible keypoints, differ.
    Returns (the JAX steps, the ranks' spec)."""
    jcfg, pcfg = cfgs
    for cfg in (jcfg, pcfg):
        cfg.merge_from_list(["MODEL.RPN.FPN_POST_NMS_TOP_N_TRAIN", 1000,
                             "MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE", 256,
                             "SOLVER.BASE_LR", 0.01,
                             "SOLVER.WARMUP_FACTOR", 1.0])
    (jb, jt), (pb, pt) = batches(jcfg, pcfg)
    valid = np.stack([np.ones(8, bool), np.arange(8) < 2])
    jt = jt.replace(valid=jnp.asarray(valid))
    pt.valid = torch.from_numpy(valid)
    jmodel = j_build_model(jcfg)
    shapes = jax.eval_shape(lambda: jmodel.init(
        {"params": jax.random.PRNGKey(0), "sampling": jax.random.PRNGKey(1),
         "dropout": jax.random.PRNGKey(2)}, jb, jt, JDAState.create(),
        method=jmodel.train_forward))
    variables = _plain(random_variables(shapes, seed=1, scales={
        "rpn_head/cls_logits/kernel": 30.0,
        "rpn_head/bbox_pred/kernel": 0.03,
        "predictor/bbox_pred/kernel": 0.1}))
    want = _jax_run(jcfg, variables, (jb, jt), aligned=False)
    return want, dict(cfg=pcfg, variables=variables, batch=(pb, pt),
                      steps=STEPS)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The JAX steps, and one 2-rank spawn that runs every piece of
    ``rank_work``."""
    root = tmp_path_factory.mktemp("ddp")
    jcfg, pcfg = _step_cfgs()
    jbatch = _global_batch(jcfg)
    shapes = jax.eval_shape(lambda: j_build_model(jcfg).init(
        {"params": jax.random.PRNGKey(0), "sampling": jax.random.PRNGKey(1),
         "dropout": jax.random.PRNGKey(2)}, jbatch[0], jbatch[1],
        JDAState.create(), *jbatch[2:], aligned=True,
        method=j_build_model(jcfg).train_forward))
    # plain dicts of numpy arrays: the ranks unpickle them without JAX
    variables = _plain(random_variables(shapes, seed=1, scales=SCORE_SCALES))
    want = _jax_run(jcfg, variables, jbatch)
    dirs = factory.make_triplet_datasets(str(root / "data"))
    mask_want, mask_spec = _source_spec(mask_cfgs(), mask_batches)
    kp_want, kp_spec = _source_spec(keypoint_cfgs(), keypoint_batches)
    spec = dict(cfg=pcfg, variables=variables, batch=_to_port(jbatch),
                steps=STEPS, eval_cfg=_eval_cfg(), eval_data=dirs["foggy"],
                ckpt_dir=str(root / "ckpt"), eval_dir=str(root / "eval"),
                mask=mask_spec, kp=kp_spec)
    ranks = parallel.spawn(rank_work, WORLD, spec, tmp_dir=str(root))
    return dict(want=want, ranks=ranks, spec=spec, dirs=dirs, root=root,
                mask_want=mask_want, kp_want=kp_want)


def test_ranks_import_no_jax(run):
    assert [r["jax_imported"] for r in run["ranks"]] == [False, False]


def test_comm_single_process():
    assert (comm.get_world_size(), comm.get_rank()) == (1, 0)
    assert comm.is_main_process()
    comm.synchronize()
    assert comm.all_gather({"x": 1}) == [{"x": 1}]
    assert comm.reduce_dict({"a": 2.0}) == {"a": 2.0}
    assert comm.accumulate_predictions({3: "p"}) == {3: "p"}
    x = torch.tensor([1.0, 2.0])
    assert parallel.global_sum(x) is x and parallel.global_average(x) is x
    assert float(parallel.global_mean(torch.tensor(3.0), torch.tensor(0.0),
                                      0.5)) == 6.0


def test_comm_two_ranks(run):
    for rank, got in enumerate(r["comm"] for r in run["ranks"]):
        assert (got["world"], got["rank"], got["main"]) == (2, rank,
                                                            rank == 0)
        assert got["gathered"] == [{"rank": 0, "tag": "r0"},
                                   {"rank": 1, "tag": "r1"}]
        assert got["reduced"] == {"a": 1.5, "b": 1.0}
        assert got["summed"] == {"a": 3.0}
        assert got["merged"] == {"img0": 0, "img2": 0, "img1": 1, "img3": 1}
        assert got["global_sum"] == [3.0, 10.0]
        assert got["global_average"] == [1.5, 5.0]
    shares = [r["comm"]["global_mean"] for r in run["ranks"]]
    assert np.mean(shares) == pytest.approx(3.0 / 4.0, rel=1e-7)


def _losses_match(got, want) -> float:
    """The largest relative error of a loss; raises on a missing name."""
    assert set(got) == set(want)
    return max(abs(got[k] - want[k]) / abs(want[k]) for k in want)


def test_two_rank_step_matches_jax_global_batch(run):
    want, ranks = run["want"], run["ranks"]
    r0, r1 = (r["steps"] for r in ranks)
    for i in range(STEPS):
        assert _losses_match(r0["losses"][i], want["losses"][i]) <= \
            LOSS_RTOL, (i, r0["losses"][i], want["losses"][i])
        assert r1["losses"][i] == r0["losses"][i]
        assert r1["da_states"][i] == r0["da_states"][i]
        for k, v in want["da_states"][i].items():
            # margins to STATE_ATOL; the last triplet losses as losses
            tol = STATE_ATOL if k.startswith("margin") else LOSS_RTOL * abs(v)
            assert abs(r0["da_states"][i][k] - v) <= tol, (i, k)
    # rank 0's hinge is 0, the global one is not: the margin stays
    assert want["da_states"][0]["last_triplet_img"] > 0
    assert r0["da_states"][1]["margin_img"] == pytest.approx(-0.5)
    init = jax_state_dict({"params": run["spec"]["variables"]["params"]})
    moved = 0
    for name, p in r0["params"].items():
        assert torch.equal(p, r1["params"][name]), name
        if name not in want["params"]:
            continue  # frozen
        d_want = want["params"][name] - init[name]
        scale = float(d_want.abs().max())
        ulp = 1.2e-7 * float(init[name].abs().max())
        err = float(((p - init[name]) - d_want).abs().max())
        assert err <= PARAM_REL * scale + ulp, (name, err, scale)
        moved += scale > 100 * ulp
    assert moved > 20


def test_two_rank_mask_step_matches_jax_global_batch(run):
    """The source-only Mask R-CNN step over 2 ranks, an image each with 8
    and 2 GT boxes: every loss of each step (``loss_mask``, normalized by
    the global batch's positive pixels, included) within LOSS_RTOL of
    JAX's 2-image step, the ranks' parameters equal, each parameter's
    change within PARAM_REL of JAX's (the mask head's too); each rank's own
    normalizers miss JAX's mask loss."""
    _check_source_step(run, "mask", "roi_heads.mask.", "loss_mask")


def test_two_rank_keypoint_step_matches_jax_global_batch(run):
    """The source-only Keypoint R-CNN step over 2 ranks, as the mask case:
    ``loss_kp``, normalized by the global batch's visible keypoints of
    positive rows, and the keypoint head's parameters held to JAX's
    2-image step; with each rank's own normalizers the keypoint head's
    parameters miss JAX's."""
    _check_source_step(run, "kp", "roi_heads.keypoint.", "loss_kp")


def _check_source_step(run, case, head, loss):
    want, ranks = run[f"{case}_want"], run["ranks"]
    r0, r1 = (r[case] for r in ranks)
    for i in range(STEPS):
        assert _losses_match(r0["losses"][i], want["losses"][i]) <= \
            LOSS_RTOL, (i, r0["losses"][i], want["losses"][i])
        assert r1["losses"][i] == r0["losses"][i]
    assert want["losses"][0][loss] > 0
    init = jax_state_dict({"params": run["spec"][case]["variables"][
        "params"]}, cfg_fc6_chw(run["spec"][case]["cfg"]))
    moved = set()
    for name, p in r0["params"].items():
        assert torch.equal(p, r1["params"][name]), name
        if name not in want["params"]:
            continue  # frozen
        d_want = want["params"][name] - init[name]
        scale = float(d_want.abs().max())
        ulp = 1.2e-7 * float(init[name].abs().max())
        err = float(((p - init[name]) - d_want).abs().max())
        assert err <= PARAM_REL * scale + ulp, (name, err, scale)
        if scale > 100 * ulp:
            moved.add(name)
    assert any(n.startswith(head) for n in moved)
    local = ranks[0][f"{case}_local"]
    if case == "mask":
        assert abs(local["losses"][0][loss] - want["losses"][0][loss]) \
            > 10 * LOSS_RTOL * want["losses"][0][loss]
        return
    # every visible keypoint's loss sits near log(52 * 52) at random
    # weights, whatever its normalizer: the rank-local one shows in the
    # head's gradients, so in its parameters after the steps
    worst = max(float(((local["params"][n] - init[n]) - d).abs().max())
                / float(d.abs().max())
                for n, d in ((n, want["params"][n] - init[n])
                             for n in moved if n.startswith(head)))
    assert worst > 10 * PARAM_REL


def test_rank_local_normalization_fails_the_comparison(run):
    """DDP around each rank's own normalizers, probe and triplet losses:
    losses off JAX's, and the ranks' DAState apart."""
    want = run["want"]
    r0, r1 = (r["local_steps"] for r in run["ranks"])
    assert _losses_match(r0["losses"][0], want["losses"][0]) > 100 * LOSS_RTOL
    # rank 0 sees its own zero hinge and grows its margin; rank 1 does not
    assert r0["da_states"][1]["margin_img"] != r1["da_states"][1][
        "margin_img"]


def test_source_only_ddp_leaves_da_heads_out(run):
    assert [r["source_only_da_grads"] for r in run["ranks"]] == [[], []]


@pytest.mark.parametrize("mode,opts,heads", [
    ("source_only", (), {"imghead", "inshead"}),
    ("da_triplet", (), set()),
    ("da_triplet", ("MODEL.DA_HEADS.DA_TRIPLET_INS_WEIGHT", 0.0), set()),
    ("da_triplet", ("MODEL.DA_HEADS.DA_INS_LOSS_WEIGHT", 0.0,
                    "MODEL.DA_HEADS.DA_CST_LOSS_WEIGHT", 0.0), {"inshead"}),
    ("da_triplet", ("MODEL.DA_HEADS.DA_IMG_LOSS_WEIGHT", 0.0,
                    "MODEL.DA_HEADS.DA_CST_LOSS_WEIGHT", 0.0), {"imghead"}),
], ids=["source_only", "triplet", "no_ins_triplet", "img_only", "ins_only"])
def test_unused_parameters_take_no_gradient(mode, opts, heads):
    """What DDP leaves out of its reduction is exactly what a single
    process's step leaves without a gradient."""
    _, pcfg = _step_cfgs()
    pcfg.merge_from_list(list(opts))
    model = entry.prepare_model(build_detection_model(pcfg), CPU)
    state = create_train_state(pcfg, model)
    args = entry.triplet_batches(pcfg, 1)
    losses, _ = model.train_forward(
        *args[:2], state.da_state, *(args[2:] if mode != "source_only"
                                     else ()),
        aligned=True, deterministic=True, generator=state.generator)
    sum(losses.values()).backward()
    no_grad = sorted(n for n, p in model.named_parameters()
                     if p.requires_grad and p.grad is None)
    unused = parallel.unused_parameters(model, mode)
    assert no_grad == sorted(unused)
    assert {n.split(".")[1] for n in unused} == heads


def test_checkpoint_written_once_resumed_by_every_rank(run):
    got = [r["checkpoint"] for r in run["ranks"]]
    assert got[0]["path"] == got[1]["path"]
    assert got[0]["files"] == got[1]["files"] == [
        "last_checkpoint", "model_0000001.pth"]
    for g in got:
        assert g["start"] == 1 and g["own_generator"] and g["same_model"]
    ckpt = torch.load(got[0]["path"], weights_only=True)
    assert len(ckpt["generators"]) == WORLD
    assert not torch.equal(ckpt["generators"][0], ckpt["generators"][1])


def test_two_rank_eval_merge_equals_single_process(run, monkeypatch):
    """Each rank predicts its shard (together every image once); the merge
    on every rank equals one process's predictions, and its COCO numbers
    (computed once, on rank 0) equal one process's."""
    dirs, root = run["dirs"], run["root"]
    register_port_tiny_catalog(dirs, monkeypatch)
    cfg = run["spec"]["eval_cfg"]
    model = entry.prepare_model(build_detection_model(cfg), CPU)
    with torch.no_grad():
        for layer in (model.rpn["head"].cls_logits,
                      model.roi_heads["box"]["predictor"].cls_score):
            layer.weight.mul_(30.0)
    loader, dataset = build.make_data_loader(cfg, is_train=False, device=CPU)
    results, predictions = inference(model, loader, dataset,
                                     output_folder=str(root / "single"))
    shards = [r["eval"]["shard"] for r in run["ranks"]]
    assert sorted(shards[0] + shards[1]) == sorted(predictions)
    assert not set(shards[0]) & set(shards[1])
    for r in run["ranks"]:
        got = r["eval"]
        assert got["results"] == results
        assert sorted(got["predictions"]) == sorted(predictions)
        for img_id, p in predictions.items():
            for k, v in p.items():
                np.testing.assert_array_equal(got["predictions"][img_id][k],
                                              v, err_msg=f"{img_id} {k}")
    assert results["bbox"]["AP50"] > 0
    assert (root / "eval" / "coco_results.json").read_bytes() == (
        root / "single" / "coco_results.json").read_bytes()


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    dirs = factory.make_triplet_datasets(str(tmp_path_factory.mktemp("tiny")),
                                         n_images=7)
    factory.register_tiny_catalog(dirs)
    with pytest.MonkeyPatch.context() as mp:
        register_port_tiny_catalog(dirs, mp)
        yield dirs


@pytest.mark.parametrize("world", [2, 3])
@pytest.mark.parametrize("is_train", [True, False])
def test_rank_loader_equals_jax_process(tiny, monkeypatch, world, is_train):
    """Rank r's single-domain batches (a shuffled train epoch; the eval
    pass) equal JAX process r's; the eval shards partition the dataset."""
    jcfg, pcfg = _cfgs()
    monkeypatch.setattr(jax, "process_count", lambda: world)
    ids = []
    for r in range(world):
        monkeypatch.setattr(jax, "process_index", lambda r=r: r)
        want = list(j_build.make_data_loader(jcfg, is_train=is_train, seed=5,
                                             infinite=False)[0])
        got = _drain(build.make_data_loader(pcfg, is_train=is_train,
                                            device=CPU, seed=5,
                                            infinite=False, rank=r,
                                            world=world)[0])
        assert len(got) == len(want) >= 1
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_batch_matches(g, w, f"rank {r} batch {i}")
        if not is_train:
            ids += [i for _, batch_ids in got for i in batch_ids
                    if i is not None]
    if not is_train:
        assert sorted(ids) == list(range(1, 8))


@pytest.mark.parametrize("aligned", [True, False])
def test_rank_da_loader_equals_jax_process(tiny, monkeypatch, aligned):
    """Rank r's triples (k = IMS_PER_BATCH // 2 = 1 a process, over two
    epochs) equal JAX process r's; ranks read disjoint source images."""
    jcfg, pcfg = _cfgs()
    monkeypatch.setattr(jax, "process_count", lambda: WORLD)
    firsts = []
    for r in range(WORLD):
        monkeypatch.setattr(jax, "process_index", lambda r=r: r)
        want = _drain(j_build.make_data_loader_da(jcfg, aligned=aligned,
                                                  seed=3), 6)
        got = _drain(build.make_data_loader_da(pcfg, device=CPU,
                                               aligned=aligned, seed=3,
                                               rank=r, world=WORLD), 6)
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_batch_matches(g, w, f"rank {r} step {i}")
        firsts.append([g[0].images for g in got[:3]])
    for a in firsts[0]:
        assert not any(torch.equal(a, b) for b in firsts[1])


def test_loader_rank_defaults_to_comm(tiny, monkeypatch):
    _, pcfg = _cfgs()
    monkeypatch.setattr(comm, "get_world_size", lambda: 2)
    monkeypatch.setattr(comm, "get_rank", lambda: 1)
    got = _drain(build.make_data_loader(pcfg, is_train=False, device=CPU)[0])
    want = _drain(build.make_data_loader(pcfg, is_train=False, device=CPU,
                                         rank=1, world=2)[0])
    assert [ids for _, ids in got] == [ids for _, ids in want]


@pytest.mark.parametrize("local_rank,local_world,cards,want", [
    (1, 2, 2, ("nccl", 1)), (0, 1, 1, ("nccl", 0)), (0, 2, 1, ("gloo", 0)),
    (1, 2, 1, ("gloo", 0)), (3, 4, 2, ("gloo", 1))])
def test_backend_follows_local_ranks_per_card(local_rank, local_world,
                                              cards, want):
    """NCCL with a card a local rank; more local ranks than cards share
    them through gloo, rank r on card r modulo the cards."""
    assert parallel.ddp.card_for(local_rank, local_world, cards) == want


@pytest.mark.parametrize("key,value,error", [
    ("TPU.MESH_SPATIAL", 3, ValueError),
    ("TPU.MESH_MODEL", 3, ValueError),
    ("TPU.MESH_DATA", 4, ValueError),
])
def test_mesh_options_beyond_data_parallel_raise(key, value, error,
                                                 tmp_path):
    """Mesh keys the world cannot hold raise, naming the key: a space or
    model size that does not divide the 2 processes (or the one process
    of a plain CLI run), a data size other than world / (S * M)."""
    _, pcfg = tiny_cfgs()
    pcfg.merge_from_list([key, value])
    with pytest.raises(error, match=key):
        parallel.check_mesh(pcfg, 2)
    with pytest.raises(error, match=key):
        train_net_triplet.main(["--device", "cpu", "--skip-test", key,
                                str(value), "MODEL.OUTPUT_DIR",
                                str(tmp_path)])


def test_mesh_data_default_and_world_pass():
    _, pcfg = tiny_cfgs()
    parallel.check_mesh(pcfg, 3)
    pcfg.TPU.MESH_DATA = 3
    parallel.check_mesh(pcfg, 3)
    # a (data, space, model) mesh: MESH_DATA -1 or world / (S * M)
    pcfg.TPU.MESH_SPATIAL, pcfg.TPU.MESH_MODEL = 2, 2
    for data in (-1, 2):
        pcfg.TPU.MESH_DATA = data
        parallel.check_mesh(pcfg, 8)
    with pytest.raises(ValueError, match="TPU.MESH_DATA"):
        parallel.check_mesh(pcfg, 4)
    with pytest.raises(ValueError, match="not divisible by 3"):
        parallel.shard(entry.triplet_batches(pcfg, 2), 0, 3)


def test_dryrun_multichip_on_two_cpu_ranks(capsys):
    """The user-facing dry run, narrowed: a line a run, every check
    passing."""
    cfg = entry.dryrun_cfg()
    cfg.MODEL.RESNETS.STEM_OUT_CHANNELS = 16
    cfg.MODEL.RESNETS.WIDTH_PER_GROUP = 8
    cfg.MODEL.RESNETS.RES2_OUT_CHANNELS = 32
    out = entry.dryrun_multichip(2, device="cpu", cfg=cfg)
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0].startswith("dryrun_multichip(2): single process ok")
    assert lines[-1].startswith("dryrun_multichip(2): dp ok over 2 ranks")
    assert out["backend"] == "gloo" and out["param_bound_used"] <= 1.0
    assert np.allclose(out["margins"], entry.DRYRUN_MARGINS, atol=1e-6)


def test_dryrun_multichip_meshes_on_four_cpu_ranks(capsys):
    """With 4 ranks the dry run adds the JAX dry run's "dp2 x sp2" and
    "dp2 x tp2" meshes (one spawn), each held to the single process."""
    cfg = entry.dryrun_cfg()
    cfg.MODEL.RESNETS.STEM_OUT_CHANNELS = 16
    cfg.MODEL.RESNETS.WIDTH_PER_GROUP = 8
    cfg.MODEL.RESNETS.RES2_OUT_CHANNELS = 32
    out = entry.dryrun_multichip(4, device="cpu", cfg=cfg)
    lines = capsys.readouterr().out.strip().splitlines()
    assert [ln.split(" ok")[0] for ln in lines] == [
        "dryrun_multichip(4): single process", "dryrun_multichip(4): dp",
        "dryrun_multichip(4): dp2 x sp2", "dryrun_multichip(4): dp2 x tp2"]
    assert sorted(out["meshes"]) == ["dp2 x sp2", "dp2 x tp2"]
    for got in [out] + list(out["meshes"].values()):
        assert got["param_bound_used"] <= 1.0
        assert np.allclose(got["margins"], entry.DRYRUN_MARGINS, atol=1e-6)


def test_setup_environment_runs_the_named_module(tmp_path, monkeypatch):
    """The reference's hook: $TORCH_DETECTRON_ENV_MODULE names a file whose
    setup_environment() runs; without one nothing happens; a module
    without the function raises."""
    from da_detect_tpu_torch.utils.env import ENV_MODULE, setup_environment

    monkeypatch.delenv(ENV_MODULE, raising=False)
    setup_environment()
    mark = tmp_path / "ran"
    good = tmp_path / "custom_env.py"
    good.write_text("def setup_environment():\n"
                    f"    open({str(mark)!r}, 'w').close()\n")
    monkeypatch.setenv(ENV_MODULE, str(good))
    setup_environment()
    assert mark.exists()
    bad = tmp_path / "no_hook.py"
    bad.write_text("x = 1\n")
    monkeypatch.setenv(ENV_MODULE, str(bad))
    with pytest.raises(ImportError, match="no setup_environment"):
        setup_environment()
