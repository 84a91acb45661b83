"""Default configuration tree.

Key surface is YAML-compatible with the reference's yacs defaults
(reference: maskrcnn_benchmark/config/defaults.py:21-430) so that the
reference ``configs/*.yaml`` zoo parses unchanged. On top of that we add:

* ``TEST.BBOX_AUG.*`` — the reference ships test-time-aug code and configs but
  forgot the keys (reference engine/bbox_aug.py is unreachable); we wire it.
* ``MODEL.RESNETS.STAGE_WITH_DCN`` etc. — the reference's ``configs/dcn``
  yamls reference keys its defaults lack; we define them and actually wire
  deformable conv into the backbone.
* ``TPU.*`` — static-shape bucketing, mesh layout, and dtype policy; these are
  the knobs a fixed-shape XLA pipeline needs that a dynamic-shape CUDA
  pipeline does not.

This is the PyTorch port's own copy of the JAX package's tree, key for key,
so that one YAML drives both. The port keeps the fixed-shape design and reads
``TPU.IMAGE_SHAPE``, ``TPU.MAX_GT_BOXES``, ``TPU.COMPUTE_DTYPE`` and
``TPU.ROI_MAX_SAMPLES``; the other ``TPU`` keys are parsed and unused.
"""

from .node import CfgNode as CN

_C = CN()

_C.MODEL = CN()
_C.MODEL.RPN_ONLY = False
_C.MODEL.MASK_ON = False
_C.MODEL.DOMAIN_ADAPTATION_ON = False
_C.MODEL.RETINANET_ON = False
_C.MODEL.KEYPOINT_ON = False
_C.MODEL.DEVICE = "cuda"  # informational; entry points take a device
_C.MODEL.META_ARCHITECTURE = "GeneralizedRCNN"
_C.MODEL.CLS_AGNOSTIC_BBOX_REG = False
# "catalog://..." resolved through ModelCatalog, else a filesystem path to a
# Detectron .pkl / torch .pth / orbax checkpoint.
_C.MODEL.WEIGHT = ""
_C.MODEL.EVAL_USE_IN_TRAINING = True
_C.MODEL.OUTPUT_DIR = "./"
_C.MODEL.SAVE_DIR = "./"
_C.MODEL.OUTPUT_SAVE_NAME = "output"

# ---------------------------------------------------------------------------
# INPUT
# ---------------------------------------------------------------------------
_C.INPUT = CN()
_C.INPUT.MIN_SIZE_TRAIN = (800,)
_C.INPUT.MAX_SIZE_TRAIN = 1333
_C.INPUT.MIN_SIZE_TEST = 800
_C.INPUT.MAX_SIZE_TEST = 1333
# Caffe2 convention: BGR, 0-255, mean subtraction only
# (reference data/transforms/transforms.py:94-97).
_C.INPUT.PIXEL_MEAN = (102.9801, 115.9465, 122.7717)
_C.INPUT.PIXEL_STD = (1.0, 1.0, 1.0)
_C.INPUT.TO_BGR255 = True

# ---------------------------------------------------------------------------
# Datasets / loader
# ---------------------------------------------------------------------------
_C.DATASETS = CN()
_C.DATASETS.TRAIN = ()
_C.DATASETS.SOURCE_TRAIN = ()
_C.DATASETS.TARGET_TRAIN = ()
_C.DATASETS.TARGET_TRAIN_negative = ()
_C.DATASETS.TEST = ()
_C.DATASETS.TEST_SOURCE = ()

_C.DATALOADER = CN()
_C.DATALOADER.NUM_WORKERS = 4
_C.DATALOADER.SIZE_DIVISIBILITY = 0
_C.DATALOADER.ASPECT_RATIO_GROUPING = True
# Prepped-canvas staging cache (data/staging.py): persist each image's
# post-prep canvas keyed by (file identity, geometry); epochs >= 2 skip PNG
# decode + resize/normalize entirely. The decode is the host-feed
# bottleneck on small hosts (BENCH_r04: loader-fed ran at ~10% of the
# device-resident step on a 1-core VM). STAGE_DIR "" = a shared per-host
# temp directory. STAGE_DTYPE float32 (default) makes hits BIT-EXACT with
# the cold decode path; float16 halves the disk/read bytes at a rounding
# error (<= 0.0625 on BGR255-mean canvases) strictly below the bf16
# compute rounding.
_C.DATALOADER.STAGE_CACHE = True
_C.DATALOADER.STAGE_DIR = ""
_C.DATALOADER.STAGE_DTYPE = "float32"

# ---------------------------------------------------------------------------
# Backbone
# ---------------------------------------------------------------------------
_C.MODEL.BACKBONE = CN()
_C.MODEL.BACKBONE.CONV_BODY = "R-50-C4"
_C.MODEL.BACKBONE.FREEZE_CONV_BODY_AT = 2
_C.MODEL.BACKBONE.OUT_CHANNELS = 256 * 4
_C.MODEL.BACKBONE.USE_GN = False

_C.MODEL.FPN = CN()
_C.MODEL.FPN.USE_GN = False
_C.MODEL.FPN.USE_RELU = False

_C.MODEL.GROUP_NORM = CN()
_C.MODEL.GROUP_NORM.DIM_PER_GP = -1
_C.MODEL.GROUP_NORM.NUM_GROUPS = 32
_C.MODEL.GROUP_NORM.EPSILON = 1e-5

# ---------------------------------------------------------------------------
# RPN
# ---------------------------------------------------------------------------
_C.MODEL.RPN = CN()
_C.MODEL.RPN.USE_FPN = False
_C.MODEL.RPN.ANCHOR_SIZES = (32, 64, 128, 256, 512)
_C.MODEL.RPN.ANCHOR_STRIDE = (16,)
_C.MODEL.RPN.ASPECT_RATIOS = (0.5, 1.0, 2.0)
_C.MODEL.RPN.STRADDLE_THRESH = 0
_C.MODEL.RPN.FG_IOU_THRESHOLD = 0.7
_C.MODEL.RPN.BG_IOU_THRESHOLD = 0.3
_C.MODEL.RPN.BATCH_SIZE_PER_IMAGE = 256
_C.MODEL.RPN.POSITIVE_FRACTION = 0.5
_C.MODEL.RPN.PRE_NMS_TOP_N_TRAIN = 12000
_C.MODEL.RPN.PRE_NMS_TOP_N_TEST = 6000
_C.MODEL.RPN.POST_NMS_TOP_N_TRAIN = 2000
_C.MODEL.RPN.POST_NMS_TOP_N_TEST = 1000
_C.MODEL.RPN.NMS_THRESH = 0.7
_C.MODEL.RPN.MIN_SIZE = 0
_C.MODEL.RPN.FPN_POST_NMS_TOP_N_TRAIN = 2000
_C.MODEL.RPN.FPN_POST_NMS_TOP_N_TEST = 2000
_C.MODEL.RPN.RPN_HEAD = "SingleConvRPNHead"

# ---------------------------------------------------------------------------
# ROI heads
# ---------------------------------------------------------------------------
_C.MODEL.ROI_HEADS = CN()
_C.MODEL.ROI_HEADS.USE_FPN = False
_C.MODEL.ROI_HEADS.FG_IOU_THRESHOLD = 0.5
_C.MODEL.ROI_HEADS.BG_IOU_THRESHOLD = 0.5
_C.MODEL.ROI_HEADS.BBOX_REG_WEIGHTS = (10.0, 10.0, 5.0, 5.0)
_C.MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE = 512
_C.MODEL.ROI_HEADS.POSITIVE_FRACTION = 0.25
_C.MODEL.ROI_HEADS.SCORE_THRESH = 0.05
_C.MODEL.ROI_HEADS.NMS = 0.5
_C.MODEL.ROI_HEADS.DETECTIONS_PER_IMG = 100

_C.MODEL.ROI_BOX_HEAD = CN()
_C.MODEL.ROI_BOX_HEAD.FEATURE_EXTRACTOR = "ResNet50Conv5ROIFeatureExtractor"
_C.MODEL.ROI_BOX_HEAD.PREDICTOR = "FastRCNNPredictor"
_C.MODEL.ROI_BOX_HEAD.POOLER_RESOLUTION = 14
_C.MODEL.ROI_BOX_HEAD.POOLER_SAMPLING_RATIO = 0
_C.MODEL.ROI_BOX_HEAD.POOLER_SCALES = (1.0 / 16,)
_C.MODEL.ROI_BOX_HEAD.NUM_CLASSES = 81
_C.MODEL.ROI_BOX_HEAD.MLP_HEAD_DIM = 1024
_C.MODEL.ROI_BOX_HEAD.USE_GN = False
_C.MODEL.ROI_BOX_HEAD.DILATION = 1
_C.MODEL.ROI_BOX_HEAD.CONV_HEAD_DIM = 256
_C.MODEL.ROI_BOX_HEAD.NUM_STACKED_CONVS = 4

_C.MODEL.ROI_MASK_HEAD = CN()
_C.MODEL.ROI_MASK_HEAD.FEATURE_EXTRACTOR = "ResNet50Conv5ROIFeatureExtractor"
_C.MODEL.ROI_MASK_HEAD.PREDICTOR = "MaskRCNNC4Predictor"
_C.MODEL.ROI_MASK_HEAD.POOLER_RESOLUTION = 14
_C.MODEL.ROI_MASK_HEAD.POOLER_SAMPLING_RATIO = 0
_C.MODEL.ROI_MASK_HEAD.POOLER_SCALES = (1.0 / 16,)
_C.MODEL.ROI_MASK_HEAD.MLP_HEAD_DIM = 1024
_C.MODEL.ROI_MASK_HEAD.CONV_LAYERS = (256, 256, 256, 256)
_C.MODEL.ROI_MASK_HEAD.RESOLUTION = 14
_C.MODEL.ROI_MASK_HEAD.SHARE_BOX_FEATURE_EXTRACTOR = True
_C.MODEL.ROI_MASK_HEAD.POSTPROCESS_MASKS = False
_C.MODEL.ROI_MASK_HEAD.POSTPROCESS_MASKS_THRESHOLD = 0.5
_C.MODEL.ROI_MASK_HEAD.DILATION = 1
_C.MODEL.ROI_MASK_HEAD.USE_GN = False

_C.MODEL.ROI_KEYPOINT_HEAD = CN()
_C.MODEL.ROI_KEYPOINT_HEAD.FEATURE_EXTRACTOR = "KeypointRCNNFeatureExtractor"
_C.MODEL.ROI_KEYPOINT_HEAD.PREDICTOR = "KeypointRCNNPredictor"
_C.MODEL.ROI_KEYPOINT_HEAD.POOLER_RESOLUTION = 14
_C.MODEL.ROI_KEYPOINT_HEAD.POOLER_SAMPLING_RATIO = 0
_C.MODEL.ROI_KEYPOINT_HEAD.POOLER_SCALES = (1.0 / 16,)
_C.MODEL.ROI_KEYPOINT_HEAD.MLP_HEAD_DIM = 1024
_C.MODEL.ROI_KEYPOINT_HEAD.CONV_LAYERS = tuple(512 for _ in range(8))
_C.MODEL.ROI_KEYPOINT_HEAD.RESOLUTION = 14
_C.MODEL.ROI_KEYPOINT_HEAD.NUM_CLASSES = 17
_C.MODEL.ROI_KEYPOINT_HEAD.SHARE_BOX_FEATURE_EXTRACTOR = True

# ---------------------------------------------------------------------------
# Domain-adaptation heads (reference defaults.py:259-283)
# ---------------------------------------------------------------------------
_C.MODEL.DA_HEADS = CN()
_C.MODEL.DA_HEADS.DA_IMG_GRL_WEIGHT = 0.1
_C.MODEL.DA_HEADS.DA_INS_GRL_WEIGHT = 0.1
_C.MODEL.DA_HEADS.DA_IMG_LOSS_WEIGHT = 1.0
_C.MODEL.DA_HEADS.DA_INS_LOSS_WEIGHT = 1.0
_C.MODEL.DA_HEADS.DA_CST_LOSS_WEIGHT = 0.1
_C.MODEL.DA_HEADS.DA_TRIPLET_INS_WEIGHT = 1.0
_C.MODEL.DA_HEADS.DA_TRIPLET_IMG_WEIGHT = 1.0
_C.MODEL.DA_HEADS.DA_ADV_GRL = True
# banded AdvGRL variant (reference Adv_GRL_Optimized, present but uncalled
# there; selectable here)
_C.MODEL.DA_HEADS.DA_ADV_GRL_OPTIMIZED = False
_C.MODEL.DA_HEADS.DA_ADV_GRL_THRESHOLD = 30
_C.MODEL.DA_HEADS.ALIGNMENT = True
_C.MODEL.DA_HEADS.TRIPLET_USE = True
# present-but-unused in the reference too (its loss only reads _INS/_IMG)
_C.MODEL.DA_HEADS.TRIPLET_MARGIN = 1.0
_C.MODEL.DA_HEADS.TRIPLET_MAX_MARGIN = 1.0
_C.MODEL.DA_HEADS.TRIPLET_MARGIN_INS = 1.0
_C.MODEL.DA_HEADS.TRIPLET_MARGIN_IMG = 1.0
# adaptive-margin growth rate (the reference hard-codes lr=0.001 at its
# call sites, da_heads.py:241,266; exposed as a key here, same default)
_C.MODEL.DA_HEADS.TRIPLET_MARGIN_LR = 0.001
_C.MODEL.DA_HEADS.DA_IMG_advGRL_WEIGHT = 0.1
_C.MODEL.DA_HEADS.DA_INS_advGRL_WEIGHT = 0.1

# ---------------------------------------------------------------------------
# ResNe[X]t
# ---------------------------------------------------------------------------
_C.MODEL.RESNETS = CN()
_C.MODEL.RESNETS.NUM_GROUPS = 1
_C.MODEL.RESNETS.WIDTH_PER_GROUP = 64
_C.MODEL.RESNETS.STRIDE_IN_1X1 = True
_C.MODEL.RESNETS.TRANS_FUNC = "BottleneckWithFixedBatchNorm"
_C.MODEL.RESNETS.STEM_FUNC = "StemWithFixedBatchNorm"
_C.MODEL.RESNETS.RES5_DILATION = 1
_C.MODEL.RESNETS.RES2_OUT_CHANNELS = 256
_C.MODEL.RESNETS.STEM_OUT_CHANNELS = 64
# used by the caffe2 config zoo
_C.MODEL.RESNETS.BACKBONE_OUT_CHANNELS = 256
# Deformable conv wiring. The reference's configs/dcn yamls use these keys but
# its defaults.py never defines them (broken inherited feature); defined and
# wired here.
_C.MODEL.RESNETS.STAGE_WITH_DCN = (False, False, False, False)
_C.MODEL.RESNETS.WITH_MODULATED_DCN = False
_C.MODEL.RESNETS.DEFORMABLE_GROUPS = 1

# ---------------------------------------------------------------------------
# RetinaNet
# ---------------------------------------------------------------------------
_C.MODEL.RETINANET = CN()
_C.MODEL.RETINANET.NUM_CLASSES = 81
_C.MODEL.RETINANET.ANCHOR_SIZES = (32, 64, 128, 256, 512)
_C.MODEL.RETINANET.ASPECT_RATIOS = (0.5, 1.0, 2.0)
_C.MODEL.RETINANET.ANCHOR_STRIDES = (8, 16, 32, 64, 128)
_C.MODEL.RETINANET.STRADDLE_THRESH = 0
_C.MODEL.RETINANET.OCTAVE = 2.0
_C.MODEL.RETINANET.SCALES_PER_OCTAVE = 3
_C.MODEL.RETINANET.USE_C5 = True
_C.MODEL.RETINANET.NUM_CONVS = 4
_C.MODEL.RETINANET.BBOX_REG_WEIGHT = 4.0
_C.MODEL.RETINANET.BBOX_REG_BETA = 0.11
_C.MODEL.RETINANET.PRE_NMS_TOP_N = 1000
_C.MODEL.RETINANET.FG_IOU_THRESHOLD = 0.5
_C.MODEL.RETINANET.BG_IOU_THRESHOLD = 0.4
_C.MODEL.RETINANET.LOSS_ALPHA = 0.25
_C.MODEL.RETINANET.LOSS_GAMMA = 2.0
_C.MODEL.RETINANET.PRIOR_PROB = 0.01
_C.MODEL.RETINANET.INFERENCE_TH = 0.05
_C.MODEL.RETINANET.NMS_TH = 0.4

# ---------------------------------------------------------------------------
# FBNet (mobile search-space backbones, upstream feature)
# ---------------------------------------------------------------------------
_C.MODEL.FBNET = CN()
_C.MODEL.FBNET.ARCH = "default"
_C.MODEL.FBNET.ARCH_DEF = ""
_C.MODEL.FBNET.BN_TYPE = "bn"
_C.MODEL.FBNET.SCALE_FACTOR = 1.0
_C.MODEL.FBNET.WIDTH_DIVISOR = 1
_C.MODEL.FBNET.DW_CONV_SKIP_BN = True
_C.MODEL.FBNET.DW_CONV_SKIP_RELU = True
_C.MODEL.FBNET.DET_HEAD_LAST_SCALE = 1.0
_C.MODEL.FBNET.DET_HEAD_BLOCKS = ()
_C.MODEL.FBNET.DET_HEAD_STRIDE = 0
_C.MODEL.FBNET.KPTS_HEAD_LAST_SCALE = 0.0
_C.MODEL.FBNET.KPTS_HEAD_BLOCKS = ()
_C.MODEL.FBNET.KPTS_HEAD_STRIDE = 0
_C.MODEL.FBNET.MASK_HEAD_LAST_SCALE = 0.0
_C.MODEL.FBNET.MASK_HEAD_BLOCKS = ()
_C.MODEL.FBNET.MASK_HEAD_STRIDE = 0
_C.MODEL.FBNET.RPN_HEAD_BLOCKS = 0
_C.MODEL.FBNET.RPN_BN_TYPE = ""

# ---------------------------------------------------------------------------
# Solver
# ---------------------------------------------------------------------------
_C.SOLVER = CN()
_C.SOLVER.MAX_ITER = 40000
_C.SOLVER.BASE_LR = 0.0001
_C.SOLVER.BIAS_LR_FACTOR = 2
_C.SOLVER.MOMENTUM = 0.9
_C.SOLVER.WEIGHT_DECAY = 0.0005
_C.SOLVER.WEIGHT_DECAY_BIAS = 0.0
_C.SOLVER.GAMMA = 0.1
_C.SOLVER.STEPS = (30000,)
_C.SOLVER.WARMUP_FACTOR = 1.0 / 3
_C.SOLVER.WARMUP_ITERS = 500
_C.SOLVER.WARMUP_METHOD = "linear"
# cosine-schedule keys used by the triplet trainer
# (reference tools/train_net_triplet.py:66-81)
_C.SOLVER.WARMUP_LR = 0.0001
_C.SOLVER.LR_MIN = 0.000001
_C.SOLVER.CHECKPOINT_PERIOD = 2500
# in-training eval period (0 = at CHECKPOINT_PERIOD; used by the
# periodically_testing config upstream)
_C.SOLVER.TEST_PERIOD = 0
_C.SOLVER.IMS_PER_BATCH = 16

# ---------------------------------------------------------------------------
# Test
# ---------------------------------------------------------------------------
_C.TEST = CN()
_C.TEST.EXPECTED_RESULTS = ()
_C.TEST.EXPECTED_RESULTS_SIGMA_TOL = 4
# "coco" (pycocotools protocol) or "cityscapes" (the instance-level AP of
# cityscapesScripts, which the reference vendors for its conversion tooling)
_C.TEST.EVAL_STYLE = "coco"
_C.TEST.IMS_PER_BATCH = 8
_C.TEST.DETECTIONS_PER_IMG = 100
# Test-time augmentation. The reference ships engine/bbox_aug.py + the
# configs/test_time_aug yamls but omits these keys from its defaults, leaving
# TTA unreachable; defined and wired here.
_C.TEST.BBOX_AUG = CN()
_C.TEST.BBOX_AUG.ENABLED = False
_C.TEST.BBOX_AUG.H_FLIP = False
_C.TEST.BBOX_AUG.SCALES = ()
_C.TEST.BBOX_AUG.MAX_SIZE = 4000
_C.TEST.BBOX_AUG.SCALE_H_FLIP = False

# ---------------------------------------------------------------------------
# TPU-native additions (no reference equivalent)
# ---------------------------------------------------------------------------
_C.TPU = CN()
# Static padded image shape (H, W); 0 means derive from
# INPUT.MAX/MIN sizes rounded up to SIZE_DIVISIBILITY.
_C.TPU.IMAGE_SHAPE = (0, 0)
# Max ground-truth boxes per image after padding.
_C.TPU.MAX_GT_BOXES = 100
# Compute dtype for conv/matmul heavy paths ("bfloat16" | "float32").
_C.TPU.COMPUTE_DTYPE = "bfloat16"
# Mesh axis sizes: (data,). Data-parallel over triples is the reference
# strategy (SURVEY §2.9); model axes reserved for future TP of the backbone.
_C.TPU.MESH_DATA = -1  # -1: use all devices
# Spatial partitioning: fold the devices into a (data, space) mesh and split
# every image canvas's H axis over the `space` axis — GSPMD spatially
# partitions the backbone convs (halo exchanges inserted by XLA). Scales
# training/eval when the per-device batch cannot go below one image
# (parallel/mesh.py; tests/test_spatial_partition.py proves 1-device
# equivalence). 1 = off (pure data-parallel, the reference-equivalent mode).
_C.TPU.MESH_SPATIAL = 1
# Tensor-parallel mesh axis: shard every wide trailing channel axis of the
# parameters/optimizer state over `model` devices (Megatron-style column
# split, collectives derived by GSPMD — parallel/mesh.py::shard_model).
# Use when one chip cannot hold model+optimizer at the target canvas.
# 1 = off. Loss-equivalence with pure dp: tests/test_tensor_parallel.py.
_C.TPU.MESH_MODEL = 1
# Use the Pallas kernels where available (else pure-XLA formulations).
_C.TPU.USE_PALLAS = True
# Run the stem's 7x7/s2 conv in space-to-depth form (exact algebra; MXU
# packs the 3-channel input 4x better; parameters unaffected). Measured
# net-NEGATIVE on v5e at the parity config (75.5 vs 77.6 img/s — the input
# block-transpose costs more than the conv saves), so off by default; kept
# for hardware where conv0 dominates.
_C.TPU.STEM_SPACE_TO_DEPTH = False
# Aligned-triplet mode: reuse the detection pass's pooled target-instance
# features as the triplet's positive member instead of re-pooling them with
# an independent subsample draw (reference generalized_rcnn.py:109-114 draws
# independently). Identical feature/subsample distribution — only the draw
# is shared with the DA-instance loss — and saves one full ROI-head pass
# per step (+~17% aligned throughput, BENCH_r04 50.1 -> 60.2 img/s at k=8).
# ON by default: the loss-equivalence gate is tests/test_model_build.py:122;
# the reference-parity suites pin this False to anchor the independent-draw
# path (tests/test_train_{loss,trajectory}_parity.py). No effect outside
# the aligned-triplet branch.
_C.TPU.SHARE_POSITIVE_POOL = True
# Per-block activation rematerialization (jax.checkpoint): the backward pass
# recomputes each bottleneck block instead of storing its internals —
# activation HBM drops ~3x for ~1/3 extra forward FLOPs. Numerics and param
# names are unchanged (checkpoints interchange with the non-remat model).
# Turn on to fit bigger canvases / more triples per chip.
_C.TPU.REMAT_BACKBONE = False
_C.TPU.REMAT_ROI_HEAD = False
# "block": per-bottleneck (store block outputs, recompute internals);
# "stage": per-stage (store only stage inputs — the stronger lever when
# block outputs themselves blow HBM, e.g. 832x1344 at 16 triples/step).
_C.TPU.REMAT_LEVEL = "block"
# Lower ResNeXt grouped 3x3 convs with per-group width <= this as
# block-diagonal DENSE convs: g x the nominal FLOPs, but small groups run at
# ~0.2 TFLOP/s on the MXU while dense runs near peak — measured 2.2x
# end-to-end on X-101-32x8d inference. Exact math, same param layout.
# 0 disables (native grouped conv everywhere).
_C.TPU.GROUPED_DENSE_MAX_WIDTH = 16
# DCN bilinear corner gather lowering: "four" = four narrow per-corner row
# takes (measured fastest round 2); "quad" = one wide take per tap from an
# overlapped 4-corner table (fewer, 4x-wider rows — wins iff XLA's gather is
# row-issue-bound). Exact same numerics; see scripts/bench_gather.py.
_C.TPU.DCN_GATHER = "four"
# Use jax.lax.approx_max_k (TPU-native, tiled) for huge flat pre-NMS top-ks:
# RetinaNet per-level candidate selection (~12M scores at P3/800x1344 — the
# exact sort is 31.8 of a 44.7 ms step) and RPN levels with > 16x more
# anchors than pre_nms_top_n (FPN P2). Only affects which
# tail-of-pre_nms_top_n candidates reach NMS; the C4 parity path never
# qualifies. False = reference-exact sort everywhere.
_C.TPU.APPROX_TOPK = True
# Static cap on the adaptive (sampling_ratio=0) ROIAlign sample grid. 8
# reproduces the reference's ceil(roi_size/P) exactly for any ROI side up to
# max_samples*P/scale (C4: 1792 px > every shipped canvas). Nearly free to
# raise: the sample sum folds into the interpolation matrices.
_C.TPU.ROI_MAX_SAMPLES = 8
# Host data pipeline prefetch depth (device buffers).
_C.TPU.PREFETCH = 2
# Pixel transport dtype for loader-fed batches. "uint8" (default) ships
# RAW resized pixels (1 byte each) and normalizes on device
# (structures/image_batch.py::ImageBatch.normalized — the affine fuses
# into the first conv); the host->device wire then carries 4x fewer bytes,
# which is the loader-fed bottleneck on relayed attachments
# (PERFORMANCE.md §Host input pipeline). "float32" = host-side
# normalization (reference-exact f32 bilinear; uint8 differs only by
# cv2's 1/255 resize rounding, below bf16 input rounding).
_C.TPU.TRANSPORT_PIXELS = "uint8"
# Single-transfer batch transport (data/packing.py): pack each step's whole
# input pytree into one buffer and ship it with one device_put from the
# prefetch thread. On relayed/remote chips the per-transfer round-trip
# (~23 ms measured) otherwise multiplies by the ~21 input leaves and
# dominates the 64 ms step. Applies to single-process single-device
# host-feed training; sharded meshes keep the per-leaf sharded puts.
_C.TPU.PACKED_TRANSPORT = True

_C.TENSORBOARD_EXPERIMENT = "logs/da_detect_tpu"
_C.PATHS_CATALOG = ""
_C.OUTPUT_DIR = "."


def get_default_cfg() -> CN:
    return _C.clone()
