#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``da_detect_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one JSON line each:
  1. env       torch, CUDA and nvcc versions, the card's name and power limit
  2. build     the six CUDA kernels, compiled from csrc/ for sm_90a
  3. kernels   each kernel against its plain PyTorch version on the card, at
               the main paths' shapes and on edge cases (NMS: 1 to 12000
               boxes, invalid rows, a ragged batch, max_keep truncation;
               ROIAlign forward: ROIs off the map, wide ones, the whole C4
               map at cap 8, and one level-aware launch over the DCN
               pooler's 4 maps, with a level that gets no ROI, two images
               and no ROI; ROIAlign backward: whole C4 and P2 maps, map
               edges, C = 4 and 12, a map that needs more than 48 KB a
               block, a strided gradient; the row scatter-add against
               index_add_ on the card and, bit for bit, on the CPU (rows
               of at most LONG_ROW sources; every row against the kernel's
               order in plain PyTorch), and against its own second run:
               the DCN taps' shapes, 4C-wide rows, a column slice,
               out-of-range indices, every index alike, none; each timed);
               ROIAlign at the Cityscapes mask pooler's shapes (800x1344,
               P2-P5, 256 channels, P 14, sampling ratio 2; 100 ROIs on 1
               image and 512 on each of 2) in float32 and bfloat16: the
               level-aware forward, the backward a level on its masked
               gradient (bit for bit its own rerun), and both tilings;
               ROIAlign at the FBNet poolers' shapes (P 6, adaptive
               sampling, one stride-16 map, 512 ROIs on each of 16
               images) at C 128 (20x40) and C 88 (38x63), float32,
               forward and backward; NMS at RetinaNet's site, 5000
               class-offset boxes at IoU 0.4, stopped at 100 kept and
               whole
 3a. serving_bf16  serving export (``engine/serving.py``) in bfloat16 at
               full width: the flagship YAML at 608x1216 exported as a
               ``stablehlo`` and an ``aot`` artifact and as a uint8 ``aot``
               one, the X-101-32x8d-FPN-DCN YAML at 608x1216 ("four"
               gathers, 270 row_gather launches a request), the
               Cityscapes mask YAML (with masks) and the keypoint YAML (with
               keypoints) at 800x1344 as ``aot`` artifacts (a CUDA graph
               captured at load). Each artifact's request against the eager
               kernel route on the same weights and batch: outputs bit for
               bit, the
               launches of one call read by kernel name from a profile
               equal to eager's, its device time and busy share; export and
               load seconds, artifact bytes, peak memory; the steady request
               in turns (eager, stablehlo, aot); an aot artifact whose
               recorded device kind was edited must be refused; the
               flagship's cold starts, a fresh process each from its start
               to its first detection (eager, stablehlo, aot)
 3b. serving_move  ``load_serving(path, device=...)``, the flagship YAML at
               608x1216 in float32, then bfloat16: a stablehlo artifact
               exported on the card and loaded on the CPU, bit for bit the
               eager forward of a CPU copy of the model; one exported on
               the CPU and loaded on the card, bit for bit the
               card-exported one's request, with the flagship's launches
               counted and profiled; export, load and CPU seconds, the two
               artifacts' requests in turns
  4. slice     the flagship R-50-C4 config (its YAML) at the 608x1216 canvas
               (phases 4-10 in float32, then again in bfloat16, below),
               random weights from a seed, answers 4 eval requests
               of batch 1 through ``entry()``; launch counts show the kernels
               ran; one request again with impl="plain" must agree
  5. times     kernel and plain times on the inputs the eval path gave the
               kernels (NMS also split into its mask launch and its walk by
               torch.profiler), the forward's latency and stages, a profile
               with its convolution kernels by element type, peak memory
 5a. roi_pool  ROIPool (``ops/roi_align.py::roi_pool_image``) on the eval
               path's C4 map and 256 of its ROIs, P 7: bit for bit the
               same call on the CPU; its time and peak memory
  6. train     the flagship triplet-DA train step through ``train_entry()``:
               kernel-run against plain-run step 1, timed steps with launch
               counts, the step's split and profile, 2 aligned steps
  7. train_times  kernel and plain times on the train path's kernel inputs,
               with the NMS split
 7a. ddp       phase 6's step through DDP at world size 1 (NCCL): 3 steps
               with phase 6's launch counts, each step's losses, DAState
               and parameters bit for bit the unwrapped step's from the
               same seed (cuDNN deterministic for the check); then the two
               steps' times in turns
 7b. ddp2      (float32 only) two ranks on the one card through gloo, one
               triple each, step 1 against one process's step on the
               2-triple batch on the same sampler draws (losses, DAState,
               parameters); each rank launches NMS and both ROIAlign
               kernels; then each side's step times
 7c. mesh2     (float32, in ddp2's spawn) the same two ranks as the
               (data=1, space=2) and the (data=1, model=2) mesh
               (``parallel.parallelize``): one triple's step 1 against one
               process's on the same draws (ddp2's bounds; split leaves
               gathered first), the replicated parameters bit for bit
               alike on both ranks, each rank's launches (the train
               phase's a step), an eval request's detections against one
               process's; each rank's step times, peak memory, and
               parameter and momentum bytes. Then the FBNet models at
               their published widths under both meshes (line
               "mesh2_fbnet"): the xirb16d_dsmask Mask R-CNN at 320x640
               (a request with masks, every detection with its twin in
               one process's; its source-only step 1 on 2 images on the
               same draws, with the same checks as the flagship's) and,
               under space=2, a request of the chamv1a Faster R-CNN at
               600x1000; exact launches a rank; each rank's request and
               step times and peak memory
  8. dcn       the X-101-32x8d-FPN-DCN YAML at 608x1216 in float32 through
               ``entry(cfg=dcn_cfg())``: 4 requests with exact launch counts
               (row_gather 270 a forward, NMS 6, ROIAlign 1: each ROI from
               its own level of P2-P5), one request with
               impl="plain" and one with TPU.DCN_GATHER "quad" (row_gather_bulk
               270) that must agree with it
  9. dcn_times  each gather's kernel, plain and ``torch.index_select`` device
               times on the path's inputs, summed a forward, from 3
               profiles taken in turns (median and spread), with the byte
               bound; forward latency, stage split, profile, the pooler's
               device time and peak memory
 10. dcn_train  the X-101-32x8d-FPN-DCN triplet-DA train step at 608x1216
               through ``train_entry(cfg=dcn_train_cfg())``, offsets drawn
               as in phase 8: kernel-run against plain-run step 1 in both
               gather modes, timed steps with exact launch counts (the
               gathers forward and recomputed in the backward, the
               scatter-add, NMS, ROIAlign forward and backward, and the 90
               CSR builds of the scatter-add's indices: one a deformable
               conv a backbone pass), peak memory, a profile with its
               launches by kernel group, and every kernel checked on the
               step's own inputs (the scatter-add also bit for bit against
               the CPU and its own second run on one record of each
               destination shape); the scatter-add as a function
               with a dense output on step 1's indices (offsets as drawn):
               the kernel with the layers' CSR and with its own, the plain
               version and torch.zeros + index_add_ (2 profiles in turns),
               beside its byte bound, with the longest row and share of
               sources in rows summed in pieces; a later step's inputs
               checked too (by then the random-weight step diverges), its
               rows' traffic, and its NMS and ROIAlign sites' times
 10a. mask     the Cityscapes Mask R-CNN YAML (R-50-FPN, MASK_ON) at its
               800x1344 canvas through ``entry(cfg=mask_cfg(),
               with_masks=True)``, random weights from seed 0 (score layers
               spread): 4 requests with masks and exact launch counts (NMS
               6, ROIAlign forward 2: the box and mask poolers), kernel run
               against plain run (detections; the mask probabilities on
               the kernel run's detections), the path's sites timed; then
               ``mask_train``: the source-only step on 2 images with GT
               masks through ``source_train_entry``: kernel-run against
               plain-run step 1 (loss_mask included), 4 timed steps with
               exact launches (NMS 5, ROIAlign forward 2, backward 8), a
               profile, peak memory, one step's kernel inputs checked and
               timed
 10b. fbnet    the FBNet xirb16d_dsmask Mask R-CNN YAML uncut at its own
               320x640 canvas (81 classes) through ``entry(cfg=
               fbnet_cfg(), with_masks=True)``, random weights from seed 0
               (score layers spread): 4 requests with masks and exact
               launch counts (NMS 2, ROIAlign forward 2), kernel run
               against plain run as in 10a, its sites timed; then
               ``fbnet_train``: the source-only step on the per-card batch,
               16 images of 512 ROIs, through ``source_train_entry``:
               kernel-run against plain-run step 1, 4 timed steps with
               exact launches (NMS 1, ROIAlign forward 2, backward 2), a
               profile, peak memory, one step's kernel inputs checked and
               timed; then ``fbnet_cham``: 4 requests of the chamv1a
               Faster R-CNN YAML at 600x1000 (an 88-channel map; NMS 2,
               ROIAlign forward 1), kernel run against plain run, its
               sites timed. The poolers' maps are float32 (FBNet's
               BatchNorm output) in both dtypes.
 10c. retinanet  RetinaNet R-50-FPN (its YAML uncut, 800x1344, 81 classes)
               through ``entry(cfg=retinanet_cfg())``, the class logits
               spread (prior bias zeroed, weights times SCORE_SCALE): 4
               requests with exact launches (one class-offset NMS over up
               to 5000 candidates at IoU 0.4, keeping 100), kernel run
               against plain run, the NMS site timed beside the P3-P7
               candidate selection's time; then ``retina_train``: the
               source-only step on 2 images, kernel-run against plain-run
               step 1, 4 timed steps with every kernel's launches 0, a
               profile, peak memory
 10d. keypoint  the Keypoint R-CNN R-50-FPN YAML (KEYPOINT_ON, 2 classes,
               17 keypoints) uncut at 800x1344 through ``entry(cfg=
               keypoint_cfg(), with_keypoints=True)``, random weights from
               seed 0 (score layers spread): 4 requests with keypoints and
               exact launch counts (NMS 6, ROIAlign forward 2: the box and
               keypoint poolers), kernel run against plain run (detections;
               the keypoint head's heatmaps on the kernel run's detections,
               a moved keypoint only to a near tie; the head rerun through
               the kernels gives the request's keypoints bit for bit), the
               path's sites timed
               (the keypoint pooler: P 14, sampling 2, P2-P5 at 256
               channels, 100 detections), the request's stages, a profile
               with its convolution census, peak memory; then
               ``keypoint_train``: the source-only step on 2 images of 512
               ROIs with GT keypoints through ``source_train_entry``:
               kernel-run against plain-run step 1 (loss_kp included), 4
               timed steps with exact launches (NMS 5, ROIAlign forward 2,
               backward 8), a profile, peak memory, one step's kernel inputs
               checked and timed
 10e. vgg      the VGG-16 DA-Faster R-CNN (``entry.vgg_cfg()``: the
               flagship triplet-DA YAML on VGG-16 with the FPN2MLP head
               over its one stride-16 map) at 608x1216: 4 requests with
               the flagship's launches (NMS 2, ROIAlign forward 1: one
               38x76 map of 512 channels at P 7, adaptive sampling),
               kernel run against plain run, its sites timed, a profile
               with its busy share and convolution census, peak memory;
               then ``vgg_train``: the triplet step through
               ``train_entry(cfg=vgg_cfg())`` (no parameter frozen, as in
               JAX): kernel-run against plain-run step 1 (the ReLU flips
               of the box MLP and the DA instance head left out), 6 timed
               steps with exact launches, a profile, peak memory, one
               step's kernel inputs checked and timed, 2 aligned steps
 11. *_bf16    phases 4-10e (7b excepted) again with TPU.COMPUTE_DTYPE
               bfloat16, the
               JAX package's default: the same launch counts, each bf16
               kernel held to its plain version (BF16_* tolerances) on the
               phase's own inputs, kernel-run against plain-run agreement
               relative to an f32 copy of the model, and no float32
               convolution kernel in any profile outside the modules the
               JAX package computes in float32 (the C4 mask predictor and
               the keypoint predictor: a profiler range around each
               forward, and their backward by its autograd nodes'
               sequence numbers, ``float32_head_kernels``); NMS (float32 boxes in
               both dtypes) is not timed again, the DCN train step runs
               "four" only, BF16_DCN_TRAIN_STEPS timed steps, and step 1's
               inputs are its sites
The remaining single-card modules, float32:
 11a. derain   ``tools/train_derain.main`` at its defaults (crop 224, batch
               8) for 40 iterations on 12 PNGs written at run time, rain
               synthesized (cv2): its checkpoint's keys, validation PSNR
               and SSIM, iterations a second; the KPN step's device time,
               profile and peak memory, and the per-pixel filtering's
               share of it; the JAX package's learning check on the card
               (KPN base 8, 200 Adam steps); KPNRef at 224 against the CPU
 11b. aux_deform_pool  ``DeformRoIPooling`` at P 7, C' 9, 4 x 4 samples a
               bin, 256 ROIs on 38x76 score maps, offsets drawn nonzero:
               exact launches (2 row gathers, 2 scatter-adds and their 2
               CSR builds), output bit for bit and gradients within 1e-5
               of the plain run, the gradients bit for bit their rerun,
               the gathers' and scatter-adds' device times against the
               plain versions and index_select / index_add_; then ``aux``:
               PAM, CAM, MultiLevelDAModule and Boxes on the card against
               the CPU
The from-scratch learning gate, in bfloat16 (the JAX package's
``tools/sanity_check.py``, ported; its synthetic 120x160 datasets written at
run time, seed 3, 16 images a domain):
 12. sanity_bf16  step 1 of the gate's GN triplet-DA model on a loader
               batch, kernel-run against plain-run (relative to an f32 copy,
               as the bf16 train phases); one step's kernel inputs (float32
               ROIAlign maps and gradients in the bfloat16 model, P 7, 16
               ROIs an image) held to the plain versions and timed; then
               ``sanity_check.main`` with the JAX package's ablation gate
               unchanged (``--ablation --iters 200 --min-gap 0.2``: source-
               only and triplet-DA trained from scratch, DA AP50 on the
               channel-inverted target must beat source-only's by 0.2), with
               exact launches a step and an evaluation in each arm; the
               kernel-run step twice, bit for bit the same
The data path, in bfloat16, on datasets written at run time (an aligned
clean / foggy / rainy triple at Cityscapes geometry, 1024x2048 PNGs from the
port's writer, 8 images a domain, 8 to 40 boxes in 2 classes, named through
a user catalog, PATHS_CATALOG):
 13. data      the PNG reader on a filter-0 and a Paeth-filtered image; the
               flagship YAML's triplet loader alone (608x1216 uint8, packed,
               one copy a step) at the YAML's 0 workers, at 4, and at 4 with
               the port's PNG reader where cv2 decodes, the staging cache
               off (cold): batches a second, host seconds a step by stage,
               the copy's bytes; its first batch on the card equals the CPU
               loader's
 14. cli_train_bf16  ``tools/train_net_triplet.main`` on the flagship YAML,
               8 loader-fed steps, a checkpoint every 4, launch counts a step
               as the train phase's; again from the step-4 checkpoint to 8;
               a profile of loader-fed steps (busy share)
 15. cli_eval_bf16  ``tools/test_net.main --ckpt``: coco_results.json and
               the bbox AP (random weights: printed only), launch counts a
               request; compute_on_dataset's detections of one image equal
               model(batch) on the same batch; images a second; the same
               checkpoint under TEST.EVAL_STYLE cityscapes (its AP printed);
               ``tools/test_net_batch.main`` over the two checkpoints of
               phase 14; a ``--profile`` training run (21 steps) that leaves
               its trace of iterations 10-19
 16. stage     ``tools/stage_dataset.main`` on the smoke datasets, then the
               triplet loader warm at 0 and 4 workers (it must decode
               nothing: every canvas a staging hit), beside phase 13's cold
               numbers, and a warm loader-fed ``train_net_triplet`` run: its
               median step and data wait
 17. tta_bf16  ``tools/train_core.run_eval`` on the X-101-32x8d-FPN-DCN YAML
               (TEST.BBOX_AUG: 8 passes) over 2 images, offsets drawn as in
               phase 8: each pass's canvas, latency and launches (270 row
               gathers a forward at every scale); the merge's NMS kernel
               against its plain version (exact keep masks) and the merged
               order against the JAX package's merge rule in numpy
 18. tools_ddp_bf16  the dataset tools at run time: a gtFine tree at
               Cityscapes geometry through ``convert_cityscapes_to_coco``,
               the clean PNG tree copied as the foggy domain and through
               ``generate_rainy_dataset`` as the rainy one; the flagship
               YAML's triplet loader reads the three and feeds 2 steps
               through DDP at world size 1 (NCCL), phase 6's launch counts
 19. mask_cli_bf16  a gtFine tree (4 images) through
               ``convert_cityscapes_to_coco``, ``train_net`` on the
               Cityscapes mask YAML for 2 steps (its loader rasterizing the
               polygons into GT masks; phase 10a's launches a step), then
               ``test_net`` reporting bbox and segm in the COCO and the
               Cityscapes protocols (phase 10a's launches a request)
 20. retina_fbnet_cli_bf16  a gtFine tree (4 images) through
               ``convert_cityscapes_to_coco``, named through a user
               catalog; on the FBNet xirb16d_dsmask and the RetinaNet
               R-50-FPN YAMLs each, ``train_net`` for 2 steps of 2 images
               (phases 10b's and 10c's launches a step), then ``test_net``
               reporting bbox AP (and segm for FBNet; random weights:
               printed only) with their launches a request
 21. keypoint_cli_bf16  a COCO person-keypoint tree (4 PNGs of 480x640)
               written at run time and named through a user catalog;
               ``train_net`` on the keypoint YAML for 2 steps of 2 images
               (its loader carrying GT keypoints; phase 10d's launches a
               step), then ``test_net`` reporting bbox and keypoints (OKS)
               AP (random weights: printed only), phase 10d's launches a
               request
 22. demo_bf16  ``demo.COCODemo`` on the keypoint YAML (score layers
               spread) on a seeded 480x640 BGR image: the overlay of
               ``run_on_opencv_image`` with a request's launches, the
               latency of ``compute_prediction``, kernel-run against
               plain-run detections and keypoints; ``draw_detection.main``
               over a folder of 2 PNGs writes 2 files
``--data-only`` runs phases 1, 2 and 12-22 alone, without the kernel line
(and without phase 3a).
``--gate-spread GATES RUNS [CONDITION[:FIRST] ...]`` runs phases 1 and 2,
then the learning gate of phase 12 GATES times and its triplet-DA arm RUNS
times under each condition (default: all of SPREAD_CONDITIONS) with its
initial weights changed in the last bit from seed FIRST on (0: unchanged)
(``gate_spread``), without the kernel line.
Each ROIAlign-forward site of phases 5, 7 and 9 also gives its kernel's
device time (profiler), the corner bytes that the per-thread gather it
replaced read through L2, and the ROIs' footprint bytes the kernel stages.
Then a line with every kernel's numbers (a row a kernel and dtype, and one
for the TTA merge's NMS site; the float32 NMS and ROIAlign rows also under
the path "sanity_bf16", the ablation's run, and the bfloat16 FBNet paths,
whose poolers pool float32 maps; the serving paths of phase 3a,
"serving_*_bf16", with an aot request's launches read from a replay's
profile, under the forward kernels' rows; the VGG paths "vgg_*"; the deform
pool's gathers and scatter-adds, "aux_deform_pool", under the float32
row_gather and row_scatter_add rows, with device times), the nvidia-smi
line of the
card, and last ``{"ok": true, "device": {...}}``. Any failure raises: the
script exits non-zero and prints no result. With no CUDA device it exits 1
at once.

Tolerances: NMS keep masks exactly, truncated ones (``max_keep``) too;
ROIAlign rtol = atol = 1e-5 (float32 sums in another order), its backward
1e-5 of max |dF| and bit for bit its own rerun (a fixed order, no
atomics); the row gathers bit for bit (copies); kernel-run against
plain-run detections, and "quad" against "four": the same valid count, and
each detection has a twin with the same label, boxes within 1e-2 pixels and
scores within 1e-4 (the pooled features differ by float32 rounding, which
the box head carries into the scores); the row scatter-add within 1e-5 of
the largest |dst| of the card's index_add_ (which adds with atomics, in an
order that changes from run to run), and bit for bit equal to its own
second run, to the kernel's order run on the CPU (row_scatter_add_csr_)
and, on the rows of at most LONG_ROW sources, which both add in source
order, to the CPU's index_add_ (a longer row is summed in pieces); DCN
kernel-run step 1 against plain-run step 1 as the flagship's. bfloat16:
see BF16_ROI_ULPS and the notes beside it.
"""

from __future__ import annotations

import collections
import contextlib
import json
import logging
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
FLAGSHIP_YAML = os.path.join(
    REPO, "configs", "da_faster_rcnn",
    "e2e_triplet_da_faster_rcnn_R_50_C4_cityscapes_to_foggy_cityscapes.yaml")
# MIN/MAX_SIZE_TEST 600/1200, rounded up to DATALOADER.SIZE_DIVISIBILITY 32
CANVAS = (608, 1216)
REQUESTS = 4
# the slice's kernel shapes: RPN NMS 6000 -> 1000 at IoU 0.7, box-head NMS
# over 2048 candidates at IoU 0.3, ROIAlign of 1000 ROIs from the C4 map
RPN_NMS_BOXES, BOX_HEAD_NMS_BOXES = 6000, 2048
SLICE_ROIS, C4_CHANNELS = 1000, 1024
SCORE_SCALE = 30.0  # spreads random-init class scores, as the CPU tests do
ROI_TOL = dict(rtol=1e-5, atol=1e-5)
DET_BOX_ATOL, DET_SCORE_ATOL = 1e-2, 1e-4
# bfloat16 (TPU.COMPUTE_DTYPE, the JAX package's default): tolerances in
# bfloat16 ulps of the reference's largest magnitude (bf16_ulp). The ROIAlign
# kernels sum in float32 and round each output (dF) once, where the plain
# versions round their weights and their first contraction too: forward and
# backward within BF16_ROI_ULPS of the plain bfloat16 version's largest
# value, and within one ulp of each value of the plain version run in
# float32 on the same bfloat16 inputs (the backward plus 1e-5 of its largest
# |dF|, float32 sums in another order). The gathers are copies: exact.
# The scatter-add sums in float32 and rounds once: bit for bit its plain
# order (row_scatter_add_csr_ widens, sums and rounds so) and its rerun, and
# within one ulp of the largest |dst| of the plain version on the card
# (float32 index_add_ with atomics, then one rounding). End to end, relative
# to what bfloat16 itself does (an f32 copy of the model through the plain
# versions; compare_steps, match_detections): with random weights, ulp-level
# differences reorder selections and move a step's gradients far past any
# fixed bound. Detection twins: same label, boxes within BF16_DET_BOX_ATOL
# px, scores within BF16_DET_SCORE_ATOL.
BF16_ROI_ULPS = 4
BF16_DET_BOX_ATOL, BF16_DET_SCORE_ATOL = 1.0, 2e-2

# H100 SXM, published dense peaks (NVIDIA data sheet): HBM3 bytes a second,
# float32 operations a second outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
# operations a box pair costs in the IoU test, and a box its area
IOU_OPS, AREA_OPS = 16, 5
# ROIAlign: a multiply and an add for each of 4 corners, per channel sample
ROI_SAMPLE_OPS = 8

# launches a forward makes: NMS in the RPN and in the box head; ROIAlign in
# the box head
PER_FORWARD = {"nms": 2, "roi_align_fwd": 1}
# launches a train step makes: NMS in the source's and the positive target's
# RPN; ROIAlign forward and backward in their box-head passes; the aligned
# variant (instance triplet on) re-pools the source and negative members too
PER_TRAIN_STEP = {"nms": 2, "roi_align_fwd": 2, "roi_align_bwd": 2}
PER_ALIGNED_STEP = {"nms": 2, "roi_align_fwd": 4, "roi_align_bwd": 4}
TRAIN_STEPS, ALIGNED_STEPS, SPLIT_STEPS, PROFILE_STEPS = 6, 2, 5, 3
# the train step's kernel shapes: RPN NMS 12000 -> 2000 at IoU 0.7, ROIAlign
# of the 256 sampled ROIs an image
TRAIN_NMS_BOXES, TRAIN_ROIS = 12000, 256
TRAIN_LOSS_RTOL, TRAIN_GRAD_REL, TRAIN_GRAD_FLOOR = 1e-4, 1e-3, 1e-6
ROI_BWD_REL = 1e-5

# the DCN model: launches a forward makes. A row gather a tap of each of the
# 30 deformable convs (res3 4, res4 23, res5 3 blocks; 9 taps); NMS in the
# RPN's 5 levels (P2-P6) and the box head; ROIAlign from P2-P5, each ROI
# from its own level, in one launch
PER_DCN_FORWARD = {"row_gather": 270, "nms": 6, "roi_align_fwd": 1}
PER_QUAD_FORWARD = {"row_gather_bulk": 270, "nms": 6, "roi_align_fwd": 1}
# (gathers and scatter-adds: 2 profiles of 2 passes, and 2 timed DCN train
# steps a dtype, since the serving and mesh phases joined the run; 10 timed
# DCN requests, and the DCN train step's and the gathers' and scatter-adds'
# profiles of the device's activity alone, since the serving moves joined
# it: the script's whole run must stay inside its time limit on a slow host)
DCN_PROFILE_RUNS, GATHER_TIMING_RUNS, GATHER_PROFILES = 3, 2, 2
DCN_FORWARD_RUNS = 10
# the DCN model's train step, "four" gathers (deformable_groups 1): each of
# the 3 backbone passes (source, positive, negative) gathers once a tap of
# its 30 deformable convs (270) forward and once more in the backward (the
# tap recomputed under its checkpoint), and scatter-adds each tap's rows'
# gradient once (270; every pass's deformable convs read an input that
# needs a gradient: res2 is frozen, res3's conv1 is not); NMS a level
# (P2-P6) in the source's and the positive target's RPN; ROIAlign forward
# once a box-head pass (source, positive: each ROI from its own level) and
# backward once a level (P2-P5) a pass
# The scatter-add's CSR ("row_csr", not a kernel: a sort) is built once a
# deformable conv a pass in the training forward, and never in eval.
PER_DCN_TRAIN_STEP = {"row_gather": 3 * 2 * 270, "row_scatter_add": 3 * 270,
                      "nms": 2 * 5, "roi_align_fwd": 2, "roi_align_bwd": 2 * 4,
                      "row_csr": 3 * 30}
PER_DCN_QUAD_TRAIN_STEP = {
    ("row_gather_bulk" if k == "row_gather" else k): v
    for k, v in PER_DCN_TRAIN_STEP.items()}
DCN_TRAIN_STEPS, DCN_QUAD_TRAIN_STEPS, SCATTER_TIMING_RUNS = 2, 1, 1
BF16_DCN_TRAIN_STEPS = 2
DCN_TRAIN_NMS_SITES = tuple(f"rpn_{d}_p{l}" for d in ("source", "target")
                            for l in range(2, 7))
SCATTER_REL = 1e-5
# the saved rows that the recompute avoids, a step at 608x1216: a [4P, C]
# float32 buffer a tap a pass (res3 76x152 at C 512, res4 38x76 at 1024,
# res5 19x38 at 2048; 9 taps of 4, 23 and 3 layers), 3 passes
SAVED_TAP_BYTES = 3 * 9 * 4 * 4 * (4 * 76 * 152 * 512 + 23 * 38 * 76 * 1024
                                   + 3 * 19 * 38 * 2048)
# row scatter-adds against index_add_: name -> (S, C, P, row stride or
# None, index range or None for a tenth out of range on either side)
SCATTER_CASES = {
    "res3_four": (76 * 152, 512, 4 * 76 * 152, None, None),
    "res3_block0_four": (152 * 304, 512, 4 * 76 * 152, None, None),
    "res4_four": (38 * 76, 1024, 4 * 38 * 76, None, None),
    "res5_four": (19 * 38, 2048, 4 * 19 * 38, None, None),
    "quad_res3": (76 * 152 - 1 - 152, 4 * 512, 76 * 152, None, None),
    "column_slice": (40, 16, 257, 48, None),
    "c6_scalar": (50, 6, 333, None, None),
    "one_hot_row": (1000, 128, 20000, None, (17, 18)),
    "empty": (10, 8, 0, None, None),
}
# calls of each NMS and ROIAlign site under torch.profiler for the device
# time of its kernels (NMS: the mask launch and the walk apart), and of the
# DCN model's whole pooler
KERNEL_PROFILE_RUNS = 5
# the plain NMS (a host-driven loop, 40-180 ms a call) is timed over fewer
# calls than the kernels
NMS_PLAIN_RUNS = 5
# the DCN pooler's maps at 608x1216 (P2-P5) and scales
FPN_SHAPES = ((152, 304), (76, 152), (38, 76), (19, 38))
FPN_SCALES = (1 / 4, 1 / 8, 1 / 16, 1 / 32)
# the Cityscapes Mask R-CNN YAML (R-50-FPN, MASK_ON) at its own canvas,
# 800x1344: P2-P5 of its FPN, which its mask pooler (P 14, sampling ratio 2,
# 256 channels) pools from; 100 detections an image in eval, 512 sampled
# ROIs on each of 2 images a train step
MASK_CANVAS = (800, 1344)
MASK_FPN_SHAPES = ((200, 336), (100, 168), (50, 84), (25, 42))
MASK_POOLER = dict(scales=FPN_SCALES, output_size=14, sampling_ratio=2,
                   max_samples=8)
MASK_EVAL_ROIS, MASK_TRAIN_ROIS, MASK_TRAIN_IMAGES = 100, 512, 2
# launches a mask request makes: NMS in the RPN's 5 levels and the box
# head; ROIAlign forward in the box head and the mask head (each ROI from
# its own level, one launch each)
PER_MASK_FORWARD = {"nms": 6, "roi_align_fwd": 2}
# a source-only mask train step: NMS a level of the RPN (the 2 images in
# one launch); ROIAlign forward in the box and mask heads, backward a
# level (P2-P5) of each
PER_MASK_TRAIN_STEP = {"nms": 5, "roi_align_fwd": 2, "roi_align_bwd": 8}
MASK_NMS_SITES = ("rpn_p2", "rpn_p3", "rpn_p4", "rpn_p5", "rpn_p6",
                  "box_head")
MASK_TRAIN_STEPS, MASK_PROFILE_STEPS = 4, 2
# the mask head on the kernel run's own detections, kernel against plain:
# float32 probabilities within MASK_PROB_ATOL; bfloat16 within twice what
# bfloat16 itself moves them (the plain run against an f32 copy of the
# model) or MASK_PROB_BF16_FLOOR
MASK_PROB_ATOL, MASK_PROB_BF16_FLOOR = 1e-4, 2.0 ** -7
# Keypoint R-CNN R-50-FPN (its YAML uncut, 800x1344, 2 classes, 17
# keypoints): its keypoint pooler (P 14, sampling ratio 2, P2-P5 at 256
# channels) pools the 100 detections of a request and the 512 sampled ROIs
# on each of 2 images (IMS_PER_BATCH 16 / 8) of a train step: the mask
# pooler's shapes and the mask model's launches (NMS in the RPN's 5 levels
# and the box head, ROIAlign forward in the box and keypoint heads, its
# backward a level of each)
PER_KP_FORWARD = {"nms": 6, "roi_align_fwd": 2}
PER_KP_TRAIN_STEP = {"nms": 5, "roi_align_fwd": 2, "roi_align_bwd": 8}
KP_TRAIN_IMAGES, KP_TRAIN_STEPS, KP_PROFILE_STEPS = 2, 4, 2
KP_PROFILE_RUNS = 3
# the keypoint head on the kernel run's own detections, kernel against
# plain: float32 heatmap logits within KP_LOGIT_REL of their largest |logit|;
# bfloat16 within twice what bfloat16 itself moves them (the plain run
# against an f32 copy of the model) or one bfloat16 ulp of the largest. A
# decoded keypoint that moves by more than KP_XY_ATOL px may move only to a
# cell whose plain logit lies within twice that bound of the plain maximum
# (a near tie of the argmax)
KP_LOGIT_REL, KP_XY_ATOL = 1e-4, 1e-2
# phase keypoint_cli_bf16: a person-keypoint tree of KP_CLI_IMAGES images
# at KP_CLI_HW, KP_CLI_STEPS train_net steps of 2 images
KP_CLI_IMAGES, KP_CLI_STEPS, KP_CLI_HW = 4, 2, (480, 640)
# phase demo_bf16: the demo's image and the folder CLI's images
DEMO_HW, DEMO_FOLDER_IMAGES = (480, 640), 2
# the FBNet xirb16d_dsmask Mask R-CNN YAML at its own 320x640 canvas (81
# classes): one stride-16 map of 128 channels (20x40), pooled at P 6 with
# adaptive sampling (at most TPU.ROI_MAX_SAMPLES 8 a bin side) by its box
# and mask heads; its train step on the per-card batch, IMS_PER_BATCH 128 /
# 8 = 16 images of 512 sampled ROIs; the chamv1a Faster R-CNN YAML at
# 600x1000: a 38x63 map of 88 channels, not a multiple of the kernels'
# 32-channel slice
FBNET_CANVAS, FBNET_MAP, FBNET_CHANNELS = (320, 640), (20, 40), 128
CHAM_CANVAS, CHAM_MAP, CHAM_CHANNELS = (600, 1000), (38, 63), 88
FBNET_POOLER = dict(spatial_scale=1 / 16, output_size=6, sampling_ratio=0,
                    max_samples=8)
FBNET_TRAIN_IMAGES, FBNET_TRAIN_ROIS = 16, 512
# launches: a mask request makes NMS in the RPN (one level) and the box
# head, ROIAlign forward in the box and the mask head; a Faster request no
# mask pooler; a source-only train step (all 16 images in each launch) NMS
# in the RPN, ROIAlign forward and backward in the box and the mask head
PER_FBNET_FORWARD = {"nms": 2, "roi_align_fwd": 2}
PER_FBNET_FASTER_FORWARD = {"nms": 2, "roi_align_fwd": 1}
PER_FBNET_TRAIN_STEP = {"nms": 1, "roi_align_fwd": 2, "roi_align_bwd": 2}
FBNET_NMS_SITES = ("rpn", "box_head")
FBNET_TRAIN_STEPS, FBNET_PROFILE_STEPS = 4, 2
# RetinaNet R-50-FPN at 800x1344 (800 / 1333 rounded up to its
# SIZE_DIVISIBILITY 32), 81 classes: one class-offset NMS a request over
# the 5 levels' top 1000 candidates (at most 5000, boxes offset out near
# 1e5 px) at IoU 0.4, keeping 100; its source-only train step
# (IMS_PER_BATCH 16 / 8 = 2 images) launches no kernel
RETINA_CANVAS = (800, 1344)
RETINA_NMS_BOXES, RETINA_NMS_IOU, RETINA_KEEP = 5000, 0.4, 100
PER_RETINA_FORWARD = {"nms": 1}
PER_RETINA_TRAIN_STEP: dict = {}
RETINA_NMS_SITES = ("class_offset",)
RETINA_TRAIN_STEPS, RETINA_PROFILE_STEPS = 4, 2
# phase retina_fbnet_cli_bf16: images a train_net step
CLI_IMAGES = 2
# row gathers against the plain version at the DCN path's shapes, 608x1216:
# name -> (S table rows, C, P indices, row stride or None)
GATHER_CASES = {
    "probe": (76 * 152, 512, 4 * 76 * 152, None),  # the TPU probe's own shape
    "res3_block0": (152 * 304, 512, 4 * 76 * 152, None),  # stride-2 conv2
    "res4_block0": (76 * 152, 1024, 4 * 38 * 76, None),
    "res4": (38 * 76, 1024, 4 * 38 * 76, None),
    "res5_block0": (38 * 76, 2048, 4 * 19 * 38, None),
    "res5": (19 * 38, 2048, 4 * 19 * 38, None),
    "quad_res3": (76 * 152 - 1 - 152, 4 * 512, 76 * 152, None),
    "quad_res3_block0": (152 * 304 - 1 - 304, 4 * 512, 76 * 152, None),
    "c6_scalar": (50, 6, 333, None),        # rows of 24 B: no 16-byte vectors
    "column_slice": (40, 16, 257, 48),      # one deformable group's columns
    "empty": (10, 8, 0, None),
    # narrow rows, which the kernel maps over the flat output: the deform
    # pool's score maps (rows of 9 floats), one element, a narrow column
    # slice, a flat output ending in a ragged run (1655 elements), and
    # float32 rows either side of the crossovers (1024 B for rows of
    # 16-byte words, 512 B for others)
    "deform_pool": (38 * 76 * 49, 9, 802816, None),
    "c1": (1000, 1, 4097, None),
    "c3_column_slice": (40, 3, 257, 48),
    "c5_ragged": (50, 5, 331, None),
    "below_crossover": (300, 252, 1001, None),
    "above_crossover": (300, 260, 1001, None),
    "below_unaligned": (300, 127, 1001, None),
    "above_unaligned": (300, 129, 1001, None),
}
GATHER_BF16_CASES = ("probe", "quad_res3", "column_slice", "deform_pool",
                     "c1", "c3_column_slice", "c5_ragged", "below_crossover",
                     "above_crossover", "below_unaligned", "above_unaligned")
# phase gather_sweep: the row gather through each of its mappings (a warp
# a row, flat) against index_select, at these row widths in bytes, in
# float32 (20 B for 18: no float32 row has 18) and bfloat16; the deform
# pool's indices a launch into a table of at most SWEEP_TABLE_BYTES
# (L2-resident, as the paths' tables are) and at most its rows;
# SWEEP_RUNS calls a variant under the profiler
SWEEP_ROW_BYTES = (4, 18, 36, 64, 100, 128, 256, 260, 512, 516, 1024, 2048)
SWEEP_INDICES, SWEEP_TABLE_ROWS = 802816, 38 * 76 * 49
SWEEP_TABLE_BYTES, SWEEP_RUNS = 24 * 2 ** 20, 10

SOURCES = {
    "nms": ("da_detect_tpu_torch/kernels/csrc/nms.cu",
            "da_detect_tpu/ops/nms_pallas.py:117"),
    "roi_align_fwd": ("da_detect_tpu_torch/kernels/csrc/roi_align_fwd.cu",
                      "da_detect_tpu/ops/roi_align_pallas.py:108"),
    "roi_align_bwd": ("da_detect_tpu_torch/kernels/csrc/roi_align_bwd.cu",
                      "da_detect_tpu/ops/roi_align_pallas.py:138"),
    "row_gather": ("da_detect_tpu_torch/kernels/csrc/row_gather.cu",
                   "scripts/bench_gather_pallas.py:35"),
    "row_gather_bulk": ("da_detect_tpu_torch/kernels/csrc/row_gather_bulk.cu",
                        "scripts/bench_gather_pallas.py:75"),
    # the gathers' adjoint: no Pallas kernel behind it (XLA's autodiff of
    # the takes in da_detect_tpu/layers/deform_conv.py::_gather_tap)
    "row_scatter_add": ("da_detect_tpu_torch/kernels/csrc/row_scatter_add.cu",
                        "da_detect_tpu/layers/deform_conv.py:101"),
}
# the path whose run gives each kernel's launches and times in the last line
MAIN_PATH = {"nms": "train", "roi_align_fwd": "train",
             "roi_align_bwd": "train", "row_gather": "dcn",
             "row_gather_bulk": "dcn_quad", "row_scatter_add": "dcn_train"}
# the kernels with a bfloat16 variant: a row "<name>_bf16" each, from the
# bfloat16 run of the same path (NMS takes float32 boxes in both dtypes)
BF16_KERNELS = ("roi_align_fwd", "roi_align_bwd", "row_gather",
                "row_gather_bulk", "row_scatter_add")


T0 = time.perf_counter()


def emit(phase: str, **fields) -> None:
    """One phase's JSON line, with the seconds since the script began."""
    print(json.dumps({"phase": phase, "elapsed_s": time.perf_counter() - T0,
                      **fields}), flush=True)


def time_ms(fn, runs: int = 25, warmup: int = 3) -> float:
    """Median device time of ``fn`` over ``runs`` calls, CUDA events around
    each call, after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def host_ms(fn, runs: int = 20, warmup: int = 2) -> float:
    """Median host time of ``fn`` ending in a synchronize (a request)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def bf16_ulp(magnitude: float) -> float:
    """One bfloat16 ulp at ``magnitude``: 2 ** (floor(log2 m) - 7)."""
    m = float(magnitude)
    return 2.0 ** (np.floor(np.log2(m)) - 7) if m > 0 else 0.0


def within_one_ulp(got, want32, floor: float) -> float:
    """The largest |got - want32| in bfloat16 ulps of each value of the
    float32 reference (``floor`` added to each ulp); raises past one."""
    g, w = got.float(), want32.float()
    ulp = torch.exp2(torch.floor(torch.log2(w.abs().clamp(min=1e-30))) - 7)
    worst = float(((g - w).abs() / (ulp + floor)).max()) if g.numel() else 0.0
    if not worst <= 1.0:
        raise AssertionError(f"bfloat16 kernel output off its float32 "
                             f"reference by {worst:.3f} x (one ulp + floor)")
    return worst


def bound(nbytes: float, ops: float) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_FLOPS
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


# ---------------------------------------------------------------- inputs

def cluster_boxes(rng, b: int, n: int, hw) -> tuple[np.ndarray, np.ndarray]:
    """Heavily overlapping clusters over an h x w canvas (the RPN regime),
    in descending score order, with ~20% invalid rows interspersed."""
    h, w = hw
    out_boxes, out_valid = [], []
    for _ in range(b):
        centers = rng.uniform((20, 20), (w - 20, h - 20), (max(n // 16, 1), 2))
        c = centers[np.arange(n) % len(centers)] + rng.uniform(-20, 20, (n, 2))
        half = rng.uniform(10, 60, (n, 2))
        boxes = np.concatenate([c - half, c + half], 1).astype(np.float32)
        order = np.argsort(-rng.uniform(0, 1, n), kind="stable")
        out_boxes.append(boxes[order])
        out_valid.append(rng.rand(n) > 0.2)
    return np.stack(out_boxes), np.stack(out_valid)


def random_rois(rng, b: int, r: int, hw, max_side: float) -> np.ndarray:
    h, w = hw
    x1 = rng.uniform(-60, w, (b, r))
    y1 = rng.uniform(-60, h, (b, r))
    return np.stack([x1, y1, x1 + rng.uniform(2, max_side, (b, r)),
                     y1 + rng.uniform(2, max_side / 2, (b, r))],
                    -1).astype(np.float32)


def fpn_inputs(rng, b: int, r: int, c: int, dev, empty_level=None,
               shapes=FPN_SHAPES, canvas=CANVAS):
    """The DCN pooler's 4 maps (or ``shapes``; random, channels-last), ROIs
    of 4 to 700 pixels a side over the canvas and their levels by FPN's
    rule; with ``empty_level``, the ROIs of that level are dropped."""
    from da_detect_tpu_torch.models import poolers

    maps = [torch.from_numpy(rng.randn(b, h, w, c).astype(np.float32)).to(
        dev).permute(0, 3, 1, 2) for h, w in shapes]
    side = np.exp(rng.uniform(np.log(4), np.log(700), (b, 3 * r, 2)))
    xy = rng.uniform(-50, (canvas[1], canvas[0]), (b, 3 * r, 2))
    rois = torch.from_numpy(np.concatenate([xy, xy + side], -1).astype(
        np.float32))
    levels = poolers.assign_levels(rois, 2, 5)
    if empty_level is not None:
        keep = (levels != empty_level).all(0)
        rois, levels = rois[:, keep], levels[:, keep]
    return maps, rois[:, :r].to(dev), levels[:, :r].to(dev)


# ---------------------------------------------------------------- bounds

def nms_stops(keep: torch.Tensor, max_keep) -> np.ndarray:
    """Where greedy NMS ends in each image: after the max_keep-th kept box
    where the image has that many, else after its last box."""
    k = keep.cpu().numpy()
    stops = np.full(k.shape[0], k.shape[1])
    if max_keep:
        for i, row in enumerate(k):
            if row.sum() == max_keep:
                stops[i] = np.flatnonzero(row)[-1] + 1
    return stops


def nms_work(valid: torch.Tensor, keep: torch.Tensor,
             max_keep) -> tuple[float, float]:
    """(bytes, operations) greedy NMS needs on these inputs, each image up
    to its stop (``nms_stops``): the boxes and valid rows up to there read
    once, keep written once; an IoU test of every kept box against each
    valid box after it up to the stop, and one area a valid box there."""
    b, n = valid.shape
    stops = nms_stops(keep, max_keep)
    v = valid.cpu().numpy().astype(np.int64) * (np.arange(n) < stops[:, None])
    k = keep.cpu().numpy().astype(np.int64)
    after = np.cumsum(v[:, ::-1], axis=1)[:, ::-1] - v
    pairs = int((after * k).sum())
    return (int(stops.sum()) * (16 + 1) + b * n,
            IOU_OPS * pairs + AREA_OPS * int(v.sum()))


def roi_align_geometry(height, width, rois, *, spatial_scale, output_size,
                       sampling_ratio, max_samples):
    """Per ROI [B, R] (float64): the samples that lie in bounds on this map,
    and its footprint, the pixels of the rectangle of rows and columns its
    in-bounds samples' corners reach."""
    from da_detect_tpu_torch.ops.roi_align import _roi_grid

    p = output_size
    s = sampling_ratio if sampling_ratio > 0 else max_samples
    start_h, start_w, bin_h, bin_w, grid_h, grid_w = _roi_grid(
        rois.float(), spatial_scale, p, sampling_ratio, max_samples)
    pos = torch.arange(p, dtype=torch.float32, device=rois.device)[:, None]
    idx = torch.arange(s, dtype=torch.float32, device=rois.device)

    def axis(start, bin_size, grid, size):
        start, bin_size, grid = (t[..., None, None]
                                 for t in (start, bin_size, grid))
        coords = start + pos * bin_size + (idx + 0.5) * bin_size / grid
        ok = (idx < grid) & (coords >= -1.0) & (coords <= size)
        lo = torch.floor(coords.clamp(0.0, size - 1.0)).double()
        hi = (lo + 1).clamp(max=size - 1)
        first = torch.where(ok, lo, np.inf).amin((-1, -2))
        last = torch.where(ok, hi, -np.inf).amax((-1, -2))
        return ok.sum(-1).double(), (last - first + 1).clamp(min=0)

    ny, span_y = axis(start_h, bin_h, grid_h, height)
    nx, span_x = axis(start_w, bin_w, grid_w, width)
    return (ny[..., :, None] * nx[..., None, :]).sum((-1, -2)), span_y * span_x


def roi_align_work(maps, rois, levels, kw, elem_bytes: int = 4,
                   owned=None) -> dict:
    """What ROIAlign needs on these inputs: ``bytes`` (the maps, ROIs and
    levels read once, the output written once) and ``operations`` (8 a
    channel for each in-bounds sample of each ROI on its own level, and the
    average); ``owned`` ([B, R] bool, one map): only these ROIs' rows, ROIs
    and levels count, the share of a level-aware function that one level's
    launch does (``level_rows``); ``old_l2_bytes``, the corner reads the
    per-thread gather that the forward kernel replaced made through L2 (4
    corners of C floats an in-bounds sample; with several maps it pooled
    every ROI from every one of them); ``footprint_bytes``, the ROIs'
    footprints on their own maps (C floats a pixel), which the forward
    kernel stages in shared memory.
    ``maps``: (B, C, H, W) of each map; ``levels`` None for one map; ``kw``:
    the wrapper's keywords (``spatial_scale`` or ``scales``); maps and
    output of ``elem_bytes`` an element (4 float32, 2 bfloat16). The backward
    moves the same bytes (the gradient read once, dF written once) and does
    the same operations (a multiply and an add into each of 4 corners)."""
    b, c = maps[0][:2]
    r, p = rois.shape[1], kw["output_size"]
    rows = b * r if owned is None else int(owned.sum())
    scales = kw["scales"] if levels is not None else (kw["spatial_scale"],)
    geo = dict(output_size=p, sampling_ratio=kw["sampling_ratio"],
               max_samples=kw["max_samples"])
    own_samples = own_footprint = 0.0
    all_samples = 0.0
    for i, (shape, scale) in enumerate(zip(maps, scales)):
        samples, footprint = roi_align_geometry(
            shape[2], shape[3], rois, spatial_scale=scale, **geo)
        if levels is not None:
            own = (levels == i).double()
        elif owned is not None:
            own = owned.double()
        else:
            own = torch.ones_like(samples)
        own_samples += float((samples * own).sum())
        own_footprint += float((footprint * own).sum())
        all_samples += float(samples.sum())
    nbytes = elem_bytes * (sum(m[0] * m[1] * m[2] * m[3] for m in maps)
                           + rows * p * p * c)
    if owned is not None:
        nbytes += (16 + 8) * rows
    else:
        nbytes += 4 * rois.numel()
        if levels is not None:
            nbytes += 8 * levels.numel()
    return dict(bytes=nbytes,
                operations=ROI_SAMPLE_OPS * c * own_samples + rows * p * p * c,
                old_l2_bytes=elem_bytes * 4 * c * all_samples,
                footprint_bytes=elem_bytes * c * own_footprint)


# ---------------------------------------------------------------- checks

def check_nms(boxes, valid, thresh,
              max_keep=None) -> tuple[int, torch.Tensor]:
    from da_detect_tpu_torch.ops import nms, nms_cuda

    got = nms_cuda.nms_mask_sorted(boxes, valid, thresh, max_keep)
    want = nms.nms_mask_sorted(boxes, valid, thresh, max_keep)
    torch.cuda.synchronize()
    mismatches = int((got != want).sum())
    if mismatches:
        raise AssertionError(f"NMS kernel keep mask differs from the plain "
                             f"version in {mismatches} of {got.numel()} rows "
                             f"(shape {tuple(boxes.shape)}, IoU {thresh}, "
                             f"max_keep {max_keep})")
    return mismatches, got


def fwd_call(maps, rois, levels, kw, plain: bool = False):
    """The forward kernel's wrapper (or with ``plain`` its plain version) on
    one captured input: one map, or several with each ROI's level."""
    from da_detect_tpu_torch.ops import roi_align, roi_align_cuda

    if levels is None:
        fn = roi_align.roi_align if plain else roi_align_cuda.roi_align_forward
        return fn(maps[0], rois, **kw)
    fn = roi_align.roi_align_levels if plain \
        else roi_align_cuda.roi_align_levels_forward
    return fn(maps, rois, levels, **kw)


def check_roi_align_fwd(maps, rois, levels, kw) -> float:
    """The forward kernel against its plain version, one map or several;
    bfloat16 maps also against the plain version in float32 (one ulp a
    value)."""
    got = fwd_call(maps, rois, levels, kw)
    want = fwd_call(maps, rois, levels, kw, plain=True)
    torch.cuda.synchronize()
    if not got.numel():
        return 0.0
    if maps[0].dtype == torch.bfloat16:
        if got.dtype != torch.bfloat16:
            raise AssertionError(f"ROIAlign kernel returned {got.dtype}")
        err = float((got.float() - want.float()).abs().max())
        scale = float(want.float().abs().max())
        if not err <= BF16_ROI_ULPS * bf16_ulp(scale):
            raise AssertionError(f"bfloat16 ROIAlign kernel differs from the "
                                 f"plain version by {err:.3e} (max |out| "
                                 f"{scale:.3e})")
        within_one_ulp(got, fwd_call([m.float() for m in maps], rois, levels,
                                     kw, plain=True), 1e-6)
        return err
    torch.testing.assert_close(got, want, **ROI_TOL)
    return float((got - want).abs().max())


def fwd_inputs(captured) -> list:
    """A summary of each captured forward input, for the phase lines."""
    out = []
    for maps, rois, levels, kw in captured["roi_align_fwd"]:
        row = dict(features=[list(m.shape) for m in maps],
                   rois=list(rois.shape), **kw)
        if levels is not None:
            row["rois_a_level"] = [int((levels == i).sum())
                                   for i in range(len(maps))]
        out.append(row)
    return out


def check_roi_align_backward(rois, grad, height, width,
                             **kw) -> tuple[float, float]:
    """Backward kernel against autograd of the plain version
    (``roi_align_grad``); raises past ROI_BWD_REL of the largest |dF|, or
    if a second launch differs from the first by a bit (it sums in a fixed
    order). Returns (max abs error, max |dF|)."""
    from da_detect_tpu_torch.ops import roi_align, roi_align_cuda

    got = roi_align_cuda.roi_align_backward(grad, rois, height=height,
                                            width=width, **kw)
    again = roi_align_cuda.roi_align_backward(grad, rois, height=height,
                                              width=width, **kw)
    want = roi_align.roi_align_grad(grad, rois, height=height, width=width,
                                    **kw)
    torch.cuda.synchronize()
    if not torch.equal(got, again):
        raise AssertionError(f"ROIAlign backward kernel not reproducible: "
                             f"two launches differ (grad "
                             f"{tuple(grad.shape)})")
    if not want.numel():
        return 0.0, 0.0
    err = float((got.float() - want.float()).abs().max())
    scale = float(want.float().abs().max())
    if grad.dtype == torch.bfloat16:
        if got.dtype != torch.bfloat16:
            raise AssertionError(f"ROIAlign backward kernel returned "
                                 f"{got.dtype}")
        if not err <= BF16_ROI_ULPS * bf16_ulp(scale):
            raise AssertionError(f"bfloat16 ROIAlign backward kernel differs "
                                 f"from the plain version by {err:.3e} (max "
                                 f"|dF| {scale:.3e}, grad "
                                 f"{tuple(grad.shape)})")
        want32 = roi_align.roi_align_grad(grad.float(), rois, height=height,
                                          width=width, **kw)
        within_one_ulp(got, want32, 1e-5 * float(want32.abs().max()))
        return err, scale
    if not err <= ROI_BWD_REL * scale:
        raise AssertionError(f"ROIAlign backward kernel differs from the "
                             f"plain version by {err:.3e} (max |dF| "
                             f"{scale:.3e}, grad {tuple(grad.shape)})")
    return err, scale


def check_gather(name: str, table, idx) -> float:
    """The named gather kernel against the plain version: bit for bit."""
    from da_detect_tpu_torch.ops import gather, gather_cuda

    got = getattr(gather_cuda, name)(table, idx)
    want = gather.row_gather(table, idx)
    torch.cuda.synchronize()
    if got.shape != want.shape or not torch.equal(got, want):
        bad = int((got != want).any(-1).sum()) if got.shape == want.shape \
            else "all"
        raise AssertionError(f"gather kernel {name} differs from the plain "
                             f"version in {bad} of {idx.numel()} rows (table "
                             f"{tuple(table.shape)} {table.dtype})")
    return float((got.float() - want.float()).abs().max()) \
        if got.numel() else 0.0


def scatter_bits(got, start, grad, idx) -> dict:
    """The scatter-add kernel's result ``got`` from ``start`` (the
    destination before the call, on the CPU) against the CPU: is it equal
    bit for bit to index_add_ on every row of at most LONG_ROW sources
    (both add in source order), and on every row to the kernel's order in
    plain PyTorch (``row_scatter_add_csr_``: longer rows in pieces)."""
    from da_detect_tpu_torch.ops import gather

    got, grad, idx = got.cpu(), grad.cpu(), idx.cpu()
    perm, row_ptr = gather.row_csr(idx, start.shape[0])
    short = (row_ptr[1:] - row_ptr[:-1]) <= gather.LONG_ROW
    added = gather.row_scatter_add_(start.clone(), grad, idx)
    ordered = gather.row_scatter_add_csr_(start.clone(), grad, perm, row_ptr)
    return dict(index_add_short_rows=torch.equal(got[short], added[short]),
                kernel_order=torch.equal(got, ordered),
                rows_in_pieces=int((~short).sum()))


def check_scatter(dst, grad, idx) -> tuple[float, float, int]:
    """The scatter-add kernel adding into ``dst`` (a view, any row stride)
    against index_add_ on a copy of it on the card: raises past SCATTER_REL
    of the largest |dst|; and against the CPU (``scatter_bits``): raises
    unless bit for bit. Then its fresh-output form twice: raises unless the
    two are equal bit for bit and pass the same CPU checks. Returns (max
    abs error against the card's index_add_, max |dst|, rows summed in
    pieces)."""
    from da_detect_tpu_torch.ops import gather, gather_cuda

    start = dst.cpu()
    want = gather.row_scatter_add_(dst.clone(), grad, idx)
    got = gather_cuda.row_scatter_add_(dst, grad, idx)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    scale = float(want.abs().max())
    if not err <= SCATTER_REL * scale:
        raise AssertionError(f"scatter-add kernel differs from index_add_ by "
                             f"{err:.3e} (max |dst| {scale:.3e}, dst "
                             f"{tuple(dst.shape)} stride {dst.stride(0)}, "
                             f"{idx.numel()} rows)")
    runs = [gather_cuda.row_scatter_add(grad, idx, dst.shape[0])
            for _ in range(2)]
    checks = [scatter_bits(got, start, grad, idx),
              scatter_bits(runs[0], torch.zeros(dst.shape), grad, idx),
              dict(rerun_identical=torch.equal(runs[0], runs[1]))]
    for bits in checks:
        if not all(v for k, v in bits.items() if k != "rows_in_pieces"):
            raise AssertionError(f"scatter-add kernel not bit for bit as "
                                 f"expected: {bits} (dst {tuple(dst.shape)} "
                                 f"stride {dst.stride(0)}, {idx.numel()} "
                                 f"rows)")
    return err, scale, checks[0]["rows_in_pieces"]


def longest_row(csr) -> int:
    """The most sources that one destination row of a CSR owns."""
    _, row_ptr = csr
    return int((row_ptr[1:] - row_ptr[:-1]).max()) if row_ptr.numel() > 1 \
        else 0


def scatter_traffic(records) -> dict:
    """How a step's scatter-adds (``records`` from ``record_kernel_inputs``,
    each with its layer's CSR) spread over their destination rows: the
    sources, the share of them in rows of more than LONG_ROW (which the
    kernel sums in pieces), those rows, the records that hold one, and the
    longest row."""
    from da_detect_tpu_torch.ops import gather

    long_sources = rows_in_pieces = with_long = longest = 0
    at = records[0]
    for rec in records:
        counts = rec["csr"][1][1:] - rec["csr"][1][:-1]
        big = counts > gather.LONG_ROW
        long_sources += int(counts[big].sum())
        rows_in_pieces += int(big.sum())
        with_long += bool(big.any())
        if longest_row(rec["csr"]) > longest:
            longest, at = longest_row(rec["csr"]), rec
    sources = sum(rec["idx"].numel() for rec in records)
    return dict(sources=sources, long_row_share=long_sources / sources,
                rows_in_pieces=rows_in_pieces,
                records_with_long_rows=with_long, records=len(records),
                longest_row=dict(sources=longest, dst=list(at["shape"]),
                                 indices=at["idx"].numel()))


@contextlib.contextmanager
def record_kernel_inputs():
    """While open, each kernel wrapper's inputs are recorded on the way (the
    kernels' inputs as a main path gives them): yields a dict kernel name ->
    list of inputs (ROIAlign forward: the maps, ROIs, levels or None, and
    the keywords of the one-level or the level-aware wrapper). A gather's
    table is kept by reference (no copy): the forward writes no tensor in
    place. A scatter-add is checked where it runs, against the plain
    version on its own gradient (kept nowhere: a step's would fill the
    card), and recorded as its indices, the CSR its caller handed over (or
    None), its destination's shape and the error and largest |dst|, both
    left on the device; the first of each destination shape is also run
    again and checked bit for bit (``scatter_bits``)."""
    from da_detect_tpu_torch.ops import (gather, gather_cuda, nms_cuda,
                                         roi_align_cuda)

    captured = {name: [] for name in SOURCES}
    nms_kernel = nms_cuda.nms_mask_sorted
    fwd_kernel = roi_align_cuda.roi_align_forward
    levels_kernel = roi_align_cuda.roi_align_levels_forward
    bwd_kernel = roi_align_cuda.roi_align_backward
    gathers = {name: getattr(gather_cuda, name)
               for name in ("row_gather", "row_gather_bulk")}
    scatter_kernel = gather_cuda.row_scatter_add

    def gather_rec(name):
        def rec(table, idx, csr=None):
            captured[name].append((table, idx.clone()))
            return gathers[name](table, idx, csr)
        return rec

    def scatter_rec(grad, idx, num_rows, csr=None):
        got = scatter_kernel(grad, idx, num_rows, csr)
        want = gather.row_scatter_add(grad, idx, num_rows)
        rec = dict(idx=idx.clone(), csr=csr, shape=(num_rows, grad.shape[1]),
                   dtype=grad.dtype,
                   err=(got.float() - want.float()).abs().max(),
                   scale=want.float().abs().max())
        if not any(r["shape"] == rec["shape"] and "bits" in r
                   for r in captured["row_scatter_add"]):
            again = scatter_kernel(grad, idx, num_rows, csr)
            rec["bits"] = dict(
                rerun_identical=torch.equal(got, again),
                **scatter_bits(got, torch.zeros(rec["shape"],
                                                dtype=grad.dtype),
                               grad, idx))
        captured["row_scatter_add"].append(rec)
        return got

    def nms_rec(boxes, valid, thresh, max_keep=None):
        captured["nms"].append((boxes.clone(), valid.clone(), thresh,
                                max_keep))
        return nms_kernel(boxes, valid, thresh, max_keep)

    def fwd_rec(features, rois, **kw):
        captured["roi_align_fwd"].append(([features.detach().clone()],
                                          rois.clone(), None, kw))
        return fwd_kernel(features, rois, **kw)

    def levels_rec(features, rois, levels, **kw):
        captured["roi_align_fwd"].append((
            [f.detach().clone() for f in features], rois.clone(),
            levels.clone(), kw))
        return levels_kernel(features, rois, levels, **kw)

    def bwd_rec(grad, rois, *, height, width, **kw):
        # the clone keeps the gradient's strides; and whether the kernel
        # wrapper reads it in place or copies it
        captured["roi_align_bwd"].append((
            grad.clone(), rois.clone(), height, width, kw,
            roi_align_cuda.grad_view(grad)[1]))
        return bwd_kernel(grad, rois, height=height, width=width, **kw)

    nms_cuda.nms_mask_sorted = nms_rec
    roi_align_cuda.roi_align_forward = fwd_rec
    roi_align_cuda.roi_align_levels_forward = levels_rec
    roi_align_cuda.roi_align_backward = bwd_rec
    for name in gathers:
        setattr(gather_cuda, name, gather_rec(name))
    gather_cuda.row_scatter_add = scatter_rec
    try:
        yield captured
    finally:
        nms_cuda.nms_mask_sorted = nms_kernel
        roi_align_cuda.roi_align_forward = fwd_kernel
        roi_align_cuda.roi_align_levels_forward = levels_kernel
        roi_align_cuda.roi_align_backward = bwd_kernel
        for name, fn in gathers.items():
            setattr(gather_cuda, name, fn)
        gather_cuda.row_scatter_add = scatter_kernel


def check_captured(captured) -> dict:
    """Each kernel against its plain version on a main path's own inputs
    (``captured`` from ``record_kernel_inputs``): the largest error a
    kernel."""
    errs = {}
    for boxes, valid, thresh, max_keep in captured["nms"]:
        errs["nms"] = max(errs.get("nms", 0),
                          check_nms(boxes, valid, thresh, max_keep)[0])
    for maps, rois, levels, kw in captured["roi_align_fwd"]:
        errs["roi_align_fwd"] = max(errs.get("roi_align_fwd", 0.0),
                                    check_roi_align_fwd(maps, rois, levels,
                                                        kw))
    for grad, rois, h, w, kw, _ in captured["roi_align_bwd"]:
        errs["roi_align_bwd"] = max(
            errs.get("roi_align_bwd", 0.0),
            check_roi_align_backward(rois, grad, h, w, **kw)[0])
    for name in ("row_gather", "row_gather_bulk"):
        for table, idx in captured[name]:
            errs[name] = max(errs.get(name, 0.0),
                             check_gather(name, table, idx))
    for rec in captured["row_scatter_add"]:
        err, scale = float(rec["err"]), float(rec["scale"])
        tol = bf16_ulp(scale) if rec["dtype"] == torch.bfloat16 \
            else SCATTER_REL * scale
        if not err <= tol:
            raise AssertionError(f"scatter-add kernel differs from index_add_"
                                 f" by {err:.3e} (max |dst| {scale:.3e}, dst "
                                 f"{rec['shape']}, {rec['idx'].numel()} rows)")
        if not all(v for k, v in rec.get("bits", {}).items()
                   if k != "rows_in_pieces"):
            raise AssertionError(f"scatter-add kernel not bit for bit as "
                                 f"expected: {rec['bits']} (dst "
                                 f"{rec['shape']}, {rec['idx'].numel()} rows)")
        errs["row_scatter_add"] = max(errs.get("row_scatter_add", 0.0), err)
    return errs


def match_detections(a, b, bf16_ref=None) -> dict:
    """The kernel run's detections ``a`` against the plain run's ``b``.
    float32 (``bf16_ref`` None): equal valid counts and every detection of
    ``a`` with a twin in ``b`` (DET_* bounds); raises otherwise. bfloat16:
    ``bf16_ref`` is the plain run of an f32 copy of the model, and with
    the BF16_DET_* bounds the detections of ``a`` without a twin in ``b``
    number at most those of ``b`` without a twin in ``bf16_ref``, or 1:
    the kernels move a request's detections no more than bfloat16 itself
    does (with random weights, ulp-apart scores reorder the per-class NMS
    and keep other boxes)."""
    from da_detect_tpu_torch.e2e_pairs import twins

    if bf16_ref is None:
        out = twins(a, b, DET_BOX_ATOL, DET_SCORE_ATOL)
        if out["valid"][0] != out["valid"][1]:
            raise AssertionError(f"kernel run kept {out['valid'][0]} "
                                 f"detections, plain run {out['valid'][1]}")
        if out["without_twin"]:
            raise AssertionError(f"kernel-run detections without a twin in "
                                 f"the plain run: {out['without_twin']}")
        return out
    out = twins(a, b, BF16_DET_BOX_ATOL, BF16_DET_SCORE_ATOL)
    ref = twins(b, bf16_ref, BF16_DET_BOX_ATOL, BF16_DET_SCORE_ATOL)
    allowed = max(1, len(ref["without_twin"]))
    if len(out["without_twin"]) > allowed:
        raise AssertionError(
            f"{len(out['without_twin'])} kernel-run detections without a "
            f"twin in the plain bf16 run, more than the {allowed} that bf16 "
            f"itself moves (plain bf16 against f32): {out['without_twin']}")
    return dict(out, bf16_vs_f32=dict(
        valid=ref["valid"], matched=ref["matched"],
        without_twin=len(ref["without_twin"])))


# ---------------------------------------------------------------- phases

def phase_env() -> str:
    from da_detect_tpu_torch import kernels

    nvcc = subprocess.run([kernels.nvcc_path(), "--version"],
                          capture_output=True, text=True, check=True).stdout
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, check=True
                         ).stdout.strip()
    emit("env", torch=torch.__version__, cuda=torch.version.cuda,
         nvcc=[l for l in nvcc.splitlines() if "release" in l][0].strip(),
         nvidia_smi=smi, device=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count())
    return smi


def phase_build() -> None:
    from da_detect_tpu_torch import kernels

    t0 = time.perf_counter()
    reports = kernels.build()
    seconds = time.perf_counter() - t0
    for name in kernels.SOURCES:
        kernels.load(name)
    ptxas = {name: [l.strip() for l in log.splitlines()
                    if "registers" in l or "spill" in l]
             for name, log in reports.items()}
    emit("build", seconds=seconds, built=sorted(reports), ptxas=ptxas)


def phase_kernels(dev) -> dict:
    """Kernel against plain on the card: synthetic inputs at the slice's
    shapes, then the CPU tests' edge cases. Returns the largest errors."""
    rng = np.random.RandomState(0)
    results = {}

    def nms_case(name, boxes, valid, thresh, max_keep=None):
        boxes = torch.from_numpy(boxes).to(dev)
        valid = torch.from_numpy(valid).to(dev)
        mism, keep = check_nms(boxes, valid, thresh, max_keep)
        results[name] = dict(mismatches=mism, kept=int(keep.sum()),
                             shape=list(boxes.shape), iou=thresh,
                             max_keep=max_keep)

    # RPN: 6000 -> NMS at 0.7, two images
    nms_case("nms_rpn", *cluster_boxes(rng, 2, RPN_NMS_BOXES, CANVAS), 0.7)
    # box head: 2048 candidates, 8 classes by coordinate offset, NMS at 0.3
    boxes, valid = cluster_boxes(rng, 1, BOX_HEAD_NMS_BOXES, CANVAS)
    cls = rng.randint(1, 9, (1, BOX_HEAD_NMS_BOXES)).astype(np.float32)
    unit = boxes.max() + 1.0
    nms_case("nms_box_head", (boxes + cls[..., None] * unit).astype(
        np.float32), valid, 0.3)
    # edges: one box, a ragged 64-block, all invalid, three images
    nms_case("nms_n1", *cluster_boxes(rng, 1, 1, CANVAS), 0.5)
    nms_case("nms_n65_b3", *cluster_boxes(rng, 3, 65, (120, 160)), 0.5)
    b, _ = cluster_boxes(rng, 1, 300, (120, 160))
    nms_case("nms_all_invalid", b, np.zeros((1, 300), bool), 0.5)
    nms_case("nms_n63_b2", *cluster_boxes(rng, 2, 63, (120, 160)), 0.7)
    nms_case("nms_n64_b2", *cluster_boxes(rng, 2, 64, (120, 160)), 0.3)
    # a ragged batch: all, about half and none of the boxes valid
    boxes, valid = cluster_boxes(rng, 3, 1000, CANVAS)
    valid[0], valid[1], valid[2] = True, rng.rand(1000) > 0.5, False
    nms_case("nms_ragged_b3", boxes, valid, 0.5)
    # the train RPN's shape, whole and stopped after k kept (nms_topk's
    # max_keep; k past the survivors gives the whole mask)
    boxes, valid = cluster_boxes(rng, 1, TRAIN_NMS_BOXES, CANVAS)
    nms_case("nms_train", boxes, valid, 0.7)
    for k in (1, 100, 2000, TRAIN_NMS_BOXES + 1):
        nms_case(f"nms_train_max_keep_{k}", boxes, valid, 0.7, max_keep=k)
    # nms_topk through the kernel's early stop against the top k of the
    # plain version's whole mask
    from da_detect_tpu_torch.ops import nms

    boxes, valid = torch.from_numpy(boxes).to(dev), torch.from_numpy(
        valid).to(dev)
    scores = torch.linspace(1.0, 0.0, TRAIN_NMS_BOXES, device=dev)[None]
    whole = nms.nms_mask_sorted(boxes, valid, 0.7)
    for k in (100, 2000):
        got = nms.nms_topk(boxes, scores, valid, 0.7, k, impl="cuda",
                           presorted=True)
        want = nms.topk_survivors(whole, scores, k)
        if not all(torch.equal(g, w) for g, w in zip(got, want)):
            raise AssertionError(f"nms_topk(k={k}) through the kernel's "
                                 "max_keep differs from the top k of the "
                                 "whole mask")
        results[f"nms_topk_{k}"] = dict(mismatches=0,
                                        valid=int(got[1].sum()))

    def roi_case(name, feats_nhwc, rois, **kw):
        feats = torch.from_numpy(feats_nhwc).to(dev).permute(0, 3, 1, 2)
        err = check_roi_align_fwd([feats], torch.from_numpy(rois).to(dev),
                                  None, kw)
        results[name] = dict(max_abs_err=err, features=list(feats.shape),
                             rois=list(rois.shape), **kw)

    c4 = (CANVAS[0] // 16, CANVAS[1] // 16)
    kw14 = dict(spatial_scale=1.0 / 16, output_size=14, sampling_ratio=0)
    roi_case("roi_slice", rng.randn(1, *c4, C4_CHANNELS).astype(np.float32),
             random_rois(rng, 1, SLICE_ROIS, CANVAS, 900.0), max_samples=8,
             **kw14)
    roi_case("roi_p7_s2_r11",
             rng.randn(2, 10, 16, 128).astype(np.float32),
             random_rois(rng, 2, 11, (160, 256), 80.0), spatial_scale=1 / 16,
             output_size=7, sampling_ratio=2, max_samples=8)
    oob = np.asarray([[[-40.0, -30.0, 60.0, 50.0], [200.0, 120.0, 300.0, 200.0],
                       [-100.0, -100.0, -50.0, -50.0], [1e4, 1e4, 2e4, 2e4],
                       [30.0, 40.0, 30.0, 40.0], [80.0, 90.0, 20.0, 10.0],
                       [-16.0, 0.0, 256.0, 160.0]]], np.float32)
    for sr in (2, 0):
        roi_case(f"roi_out_of_bounds_s{sr}",
                 rng.randn(1, 10, 16, 16).astype(np.float32), oob,
                 spatial_scale=1 / 16, output_size=7, sampling_ratio=sr,
                 max_samples=8)
    wide = np.asarray([[[2.0, 2.0, 1210.0, 600.0], [0.0, 100.0, 1216.0, 180.0],
                        [30.0, 40.0, 200.0, 300.0],
                        [-400.0, 0.0, 2400.0, 600.0]]], np.float32)
    for cap in (8, 4):
        roi_case(f"roi_wide_cap{cap}", rng.randn(1, *c4, 8).astype(np.float32),
                 wide, max_samples=cap, **kw14)
    # one C4 launch whose ROIs cover the whole map at cap 8: the widest bin
    # rows, walked in several steps of the forward kernel's tile
    roi_case("roi_whole_c4_cap8",
             rng.randn(1, *c4, C4_CHANNELS).astype(np.float32),
             np.asarray([[[0.0, 0.0, 1216.0, 608.0],
                          [-30.0, -20.0, 1250.0, 640.0],
                          [-400.0, 0.0, 2400.0, 600.0]]], np.float32),
             max_samples=8, **kw14)

    def levels_case(name, b, r, c, empty_level=None):
        """The level-aware launch at the DCN pooler's maps (P 7, sampling
        ratio 2) against every level, then the mask."""
        maps, rois, levels = fpn_inputs(rng, b, r, c, dev, empty_level)
        kw = dict(scales=FPN_SCALES, output_size=7, sampling_ratio=2,
                  max_samples=8)
        err = check_roi_align_fwd(maps, rois, levels, kw)
        results[name] = dict(
            max_abs_err=err, features=[list(m.shape) for m in maps],
            rois=list(rois.shape),
            rois_a_level=[int((levels == i).sum()) for i in range(4)], **kw)

    levels_case("roi_levels_dcn", 1, SLICE_ROIS, 256)
    levels_case("roi_levels_empty_p3_b2", 2, 300, 256, empty_level=1)
    levels_case("roi_levels_no_roi_b2", 2, 0, 256)

    def mask_case(name, b, r, dtype):
        """The mask pooler's shapes at 800x1344 (P 14, sampling ratio 2,
        256 channels, P2-P5): the level-aware forward, then the backward a
        level on the gradient masked to its ROIs, channels-last as autograd
        hands it over (each also run twice, bit for bit the same)."""
        from da_detect_tpu_torch.ops import roi_align_cuda

        maps, rois, levels = fpn_inputs(mask_rng, b, r, 256, dev,
                                        shapes=MASK_FPN_SHAPES,
                                        canvas=MASK_CANVAS)
        maps = [m.to(dtype) for m in maps]
        err = check_roi_align_fwd(maps, rois, levels, MASK_POOLER)
        elem = maps[0].element_size()
        results[name] = dict(
            max_abs_err=err, dtype=str(dtype)[6:],
            features=[list(m.shape) for m in maps], rois=list(rois.shape),
            rois_a_level=[int((levels == i).sum()) for i in range(4)],
            fwd_tiling=[roi_align_cuda.fwd_tiling(h, w, 14, 2, elem)
                        for h, w in MASK_FPN_SHAPES],
            bwd_tiling=[roi_align_cuda.bwd_tiling(h, w, 14, 2, elem)
                        for h, w in MASK_FPN_SHAPES], **MASK_POOLER)
        grad = torch.from_numpy(mask_rng.randn(b, r, 14, 14, 256).astype(
            np.float32)).to(dev, dtype).permute(0, 1, 4, 2, 3)
        for i, ((h, w), scale) in enumerate(zip(MASK_FPN_SHAPES,
                                               FPN_SCALES)):
            sel = (levels == i).to(dtype)[..., None, None, None]
            g = grad * sel
            err, top = check_roi_align_backward(
                rois, g, h, w, spatial_scale=scale, output_size=14,
                sampling_ratio=2, max_samples=8)
            results[f"{name.replace('roi', 'bwd')}_p{i + 2}"] = dict(
                max_abs_err=err, max_abs_dF=top, dtype=str(dtype)[6:],
                features=[b, 256, h, w], grad=list(g.shape),
                grad_copied=roi_align_cuda.grad_view(g)[1],
                rois_of_level=int((levels == i).sum()),
                rerun_identical=True)

    mask_rng = np.random.RandomState(12)  # the other cases' draws unchanged
    for dtype, prefix in ((torch.float32, ""), (torch.bfloat16, "bf16_")):
        mask_case(f"{prefix}roi_mask_eval", 1, MASK_EVAL_ROIS, dtype)
        mask_case(f"{prefix}roi_mask_train", MASK_TRAIN_IMAGES,
                  MASK_TRAIN_ROIS, dtype)

    def bwd_case(name, map_shape, rois, strided=False, **kw):
        """map_shape (B, C, H, W); a random upstream gradient, [B, R, C, P,
        P] contiguous, or with ``strided`` an R slice of a channels-last one
        (as autograd hands it over: read in place)."""
        from da_detect_tpu_torch.ops import roi_align_cuda

        b, c, h, w = map_shape
        p, r = kw["output_size"], rois.shape[1]
        if strided:
            grad = torch.from_numpy(rng.randn(b, r + 3, p, p, c).astype(
                np.float32)).to(dev).permute(0, 1, 4, 2, 3)[:, 1:r + 1]
        else:
            grad = torch.from_numpy(rng.randn(b, r, c, p, p).astype(
                np.float32)).to(dev)
        err, scale = check_roi_align_backward(torch.from_numpy(rois).to(dev),
                                              grad, h, w, **kw)
        results[name] = dict(max_abs_err=err, max_abs_dF=scale,
                             features=list(map_shape), rois=list(rois.shape),
                             grad_copied=roi_align_cuda.grad_view(grad)[1],
                             **kw)

    # the train step's shape: 256 ROIs on the C4 map, P = 14
    bwd_case("bwd_train", (1, C4_CHANNELS, *c4),
             random_rois(rng, 1, TRAIN_ROIS, CANVAS, 900.0), max_samples=8,
             **kw14)
    bwd_case("bwd_p7_s2_r11", (2, 128, 10, 16),
             random_rois(rng, 2, 11, (160, 256), 80.0), spatial_scale=1 / 16,
             output_size=7, sampling_ratio=2, max_samples=8)
    for sr in (2, 0):  # off the map, degenerate (zero size) and inverted
        bwd_case(f"bwd_out_of_bounds_s{sr}", (1, 16, 10, 16), oob,
                 spatial_scale=1 / 16, output_size=7, sampling_ratio=sr,
                 max_samples=8)
    bwd_case("bwd_empty", (1, 16, 10, 16), np.zeros((1, 0, 4), np.float32),
             spatial_scale=1 / 16, output_size=7, sampling_ratio=2,
             max_samples=8)
    whole = np.asarray([[[0.0, 0.0, 1216.0, 608.0],
                         [-30.0, -20.0, 1250.0, 640.0]]], np.float32)
    bwd_case("bwd_whole_c4", (1, C4_CHANNELS, *c4), whole, max_samples=8,
             **kw14)
    # FPN P2 at 608x1216 (the DCN YAML's pooler: P 7, sampling ratio 2)
    bwd_case("bwd_whole_p2", (1, 256, CANVAS[0] // 4, CANVAS[1] // 4),
             whole[:, :1], spatial_scale=1 / 4, output_size=7,
             sampling_ratio=2, max_samples=8)
    edges = np.asarray([[[-100.0, 100.0, 200.0, 300.0],
                         [100.0, -100.0, 300.0, 200.0],
                         [1100.0, 100.0, 1400.0, 300.0],
                         [100.0, 500.0, 300.0, 800.0],
                         [-50.0, -50.0, 60.0, 40.0],
                         [1150.0, 560.0, 1300.0, 700.0]]], np.float32)
    bwd_case("bwd_map_edges", (1, 64, *c4), edges, max_samples=8, **kw14)
    for c in (4, 12):  # the last 32-channel slice partly empty
        bwd_case(f"bwd_c{c}", (1, c, *c4),
                 random_rois(rng, 1, 20, CANVAS, 900.0), max_samples=8,
                 **kw14)
    # 800 rows: 50 tiles in a column, each ROI across many
    tall = np.asarray([[[0.0, 0.0, 128.0, 12800.0],
                        [10.0, 300.0, 90.0, 5000.0]]], np.float32)
    bwd_case("bwd_tall_map", (1, 8, 800, 8), tall, max_samples=8, **kw14)
    bwd_case("bwd_strided_grad", (1, C4_CHANNELS, *c4),
             random_rois(rng, 1, 40, CANVAS, 900.0), strided=True,
             max_samples=8, **kw14)

    from da_detect_tpu_torch.ops import gather, gather_cuda

    gather_errs = {"row_gather": 0.0, "row_gather_bulk": 0.0}
    for case, (s, c, p, stride) in GATHER_CASES.items():
        for dtype in ((torch.float32, torch.bfloat16)
                      if case in GATHER_BF16_CASES else (torch.float32,)):
            wide = torch.from_numpy(rng.randn(s, stride or c).astype(
                np.float32)).to(dev, dtype)
            table = wide[:, 8:8 + c] if stride else wide
            # a tenth of the indices out of range on either side: clamped
            idx = torch.from_numpy(rng.randint(
                -s // 10 - 1, s + s // 10 + 1, p).astype(np.int32)).to(dev)
            for name in gather_errs:
                key = f"{name}_{case}_{str(dtype)[6:]}"
                if name == "row_gather_bulk" and (c * table.element_size()
                                                  ) % 16:
                    try:
                        gather_cuda.row_gather_bulk(table, idx)
                    except ValueError:
                        results[key] = dict(refused="rows not 16-byte "
                                                    "aligned")
                        continue
                    raise AssertionError(f"{key}: unaligned rows accepted")
                err = check_gather(name, table, idx)
                gather_errs[name] = max(gather_errs[name], err)
                results[key] = dict(max_abs_err=err, table=[s, c],
                                    row_stride=table.stride(0), indices=p)
    scatter_err = 0.0
    for case, (s, c, p, stride, span) in SCATTER_CASES.items():
        lo, hi = span or (-s // 10 - 1, s + s // 10 + 1)
        wide = torch.from_numpy(rng.randn(s, stride or c).astype(
            np.float32)).to(dev)
        dst = wide[:, 8:8 + c] if stride else wide
        grad = torch.from_numpy(rng.randn(p, c).astype(np.float32)).to(dev)
        idx = torch.from_numpy(rng.randint(lo, hi, p).astype(np.int32)).to(
            dev)
        err, scale, in_pieces = check_scatter(dst, grad, idx)
        scatter_err = max(scatter_err, err)
        csr = gather.row_csr(idx, s)
        results[f"row_scatter_add_{case}"] = dict(
            max_abs_err=err, max_abs_dst=scale, bits_as_expected=True,
            rows_in_pieces=in_pieces, dst=[s, c], row_stride=dst.stride(0),
            indices=p, longest_row=longest_row(csr),
            # CUDA events around a fresh-output call: the CSR given, and
            # built by the wrapper
            ms=time_ms(lambda: gather_cuda.row_scatter_add(grad, idx, s,
                                                           csr)),
            csr_build_ms=time_ms(lambda: gather_cuda.row_scatter_add(
                grad, idx, s)))

    # the FBNet poolers' shapes (P 6, adaptive sampling, one stride-16
    # map): 8192 ROIs on 16 images at 128 channels (320x640) and at 88
    # (chamv1a, 600x1000: the forward's last 32-channel slice 24 wide), in
    # float32 (FBNet's BatchNorm feeds float32 maps in both dtypes);
    # RetinaNet's NMS: 5000 class-offset boxes (80 classes), IoU 0.4,
    # stopped at 100 kept and whole
    from da_detect_tpu_torch.ops import roi_align_cuda

    fb_rng = np.random.RandomState(13)  # the other cases' draws unchanged
    for case, (h, w), c, canvas in (
            ("fbnet_c128", FBNET_MAP, FBNET_CHANNELS, FBNET_CANVAS),
            ("fbnet_c88", CHAM_MAP, CHAM_CHANNELS, CHAM_CANVAS)):
        rois = random_rois(fb_rng, FBNET_TRAIN_IMAGES, FBNET_TRAIN_ROIS,
                           canvas, 400.0)
        roi_case(f"roi_{case}", fb_rng.randn(
            FBNET_TRAIN_IMAGES, h, w, c).astype(np.float32), rois,
            **FBNET_POOLER)
        results[f"roi_{case}"]["fwd_tiling"] = roi_align_cuda.fwd_tiling(
            h, w, 6, 8)
        bwd_case(f"bwd_{case}", (FBNET_TRAIN_IMAGES, c, h, w), rois,
                 **FBNET_POOLER)
        results[f"bwd_{case}"]["bwd_tiling"] = roi_align_cuda.bwd_tiling(
            h, w, 6, 8)
    boxes, valid = cluster_boxes(fb_rng, 1, RETINA_NMS_BOXES, RETINA_CANVAS)
    cls = fb_rng.randint(1, 81, (1, RETINA_NMS_BOXES)).astype(np.float32)
    boxes = (boxes + cls[..., None] * (boxes.max() + 1.0)).astype(np.float32)
    nms_case("nms_retina_class_offset", boxes, valid, RETINA_NMS_IOU,
             max_keep=RETINA_KEEP)
    nms_case("nms_retina_class_offset_whole", boxes, valid, RETINA_NMS_IOU)
    emit("kernels", **results)
    return dict(row_scatter_add=scatter_err,
        nms=max(r["mismatches"] for k, r in results.items()
                if k.startswith("nms")),
        roi_align_fwd=max(r["max_abs_err"] for k, r in results.items()
                          if k.startswith("roi")),
        roi_align_bwd=max(r["max_abs_err"] for k, r in results.items()
                          if k.startswith("bwd")),
        roi_align_fwd_bf16=max(r["max_abs_err"] for k, r in results.items()
                               if k.startswith("bf16_roi")),
        roi_align_bwd_bf16=max(r["max_abs_err"] for k, r in results.items()
                               if k.startswith("bf16_bwd")),
        **gather_errs)


def label(name: str, dtype: str) -> str:
    """A phase's or path's name: float32's as it was, bfloat16's with
    "_bf16"."""
    return name if dtype == "float32" else f"{name}_bf16"


def spread_scores(model) -> None:
    """The RPN's objectness and the box head's class weights times
    SCORE_SCALE (random-init scores otherwise sit within float32 noise of
    each other, under the detection threshold)."""
    with torch.no_grad():
        model.rpn["head"].cls_logits.weight.mul_(SCORE_SCALE)
        model.roi_heads["box"]["predictor"].cls_score.weight.mul_(SCORE_SCALE)


def flagship_model(dev, dtype: str = "float32"):
    """The flagship YAML at the 608x1216 canvas computing in ``dtype``,
    through ``entry(cfg=...)``, score layers spread; and REQUESTS batches."""
    from da_detect_tpu_torch import entry
    from da_detect_tpu_torch.config import get_cfg

    cfg = get_cfg()
    cfg.merge_from_file(FLAGSHIP_YAML)
    cfg.TPU.IMAGE_SHAPE = CANVAS
    cfg.TPU.COMPUTE_DTYPE = dtype
    cfg.freeze()
    fn, (model, _) = entry.entry(device=str(dev), seed=0, cfg=cfg)
    spread_scores(model)
    batches = [entry.make_batch(cfg, 1, seed=s, device=dev)[0]
               for s in range(REQUESTS)]
    return cfg, fn, model, batches


def clear_counts() -> None:
    """Every kernel's launch count and the CSR builds set to 0."""
    from da_detect_tpu_torch import kernels
    from da_detect_tpu_torch.ops import gather

    torch.cuda.synchronize()
    kernels.LAUNCHES.clear()
    gather.CSR_BUILDS.clear()


def read_counts(expected: dict, n: int, label: str, what: str) -> dict:
    """Each kernel's launches and the CSR builds ("row_csr") since
    ``clear_counts``; raises if one ran another number of times than
    ``expected`` (a request's or a step's) times ``n``."""
    from da_detect_tpu_torch import kernels
    from da_detect_tpu_torch.ops import gather

    counts = {name: kernels.LAUNCHES[name] for name in kernels.SOURCES}
    counts["row_csr"] = gather.CSR_BUILDS["row_csr"]
    for name, got in counts.items():
        if got != expected.get(name, 0) * n:
            raise AssertionError(f"{label}: {name} ran {got} times in {n} "
                                 f"{what}, expected "
                                 f"{expected.get(name, 0) * n}")
    return counts


def serve_requests(fn, model, batches, per_forward: dict, label: str):
    """The main path: counts set to 0, one request a batch through ``fn``,
    counts read. Raises if a kernel ran another number of times than
    ``per_forward`` a request, or a CSR was built. Returns (answers,
    launches, seconds)."""
    clear_counts()
    t0 = time.perf_counter()
    answers = [fn(model, b) for b in batches]
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = read_counts(per_forward, len(batches), label, "requests")
    return answers, launches, seconds


def check_detections(cfg, dets, slots=None) -> dict:
    """Shape (``slots`` detections, default ROI_HEADS.DETECTIONS_PER_IMG),
    finiteness and at least one valid detection; a summary."""
    slots = slots or cfg.MODEL.ROI_HEADS.DETECTIONS_PER_IMG
    if tuple(dets.boxes.shape) != (1, slots, 4):
        raise AssertionError(f"detections {tuple(dets.boxes.shape)}")
    if not (torch.isfinite(dets.boxes).all()
            and torch.isfinite(dets.scores).all()):
        raise AssertionError("non-finite detections")
    n_valid = int(dets.valid.sum())
    if n_valid == 0:
        raise AssertionError("a request returned no detection")
    return dict(valid=n_valid, top_score=float(dets.scores.max()),
                labels=sorted(set(dets.labels[dets.valid].tolist())))


def phase_slice(dev, dtype: str = "float32"):
    name = label("slice", dtype)
    cfg, fn, model, batches = flagship_model(dev, dtype)
    answers, launches, seconds = serve_requests(fn, model, batches,
                                                PER_FORWARD, name)
    summary = [check_detections(cfg, dets) for dets in answers]

    with record_kernel_inputs() as captured:
        dets_k = fn(model, batches[0])
    rerun_identical = all(torch.equal(x, y)
                          for x, y in zip(dets_k, answers[0]))
    dets_p = model(batches[0], impl="plain")
    ref = f32_copy(model, cfg)(batches[0], impl="plain") \
        if dtype == "bfloat16" else None
    agreement = match_detections(dets_k, dets_p, ref)
    errs = check_captured(captured)
    emit(name, config=os.path.relpath(FLAGSHIP_YAML, REPO), dtype=dtype,
         canvas=list(CANVAS), requests=REQUESTS, seconds=seconds,
         launches=launches, detections=summary,
         rerun_identical=rerun_identical, plain_agreement=agreement,
         main_path_inputs={
             "nms": [dict(shape=list(b.shape), iou=t, valid=int(v.sum()),
                          max_keep=k)
                     for b, v, t, k in captured["nms"]],
             "roi_align_fwd": fwd_inputs(captured)},
         max_abs_err=errs)
    return model, fn, batches, captured, launches, errs


def stage_times(model, batch, marks, spans, runs: int = 10,
                forward=None) -> dict:
    """Median device time of each stage of the forward (``forward(model,
    batch)``, default ``model(batch)``), from CUDA events recorded by
    module hooks: ``marks`` names modules (events "name.in" and "name.out"
    around each; "start" and "end" around the forward), ``spans`` maps a
    stage to its (first event, last event)."""
    events: dict[str, torch.cuda.Event] = {}

    def rec(key):
        def hook(*_):
            events[key] = torch.cuda.Event(enable_timing=True)
            events[key].record()
        return hook

    handles = []
    for name, mod in marks:
        handles.append(mod.register_forward_pre_hook(rec(name + ".in")))
        handles.append(mod.register_forward_hook(rec(name + ".out")))
    samples = {k: [] for k in spans}
    try:
        for i in range(runs + 2):
            rec("start")()
            model(batch) if forward is None else forward(model, batch)
            rec("end")()
            torch.cuda.synchronize()
            if i >= 2:
                for k, (a, b) in spans.items():
                    samples[k].append(events[a].elapsed_time(events[b]))
    finally:
        for h in handles:
            h.remove()
    return {k: statistics.median(v) for k, v in samples.items()}


def nms_split(boxes, valid, thresh, max_keep, keep) -> dict:
    """One NMS call's device time split into its two launches, the IoU mask
    and the walk, and the walk's steps: the 64-box blocks it resolved, up to
    the block of its stop (the slowest image of the batch)."""
    from da_detect_tpu_torch.ops import nms_cuda

    ms = device_profile(
        lambda: nms_cuda.nms_mask_sorted(boxes, valid, thresh, max_keep),
        KERNEL_PROFILE_RUNS,
        kernels=("nms_mask_kernel", "nms_walk_kernel"))["kernel_ms_per_run"]
    mask_ms, walk_ms = ms["nms_mask_kernel"], ms["nms_walk_kernel"]
    steps = int(-(-nms_stops(keep, max_keep).max() // 64))
    return dict(
        device_ms=None if None in (mask_ms, walk_ms) else mask_ms + walk_ms,
        mask_device_ms=mask_ms, walk_device_ms=walk_ms, walk_steps=steps,
        walk_us_per_step=None if walk_ms is None
        else walk_ms * 1e3 / max(steps, 1))


def level_rows(fwd_captured, rois, scale):
    """The ROIs that an FPN backward launch at ``scale`` owns ([B, R] bool):
    those on that scale's level in the level-aware forward of the same ROIs
    (``fwd_captured``: ``record_kernel_inputs``'s forward inputs). The
    backward launches once a level on the whole gradient with the other
    levels' rows zeroed, so its bound counts the owned rows only, and the
    level's launches together read the gradient once. None (every row):
    a one-map pooler."""
    for _, f_rois, levels, kw in fwd_captured:
        if levels is not None and scale in kw["scales"] \
                and f_rois.shape == rois.shape and torch.equal(f_rois, rois):
            return levels == list(kw["scales"]).index(scale)
    return None


def time_sites(captured, path: str, nms_sites=()) -> list:
    """Kernel and plain times, and the bound, of each kernel launch a main
    path made (``captured`` from ``record_kernel_inputs``), on its inputs.
    NMS is timed at the sites ``nms_sites`` names (none: the bfloat16
    paths, whose NMS takes the same float32 boxes as the float32 ones)."""
    from da_detect_tpu_torch.ops import (gather, gather_cuda, nms, nms_cuda,
                                         roi_align, roi_align_cuda)

    sites = []
    for (boxes, valid, thresh, k), site in zip(captured["nms"], nms_sites):
        keep = nms_cuda.nms_mask_sorted(boxes, valid, thresh, k)
        nbytes, ops = nms_work(valid, keep, k)
        bound_ms, by = bound(nbytes, ops)
        sites.append(dict(
            kernel="nms", path=path, site=site, shape=list(boxes.shape),
            iou=thresh, max_keep=k, kept=int(keep.sum()), bytes=nbytes,
            operations=ops,
            ms=time_ms(lambda: nms_cuda.nms_mask_sorted(boxes, valid, thresh,
                                                        k)),
            plain_ms=time_ms(lambda: nms.nms_mask_sorted(boxes, valid, thresh,
                                                         k),
                             runs=NMS_PLAIN_RUNS, warmup=1),
            bound_ms=bound_ms, bound_by=by,
            **nms_split(boxes, valid, thresh, k, keep)))
    for i, (maps, rois, levels, kw) in enumerate(captured["roi_align_fwd"]):
        work = roi_align_work([m.shape for m in maps], rois, levels, kw,
                              maps[0].element_size())
        bound_ms, by = bound(work["bytes"], work["operations"])
        sites.append(dict(
            kernel="roi_align_fwd", path=path, site=f"pool{i}",
            features=[list(m.shape) for m in maps], rois=list(rois.shape),
            levels=len(maps), **work,
            ms=time_ms(lambda: fwd_call(maps, rois, levels, kw)),
            plain_ms=time_ms(lambda: fwd_call(maps, rois, levels, kw,
                                              plain=True), runs=20),
            device_ms=device_profile(
                lambda: fwd_call(maps, rois, levels, kw),
                KERNEL_PROFILE_RUNS, kernels=("roi_align_fwd_kernel",)
            )["kernel_ms_per_run"]["roi_align_fwd_kernel"],
            bound_ms=bound_ms, bound_by=by))
    for i, (grad, rois, h, w, kw, copied) in enumerate(
            captured["roi_align_bwd"]):
        shape = (grad.shape[0], grad.shape[2], h, w)
        owned = level_rows(captured["roi_align_fwd"], rois,
                           kw["spatial_scale"])
        work = roi_align_work([shape], rois, None, kw, grad.element_size(),
                              owned)
        nbytes, ops = work["bytes"], work["operations"]
        bound_ms, by = bound(nbytes, ops)
        sites.append(dict(
            kernel="roi_align_bwd", path=path, site=f"grad{i}",
            grad=list(grad.shape), grad_copied=copied, features=list(shape),
            rois=list(rois.shape),
            rois_owned=None if owned is None else int(owned.sum()),
            bytes=nbytes, operations=ops,
            ms=time_ms(lambda: roi_align_cuda.roi_align_backward(
                grad, rois, height=h, width=w, **kw)),
            plain_ms=time_ms(lambda: roi_align.roi_align_grad(
                grad, rois, height=h, width=w, **kw), runs=20),
            device_ms=device_profile(
                lambda: roi_align_cuda.roi_align_backward(
                    grad, rois, height=h, width=w, **kw),
                KERNEL_PROFILE_RUNS, kernels=("roi_align_bwd_kernel",)
            )["kernel_ms_per_run"]["roi_align_bwd_kernel"],
            bound_ms=bound_ms, bound_by=by))
    for name in ("row_gather", "row_gather_bulk"):
        kernel = getattr(gather_cuda, name)
        for i, (table, idx) in enumerate(captured[name]):
            s = table.shape[0]
            if idx.numel() and not (0 <= int(idx.min())
                                    and int(idx.max()) < s):
                raise AssertionError(f"{path}: a {name} index of the main "
                                     f"path lies outside its table of {s}")
            # bytes: each distinct row read once, the indices, the output
            rows = int(torch.unique(idx).numel())
            row_bytes = table.shape[1] * table.element_size()
            nbytes = rows * row_bytes + 4 * idx.numel() \
                + idx.numel() * row_bytes
            bound_ms, by = bound(nbytes, 0)
            sites.append(dict(
                kernel=name, path=path, site=f"tap{i}",
                table=list(table.shape), row_stride=table.stride(0),
                indices=idx.numel(), distinct_rows=rows, bytes=nbytes,
                operations=0,
                ms=time_ms(lambda: kernel(table, idx),
                           runs=GATHER_TIMING_RUNS),
                plain_ms=time_ms(lambda: gather.row_gather(table, idx),
                                 runs=GATHER_TIMING_RUNS),
                library_ms=time_ms(lambda: torch.index_select(table, 0, idx),
                                   runs=GATHER_TIMING_RUNS),
                bound_ms=bound_ms, bound_by=by))
    return sites


def phase_times(model, fn, batches, captured,
                dtype: str = "float32") -> list:
    sites = time_sites(captured, label("eval", dtype),
                       ("rpn", "box_head") if dtype == "float32" else ())
    batch = batches[0]
    forward_ms = host_ms(lambda: fn(model, batch))
    forward_plain_ms = host_ms(lambda: model(batch, impl="plain"))
    box = model.roi_heads["box"]
    marks = [("backbone", model.backbone), ("rpn_head", model.rpn["head"]),
             ("extractor", box["feature_extractor"]),
             ("res5_head", box["feature_extractor"].head),
             ("predictor", box["predictor"])]
    spans = {"normalize": ("start", "backbone.in"),
             "backbone": ("backbone.in", "backbone.out"),
             "rpn_head": ("rpn_head.in", "rpn_head.out"),
             "proposals_with_nms": ("rpn_head.out", "extractor.in"),
             "roi_align": ("extractor.in", "res5_head.in"),
             "res5_head": ("res5_head.in", "res5_head.out"),
             "predictor": ("predictor.in", "predictor.out"),
             "postprocess_with_nms": ("predictor.out", "end")}
    stages = stage_times(model, batch, marks, spans)
    profile = device_profile(lambda: fn(model, batch), DCN_PROFILE_RUNS)
    census = conv_census(profile, dtype == "bfloat16", label("eval", dtype))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fn(model, batch)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    emit(label("times", dtype), sites=sites, forward_ms=forward_ms,
         forward_plain_ms=forward_plain_ms, stages_ms=stages,
         profile=profile, conv_kernels_by_dtype=census,
         max_memory_allocated=peak)
    return sites


# ---------------------------------------------------------------- training

def train_cfg(aligned: bool, dtype: str = "float32", cfg=None):
    """The flagship YAML at the 608x1216 canvas in ``dtype``, or ``cfg``
    (the VGG model's). ``aligned``: the aligned variant with its instance
    triplet on (weight 1.0), as the reference's aligned triplet trainer
    runs it; the YAML's weight 0 would leave the re-pooled members
    unused."""
    from da_detect_tpu_torch.config import get_cfg

    if cfg is None:
        cfg = get_cfg()
        cfg.merge_from_file(FLAGSHIP_YAML)
        cfg.TPU.IMAGE_SHAPE = CANVAS
        cfg.TPU.COMPUTE_DTYPE = dtype
    if aligned:
        cfg.MODEL.DA_HEADS.ALIGNMENT = True
        cfg.MODEL.DA_HEADS.DA_TRIPLET_INS_WEIGHT = 1.0
    cfg.freeze()
    return cfg


def train_step_one(state, args, impl: str, seed: int = 1):
    """Step 1's losses and gradients without the update, dropout off, the
    sampling priorities from a generator seeded with ``seed``."""
    model = state.model
    model.zero_grad(set_to_none=True)
    gen = torch.Generator(device=args[0].images.device).manual_seed(seed)
    losses, _ = model.train_forward(args[0], args[1], state.da_state,
                                    *args[2:], deterministic=True,
                                    generator=gen, impl=impl)
    sum(losses.values()).backward()
    torch.cuda.synchronize()
    grads = {n: p.grad.detach().clone() for n, p in model.named_parameters()
             if p.requires_grad}
    model.zero_grad(set_to_none=True)
    return {k: v.item() for k, v in losses.items()}, grads


# the box head's ReLU layers whose inputs the f32 step-1 checks read; and
# the keypoint head's convs (conv_fcn1..8), each followed by a ReLU
RELU_LAYERS = ("fc6", "fc7")


@contextlib.contextmanager
def relu_inputs(model):
    """While open, the box head's fc6 and fc7 outputs, with a keypoint
    head its conv_fcn outputs, and with DA heads their instance head's
    fc1_da and fc2_da outputs (on the VGG model the MLP features feed
    them), the inputs of their ReLUs, on each call: yields a dict
    parameter prefix -> list of [..., units] float32 copies (a conv's
    output channels last)."""
    layers = {f"roi_heads.box.feature_extractor.{n}":
              getattr(model.roi_heads["box"]["feature_extractor"], n)
              for n in RELU_LAYERS}
    if getattr(model, "da_heads", None) is not None:
        layers.update({f"da_heads.inshead.{n}":
                       getattr(model.da_heads.inshead, n)
                       for n in ("fc1_da", "fc2_da")})
    kp = getattr(model, "keypoint_head", None)
    if kp is not None:
        layers.update({
            f"roi_heads.keypoint.feature_extractor.{n}": m
            for n, m in kp.feature_extractor.named_children()
            if n.startswith("conv_fcn")})
    out = {key: [] for key in layers}

    def hook(key):
        def rec(mod, inp, y):
            y = y.detach().float()
            if isinstance(mod, torch.nn.Conv2d):
                y = y.movedim(1, -1)
            out[key].append(y.clone())
        return rec

    handles = [m.register_forward_hook(hook(key))
               for key, m in layers.items()]
    try:
        yield out
    finally:
        for h in handles:
            h.remove()


def relu_flips(pre_k, pre_p) -> dict:
    """Where a ReLU input changed sign between the kernel run and the plain
    run (``relu_inputs`` of each): parameter prefix -> ([N, units] bool
    flips, largest |input| of a flipped entry, in either run)."""
    out = {}
    for name, calls in pre_p.items():
        a = torch.cat([x.reshape(-1, x.shape[-1]) for x in pre_k[name]])
        b = torch.cat([x.reshape(-1, x.shape[-1]) for x in calls])
        flips = (a > 0) != (b > 0)
        top = float(torch.maximum(a.abs(), b.abs())[flips].max()) \
            if flips.any() else 0.0
        out[name] = (flips, top)
    return out


def compare_steps(kernel, plain, ref=None, flips=None) -> dict:
    """Step 1 through the kernels against step 1 through the plain
    versions, each (losses, gradients). float32 (``ref`` None): losses rtol
    TRAIN_LOSS_RTOL, each gradient leaf within TRAIN_GRAD_REL of its
    largest |g| (plus TRAIN_GRAD_FLOOR of the model's largest). ``flips``
    (``relu_flips``): a ReLU whose input lies within float32 rounding of 0
    takes another side in the two runs and moves its unit's row of the
    layer's weight and bias by a whole ROI's term; those rows are left out
    of their leaves' bound, every other row and leaf held to it, and the
    line reports each layer's flips, where its leaves' largest error lies
    and how far the flipped rows are from the bound. bfloat16:
    ``ref`` is step 1 of an f32 copy of the model through the plain
    versions, and each loss lies within one bf16 ulp of its value or twice
    |plain - ref|, each gradient leaf, in L2, within twice
    ||plain - ref|| plus one bf16 ulp of ||plain||: the kernels move the
    step no more than bfloat16 itself does. Raises past the bounds."""
    (lk, gk), (lp, gp) = kernel, plain
    if set(lk) != set(lp):
        raise AssertionError(f"loss names differ: {sorted(lk)} {sorted(lp)}")
    loss_rel = {k: abs(lk[k] - lp[k]) / max(abs(lp[k]), 1e-30) for k in lp}
    if ref is None:
        bad = {k: (lk[k], lp[k]) for k in lp
               if abs(lk[k] - lp[k]) > TRAIN_LOSS_RTOL * abs(lp[k])}
    else:
        lr = ref[0]
        bad = {k: (lk[k], lp[k], lr[k]) for k in lp
               if abs(lk[k] - lp[k]) > max(bf16_ulp(abs(lp[k])),
                                           2 * abs(lp[k] - lr[k]))}
    if bad:
        raise AssertionError(f"kernel-run step-1 losses differ from the "
                             f"plain run past their bounds: {bad}")
    floor = TRAIN_GRAD_FLOOR * max(float(g.abs().max()) for g in gp.values())
    exempt = {}
    for name, (f, top) in (flips or {}).items():
        exempt[name + ".weight"] = exempt[name + ".bias"] = f.any(0)
    worst, worst_name, exempted = 0.0, None, {}
    for n, g in gp.items():
        if g.dtype != torch.float32:
            raise AssertionError(f"gradient of {n} is {g.dtype}")
        if ref is not None:
            ratio = float((gk[n] - g).norm()) / (
                2 * float((g - ref[1][n]).norm())
                + bf16_ulp(float(g.norm())) + 1e-30)
        else:
            scale = TRAIN_GRAD_REL * float(g.abs().max()) + floor
            err = (gk[n] - g).abs()
            rows = exempt.get(n)
            if rows is not None:
                row_err = err.reshape(err.shape[0], -1).amax(1)
                exempted[n] = dict(
                    rows=int(rows.sum()),
                    ratio_all_rows=float(row_err.max()) / scale,
                    ratio_flipped_rows=float(row_err[rows].max()) / scale
                    if rows.any() else 0.0,
                    worst_row_flipped=bool(rows[int(row_err.argmax())]))
                err = row_err[~rows]
            ratio = float(err.max()) / scale if err.numel() else 0.0
        if ratio > worst:
            worst, worst_name = ratio, n
    if worst > 1.0:
        raise AssertionError(f"kernel-run step-1 gradient of {worst_name} "
                             f"differs from the plain run: {worst:.3f} x "
                             f"its bound (flipped rows left out: "
                             f"{exempted})")
    out = dict(losses=lk, max_loss_rel_err=max(loss_rel.values()),
               leaves=len(gp), worst_grad_bound_used=worst,
               worst_grad_leaf=worst_name)
    if flips:
        out["relu_flips"] = {
            name: dict(flipped=int(f.sum()), of=f.numel(),
                       units=int(f.any(0).sum()), max_abs_input=top)
            for name, (f, top) in flips.items()}
        out["flipped_rows_left_out"] = exempted
    return out


def f32_copy(model, cfg):
    """An f32 copy of ``model`` (built for ``cfg`` with COMPUTE_DTYPE
    float32, the same float32 parameters and buffers) on its device: the
    reference of what bfloat16 itself changes."""
    from da_detect_tpu_torch.entry import prepare_model
    from da_detect_tpu_torch.models import build_detection_model

    cfg32 = cfg.clone()
    cfg32.defrost()
    cfg32.TPU.COMPUTE_DTYPE = "float32"
    ref = build_detection_model(cfg32)
    ref.load_state_dict(model.state_dict())
    return prepare_model(ref, next(model.parameters()).device)


def f32_step_one(state, cfg, args):
    """``train_step_one`` through the plain versions of an f32 copy of
    ``state``'s model (the same DAState and draws)."""
    import dataclasses

    ref = dataclasses.replace(state, model=f32_copy(state.model, cfg))
    out = train_step_one(ref, args, "plain")
    del ref
    return out


def train_split(step, state, args, runs: int) -> dict:
    """Median device spans of ``runs`` calls of the entry's own train step
    (dropout on): forward (``zero_grad`` and ``train_forward``), backward
    (the loss sum and ``backward``), optimizer (``DetectronSGD.step``) and
    the whole step, from CUDA events recorded when the model's
    ``train_forward`` returns and around the optimizer's ``step``, both
    wrapped for these calls only."""
    model, opt = state.model, state.optimizer
    forward, update = model.train_forward, opt.step
    marks: dict[str, torch.cuda.Event] = {}

    def record(key):
        marks[key] = torch.cuda.Event(enable_timing=True)
        marks[key].record()

    def timed_forward(*a, **kw):
        out = forward(*a, **kw)
        record("forward")
        return out

    def timed_update(*a, **kw):
        record("backward")
        update(*a, **kw)
        record("optimizer")

    spans = {"forward": ("start", "forward"),
             "backward": ("forward", "backward"),
             "optimizer": ("backward", "optimizer"), "step": ("start", "end")}
    samples = {k: [] for k in spans}
    model.train_forward, opt.step = timed_forward, timed_update
    try:
        for _ in range(runs):
            record("start")
            state, _ = step(state, *args)
            record("end")
            torch.cuda.synchronize()
            for k, (a, b) in spans.items():
                samples[k].append(marks[a].elapsed_time(marks[b]))
    finally:
        del model.train_forward, opt.step
    return {k: statistics.median(v) for k, v in samples.items()}


# kernel-name fragments -> group, for the profile's breakdown (first match)
KERNEL_GROUPS = (
    ("roi_align_bwd", ("roi_align_bwd",)),
    ("roi_align_fwd", ("roi_align_fwd",)),
    ("nms", ("nms_",)),
    ("row_scatter_add", ("row_scatter_add",)),
    ("row_gather_bulk", ("row_gather_bulk",)),
    ("row_gather", ("row_gather",)),
    ("convolution", ("conv", "cudnn", "xmma", "fprop", "dgrad", "wgrad",
                     "implicit", "winograd", "fft")),
    ("matmul", ("gemm", "cutlass", "cublas")),
    ("sort, top-k, scan", ("sort", "radix", "topk", "scan", "cumsum")),
    ("reduction", ("reduce",)),
    ("elementwise, copy", ("elementwise", "vectorized", "copy", "fill",
                           "cat", "index", "gather", "scatter", "where")),
)


# fragments of a kernel's name -> its element type, first match (cuDNN's and
# cuBLAS's names carry it: "bf16bf16_bf16f32", "__nv_bfloat16", "sgemm")
DTYPE_MARKS = (
    ("workspace", ("init_device_workspace",)),
    ("bfloat16", ("bf16", "bfloat16")),
    ("float16", ("f16", "fp16", "half", "hmma", "h884", "h1688", "h16816")),
    ("float32", ("f32", "fp32", "float", "sgemm", "tf32", "s884", "s1688",
                 "s16816", "scudnn")),
)


def kernel_dtype(name: str) -> str:
    """The element type a kernel's name shows, or "unknown"."""
    name = name.lower()
    return next((d for d, frags in DTYPE_MARKS
                 if any(f in name for f in frags)), "unknown")


def conv_census(profile: dict, bf16: bool, label: str) -> dict:
    """The convolution kernels of a profile by element type (calls a run),
    on a bfloat16 path those of the float32 heads (``float32_head_spans``)
    left out and counted apart; a bfloat16 path that launched a float32
    convolution kernel anywhere else raises."""
    census = profile["conv_kernels_by_dtype"]
    if bf16 and census.get("float32"):
        raise AssertionError(f"{label}: float32 convolution kernels on a "
                             f"bfloat16 path outside the float32 heads: "
                             f"{profile['conv_kernels']}")
    return dict(census, float32_heads=profile["float32_head_convs"])


# the profiler range around the modules that the JAX package computes in
# float32 in a bfloat16 model (their Flax convs have no dtype and promote to
# their float32 kernels): the C4 mask predictor (conv5_mask,
# mask_fcn_logits) and the keypoint predictor (kps_score_lowres). Their only
# convolutions are those layers.
F32_SPAN = "float32_head"


@contextlib.contextmanager
def float32_head_spans():
    """While open, every forward of a float32 head runs inside a profiler
    range named F32_SPAN (global module hooks)."""
    from torch.nn.modules import module as nn_module

    from da_detect_tpu_torch.models.keypoint_head import KeypointRCNNPredictor
    from da_detect_tpu_torch.models.mask_head import MaskRCNNC4Predictor

    heads = (MaskRCNNC4Predictor, KeypointRCNNPredictor)
    open_spans = {}

    def enter(mod, args):
        if isinstance(mod, heads):
            span = torch.profiler.record_function(F32_SPAN)
            span.__enter__()
            open_spans[id(mod)] = span

    def leave(mod, args, out):
        if isinstance(mod, heads):
            open_spans.pop(id(mod)).__exit__(None, None, None)

    handles = [nn_module.register_module_forward_pre_hook(enter),
               nn_module.register_module_forward_hook(leave)]
    try:
        yield
    finally:
        for h in handles:
            h.remove()


def float32_head_kernels(prof) -> dict:
    """Kernel name -> launches of a profile that belong to the float32
    heads: those launched by an op inside an F32_SPAN range, and those
    launched by the backward of such an op (an autograd node's
    evaluate_function range carries the sequence number of the forward op
    that made it)."""
    events = prof.events()

    def chain(e):
        while e is not None:
            yield e
            e = e.cpu_parent

    def in_span(e):
        return any(a.name == F32_SPAN for a in chain(e))

    seqs = {e.sequence_nr for e in events
            if e.sequence_nr >= 0 and in_span(e)}
    held: dict = {}
    for e in events:
        if not e.kernels:
            continue
        if in_span(e) or any(
                a.name.startswith("autograd::engine::evaluate_function")
                and a.sequence_nr in seqs for a in chain(e)):
            for k in e.kernels:
                held[k.name] = held.get(k.name, 0) + 1
    return held


def device_kernels(prof) -> list:
    """The device events of a profile summed by name, as
    ``prof.key_averages()`` sums its device rows, but over the device
    events alone: each entry has ``key``, ``count`` and
    ``self_device_time_total`` (us). ``key_averages`` also totals every
    host op's time through its children, which took ~60 s on the ~450,000
    events of one profiled DCN train step."""
    from types import SimpleNamespace

    from torch.autograd import DeviceType

    sums: dict = {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        key = (e.key, getattr(e, "is_user_annotation", False))
        total, count = sums.get(key, (0.0, 0))
        sums[key] = (total + e.self_device_time_total, count + 1)
    return [SimpleNamespace(key=key, self_device_time_total=total,
                            count=count)
            for (key, _), (total, count) in sums.items()]


def device_profile(run, runs: int, kernels=(), attempts: int = 3,
                   host: bool = True) -> dict:
    """``runs`` calls of ``run()`` (a train step, a forward, one kernel's
    wrapper) under ``torch.profiler``: device time and device launches a
    call by kernel group, the top kernels, the convolution kernels by
    element type (the float32 heads' apart, ``float32_head_kernels``) and,
    for the kernels whose names hold each of ``kernels``, their device time
    and calls a run,
    and the device's busy share of the host's wall clock (under the
    profiler's own overhead). Unlike CUDA events around a call, device
    times leave out the host's launch work. Now and then a profile records
    no launch of a kernel that ran: it is then taken again, up to
    ``attempts`` times, and a time still missing is None, not 0. With
    ``host`` false only the device's activity is recorded, which a
    profile of many launches (a DCN train step's ~65,000) processes in a
    fraction of the time; no convolution is then set apart as a float32
    head's. Should such a profile hold no device launch at all, it is
    taken again with the host's activity."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(attempts):
        activities = [ProfilerActivity.CPU] * host + [ProfilerActivity.CUDA]
        torch.cuda.synchronize()
        with profile(activities=activities) as prof, \
                (float32_head_spans() if host else contextlib.nullcontext()):
            t0 = time.perf_counter()
            for _ in range(runs):
                run()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        kern = [e for e in device_kernels(prof)
                if e.self_device_time_total > 0]
        if not kern and not host:
            host = True
            continue
        named = {name: sum(e.self_device_time_total for e in kern
                           if name in e.key) / 1e3 / runs
                 for name in kernels}
        calls = {name: sum(e.count for e in kern if name in e.key) / runs
                 for name in kernels}
        if all(named.values()):
            break
    groups: dict[str, float] = {}
    group_calls: dict[str, float] = {}
    convs: dict[str, float] = {}
    head_convs: dict[str, float] = {}
    conv_names: dict[str, str] = {}
    conv_kern = []
    for e in kern:
        name = e.key.lower()
        group = next((g for g, frags in KERNEL_GROUPS
                      if any(f in name for f in frags)), "other")
        groups[group] = groups.get(group, 0.0) + (
            e.self_device_time_total / 1e3 / runs)
        group_calls[group] = group_calls.get(group, 0.0) + e.count / runs
        # the census leaves out plain GEMMs that the group's "xmma" takes in
        # (the deformable convs' float32 tap products are matmuls)
        if group == "convolution" and ("gemm" not in name or any(
                f in name for f in ("conv", "implicit", "fprop", "dgrad",
                                    "wgrad"))):
            conv_kern.append((e, kernel_dtype(name)))
    # the float32 heads' share of a bfloat16 path's float32 convolutions,
    # attributed by the event tree (a walk of every event: not on a float32
    # path, whose every convolution is float32)
    held = float32_head_kernels(prof) if host and any(
        d == "bfloat16" for _, d in conv_kern) and any(
        d == "float32" for _, d in conv_kern) else {}
    for e, dtype in conv_kern:
        own = min(held.get(e.key, 0), e.count) if dtype == "float32" else 0
        if own:
            head_convs[dtype] = head_convs.get(dtype, 0.0) + own / runs
        if e.count > own:
            convs[dtype] = convs.get(dtype, 0.0) + (e.count - own) / runs
            conv_names[e.key[:120]] = dtype
    busy_ms = sum(groups.values())
    top = sorted(kern, key=lambda e: -e.self_device_time_total)[:12]
    return dict(
        runs=runs, wall_ms_per_run=wall_ms / runs,
        device_ms_per_run=busy_ms,
        device_busy_share=busy_ms * runs / wall_ms,
        groups_ms_per_run=dict(sorted(groups.items(),
                                      key=lambda kv: -kv[1])),
        device_calls_per_run=sum(group_calls.values()),
        groups_calls_per_run=dict(sorted(group_calls.items(),
                                         key=lambda kv: -kv[1])),
        top_kernels=[dict(name=e.key[:100], calls_per_run=e.count / runs,
                          ms_per_run=e.self_device_time_total / 1e3 / runs)
                     for e in top],
        kernel_ms_per_run={name: t or None for name, t in named.items()},
        kernel_calls_per_run=calls, conv_kernels_by_dtype=convs,
        float32_head_convs=head_convs, conv_kernels=conv_names)


def run_steps(step, state, args, n: int, expected: dict, label: str):
    """The main path: counts set to 0, ``n`` steps through the train step,
    each timed on the host clock to its synchronize, counts read. Raises if
    a kernel ran (or a CSR was built) another number of times than
    ``expected`` per step, or a loss is not finite."""
    clear_counts()
    times, metrics = [], []
    for _ in range(n):
        t0 = time.perf_counter()
        state, m = step(state, *args)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        metrics.append(m)
    launches = read_counts(expected, n, label, "steps")
    totals = [float(m["loss_total"]) for m in metrics]
    if not all(np.isfinite(totals)):
        raise AssertionError(f"{label}: non-finite loss: {totals}")
    return state, launches, times, metrics


def measure_train_path(step, state, args, name: str, bf16: bool, steps: int,
                       per_step: dict, profile_steps: int):
    """A train path's measurements after its step-1 agreement: ``steps``
    timed steps with exact launches (``run_steps``; their median into
    STEP_MEDIANS), a profile of ``profile_steps`` steps and its
    convolution census (``conv_census``), then one more step with the peak
    memory reset around it and its kernels' inputs recorded. Returns
    (state, the fields of the phase line, the recorded inputs)."""
    state, launches, times, metrics = run_steps(step, state, args, steps,
                                                per_step, name)
    STEP_MEDIANS[name] = statistics.median(times)
    holder = [state]

    def one_step():
        holder[0], _ = step(holder[0], *args)

    profile = device_profile(one_step, profile_steps)
    census = conv_census(profile, bf16, name)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with record_kernel_inputs() as captured:
        one_step()
        torch.cuda.synchronize()
    record = dict(
        steps=steps, launches=launches,
        launches_per_step={k: v / steps for k, v in launches.items()},
        step_ms=times, step_ms_median=statistics.median(times),
        profile=profile, conv_kernels_by_dtype=census,
        max_memory_allocated=torch.cuda.max_memory_allocated(),
        losses=[{k: float(v) for k, v in m.items()} for m in metrics])
    return holder[0], record, captured


def merge_errs(errs: dict, more: dict) -> None:
    """Keeps in ``errs`` the larger error of each kernel."""
    for k, v in more.items():
        errs[k] = max(errs.get(k, 0.0), v)


# ROIPool (``ops/roi_align.py::roi_pool_image``; plain PyTorch, no TPU
# kernel behind it) on the flagship's C4 map: the first eval request's map
# and its first ROI_POOL_ROIS proposals, P ROI_POOL_P at the map's scale;
# CUDA events over ROI_POOL_RUNS calls
ROI_POOL_ROIS, ROI_POOL_P, ROI_POOL_RUNS = 256, 7, 10


def phase_roi_pool(captured, dtype: str) -> dict:
    """``roi_pool_image`` on the flagship's real C4 map (1024 x 38 x 76 in
    ``dtype``, the map the eval path handed its ROIAlign launch) and
    ROI_POOL_ROIS of its ROIs, on the card against the same call on the
    CPU: bit for bit (a max picks an input value); its gradient (a
    random cotangent) twice on the card: bit for bit. Its time, the peak
    memory above what was allocated before the call, the CPU call's
    seconds."""
    from da_detect_tpu_torch.ops.roi_align import roi_pool_image

    name = label("roi_pool", dtype)
    maps, rois, _, kw = captured["roi_align_fwd"][0]
    feat, boxes = maps[0][0], rois[0, :ROI_POOL_ROIS]
    scale = kw["spatial_scale"]

    def call():
        return roi_pool_image(feat, boxes, spatial_scale=scale,
                              output_size=ROI_POOL_P)

    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    got = call()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - before
    t0 = time.perf_counter()
    want = roi_pool_image(feat.cpu(), boxes.cpu(), spatial_scale=scale,
                          output_size=ROI_POOL_P)
    cpu_s = time.perf_counter() - t0
    same = torch.equal(got.cpu(), want)
    cot = torch.randn(got.shape, generator=torch.Generator(
        device=feat.device).manual_seed(0), device=feat.device).to(got.dtype)
    grads = []
    for _ in range(2):
        f = feat.detach().clone().requires_grad_(True)
        grads.append(torch.autograd.grad(
            roi_pool_image(f, boxes, spatial_scale=scale,
                           output_size=ROI_POOL_P), f, cot)[0])
    grad_same = torch.equal(grads[0], grads[1])
    out = dict(features=list(feat.shape), dtype=dtype,
               rois=int(boxes.shape[0]), output_size=ROI_POOL_P,
               spatial_scale=scale, out_shape=list(got.shape),
               bit_for_bit_cpu=same,
               max_abs_diff=float((got.cpu().float() - want.float()).abs()
                                  .max()),
               empty_bins=int((want == 0).all(1).sum()),
               grad_rerun_bit_identical=grad_same,
               ms=time_ms(call, runs=ROI_POOL_RUNS),
               peak_bytes_above_inputs=peak, cpu_s=cpu_s)
    emit(name, **out)
    if not same or not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{name}: the card's ROIPool differs from the "
                             f"CPU's: {out}")
    if not grad_same:
        raise AssertionError(f"{name}: ROIPool's gradient differs between "
                             f"two runs on the card: {out}")
    return out


def phase_train(dev, dtype: str = "float32"):
    from da_detect_tpu_torch import entry

    name, bf16 = label("train", dtype), dtype == "bfloat16"
    cfg = train_cfg(aligned=False, dtype=dtype)
    step, (state, args) = entry.train_entry(device=str(dev), seed=0, cfg=cfg)
    agreement = compare_steps(
        train_step_one(state, args, "cuda"),
        train_step_one(state, args, "plain"),
        f32_step_one(state, cfg, args) if bf16 else None)
    state, record, captured = measure_train_path(
        step, state, args, name, bf16, TRAIN_STEPS, PER_TRAIN_STEP,
        PROFILE_STEPS)
    split = train_split(step, state, args, SPLIT_STEPS)
    errs = check_captured(captured)
    margins = float(state.da_state.margin_img)
    del step, state

    a_cfg = train_cfg(aligned=True, dtype=dtype)
    a_step, (a_state, a_args) = entry.train_entry(device=str(dev), seed=0,
                                                  cfg=a_cfg)
    a_state, a_launches, a_times, a_metrics = run_steps(
        a_step, a_state, a_args, ALIGNED_STEPS, PER_ALIGNED_STEP,
        label("aligned", dtype))
    del a_step, a_state
    emit(name, config=os.path.relpath(FLAGSHIP_YAML, REPO), dtype=dtype,
         canvas=list(CANVAS), split_ms=split, margin_img=margins,
         plain_agreement=agreement, main_path_inputs=train_inputs(captured),
         max_abs_err=errs, **record,
         aligned=dict(steps=ALIGNED_STEPS, launches=a_launches,
                      step_ms=a_times,
                      losses=[{k: float(v) for k, v in m.items()}
                              for m in a_metrics]))
    return captured, record["launches"], errs


# ---------------------------------------------------------------- DDP

# phase ddp: the flagship train step through DDP at world size 1 (NCCL),
# against the unwrapped step: DDP_STEPS checked steps, then DDP_TIMED_STEPS
# of each timed in turns
DDP_STEPS, DDP_TIMED_STEPS = 3, 6
# phase ddp2: two ranks on the one card through gloo, k = 1 triple each,
# against one process on the 2-triple batch; then DDP2_TIMED_STEPS steps
# of each timed. The updated parameters: each leaf's change within
# DDP2_PARAM_REL of its largest change plus a float32 ulp of its weights
# (the ranks sum the batch's gradients in another order)
DDP2_WORLD, DDP2_TIMED_STEPS, DDP2_PARAM_REL = 2, 4, 1e-3
# phase mesh2, in ddp2's spawn: the flagship step on one triple under each
# (label, space, model) mesh of the two ranks, against one process's step
# (ddp2's bounds); then MESH2_TIMED_STEPS steps of each rank timed
MESH2_MODES = (("sp2", 2, 1), ("tp2", 1, 2))
MESH2_TIMED_STEPS = 2
# phase mesh2's FBNet runs, in the same spawn, each against one process:
# the xirb16d_dsmask Mask R-CNN at its published widths and 320x640 canvas
# (one eval request with masks, then one source-only step on
# FBNET_MESH_IMAGES images) under each (label, space, model) mesh, and one
# request of the chamv1a Faster R-CNN at 600x1000 under space=2 (its
# depthwise kernels reach 5 and 7, its 75-row map pads 1/1 before a
# stride-2 conv); each request timed MESH_REQUEST_RUNS more times
FBNET_MESH_MODES = (("fbnet_sp2", 2, 1), ("fbnet_tp2", 1, 2))
FBNET_CHAM_MESH_MODES = (("fbnet_cham_sp2", 2, 1),)
FBNET_MESH_IMAGES, MESH_REQUEST_RUNS = 2, 3


@contextlib.contextmanager
def nccl_world1(dev):
    """A process group of this process alone, through NCCL (a file store in
    a temporary directory), destroyed at the end."""
    from da_detect_tpu_torch import parallel

    with tempfile.TemporaryDirectory(prefix="chip_smoke_nccl_") as tmp:
        parallel.init_distributed(
            dev, init_method="file://" + os.path.join(tmp, "store"), rank=0,
            world_size=1)
        try:
            if torch.distributed.get_backend() != "nccl":
                raise AssertionError("the world-1 group is not NCCL")
            yield
        finally:
            parallel.shutdown()


def step_record(state, metrics) -> dict:
    """A step's losses, parameters (on the card) and DAState."""
    return dict(losses={k: v.item() for k, v in metrics.items()},
                params=[p.detach().clone() for p in state.model.parameters()],
                da_state=[float(getattr(state.da_state, f)) for f in (
                    "margin_img", "margin_ins", "last_triplet_img",
                    "last_triplet_ins")])


def first_difference(got: dict, want: dict, names: list) -> dict | None:
    """None when two step records are equal bit for bit, else where they
    first differ."""
    if got["losses"] != want["losses"]:
        return dict(what="losses", got=got["losses"], want=want["losses"])
    if got["da_state"] != want["da_state"]:
        return dict(what="da_state", got=got["da_state"],
                    want=want["da_state"])
    for n, a, b in zip(names, got["params"], want["params"]):
        if not torch.equal(a, b):
            return dict(what="param", leaf=n,
                        max_abs_diff=float((a - b).abs().max()),
                        differing=int((a != b).sum()), numel=a.numel())
    return None


def timed_step(step, state, args) -> tuple:
    t0 = time.perf_counter()
    state, _ = step(state, *args)
    torch.cuda.synchronize()
    return state, (time.perf_counter() - t0) * 1e3


def phase_ddp(dev, dtype: str = "float32") -> dict:
    """The flagship triplet-DA train step through DDP at world size 1
    (NCCL), dropout on: DDP_STEPS steps with exact launch counts (the train
    phase's), each step's losses, DAState and parameters bit for bit the
    unwrapped step's from the same seed (cuDNN deterministic for the
    check); then the two steps' times in turns."""
    from da_detect_tpu_torch import entry
    from da_detect_tpu_torch.engine.trainer import make_train_step
    from da_detect_tpu_torch.parallel import wrap_train_forward

    name = label("ddp", dtype)
    cfg = train_cfg(aligned=False, dtype=dtype)
    step, (state, args) = entry.train_entry(device=str(dev), seed=0, cfg=cfg)
    _, (d_state, _) = entry.train_entry(device=str(dev), seed=0, cfg=cfg)
    names = [n for n, _ in state.model.named_parameters()]
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        want = []
        for _ in range(DDP_STEPS):
            state, m = step(state, *args)
            want.append(step_record(state, m))
        with nccl_world1(dev):
            d_step = make_train_step(
                d_state.model, d_state.optimizer, aligned=False,
                forward=wrap_train_forward(d_state.model, "da_triplet"))
            clear_counts()
            diffs = []
            for i in range(DDP_STEPS):
                d_state, m = d_step(d_state, *args)
                diffs.append(first_difference(step_record(d_state, m),
                                              want[i], names))
            launches = read_counts(PER_TRAIN_STEP, DDP_STEPS, name, "steps")
            torch.backends.cudnn.deterministic = deterministic
            times = {"unwrapped": [], "ddp": []}
            for _ in range(DDP_TIMED_STEPS):
                state, ms = timed_step(step, state, args)
                times["unwrapped"].append(ms)
                d_state, ms = timed_step(d_step, d_state, args)
                times["ddp"].append(ms)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    medians = {k: statistics.median(v) for k, v in times.items()}
    emit(name, dtype=dtype, world=1, backend="nccl", steps=DDP_STEPS,
         launches=launches, bitwise_equal_steps=[d is None for d in diffs],
         first_differences=diffs,
         losses=[w["losses"] for w in want], step_ms=times,
         step_ms_median=medians,
         ddp_over_unwrapped=medians["ddp"] / medians["unwrapped"])
    if any(d is not None for d in diffs):
        raise AssertionError(f"{name}: the DDP step differs from the "
                             f"unwrapped one: {diffs}")
    del step, state, d_step, d_state
    return launches


class SamplerDraws:
    """The sampler's priorities of a train step: ``record`` draws them from
    the step's generator, as the sampler does, and keeps them (on the CPU)
    call by call; ``inject(rows)`` hands each call its recorded draws'
    ``rows`` (a rank's images) instead of drawing."""

    def __init__(self):
        self.calls: list = []

    @contextlib.contextmanager
    def _patched(self, priorities_for):
        from da_detect_tpu_torch.models import box_head, rpn
        from da_detect_tpu_torch.ops.sampler import balanced_sample

        count = iter(range(1 << 30))

        def sample(labels, batch_size, fraction, *, generator=None,
                   priorities=None):
            return balanced_sample(
                labels, batch_size, fraction,
                priorities=priorities_for(next(count), labels, generator))

        saved = rpn.balanced_sample, box_head.balanced_sample
        rpn.balanced_sample = box_head.balanced_sample = sample
        try:
            yield
        finally:
            rpn.balanced_sample, box_head.balanced_sample = saved

    def record(self):
        def draw(i, labels, generator):
            pr = tuple(torch.rand(labels.shape, generator=generator,
                                  device=labels.device) for _ in range(2))
            self.calls.append(tuple(p.cpu() for p in pr))
            return pr
        return self._patched(draw)

    def inject(self, rows: slice):
        def take(i, labels, generator):
            return tuple(p[rows].to(labels.device) for p in self.calls[i])
        return self._patched(take)


def ddp2_model(cfg, dev):
    """The flagship model (seed 0), its score layers spread, and a
    TrainState with the train entry's cosine schedule."""
    from da_detect_tpu_torch.engine.trainer import create_train_state
    from da_detect_tpu_torch.entry import prepare_model
    from da_detect_tpu_torch.models import build_detection_model

    model = prepare_model(build_detection_model(cfg, seed=0), dev)
    spread_scores(model)
    return create_train_state(cfg, model, 0, "cosine")


def mesh_step(model, state, step, args, draws, rows: slice, dev) -> dict:
    """Step 1 of ``step`` on ``args`` with the recorded ``draws``' ``rows``
    (launches counted, peak memory), the whole parameters (split leaves
    gathered) and this rank's own, its parameter and momentum bytes; then
    MESH2_TIMED_STEPS steps timed."""
    from da_detect_tpu_torch import kernels
    from da_detect_tpu_torch.parallel.tensor import full_state_dict

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    kernels.LAUNCHES.clear()
    with draws.inject(rows):
        state, metrics = step(state, *args)
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated(dev)
    out = step_record(state, metrics)
    full = full_state_dict(model)
    out["params"] = {n: full[n].to("cpu", copy=True) for n, _ in
                     model.named_parameters()}
    out["local"] = {n: p.detach().to("cpu", copy=True) for n, p in
                    model.named_parameters()}
    param_bytes = sum(p.numel() * p.element_size()
                      for p in model.parameters())
    momentum_bytes = sum(b.numel() * b.element_size() for b in
                         state.optimizer.momentum_buffers().values())
    times = []
    for _ in range(MESH2_TIMED_STEPS):
        state, ms = timed_step(step, state, args)
        times.append(ms)
    return dict(out, launches=launches, peak_bytes=peak,
                param_bytes=param_bytes, momentum_bytes=momentum_bytes,
                split_leaves=len(model._tp_plan),
                step_ms=times)


def mesh2_rank(cfg, dev, spec: dict, spatial: int, model_ranks: int):
    """One rank's run of phase mesh2 under the (1, spatial, model_ranks)
    mesh: the eval request at the initial weights, then ``mesh_step`` on
    one triple on the recorded draws."""
    from da_detect_tpu_torch.engine.trainer import (create_train_state,
                                                    make_train_step)
    from da_detect_tpu_torch.entry import prepare_model
    from da_detect_tpu_torch.models import build_detection_model
    from da_detect_tpu_torch.parallel import (make_mesh, parallelize,
                                              set_mesh, wrap_train_forward)

    mesh = make_mesh(spatial=spatial, model=model_ranks)
    set_mesh(mesh)
    try:
        model = prepare_model(build_detection_model(cfg, seed=0), dev)
        spread_scores(model)
        parallelize(model, mesh)
        state = create_train_state(cfg, model, 0, "cosine")
        with torch.no_grad():
            dets = model(spec["eval_batch"].to(dev))
        torch.cuda.synchronize()
        dets = type(dets)(*[t.cpu() for t in dets])
        step = make_train_step(
            model, state.optimizer, aligned=False, deterministic=True,
            forward=wrap_train_forward(model, "da_triplet"))
        args = tuple(a.to(dev) for a in spec["args"])
        out = mesh_step(model, state, step, args, spec["draws"],
                        slice(0, 1), dev)
        return dict(out, dets=dets)
    finally:
        set_mesh(None)


def fbnet_mesh_model(yaml: str, dev, mesh=None):
    """(cfg, model): an FBNet YAML at its own canvas in float32 (phase
    fbnet's: ``entry.fbnet_cfg``, weights from seed 0, score layers
    spread), under ``mesh`` (``parallelize``) when given."""
    from da_detect_tpu_torch import entry
    from da_detect_tpu_torch.models import build_detection_model
    from da_detect_tpu_torch.parallel import parallelize

    cfg = entry.fbnet_cfg(yaml, "float32")
    cfg.freeze()
    model = entry.prepare_model(build_detection_model(cfg, seed=0), dev)
    spread_scores(model)
    if mesh is not None:
        parallelize(model, mesh)
    return cfg, model


def mesh_request(model, batch, masks: bool, dev) -> dict:
    """One eval request (with masks for a mask model), launches counted,
    peak memory: its detections (and mask probabilities) on the CPU; then
    MESH_REQUEST_RUNS more requests timed on the host's clock."""
    from da_detect_tpu_torch import kernels

    def request():
        with torch.no_grad():
            return model(batch, with_masks=True) if masks else model(batch)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    kernels.LAUNCHES.clear()
    out = request()
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated(dev)
    dets, probs = out if masks else (out, None)
    times = []
    for _ in range(MESH_REQUEST_RUNS):
        t0 = time.perf_counter()
        request()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return dict(dets=type(dets)(*[t.cpu() for t in dets]),
                probs=None if probs is None else probs.cpu(),
                launches=launches, peak_bytes=peak, request_ms=times)


def fbnet_mesh_rank(dev, spec: dict, spatial: int, model_ranks: int):
    """One rank's FBNet runs of phase mesh2 under the (1, spatial,
    model_ranks) mesh: the mask model's request (``mesh_request``) at the
    initial weights, then its source-only step on FBNET_MESH_IMAGES images
    on the recorded draws (``mesh_step``)."""
    from da_detect_tpu_torch import entry
    from da_detect_tpu_torch.engine.trainer import (create_train_state,
                                                    make_train_step)
    from da_detect_tpu_torch.parallel import (make_mesh, set_mesh,
                                              wrap_train_forward)

    mesh = make_mesh(spatial=spatial, model=model_ranks)
    set_mesh(mesh)
    try:
        cfg, model = fbnet_mesh_model(entry.FBNET_MASK_YAML, dev, mesh)
        request = mesh_request(model, spec["batch"].to(dev), True, dev)
        state = create_train_state(cfg, model, 0, "multistep")
        step = make_train_step(
            model, state.optimizer, aligned=False, deterministic=True,
            forward=wrap_train_forward(model, "source_only"))
        args = tuple(a.to(dev) for a in spec["args"])
        out = mesh_step(model, state, step, args, spec["draws"],
                        slice(0, FBNET_MESH_IMAGES), dev)
        return dict(out, request=request)
    finally:
        set_mesh(None)
        torch.cuda.empty_cache()


def fbnet_cham_mesh_rank(dev, spec: dict, spatial: int, model_ranks: int):
    """One rank's request of the chamv1a Faster R-CNN under the (1,
    spatial, model_ranks) mesh (``mesh_request``)."""
    from da_detect_tpu_torch import entry
    from da_detect_tpu_torch.parallel import make_mesh, set_mesh

    mesh = make_mesh(spatial=spatial, model=model_ranks)
    set_mesh(mesh)
    try:
        _, model = fbnet_mesh_model(entry.FBNET_CHAM_YAML, dev, mesh)
        return dict(request=mesh_request(
            model, spec["cham_batch"].to(dev), False, dev))
    finally:
        set_mesh(None)
        torch.cuda.empty_cache()


def ddp2_rank(rank, world, init_method, cfg, args, draws, mesh_spec):
    """One rank of phases ddp2 and mesh2 (on one card both ranks on cuda:0,
    through gloo: ``parallel.ddp.card_for``): its triple of
    ``args``, step 1 on the recorded draws' rows of its image, launches
    counted; then DDP2_TIMED_STEPS steps timed; then each mesh of
    MESH2_MODES (``mesh2_rank``)."""
    from da_detect_tpu_torch import kernels
    from da_detect_tpu_torch.engine.trainer import make_train_step
    from da_detect_tpu_torch.parallel import (init_distributed, shard,
                                              wrap_train_forward)

    dev = init_distributed(torch.device("cuda"), init_method=init_method,
                           rank=rank, world_size=world)
    state = ddp2_model(cfg, dev)
    step = make_train_step(
        state.model, state.optimizer, aligned=False, deterministic=True,
        forward=wrap_train_forward(state.model, "da_triplet"))
    mine = tuple(a.to(dev) for a in shard(args, rank, world))
    torch.cuda.synchronize()
    kernels.LAUNCHES.clear()
    with draws.inject(slice(rank, rank + 1)):
        state, metrics = step(state, *mine)
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    out = step_record(state, metrics)
    out["params"] = [p.cpu() for p in out["params"]]
    times = []
    for _ in range(DDP2_TIMED_STEPS):
        state, ms = timed_step(step, state, mine)
        times.append(ms)
    del state, step
    torch.cuda.empty_cache()
    meshes = {label: mesh2_rank(cfg, dev, mesh_spec, spatial, model_ranks)
              for label, spatial, model_ranks in MESH2_MODES}
    t0 = time.perf_counter()
    fbnet = {label: fbnet_mesh_rank(dev, mesh_spec["fbnet"], spatial,
                                    model_ranks)
             for label, spatial, model_ranks in FBNET_MESH_MODES}
    fbnet.update({label: fbnet_cham_mesh_rank(dev, mesh_spec["fbnet"],
                                              spatial, model_ranks)
                  for label, spatial, model_ranks in FBNET_CHAM_MESH_MODES})
    return dict(out, launches=launches, step_ms=times,
                device=torch.cuda.get_device_name(dev), meshes=meshes,
                fbnet=fbnet, fbnet_s=time.perf_counter() - t0,
                backend=torch.distributed.get_backend())


def mesh2_reference(cfg, dev) -> dict:
    """Phase mesh2's single process: the eval request at the initial
    weights, then step 1 on one triple with its sampler draws recorded
    (peak memory), then MESH2_TIMED_STEPS steps timed."""
    from da_detect_tpu_torch import entry
    from da_detect_tpu_torch.engine.trainer import make_train_step

    state = ddp2_model(cfg, dev)
    init = {n: p.detach().to("cpu", copy=True)
            for n, p in state.model.named_parameters()}
    eval_batch, _ = entry.make_batch(cfg, 1, seed=5, device=dev)
    with torch.no_grad():
        dets = state.model(eval_batch)
    step = make_train_step(state.model, state.optimizer, aligned=False,
                           deterministic=True)
    args = entry.triplet_batches(cfg, 1, seed=0, device=dev)
    draws = SamplerDraws()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    with draws.record():
        state, metrics = step(state, *args)
    torch.cuda.synchronize()
    want = step_record(state, metrics)
    want["params"] = {n: p.to("cpu", copy=True)
                      for n, p in zip(init, want["params"])}
    want["peak_bytes"] = torch.cuda.max_memory_allocated(dev)
    times = []
    for _ in range(MESH2_TIMED_STEPS):
        state, ms = timed_step(step, state, args)
        times.append(ms)
    want["step_ms"] = times
    want["param_bytes"] = sum(p.numel() * p.element_size()
                              for p in state.model.parameters())
    want["momentum_bytes"] = sum(
        b.numel() * b.element_size()
        for b in state.optimizer.momentum_buffers().values())
    spec = dict(eval_batch=eval_batch.to("cpu"), draws=draws,
                args=tuple(a.to("cpu") for a in args))
    return dict(want=want, init=init, dets=type(dets)(
        *[t.cpu() for t in dets]), spec=spec)


def check_launches(got: dict, expected: dict, what: str) -> None:
    """Raises unless ``got`` (a rank's ``kernels.LAUNCHES``) holds exactly
    ``expected``'s launches, and no other kernel's."""
    got = {k: n for k, n in got.items() if n}
    if got != expected:
        raise AssertionError(f"{what}: launched {got}, expected {expected}")


def check_mesh_step(label: str, runs: list, want: dict, init: dict,
                    per_step: dict) -> dict:
    """A mesh's two ranks' step 1 (``mesh_step``) against one process's
    (ddp2's bounds) and each other: exact launches (``per_step``), the
    ranks' losses, DAState and whole parameters bit for bit alike, the
    replicated leaves bit for bit alike, the losses and DAState within
    TRAIN_LOSS_RTOL and each leaf's change within DDP2_PARAM_REL of one
    process's. Returns the step's summary."""
    for r, got in enumerate(runs):
        check_launches(got["launches"], per_step, f"{label}: rank {r}")
        diff = first_difference(
            dict(got, params=list(got["params"].values())),
            dict(runs[0], params=list(runs[0]["params"].values())),
            list(got["params"]))
        if diff is not None:
            raise AssertionError(f"{label}: rank {r} differs from rank 0: "
                                 f"{diff}")
    got = runs[0]
    replicated = [n for n, p in got["local"].items()
                  if p.shape == got["params"][n].shape]
    for n in replicated:
        if not torch.equal(runs[1]["local"][n], got["local"][n]):
            raise AssertionError(f"{label}: replicated {n} differs "
                                 "between the ranks")
    bad = {k: (got["losses"][k], v) for k, v in want["losses"].items()
           if abs(got["losses"][k] - v) > TRAIN_LOSS_RTOL * abs(v)}
    if bad or set(got["losses"]) != set(want["losses"]):
        raise AssertionError(f"{label}: losses differ from one process's: "
                             f"{bad}")
    state_tol = [1e-6, 1e-6] + [TRAIN_LOSS_RTOL * abs(v)
                                for v in want["da_state"][2:]]
    if any(abs(a - b) > t for a, b, t in zip(
            got["da_state"], want["da_state"], state_tol)):
        raise AssertionError(f"{label}: DAState {got['da_state']} against "
                             f"{want['da_state']}")
    worst, worst_leaf = 0.0, None
    for n, p0 in init.items():
        p, q = want["params"][n], got["params"][n]
        change = float((p - p0).abs().max())
        ulp = 1.2e-7 * float(p0.abs().max())
        ratio = float((q - p).abs().max()) / (
            DDP2_PARAM_REL * change + ulp + 1e-30)
        if ratio > worst:
            worst, worst_leaf = ratio, n
    if worst > 1.0:
        raise AssertionError(f"{label}: parameter {worst_leaf} off one "
                             f"process's step: {worst:.3f} x its bound")
    return dict(
        losses=got["losses"], da_state=got["da_state"],
        param_bound_used=worst, worst_param_leaf=worst_leaf,
        replicated_leaves_bitwise=len(replicated),
        split_leaves=got["split_leaves"],
        launches_by_rank=[r["launches"] for r in runs],
        step_ms={f"rank{r}": x["step_ms"] for r, x in enumerate(runs)},
        step_ms_median={f"rank{r}": statistics.median(x["step_ms"])
                        for r, x in enumerate(runs)},
        peak_bytes=[x["peak_bytes"] for x in runs],
        param_bytes=[x["param_bytes"] for x in runs],
        momentum_bytes=[x["momentum_bytes"] for x in runs])


def check_mesh_request(label: str, requests: list, want: dict,
                       per_forward: dict) -> dict:
    """A mesh's two ranks' request (``mesh_request``) against one
    process's: exact launches (``per_forward``), the ranks' detections and
    masks bit for bit alike, every detection with its twin in one
    process's (``match_detections``: DET_BOX_ATOL, DET_SCORE_ATOL) and, on
    the same detections in the same order, the largest mask probability
    difference. Returns the request's summary."""
    got = requests[0]
    if not bool(want["dets"].valid.any()):
        raise AssertionError(f"{label}: one process's request detected "
                             "nothing, so nothing is compared")
    for r, req in enumerate(requests):
        check_launches(req["launches"], per_forward, f"{label}: rank {r}")
        if any(not torch.equal(a, b) for a, b in zip(req["dets"],
                                                     got["dets"])) \
                or (got["probs"] is not None
                    and not torch.equal(req["probs"], got["probs"])):
            raise AssertionError(f"{label}: rank {r}'s request differs "
                                 "from rank 0's")
    dets = match_detections(got["dets"], want["dets"])
    out = dict(detections=dets,
               request_ms={f"rank{r}": x["request_ms"]
                           for r, x in enumerate(requests)},
               request_ms_median={f"rank{r}": statistics.median(
                   x["request_ms"]) for r, x in enumerate(requests)},
               request_peak_bytes=[x["peak_bytes"] for x in requests])
    if got["probs"] is not None:
        probs, valid = got["probs"], got["dets"].valid
        if tuple(probs.shape) != tuple(want["probs"].shape) \
                or not bool(((probs >= 0) & (probs <= 1)).all()):
            raise AssertionError(f"{label}: mask probabilities "
                                 f"{tuple(probs.shape)}")
        same_order = torch.equal(valid, want["dets"].valid) and torch.equal(
            got["dets"].labels[valid], want["dets"].labels[valid])
        out["mask_max_abs_diff"] = float(
            (probs[valid] - want["probs"][valid]).abs().max()) \
            if same_order else None
    return out


def check_mesh2(ref: dict, ranks: list) -> dict:
    """Phase mesh2's checks of each mesh's two ranks against the single
    process (ddp2's bounds) and each other; emits its line; returns each
    mesh's launches (both ranks')."""
    want, init = ref["want"], ref["init"]
    paths, summary = {}, {}
    for label, _, _ in MESH2_MODES:
        runs = [r["meshes"][label] for r in ranks]
        for r, got in enumerate(runs):
            if any(not torch.equal(a, b) for a, b in zip(got["dets"],
                                                         runs[0]["dets"])):
                raise AssertionError(f"mesh2 {label}: rank {r}'s "
                                     "detections differ from rank 0's")
        summary[label] = dict(
            check_mesh_step(f"mesh2 {label}", runs, want, init,
                            PER_TRAIN_STEP),
            detections=match_detections(runs[0]["dets"], ref["dets"]))
        paths[f"mesh2_{label}"] = {
            k: sum(r["launches"].get(k, 0) for r in runs)
            for k in PER_TRAIN_STEP}
    emit("mesh2", world=DDP2_WORLD, backend=ranks[0]["backend"], triples=1,
         single=dict(losses=want["losses"], step_ms=want["step_ms"],
                     step_ms_median=statistics.median(want["step_ms"]),
                     peak_bytes=want["peak_bytes"],
                     param_bytes=want["param_bytes"],
                     momentum_bytes=want["momentum_bytes"]),
         meshes=summary)
    return paths


def fbnet_mesh_reference(dev) -> dict:
    """Phase mesh2's FBNet single process: the mask model's request
    (``mesh_request``), then its source-only step 1 on FBNET_MESH_IMAGES
    images with the sampler draws recorded (peak memory) and
    MESH2_TIMED_STEPS steps timed; then the chamv1a model's request."""
    from da_detect_tpu_torch import entry
    from da_detect_tpu_torch.engine.trainer import (create_train_state,
                                                    make_train_step)

    t0 = time.perf_counter()
    cfg, model = fbnet_mesh_model(entry.FBNET_MASK_YAML, dev)
    init = {n: p.detach().to("cpu", copy=True)
            for n, p in model.named_parameters()}
    batch, _ = entry.make_batch(cfg, 1, seed=5, device=dev)
    request = mesh_request(model, batch, True, dev)
    state = create_train_state(cfg, model, 0, "multistep")
    step = make_train_step(model, state.optimizer, aligned=False,
                           deterministic=True)
    args = entry.make_batch(cfg, FBNET_MESH_IMAGES, seed=0, device=dev,
                            with_masks=True)
    draws = SamplerDraws()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    with draws.record():
        state, metrics = step(state, *args)
    torch.cuda.synchronize()
    want = step_record(state, metrics)
    want["params"] = {n: p.to("cpu", copy=True)
                      for n, p in zip(init, want["params"])}
    want["peak_bytes"] = torch.cuda.max_memory_allocated(dev)
    want["step_ms"] = []
    for _ in range(MESH2_TIMED_STEPS):
        state, ms = timed_step(step, state, args)
        want["step_ms"].append(ms)
    want["param_bytes"] = sum(p.numel() * p.element_size()
                              for p in model.parameters())
    del state, step, model
    c_cfg, c_model = fbnet_mesh_model(entry.FBNET_CHAM_YAML, dev)
    c_batch, _ = entry.make_batch(c_cfg, 1, seed=5, device=dev)
    cham = mesh_request(c_model, c_batch, False, dev)
    del c_model
    torch.cuda.empty_cache()
    spec = dict(batch=batch.to("cpu"), draws=draws,
                args=tuple(a.to("cpu") for a in args),
                cham_batch=c_batch.to("cpu"))
    return dict(want=want, init=init, request=request, cham=cham,
                spec=spec, seconds=time.perf_counter() - t0)


def check_fbnet_mesh2(ref: dict, ranks: list) -> dict:
    """Phase mesh2's FBNet checks: under each mesh of FBNET_MESH_MODES the
    mask model's request (``check_mesh_request``, PER_FBNET_FORWARD) and
    step (``check_mesh_step``, PER_FBNET_TRAIN_STEP), under
    FBNET_CHAM_MESH_MODES the chamv1a request (PER_FBNET_FASTER_FORWARD),
    each against the single process; emits line "mesh2_fbnet"; returns
    each mesh's launches (requests and step, both ranks')."""
    paths, summary = {}, {}
    for label, _, _ in FBNET_MESH_MODES + FBNET_CHAM_MESH_MODES:
        runs = [r["fbnet"][label] for r in ranks]
        cham = any(label == m[0] for m in FBNET_CHAM_MESH_MODES)
        summary[label] = check_mesh_request(
            f"mesh2 {label}", [x["request"] for x in runs],
            ref["cham" if cham else "request"],
            PER_FBNET_FASTER_FORWARD if cham else PER_FBNET_FORWARD)
        launches = collections.Counter()
        for x in runs:
            launches.update(x["request"]["launches"])
        if not cham:
            summary[label].update(check_mesh_step(
                f"mesh2 {label}", runs, ref["want"], ref["init"],
                PER_FBNET_TRAIN_STEP))
            for x in runs:
                launches.update(x["launches"])
        paths[f"mesh2_{label}"] = dict(launches)
    want = ref["want"]
    emit("mesh2_fbnet", world=DDP2_WORLD, backend=ranks[0]["backend"],
         images=FBNET_MESH_IMAGES, seconds=dict(
             single=ref["seconds"], ranks=[r["fbnet_s"] for r in ranks]),
         single=dict(
             losses=want["losses"], step_ms=want["step_ms"],
             step_ms_median=statistics.median(want["step_ms"]),
             peak_bytes=want["peak_bytes"], param_bytes=want["param_bytes"],
             request_ms=ref["request"]["request_ms"],
             request_peak_bytes=ref["request"]["peak_bytes"],
             cham_request_ms=ref["cham"]["request_ms"],
             cham_request_peak_bytes=ref["cham"]["peak_bytes"]),
         meshes=summary)
    return paths


def phase_ddp2(dev) -> dict:
    """Phases ddp2 and mesh2 in one spawn of two ranks. ddp2: two ranks on
    the one card through gloo (CUDA tensors), k = 1 triple
    each, the flagship at 608x1216 in float32, dropout off: step 1 against
    one process's step on the 2-triple batch, both on the same sampler
    draws (recorded in the single step, each rank given its image's rows):
    losses rtol TRAIN_LOSS_RTOL, DAState (margins to 1e-6, last losses as
    losses), each leaf's change within DDP2_PARAM_REL of its largest plus a
    float32 ulp, the two ranks' parameters bit for bit equal; every rank
    launched NMS and both ROIAlign kernels (the train phase's counts a
    step). Then each side's step times. Then mesh2 (``check_mesh2``): one
    triple under (data=1, space=2) and (data=1, model=2); and its FBNet
    runs (``check_fbnet_mesh2``). Returns each path's launches: "ddp2",
    "mesh2_sp2", "mesh2_tp2", "mesh2_fbnet_sp2", "mesh2_fbnet_tp2",
    "mesh2_fbnet_cham_sp2"."""
    from da_detect_tpu_torch import entry, parallel
    from da_detect_tpu_torch.engine.trainer import make_train_step

    cfg = train_cfg(aligned=False)
    state = ddp2_model(cfg, dev)
    init = [p.detach().cpu() for p in state.model.parameters()]
    names = [n for n, _ in state.model.named_parameters()]
    step = make_train_step(state.model, state.optimizer, aligned=False,
                           deterministic=True)
    args = entry.triplet_batches(cfg, DDP2_WORLD, seed=0, device=dev)
    draws = SamplerDraws()
    with draws.record():
        state, metrics = step(state, *args)
    want = step_record(state, metrics)
    want["params"] = [p.cpu() for p in want["params"]]
    single_ms = []
    for _ in range(DDP2_TIMED_STEPS):
        state, ms = timed_step(step, state, args)
        single_ms.append(ms)
    cpu_args = tuple(a.to("cpu") for a in args)
    del state, step, args, metrics
    torch.cuda.empty_cache()
    ref = mesh2_reference(cfg, dev)
    torch.cuda.empty_cache()
    f_ref = fbnet_mesh_reference(dev)
    ref["spec"]["fbnet"] = f_ref["spec"]
    t0 = time.perf_counter()
    ranks = parallel.spawn(ddp2_rank, DDP2_WORLD, cfg, cpu_args, draws,
                           ref["spec"])
    spawn_s = time.perf_counter() - t0
    for r, got in enumerate(ranks):
        for k, n in PER_TRAIN_STEP.items():
            if got["launches"].get(k) != n:
                raise AssertionError(f"ddp2: rank {r} launched {k} "
                                     f"{got['launches'].get(k)} times, "
                                     f"expected {n}")
        if got["losses"] != ranks[0]["losses"] \
                or got["da_state"] != ranks[0]["da_state"] or not all(
                    torch.equal(a, b) for a, b in zip(got["params"],
                                                      ranks[0]["params"])):
            raise AssertionError(f"ddp2: rank {r} differs from rank 0")
    got = ranks[0]
    bad = {k: (got["losses"][k], v) for k, v in want["losses"].items()
           if abs(got["losses"][k] - v) > TRAIN_LOSS_RTOL * abs(v)}
    if bad or set(got["losses"]) != set(want["losses"]):
        raise AssertionError(f"ddp2: losses differ from one process's: {bad}")
    state_tol = [1e-6, 1e-6] + [TRAIN_LOSS_RTOL * abs(v)
                                for v in want["da_state"][2:]]
    if any(abs(a - b) > t for a, b, t in zip(got["da_state"],
                                             want["da_state"], state_tol)):
        raise AssertionError(f"ddp2: DAState {got['da_state']} against "
                             f"{want['da_state']}")
    worst, worst_leaf = 0.0, None
    for n, p0, p, q in zip(names, init, want["params"], got["params"]):
        change = float((p - p0).abs().max())
        ulp = 1.2e-7 * float(p0.abs().max())
        ratio = float((q - p).abs().max()) / (DDP2_PARAM_REL * change + ulp
                                              + 1e-30)
        if ratio > worst:
            worst, worst_leaf = ratio, n
    if worst > 1.0:
        raise AssertionError(f"ddp2: parameter {worst_leaf} off one "
                             f"process's step: {worst:.3f} x its bound")
    launches = {k: sum(r["launches"].get(k, 0) for r in ranks)
                for k in PER_TRAIN_STEP}
    emit("ddp2", world=DDP2_WORLD, backend=got["backend"],
         device=got["device"],
         triples_per_rank=1, losses=got["losses"],
         single_losses=want["losses"], da_state=got["da_state"],
         param_bound_used=worst, worst_param_leaf=worst_leaf,
         launches_by_rank=[r["launches"] for r in ranks],
         sampler_calls=len(draws.calls), spawn_s=spawn_s,
         step_ms={"single_2_triples": single_ms,
                  **{f"rank{r}": x["step_ms"] for r, x in enumerate(ranks)}},
         step_ms_median={"single_2_triples": statistics.median(single_ms),
                         **{f"rank{r}": statistics.median(x["step_ms"])
                            for r, x in enumerate(ranks)}})
    return {"ddp2": launches, **check_mesh2(ref, ranks),
            **check_fbnet_mesh2(f_ref, ranks)}


# ---------------------------------------------------------------- DCN

DCN_NMS_SITES = ("rpn_p2", "rpn_p3", "rpn_p4", "rpn_p5", "rpn_p6",
                 "box_head")


def dcn_model(dev, gather_mode: str, dtype: str = "float32"):
    """The X-101-32x8d-FPN-DCN YAML at the 608x1216 canvas in ``dtype``
    with ``TPU.DCN_GATHER`` = ``gather_mode``, through ``entry(cfg=...)``
    with random weights from seed 0."""
    from da_detect_tpu_torch import entry

    cfg = entry.dcn_cfg(CANVAS, dtype)
    cfg.TPU.DCN_GATHER = gather_mode
    cfg.freeze()
    fn, (model, _) = entry.entry(device=str(dev), seed=0, cfg=cfg)
    return cfg, fn, model


def phase_dcn(dev, dtype: str = "float32"):
    """The DCN eval path in ``dtype``: 4 requests in "four" mode, one
    again with impl="plain", one in "quad" mode. In float32 the two modes
    compute one function, so "quad" is held against "four"; in bfloat16
    "four" rounds each step of the corner sum and "quad" sums its corners
    in float32 (as in the JAX package), so "quad" is held against its own
    plain run."""
    from da_detect_tpu_torch import entry
    from da_detect_tpu_torch.e2e_pairs import spread_dcn

    name, bf16 = label("dcn", dtype), dtype == "bfloat16"
    cfg, fn, model = dcn_model(dev, "four", dtype)
    batches = [entry.make_batch(cfg, 1, seed=s, device=dev)[0]
               for s in range(REQUESTS)]
    raw_std = spread_dcn(model, batches[0])
    answers, launches, seconds = serve_requests(fn, model, batches,
                                                PER_DCN_FORWARD, name)
    summary = [check_detections(cfg, dets) for dets in answers]
    # peak memory of one request, before any input is recorded
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    fn(model, batches[0])
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()

    with record_kernel_inputs() as captured:
        dets_k = fn(model, batches[0])
    rerun_identical = all(torch.equal(x, y)
                          for x, y in zip(dets_k, answers[0]))
    ref = f32_copy(model, cfg)(batches[0], impl="plain") if bf16 else None
    agreement = match_detections(dets_k, model(batches[0], impl="plain"),
                                 ref)

    q_cfg, q_fn, q_model = dcn_model(dev, "quad", dtype)
    q_model.load_state_dict(model.state_dict())
    with record_kernel_inputs() as q_captured:
        (dets_q,), q_launches, _ = serve_requests(
            q_fn, q_model, batches[:1], PER_QUAD_FORWARD,
            label("dcn_quad", dtype))
    check_detections(q_cfg, dets_q)
    quad_agreement = match_detections(
        dets_q, q_model(batches[0], impl="plain") if bf16 else dets_k, ref)
    errs = check_captured(captured)
    merge_errs(errs, check_captured(q_captured))
    emit(name, config=os.path.relpath(entry.DCN_YAML, REPO), dtype=dtype,
         canvas=list(CANVAS), requests=REQUESTS, seconds=seconds,
         launches=launches, quad_launches=q_launches, detections=summary,
         offset_std_before_scaling=dict(min=min(raw_std), max=max(raw_std),
                                        layers=len(raw_std)),
         rerun_identical=rerun_identical, plain_agreement=agreement,
         quad_agreement=quad_agreement, resident_bytes=resident,
         max_memory_allocated=peak,
         main_path_inputs={
             "nms": [dict(shape=list(b.shape), iou=t, valid=int(v.sum()),
                          max_keep=k)
                     for b, v, t, k in captured["nms"]],
             "roi_align_fwd": fwd_inputs(captured)},
         max_abs_err=errs)
    return (model, fn, q_model, q_fn, batches[0], captured, q_captured,
            launches, q_launches, errs)


def gather_device_ms(inputs, name: str, runs: int = GATHER_TIMING_RUNS,
                     profiles: int = GATHER_PROFILES) -> dict:
    """Device time of one forward's gathers (``inputs``: the (table, idx)
    of each recorded launch), for the kernel, the plain version and
    ``torch.index_select``: each variant called once per input, ``runs``
    times over under ``torch.profiler`` after a warm-up pass, its kernels'
    own device time summed per pass. ``profiles`` such profiles, the three
    variants in turns. Now and then a profile misses some of the launches
    (one of three caught 3% of a deform-pool run's): a variant's profiles
    that caught fewer device launches than its most complete one are left
    out, and more are taken, up to ``profiles`` more, until ``profiles``
    complete ones are kept. The median of those, every profile's number
    and the launches a pass are kept. Unlike CUDA events around each call,
    this leaves out the host's launch overhead, which is as long as a
    small gather itself."""
    from da_detect_tpu_torch.ops import gather, gather_cuda

    variants = {"ms": getattr(gather_cuda, name),
                "plain_ms": gather.row_gather,
                "library_ms": lambda t, i: torch.index_select(t, 0, i)}

    def runner(fn):
        def run():
            for table, idx in inputs:
                fn(table, idx)
        return run

    taken = {key: [] for key in variants}

    def take(key):
        prof = device_profile(runner(variants[key]), runs, host=False)
        taken[key].append((round(prof["device_calls_per_run"] * runs),
                           prof["device_ms_per_run"],
                           prof["device_busy_share"]))

    for fn in variants.values():
        runner(fn)()
    for _ in range(profiles):
        for key in variants:
            take(key)
    out = {}
    for key in variants:
        for _ in range(profiles):
            most = max(calls for calls, _, _ in taken[key])
            if sum(calls == most for calls, _, _ in taken[key]) >= profiles:
                break
            take(key)
        most = max(calls for calls, _, _ in taken[key])
        kept = [(ms, b) for calls, ms, b in taken[key] if calls == most]
        out[key] = statistics.median(ms for ms, _ in kept)
        out[key.replace("ms", "profiles_ms")] = [ms for _, ms, _ in
                                                 taken[key]]
        out[key.replace("ms", "busy_share")] = statistics.median(
            b for _, b in kept)
        out[key.replace("ms", "launches_per_pass")] = most / runs
    return out


def sweep_point(table, idx) -> dict:
    """Device time a call (``torch.profiler``, SWEEP_RUNS calls each) of
    the row gather through each mapping and of ``index_select`` on one
    table, each output bit for bit ``index_select``'s; and the bound."""
    from torch.profiler import ProfilerActivity, profile

    from da_detect_tpu_torch.ops import gather_cuda

    variants = {
        "rows_ms": lambda: gather_cuda.row_gather_mapped(table, idx, "rows"),
        "flat_ms": lambda: gather_cuda.row_gather_mapped(table, idx, "flat"),
        "library_ms": lambda: torch.index_select(table, 0, idx)}
    want = torch.index_select(table, 0, idx)
    out = {}
    for key, fn in variants.items():
        if not torch.equal(fn(), want):
            raise AssertionError(f"gather sweep: {key[:-3]} differs from "
                                 f"index_select on {tuple(table.shape)} "
                                 f"{table.dtype}")
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(SWEEP_RUNS):
                fn()
            torch.cuda.synchronize()
        out[key] = sum(e.self_device_time_total
                       for e in device_kernels(prof)) / 1e3 / SWEEP_RUNS
    row_bytes = table.shape[1] * table.element_size()
    rows = int(torch.unique(idx).numel())
    out["bound_ms"] = bound(rows * row_bytes + idx.numel() * (4 + row_bytes),
                            0)[0]
    return out


def phase_gather_sweep(dev) -> list:
    """The row gather's two mappings against ``index_select`` across row
    widths (SWEEP_ROW_BYTES, both dtypes), on the deform pool's count of
    indices: a line a width, each with the mapping the shapes pick; the
    crossovers (``gather_cuda.WIDE_WORD_ROW_BYTES``, ``WIDE_ROW_BYTES``)
    are where the flat mapping stops winning."""
    from da_detect_tpu_torch.ops import gather_cuda

    gen = torch.Generator(device=dev).manual_seed(11)
    points = []
    for dtype in (torch.float32, torch.bfloat16):
        item = torch.tensor([], dtype=dtype).element_size()
        for nbytes in SWEEP_ROW_BYTES:
            c = -(-nbytes // item)
            s = min(SWEEP_TABLE_ROWS, SWEEP_TABLE_BYTES // (c * item))
            table = torch.randn(s, c, device=dev, generator=gen).to(dtype)
            idx = torch.randint(0, s, (SWEEP_INDICES,), device=dev,
                                generator=gen, dtype=torch.int32)
            point = dict(dtype=str(dtype)[6:], row_bytes=c * item, c=c,
                         table_rows=s, indices=SWEEP_INDICES,
                         picked=gather_cuda.row_gather_mapping(table),
                         **sweep_point(table, idx))
            for key in ("rows_ms", "flat_ms", "library_ms"):
                point[key.replace("ms", "share_of_bound")] = (
                    point["bound_ms"] / point[key] if point[key] else None)
            emit("gather_sweep", **point)
            points.append(point)
            del table, idx
    return points


def pooler_device_ms(captured) -> dict:
    """Device time of the DCN model's whole pooler (``pool_rois``: the
    level assignment and the ROIAlign launch) on the ROIs and maps of the
    forward's own launch, by kernel group, KERNEL_PROFILE_RUNS calls."""
    from da_detect_tpu_torch.models import poolers

    (maps, rois, _, kw), = captured["roi_align_fwd"]
    prof = device_profile(lambda: poolers.pool_rois(maps, rois, **kw,
                                                    impl="cuda"),
                          KERNEL_PROFILE_RUNS,
                          kernels=("roi_align_fwd_kernel",))
    return dict(device_ms=prof["device_ms_per_run"],
                kernel_device_ms=prof["kernel_ms_per_run"][
                    "roi_align_fwd_kernel"],
                groups_ms=prof["groups_ms_per_run"])


def gather_groups(sites) -> dict:
    """The gather sites of one forward summed by kernel and shape."""
    groups = {}
    for s in sites:
        if not s["kernel"].startswith("row_gather"):
            continue
        key = (f"{s['kernel']} table {s['table'][0]}x{s['table'][1]} "
               f"P {s['indices']}")
        g = groups.setdefault(key, dict(taps=0, ms=0.0, plain_ms=0.0,
                                        library_ms=0.0, bytes=0))
        g["taps"] += 1
        for k in ("ms", "plain_ms", "library_ms", "bytes"):
            g[k] += s[k]
    for g in groups.values():
        g["bound_ms"] = bound(g["bytes"], 0)[0]
    return groups


def phase_dcn_times(model, fn, q_model, q_fn, batch, captured,
                    q_captured, dtype: str = "float32") -> tuple[list, list]:
    """The DCN eval path's kernel sites, gather device times, forward
    latency ("four" and "quad"), stage split, profile and conv census; in
    float32 also the NMS sites, the plain forward's latency and the
    pooler's device time."""
    f32 = dtype == "float32"
    nms_sites = DCN_NMS_SITES if f32 else ()
    sites = time_sites(captured, label("dcn", dtype), nms_sites)
    q_sites = time_sites(q_captured, label("dcn_quad", dtype), nms_sites)
    forward_ms = host_ms(lambda: fn(model, batch), runs=DCN_FORWARD_RUNS)
    quad_forward_ms = host_ms(lambda: q_fn(q_model, batch),
                              runs=DCN_FORWARD_RUNS)
    forward_plain_ms = host_ms(lambda: model(batch, impl="plain"), runs=5,
                               warmup=1) if f32 else None
    body, box = model.backbone.body, model.roi_heads["box"]
    marks = [("stem", body.stem), ("res2", body.layer1),
             ("res3", body.layer2), ("res4", body.layer3),
             ("res5", body.layer4), ("fpn", model.backbone.fpn),
             ("rpn_head", model.rpn["head"]),
             ("extractor", box["feature_extractor"]),
             ("fc6", box["feature_extractor"].fc6),
             ("predictor", box["predictor"])]
    spans = {"normalize": ("start", "stem.in"),
             "body_to_res2": ("stem.in", "res2.out"),
             "res3": ("res3.in", "res3.out"),
             "res4": ("res4.in", "res4.out"),
             "res5": ("res5.in", "res5.out"),
             "fpn": ("fpn.in", "fpn.out"),
             "rpn_and_proposals": ("rpn_head.in", "extractor.in"),
             "pooler": ("extractor.in", "fc6.in"),
             "box_head": ("fc6.in", "predictor.out"),
             "postprocess": ("predictor.out", "end")}
    stages = stage_times(model, batch, marks, spans)
    profile = device_profile(lambda: fn(model, batch), DCN_PROFILE_RUNS)
    census = conv_census(profile, dtype == "bfloat16", label("dcn", dtype))
    pooler = pooler_device_ms(captured) if f32 else None
    device = {"row_gather": gather_device_ms(captured["row_gather"],
                                             "row_gather"),
              "row_gather_bulk": gather_device_ms(
                  q_captured["row_gather_bulk"], "row_gather_bulk")}
    emit(label("dcn_times", dtype), forward_ms=forward_ms,
         quad_forward_ms=quad_forward_ms, forward_plain_ms=forward_plain_ms,
         stages_ms=stages, profile=profile, conv_kernels_by_dtype=census,
         pooler=pooler, gather_device_ms=device,
         gather_call_ms={"four": gather_groups(sites),
                         "quad": gather_groups(q_sites)},
         sites=[s for s in sites + q_sites
                if not s["kernel"].startswith("row_gather")])
    return sites, q_sites, device


# ---------------------------------------------------------------- DCN training

def scatter_work(records) -> float:
    """Bytes of a step's scatter-adds as functions with a dense output
    (``records`` from ``record_kernel_inputs``), whatever computes them:
    each gradient row and each index read once, each [S, C] output written
    once. The destination is not read (it starts at zero), and its zeros
    are part of the output, not a fill apart. Rows and output in the
    gradient's dtype (4 or 2 bytes an element), indices 4 bytes."""
    nbytes = 0
    for rec in records:
        (s, c), idx = rec["shape"], rec["idx"]
        if idx.numel() and not (0 <= int(idx.min()) and int(idx.max()) < s):
            raise AssertionError(f"a scatter-add index of the main path lies "
                                 f"outside its destination of {s} rows")
        elem = torch.empty((), dtype=rec["dtype"]).element_size()
        nbytes += elem * (idx.numel() * c + s * c) + 4 * idx.numel()
    return nbytes


def scatter_device_ms(records) -> dict:
    """Device time of a step's scatter-adds on the step's own indices and
    shapes, each a function with a dense [S, C] output: the kernel with the
    CSR its layer built (``ms``) and building its own (``csr_build_ms``),
    the plain version (zeros, clamp, index_add_) and torch.zeros +
    index_add_ (``library_ms``); each variant called once a record,
    SCATTER_TIMING_RUNS times over under
    ``torch.profiler`` after a warm-up pass; GATHER_PROFILES such profiles,
    the variants in turns. The gradient rows are random (the step's were
    checked where they ran and not kept): the work depends on the indices
    and shapes alone."""
    from da_detect_tpu_torch.ops import gather, gather_cuda

    dev = records[0]["idx"].device
    most = max(r["idx"].numel() * r["shape"][1] for r in records)
    buf = torch.randn(most, generator=torch.Generator(device=dev).manual_seed(
        0), device=dev).to(records[0]["dtype"])
    calls = []
    for rec in records:
        (s, c), idx = rec["shape"], rec["idx"]
        calls.append((s, buf[:idx.numel() * c].view(-1, c), idx,
                      rec["csr"] or gather.row_csr(idx, s)))
    variants = {
        "ms": lambda s, g, i, csr: gather_cuda.row_scatter_add(g, i, s, csr),
        "csr_build_ms": lambda s, g, i, csr: gather_cuda.row_scatter_add(
            g, i, s),
        "plain_ms": lambda s, g, i, csr: gather.row_scatter_add(g, i, s),
        "library_ms": lambda s, g, i, csr: torch.zeros(
            s, g.shape[1], dtype=g.dtype, device=g.device).index_add_(0, i, g)}

    def runner(fn):
        def run():
            for call in calls:
                fn(*call)
        return run

    for fn in variants.values():
        runner(fn)()
    profiles = {key: [] for key in variants}
    for _ in range(GATHER_PROFILES):
        for key, fn in variants.items():
            profiles[key].append(device_profile(
                runner(fn), SCATTER_TIMING_RUNS, host=False)[
                    "device_ms_per_run"])
    out = {}
    for key in variants:
        out[key] = statistics.median(profiles[key])
        out[key.replace("ms", "profiles_ms")] = profiles[key]
    return out


def scatter_timing(records, bound_ms: float) -> dict:
    """A step's scatter-adds (``records``, each with the CSR its layer
    handed over): their device times (``scatter_device_ms``), each one's
    share of ``bound_ms``, how their sources spread over the rows
    (``scatter_traffic``) and the bit checks made where they ran."""
    if any(rec["csr"] is None for rec in records):
        raise AssertionError("dcn_train: a scatter-add of the step got no CSR "
                             "from its layer")
    device = scatter_device_ms(records)
    times_ms = {k: v for k, v in device.items() if "profiles" not in k}
    return dict(
        **times_ms, bound_share={k: bound_ms / v for k, v in times_ms.items()},
        profiles_ms={k: v for k, v in device.items() if "profiles" in k},
        **scatter_traffic(records),
        bit_checks={f"dst {r['shape'][0]}x{r['shape'][1]}": r["bits"]
                    for r in records if "bits" in r})


def train_inputs(captured) -> dict:
    """A summary of a train step's captured NMS and ROIAlign inputs."""
    return {"nms": [dict(shape=list(b.shape), iou=t, valid=int(v.sum()),
                         max_keep=k)
                    for b, v, t, k in captured["nms"]],
            "roi_align_fwd": fwd_inputs(captured),
            "roi_align_bwd": [dict(grad=list(g.shape), rois=list(r.shape),
                                   height=h, width=w, grad_copied=copied,
                                   **kw)
                              for g, r, h, w, kw, copied in
                              captured["roi_align_bwd"]]}


def record_shapes(records) -> dict:
    """The scatter-add records by destination shape and index count."""
    shapes = {}
    for rec in records:
        key = f"dst {rec['shape'][0]}x{rec['shape'][1]} P {rec['idx'].numel()}"
        shapes[key] = shapes.get(key, 0) + 1
    return shapes


def dcn_train_model(dev, gather_mode: str, dtype: str = "float32"):
    """``train_entry(cfg=dcn_train_cfg())`` at the 608x1216 canvas in
    ``dtype`` with ``TPU.DCN_GATHER`` = ``gather_mode``: (step, state, batch
    args)."""
    from da_detect_tpu_torch import entry

    cfg = entry.dcn_train_cfg(CANVAS, dtype)
    cfg.TPU.DCN_GATHER = gather_mode
    cfg.freeze()
    step, (state, args) = entry.train_entry(device=str(dev), seed=0, cfg=cfg)
    return step, state, args


def phase_dcn_train(dev, dtype: str = "float32"):
    """The DCN train step in ``dtype``: step 1 through the kernels with its
    inputs recorded and checked, against its plain run, the scatter-add
    timed on step 1's indices, timed steps, a profile. float32: also
    "quad" step 1 against its plain run and a step, DCN_TRAIN_STEPS timed
    steps, and a later step's inputs recorded and checked, its NMS and
    ROIAlign sites timed and its scatter-adds' row traffic reported (by
    then the random-weight step has diverged). bfloat16: "four" only (the
    eval phase runs "quad"), BF16_DCN_TRAIN_STEPS timed steps, step 1's
    inputs its sites. ``seconds``: the phase's time at each part's end."""
    from da_detect_tpu_torch import entry
    from da_detect_tpu_torch.e2e_pairs import spread_dcn
    from da_detect_tpu_torch.layers import DeformConv2d

    name, bf16 = label("dcn_train", dtype), dtype == "bfloat16"
    n_steps = BF16_DCN_TRAIN_STEPS if bf16 else DCN_TRAIN_STEPS
    t0, seconds = time.perf_counter(), {}

    def done(part):
        seconds[part] = time.perf_counter() - t0
    step, state, args = dcn_train_model(dev, "four", dtype)
    raw_std = spread_dcn(state.model, args[0])
    # step 1 of the kernel run with its kernels' inputs recorded: the
    # scatter-adds' indices before any update, offsets as drawn; and the
    # offsets' std in each deformable conv of each backbone pass (source,
    # positive, negative: the source + 200 in every pixel), in forward order
    offset_std = []
    hooks = [m.conv_offset.register_forward_hook(
        lambda _m, _i, out: offset_std.append(float(out.std())))
        for m in state.model.modules() if isinstance(m, DeformConv2d)]
    try:
        with record_kernel_inputs() as first:
            kernel_one = train_step_one(state, args, "cuda")
    finally:
        for h in hooks:
            h.remove()
    layers = len(hooks)
    if len(offset_std) != 3 * layers:
        raise AssertionError(f"dcn_train: {len(offset_std)} offset convs ran "
                             f"in step 1, expected 3 passes x {layers}")
    done("step_1")
    errs = check_captured(first)
    done("step_1_checks")
    first_records = first.pop("row_scatter_add")
    # bfloat16: step 1's inputs are the phase's captures (its sites' times
    # and shapes); float32 records a later step too, below
    captured = first if bf16 else None
    shapes = record_shapes(first_records)
    del first
    agreement = compare_steps(
        kernel_one, train_step_one(state, args, "plain"),
        f32_step_one(state, entry.dcn_train_cfg(CANVAS), args)
        if bf16 else None)
    del kernel_one
    done("plain_step_1")
    # the scatter-add's bound (its bytes depend on the shapes alone, the
    # same in every step) and its times on step 1's indices, taken now so
    # that the records are gone before the timed steps' peak memory
    nbytes = scatter_work(first_records)
    bound_ms, by = bound(nbytes, 0)
    timed = {"step_1": scatter_timing(first_records, bound_ms)}
    del first_records
    done("scatter_timing")
    if bf16:
        sites = time_sites(dict(captured, row_gather=[], row_gather_bulk=[]),
                           name)
        inputs = train_inputs(captured)
        del captured  # the maps and gradients it holds: not in the peak
    quad = None
    if not bf16:
        # "quad" on the same weights: step 1 against its plain run, a step
        q_step, q_state, _ = dcn_train_model(dev, "quad")
        q_state.model.load_state_dict(state.model.state_dict())
        q_agreement = compare_steps(train_step_one(q_state, args, "cuda"),
                                    train_step_one(q_state, args, "plain"))
        q_state, q_launches, q_times, q_metrics = run_steps(
            q_step, q_state, args, DCN_QUAD_TRAIN_STEPS,
            PER_DCN_QUAD_TRAIN_STEP, "dcn_train_quad")
        del q_step, q_state
        quad = dict(plain_agreement=q_agreement, steps=DCN_QUAD_TRAIN_STEPS,
                    launches=q_launches, step_ms=q_times,
                    losses=[{k: float(v) for k, v in m.items()}
                            for m in q_metrics])
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    done("quad")
    state, launches, times, metrics = run_steps(
        step, state, args, n_steps, PER_DCN_TRAIN_STEP, name)
    peak = torch.cuda.max_memory_allocated()
    done("steps")
    holder = [state]

    def one_step():
        holder[0], _ = step(holder[0], *args)

    profile = device_profile(one_step, 1, kernels=(
        "row_gather_kernel", "row_scatter_add", "nms_mask_kernel",
        "roi_align_fwd_kernel", "roi_align_bwd_kernel"), host=False)
    census = conv_census(profile, bf16, name)
    done("profile")
    if not bf16:
        # the step after the profiled one, its kernels' inputs recorded and
        # checked: with random weights the step has diverged by then (the
        # losses), and its sample corners clamp onto the maps' border rows
        with record_kernel_inputs() as captured:
            one_step()
            torch.cuda.synchronize()
        merge_errs(errs, check_captured(captured))
        records = captured.pop("row_scatter_add")
        sites = time_sites(dict(captured, row_gather=[], row_gather_bulk=[]),
                           name, DCN_TRAIN_NMS_SITES)
        inputs = train_inputs(captured)
        if scatter_work(records) != nbytes or record_shapes(records) != shapes:
            raise AssertionError(f"{name}: the steps' scatter-adds differ in "
                                 "shape")
        timed[f"step_{n_steps + 2}_traffic"] = scatter_traffic(records)
        done("later_step")
    del step, holder, state
    # the kernel's numbers: step 1's indices, which do not depend on how
    # far the random-weight step has diverged
    head = timed["step_1"]
    scatter = dict(
        launches=launches["row_scatter_add"], ms=head["ms"],
        plain_ms=head["plain_ms"], library_ms=head["library_ms"],
        bound_ms=bound_ms, bound_by=by, bytes=nbytes, device_ms=head["ms"],
        step_profile_ms=profile["groups_ms_per_run"].get("row_scatter_add"),
        steps={key: {k: t[k] for k in ("ms", "csr_build_ms", "plain_ms",
                                       "library_ms", "long_row_share")
                     if k in t}
               for key, t in timed.items()})
    emit(name, config=os.path.relpath(entry.DCN_YAML, REPO), dtype=dtype,
         seconds=seconds, canvas=list(CANVAS), steps=n_steps,
         launches=launches,
         launches_per_step={k: v / n_steps for k, v in launches.items()},
         conv_kernels_by_dtype=census,
         step_ms=times, step_ms_median=statistics.median(times),
         resident_bytes=resident, max_memory_allocated=peak,
         saved_tap_rows_bytes=SAVED_TAP_BYTES, profile=profile,
         losses=[{k: float(v) for k, v in m.items()} for m in metrics],
         offset_std_before_scaling=dict(min=min(raw_std), max=max(raw_std),
                                        layers=len(raw_std)),
         step_1_offset_std={
             part: dict(min=min(offset_std[i * layers:(i + 1) * layers]),
                        max=max(offset_std[i * layers:(i + 1) * layers]))
             for i, part in enumerate(("source", "positive", "negative"))},
         plain_agreement=agreement, quad=quad,
         main_path_inputs=dict(inputs, row_scatter_add=shapes),
         scatter_add=dict(scatter, records=timed), sites=sites,
         max_abs_err=errs)
    return sites, launches, scatter, errs


# ---------------------------------------------------------------- summary


# ---------------------------------------------------------------- data, CLIs

# ---------------------------------------------------------------- Mask R-CNN

def mask_agreement(model, batch, dets, probs, ref=None) -> dict:
    """The mask head on the kernel run's own detections ``dets`` (the
    request's ``probs``), through the kernels again (bit for bit
    ``probs``) and through the plain versions: float32 within
    MASK_PROB_ATOL; bfloat16 (``ref``: an f32 copy of the model) within
    twice the plain run's distance from the copy's, or MASK_PROB_BF16_FLOOR.
    Only the valid detections count."""
    def run(m, impl):
        feats = m.backbone(batch.normalized(m.pixel_mean, m.pixel_std,
                                            m.to_bgr255), impl=impl)
        return m.mask_probs(feats, dets, impl)

    with torch.no_grad():
        again, plain = run(model, "cuda"), run(model, "plain")
        f32 = run(ref, "plain") if ref is not None else None
    torch.cuda.synchronize()
    valid = dets.valid
    err = float((again[valid] - plain[valid]).abs().max())
    out = dict(detections=int(valid.sum()), max_abs_err=err,
               rerun_identical=torch.equal(again, probs),
               mean_prob=float(probs[valid].mean()))
    if ref is None:
        bound = MASK_PROB_ATOL
    else:
        out["bf16_vs_f32"] = float((plain[valid] - f32[valid]).abs().max())
        bound = max(2 * out["bf16_vs_f32"], MASK_PROB_BF16_FLOOR)
    if not out["rerun_identical"] or not err <= bound:
        raise AssertionError(f"mask probabilities, kernels against plain on "
                             f"the same detections: {out}, bound {bound}")
    return out


def mask_model(dev, dtype: str):
    """The Cityscapes mask YAML at 800x1344 in ``dtype`` through
    ``entry(cfg=mask_cfg(), with_masks=True)``, random weights from seed 0,
    score layers spread; and REQUESTS batches."""
    from da_detect_tpu_torch import entry

    cfg = entry.mask_cfg(dtype=dtype)
    cfg.freeze()
    fn, (model, _) = entry.entry(device=str(dev), seed=0, cfg=cfg,
                                 with_masks=True)
    spread_scores(model)
    batches = [entry.make_batch(cfg, 1, seed=s, device=dev)[0]
               for s in range(REQUESTS)]
    return cfg, fn, model, batches


def phase_mask(dev, dtype: str = "float32"):
    """The Cityscapes Mask R-CNN (R-50-FPN, MASK_ON) at 800x1344 in
    ``dtype``. Eval: REQUESTS batch-1 requests with masks and exact launch
    counts, kernel run against plain run (detections by
    ``match_detections``; the mask probabilities on the kernel run's
    detections, ``mask_agreement``), the path's kernel sites timed. Train:
    the source-only step on 2 images through ``source_train_entry``:
    kernel-run against plain-run step 1 (losses, ``loss_mask`` included,
    and every gradient: ``compare_steps``, in float32 with the box head's
    ReLU flips between the runs found and their rows left out),
    MASK_TRAIN_STEPS timed steps with exact launch counts, a profile, peak
    memory, one step's kernel inputs checked and timed. Returns (eval
    sites, eval launches, train sites, train launches, largest errors)."""
    from da_detect_tpu_torch import entry

    name, bf16 = label("mask", dtype), dtype == "bfloat16"
    cfg, fn, model, batches = mask_model(dev, dtype)
    answers, launches, seconds = serve_requests(fn, model, batches,
                                                PER_MASK_FORWARD, name)
    summary = []
    for dets, probs in answers:
        row = check_detections(cfg, dets)
        side = 2 * cfg.MODEL.ROI_MASK_HEAD.POOLER_RESOLUTION
        if tuple(probs.shape) != (1, dets.boxes.shape[1], side, side) \
                or probs.dtype != torch.float32 \
                or not bool(((probs >= 0) & (probs <= 1)).all()):
            raise AssertionError(f"{name}: mask probabilities "
                                 f"{tuple(probs.shape)} {probs.dtype}")
        summary.append(dict(row, mask_shape=list(probs.shape)))
    with record_kernel_inputs() as captured:
        dets_k, probs_k = fn(model, batches[0])
    ref = f32_copy(model, cfg) if bf16 else None
    agreement = match_detections(
        dets_k, model(batches[0], impl="plain"),
        ref(batches[0], impl="plain") if bf16 else None)
    masks = mask_agreement(model, batches[0], dets_k, probs_k, ref)
    del ref
    errs = check_captured(captured)
    eval_sites = time_sites(captured, label("mask_eval", dtype),
                            MASK_NMS_SITES if not bf16 else ())
    forward_ms = host_ms(lambda: fn(model, batches[0]), runs=10)
    emit(name, config=os.path.relpath(entry.MASK_YAML, REPO), dtype=dtype,
         canvas=list(cfg.TPU.IMAGE_SHAPE), requests=REQUESTS,
         seconds=seconds, launches=launches, detections=summary,
         plain_agreement=agreement, mask_agreement=masks,
         forward_ms=forward_ms, sites=eval_sites,
         main_path_inputs={"roi_align_fwd": fwd_inputs(captured)},
         max_abs_err=errs)
    del model, fn, batches, captured, answers

    t_name = label("mask_train", dtype)
    cfg = entry.mask_cfg(dtype=dtype)
    cfg.freeze()
    step, (state, args) = entry.source_train_entry(device=str(dev), seed=0,
                                                   cfg=cfg)
    if bf16:
        t_agreement = compare_steps(
            train_step_one(state, args, "cuda"),
            train_step_one(state, args, "plain"),
            f32_step_one(state, cfg, args))
    else:
        with relu_inputs(state.model) as pre_k:
            kernel = train_step_one(state, args, "cuda")
        with relu_inputs(state.model) as pre_p:
            plain = train_step_one(state, args, "plain")
        t_agreement = compare_steps(kernel, plain,
                                    flips=relu_flips(pre_k, pre_p))
        del kernel, plain, pre_k, pre_p
    state, record, t_captured = measure_train_path(
        step, state, args, t_name, bf16, MASK_TRAIN_STEPS,
        PER_MASK_TRAIN_STEP, MASK_PROFILE_STEPS)
    del step, state
    merge_errs(errs, check_captured(t_captured))
    train_sites = time_sites(t_captured, t_name,
                             MASK_NMS_SITES[:5] if not bf16 else ())
    if not all(m["loss_mask"] > 0 for m in record["losses"]):
        raise AssertionError(f"{t_name}: loss_mask {record['losses']}")
    emit(t_name, config=os.path.relpath(entry.MASK_YAML, REPO), dtype=dtype,
         canvas=list(cfg.TPU.IMAGE_SHAPE), images=MASK_TRAIN_IMAGES,
         plain_agreement=t_agreement, sites=train_sites,
         main_path_inputs=train_inputs(t_captured), max_abs_err=errs,
         **record)
    return eval_sites, launches, train_sites, record["launches"], errs


def phase_mask_cli(dev) -> dict:
    """The mask path from files, bfloat16: a gtFine tree at Cityscapes
    geometry (``cityscapes_tree``) through ``convert_cityscapes_to_coco``
    (instance polygons), ``train_net.main`` on the Cityscapes mask YAML
    (source-only, its loader rasterizing the polygons into GT masks)
    for MASK_CLI_STEPS steps with exact launch counts, then
    ``test_net.main`` reporting bbox and segm in the COCO protocol and in
    the Cityscapes one (TEST.EVAL_STYLE cityscapes), a request an image
    with exact launch counts. Returns the training run's launches."""
    from da_detect_tpu_torch import entry
    from da_detect_tpu_torch.tools import (convert_cityscapes_to_coco,
                                           test_net, train_net)

    name = "mask_cli_bf16"
    with tempfile.TemporaryDirectory(prefix="chip_smoke_mask_") as root:
        clean, gt = cityscapes_tree(root, MASK_CLI_IMAGES, DATA_HW, seed=2)
        ann_dir = os.path.join(root, "annotations")
        convert_cityscapes_to_coco.main(
            ["--gt-dir", gt, "--out-dir", ann_dir, "--splits", "train"])
        ann = os.path.join(ann_dir, "instancesonly_filtered_gtFine_train.json")
        names = {"mask_train": (clean, ann), "mask_val": (clean, ann)}
        catalog = os.path.join(root, "mask_catalog.py")
        with open(catalog, "w") as f:
            f.write(USER_CATALOG.format(names=names))
        opts = {"MODEL.WEIGHT": "", "TPU.COMPUTE_DTYPE": "bfloat16",
                "PATHS_CATALOG": catalog,
                "DATASETS.TRAIN": "('mask_train',)",
                "DATASETS.TEST": "('mask_val',)",
                "SOLVER.IMS_PER_BATCH": str(MASK_TRAIN_IMAGES),
                "SOLVER.BASE_LR": str(MASK_CLI_LR),
                "SOLVER.MAX_ITER": str(MASK_CLI_STEPS),
                "SOLVER.CHECKPOINT_PERIOD": str(MASK_CLI_STEPS),
                "TEST.IMS_PER_BATCH": "1",
                "DATALOADER.STAGE_CACHE": "False",
                "MODEL.OUTPUT_DIR": os.path.join(root, "out"),
                "MODEL.OUTPUT_SAVE_NAME": "run"}
        opts = [x for kv in opts.items() for x in kv]
        argv = ["--config-file", entry.MASK_YAML, "--seed", "0"]
        clear_counts()
        t0 = time.perf_counter()
        state, meters = train_net.main(argv + ["--skip-test",
                                               "--log-period", "1"] + opts)
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        launches = read_counts(PER_MASK_TRAIN_STEP, MASK_CLI_STEPS, name,
                               "steps")
        loss_mask = [float(v) for v in meters.meters["loss_mask"].deque]
        totals = [float(v) for v in meters.meters["loss_total"].deque]
        if state.step != MASK_CLI_STEPS or len(loss_mask) != MASK_CLI_STEPS \
                or not all(np.isfinite(loss_mask + totals)) \
                or min(loss_mask) <= 0:
            raise AssertionError(f"{name}: {state.step} steps, loss_mask "
                                 f"{loss_mask}, loss_total {totals}")
        del state, meters
        run_dir = os.path.join(root, "out", "run")
        results, eval_s = {}, {}
        for style in ("coco", "cityscapes"):
            clear_counts()
            t0 = time.perf_counter()
            res = test_net.main(argv + ["--ckpt", run_dir] + opts
                                + ["TEST.EVAL_STYLE", style])["mask_val"]
            torch.cuda.synchronize()
            eval_s[style] = time.perf_counter() - t0
            read_counts(PER_MASK_FORWARD, MASK_CLI_IMAGES,
                        f"{name} {style}", "requests")
            if set(res) != {"bbox", "segm"} or not os.path.exists(
                    os.path.join(run_dir, f"{style}_results.json")):
                raise AssertionError(f"{name}: {style} results {set(res)}")
            results[style] = {
                t: ({k: res[t][k] for k in ("AP", "AP50", "AP75")}
                    if style == "coco" else
                    {k: res[t][k] for k in ("allAp", "allAp50%",
                                            "allAp75%")})
                for t in ("bbox", "segm")}
    emit(name, config=os.path.relpath(entry.MASK_YAML, REPO),
         images=MASK_CLI_IMAGES, image_hw=list(DATA_HW),
         steps=MASK_CLI_STEPS, base_lr=MASK_CLI_LR, train_s=train_s,
         launches=launches, loss_mask=loss_mask, loss_total=totals,
         eval_s=eval_s, results=results)
    return launches


# ---------------------------------------------------------------- Keypoint

def keypoint_model(dev, dtype: str):
    """The keypoint R-CNN YAML at 800x1344 in ``dtype`` through
    ``entry(cfg=keypoint_cfg(), with_keypoints=True)``, random weights from
    seed 0, score layers spread; and REQUESTS batches."""
    from da_detect_tpu_torch import entry

    cfg = entry.keypoint_cfg(dtype=dtype)
    cfg.freeze()
    fn, (model, _) = entry.entry(device=str(dev), seed=0, cfg=cfg,
                                 with_keypoints=True)
    spread_scores(model)
    batches = [entry.make_batch(cfg, 1, seed=s, device=dev)[0]
               for s in range(REQUESTS)]
    return cfg, fn, model, batches


def check_keypoints(cfg, dets, kps) -> dict:
    """A request's keypoints: [1, D, K, 3] float32, finite, each valid
    detection's inside its box (the heatmap cells' centres); a summary."""
    k = cfg.MODEL.ROI_KEYPOINT_HEAD.NUM_CLASSES
    if tuple(kps.shape) != (1, dets.boxes.shape[1], k, 3) \
            or kps.dtype != torch.float32 \
            or not bool(torch.isfinite(kps).all()):
        raise AssertionError(f"keypoints {tuple(kps.shape)} {kps.dtype}")
    v = dets.valid[0]
    pts, box = kps[0][v], dets.boxes[0][v][:, None]
    inside = ((pts[..., 0] >= box[..., 0] - 1e-3)
              & (pts[..., 0] <= box[..., 2] + 1e-3)
              & (pts[..., 1] >= box[..., 1] - 1e-3)
              & (pts[..., 1] <= box[..., 3] + 1e-3))
    if not bool(inside.all()):
        raise AssertionError("a decoded keypoint lies outside its box")
    return dict(keypoint_shape=list(kps.shape),
                mean_keypoint_score=float(pts[..., 2].mean()))


def keypoint_cells(kps, boxes, h: int, w: int) -> torch.Tensor:
    """The heatmap cell (flat index into h x w) each decoded keypoint of
    ``kps`` [B, D, K, 3] came from, inside its box of ``boxes`` [B, D, 4]
    (``heatmaps_to_keypoints`` inverted)."""
    x1, y1 = boxes[..., 0:1], boxes[..., 1:2]
    sw = (boxes[..., 2:3] - x1).clamp(min=1e-3) / w
    sh = (boxes[..., 3:4] - y1).clamp(min=1e-3) / h
    px = torch.round((kps[..., 0] - x1) / sw - 0.5).long().clamp(0, w - 1)
    py = torch.round((kps[..., 1] - y1) / sh - 0.5).long().clamp(0, h - 1)
    return py * w + px


def keypoint_agreement(model, batch, dets, kps, ref=None) -> dict:
    """The keypoint head on the kernel run's own detections ``dets`` (the
    request's keypoints ``kps``), through the kernels again and through the
    plain versions. The rerun's keypoints equal the request's bit for bit
    (the predictor's ``FoldedConvTranspose2d`` sums in a fixed order). The
    heatmap logits of the valid detections, kernel against plain, within
    KP_LOGIT_REL of the largest (float32) or, in bfloat16 (``ref``: an f32
    copy of the model), twice the plain run's distance from the copy's or
    one bf16 ulp: the bound. A keypoint whose cell differs between the
    plain run and the rerun may only move to a near tie: the plain
    heatmap at that cell within twice the bound of its maximum."""
    from da_detect_tpu_torch.models.keypoint_head import heatmaps_to_keypoints

    def run(m, impl):
        feats = m.backbone(batch.normalized(m.pixel_mean, m.pixel_std,
                                            m.to_bgr255), impl=impl)
        return m.keypoint_head(feats, dets.boxes, impl=impl).float()

    with torch.no_grad():
        again, plain = run(model, "cuda"), run(model, "plain")
        f32 = run(ref, "plain") if ref is not None else None
    torch.cuda.synchronize()
    b, d, k, h, w = again.shape
    valid = dets.valid[..., None].expand(b, d, k)
    top = float(plain[dets.valid].abs().max())
    err = float((again - plain)[dets.valid].abs().max())
    if ref is None:
        bound = KP_LOGIT_REL * top
    else:
        gap = float((plain - f32)[dets.valid].abs().max())
        bound = max(2 * gap, bf16_ulp(top))
    flat_a = again.reshape(b, d, k, h * w)
    flat_p = plain.reshape(b, d, k, h * w)
    cell_a = flat_a.argmax(-1)
    moved = (cell_a != flat_p.argmax(-1)) & valid
    at = torch.gather(flat_p, 3, cell_a[..., None])[..., 0]
    gaps = (flat_p.amax(-1) - at)[moved]
    kps_a = heatmaps_to_keypoints(
        again.reshape(b * d, k, h, w), dets.boxes.reshape(b * d, 4)
    ).reshape(b, d, k, 3)
    rerun_diff = (kps_a - kps).abs()
    out = dict(detections=int(dets.valid.sum()), keypoints=int(valid.sum()),
               max_abs_err=err, max_abs_logit=top, bound=bound,
               moved_keypoints=int(moved.sum()),
               max_moved_shortfall=float(gaps.max()) if gaps.numel()
               else 0.0,
               rerun_bit_identical=bool(torch.equal(kps_a, kps)),
               rerun_max_abs_diff=float(rerun_diff.max()))
    if ref is not None:
        out["bf16_vs_f32"] = gap
    if not err <= bound or out["max_moved_shortfall"] > 2 * bound \
            or not out["rerun_bit_identical"]:
        raise AssertionError(f"keypoint head, kernels against plain on the "
                             f"same detections: {out}")
    return out


def keypoint_stages(model, batch, fn) -> dict:
    """``stage_times`` of a keypoint request: backbone, RPN head, proposal
    selection, the box head's pooler and MLP, its predictor, the box
    post-processing, the keypoint head's pooler and eight convs, its
    predictor, and the decode."""
    box, kp = model.roi_heads["box"], model.keypoint_head
    marks = [("backbone", model.backbone), ("rpn_head", model.rpn["head"]),
             ("box_extractor", box["feature_extractor"]),
             ("box_predictor", box["predictor"]),
             ("kp_extractor", kp.feature_extractor),
             ("kp_predictor", kp.predictor)]
    spans = {"normalize": ("start", "backbone.in"),
             "backbone": ("backbone.in", "backbone.out"),
             "rpn_head": ("rpn_head.in", "rpn_head.out"),
             "proposals_with_nms": ("rpn_head.out", "box_extractor.in"),
             "box_pool_and_mlp": ("box_extractor.in", "box_extractor.out"),
             "box_predictor": ("box_predictor.in", "box_predictor.out"),
             "postprocess_with_nms": ("box_predictor.out", "kp_extractor.in"),
             "keypoint_pool_and_convs": ("kp_extractor.in",
                                         "kp_extractor.out"),
             "keypoint_predictor": ("kp_predictor.in", "kp_predictor.out"),
             "decode": ("kp_predictor.out", "end")}
    return stage_times(model, batch, marks, spans, forward=fn)


def phase_keypoint(dev, dtype: str = "float32"):
    """Keypoint R-CNN (R-50-FPN, KEYPOINT_ON) at 800x1344 in ``dtype``.
    Eval: REQUESTS batch-1 requests with keypoints and exact launch counts,
    kernel run against plain run (detections by ``match_detections``; the
    keypoint head on the kernel run's detections, ``keypoint_agreement``),
    the path's kernel sites timed, the request's latency and stages, a
    profile with its convolution census, peak memory. Train: the
    source-only step on 2 images with GT keypoints through
    ``source_train_entry``: kernel-run against plain-run step 1 (losses,
    ``loss_kp`` included, and every gradient: ``compare_steps``, in
    float32 with the box head's ReLU flips left out), KP_TRAIN_STEPS timed
    steps with exact launch counts, a profile, peak memory, one step's
    kernel inputs checked and timed. Returns (eval sites, eval launches,
    train sites, train launches, largest errors)."""
    from da_detect_tpu_torch import entry

    name, bf16 = label("keypoint", dtype), dtype == "bfloat16"
    cfg, fn, model, batches = keypoint_model(dev, dtype)
    answers, launches, seconds = serve_requests(fn, model, batches,
                                                PER_KP_FORWARD, name)
    summary = [dict(check_detections(cfg, dets),
                    **check_keypoints(cfg, dets, kps))
               for dets, kps in answers]
    with record_kernel_inputs() as captured:
        dets_k, kps_k = fn(model, batches[0])
    ref = f32_copy(model, cfg) if bf16 else None
    agreement = match_detections(
        dets_k, model(batches[0], impl="plain"),
        ref(batches[0], impl="plain") if bf16 else None)
    kp_agreement = keypoint_agreement(model, batches[0], dets_k, kps_k, ref)
    del ref
    errs = check_captured(captured)
    eval_sites = time_sites(captured, label("keypoint_eval", dtype),
                            MASK_NMS_SITES if not bf16 else ())
    forward_ms = host_ms(lambda: fn(model, batches[0]), runs=10)
    stages = keypoint_stages(model, batches[0], fn)
    profile = device_profile(lambda: fn(model, batches[0]), KP_PROFILE_RUNS)
    census = conv_census(profile, bf16, name)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fn(model, batches[0])
    torch.cuda.synchronize()
    emit(name, config=os.path.relpath(entry.KEYPOINT_YAML, REPO),
         dtype=dtype, canvas=list(cfg.TPU.IMAGE_SHAPE), requests=REQUESTS,
         seconds=seconds, launches=launches, detections=summary,
         plain_agreement=agreement, keypoint_agreement=kp_agreement,
         forward_ms=forward_ms, stages_ms=stages, profile=profile,
         conv_kernels_by_dtype=census,
         max_memory_allocated=torch.cuda.max_memory_allocated(),
         sites=eval_sites,
         main_path_inputs={"roi_align_fwd": fwd_inputs(captured)},
         max_abs_err=errs)
    del model, fn, batches, captured, answers

    t_name = label("keypoint_train", dtype)
    cfg = entry.keypoint_cfg(dtype=dtype)
    cfg.freeze()
    step, (state, args) = entry.source_train_entry(device=str(dev), seed=0,
                                                   cfg=cfg)
    if args[0].images.shape[0] != KP_TRAIN_IMAGES \
            or args[1].keypoints is None:
        raise AssertionError(f"{t_name}: {args[0].images.shape[0]} images, "
                             f"keypoints {args[1].keypoints is not None}")
    if bf16:
        t_agreement = compare_steps(
            train_step_one(state, args, "cuda"),
            train_step_one(state, args, "plain"),
            f32_step_one(state, cfg, args))
    else:
        with relu_inputs(state.model) as pre_k:
            kernel = train_step_one(state, args, "cuda")
        with relu_inputs(state.model) as pre_p:
            plain = train_step_one(state, args, "plain")
        t_agreement = compare_steps(kernel, plain,
                                    flips=relu_flips(pre_k, pre_p))
        del kernel, plain, pre_k, pre_p
    state, record, t_captured = measure_train_path(
        step, state, args, t_name, bf16, KP_TRAIN_STEPS,
        PER_KP_TRAIN_STEP, KP_PROFILE_STEPS)
    del step, state
    merge_errs(errs, check_captured(t_captured))
    train_sites = time_sites(t_captured, t_name,
                             MASK_NMS_SITES[:5] if not bf16 else ())
    if not all(m["loss_kp"] > 0 for m in record["losses"]):
        raise AssertionError(f"{t_name}: loss_kp {record['losses']}")
    emit(t_name, config=os.path.relpath(entry.KEYPOINT_YAML, REPO),
         dtype=dtype, canvas=list(cfg.TPU.IMAGE_SHAPE),
         images=KP_TRAIN_IMAGES, plain_agreement=t_agreement,
         sites=train_sites, main_path_inputs=train_inputs(t_captured),
         max_abs_err=errs, **record)
    return eval_sites, launches, train_sites, record["launches"], errs


def keypoint_tree(root: str, n: int, hw, seed: int) -> tuple[str, str]:
    """A COCO person-keypoint tree: ``n`` PNGs (the port's writer) of
    ``hw`` with 2 to 5 people each as filled rectangles, and their
    annotations: the box, 17 keypoints inside it (visibility 0, 1 or 2,
    invisible ones all zeros) and their count. Returns (image dir,
    annotation file)."""
    from da_detect_tpu_torch.data.image_io import write_png

    rng = np.random.RandomState(seed)
    h, w = hw
    img_dir = os.path.join(root, "images")
    os.makedirs(img_dir, exist_ok=True)
    images, anns = [], []
    for i in range(n):
        img = rng.randint(0, 60, (h, w, 3), dtype=np.uint8)
        for _ in range(int(rng.randint(2, 6))):
            bw, bh = int(rng.randint(40, 160)), int(rng.randint(80, 300))
            x1 = int(rng.randint(0, w - bw - 1))
            y1 = int(rng.randint(0, h - bh - 1))
            img[y1:y1 + bh, x1:x1 + bw] = (40, 220, 40)
            kps = np.zeros((17, 3))
            kps[:, 0] = x1 + rng.uniform(0, bw, 17)
            kps[:, 1] = y1 + rng.uniform(0, bh, 17)
            kps[:, 2] = rng.randint(0, 3, 17)
            kps[kps[:, 2] == 0] = 0.0
            anns.append({"id": len(anns) + 1, "image_id": i + 1,
                         "category_id": 1, "bbox": [x1, y1, bw, bh],
                         "area": bw * bh, "iscrowd": 0,
                         "keypoints": [round(float(v), 2)
                                       for v in kps.ravel()],
                         "num_keypoints": int((kps[:, 2] > 0).sum())})
        name = f"person_{i:04d}.png"
        write_png(os.path.join(img_dir, name), img)
        images.append({"id": i + 1, "file_name": name, "height": h,
                       "width": w})
    ann = os.path.join(root, "person_keypoints.json")
    with open(ann, "w") as f:
        json.dump({"images": images, "annotations": anns,
                   "categories": [{"id": 1, "name": "person"}]}, f)
    return img_dir, ann


def phase_keypoint_cli(dev) -> dict:
    """The keypoint path from files, bfloat16: a person-keypoint tree
    (``keypoint_tree``) named through a user catalog, ``train_net`` on the
    keypoint YAML (source-only, its loader carrying the GT keypoints) for
    KP_CLI_STEPS steps of 2 images with exact launch counts, then
    ``test_net`` reporting bbox and keypoints (OKS) AP (random weights: 0,
    printed only), a request an image with exact launch counts. Returns the
    training run's launches."""
    from da_detect_tpu_torch import entry
    from da_detect_tpu_torch.tools import test_net, train_net

    name = "keypoint_cli_bf16"
    with tempfile.TemporaryDirectory(prefix="chip_smoke_kp_") as root:
        data = keypoint_tree(root, KP_CLI_IMAGES, KP_CLI_HW, seed=4)
        names = {"kp_train": data, "kp_val": data}
        catalog = os.path.join(root, "kp_catalog.py")
        with open(catalog, "w") as f:
            f.write(USER_CATALOG.format(names=names))
        opts = {"MODEL.WEIGHT": "", "TPU.COMPUTE_DTYPE": "bfloat16",
                "PATHS_CATALOG": catalog,
                "DATASETS.TRAIN": "('kp_train',)",
                "DATASETS.TEST": "('kp_val',)",
                "SOLVER.IMS_PER_BATCH": str(KP_TRAIN_IMAGES),
                "SOLVER.BASE_LR": str(MASK_CLI_LR),
                "SOLVER.MAX_ITER": str(KP_CLI_STEPS),
                "SOLVER.CHECKPOINT_PERIOD": str(KP_CLI_STEPS),
                "TEST.IMS_PER_BATCH": "1",
                "DATALOADER.STAGE_CACHE": "False",
                "MODEL.OUTPUT_DIR": os.path.join(root, "out"),
                "MODEL.OUTPUT_SAVE_NAME": "run"}
        opts = [x for kv in opts.items() for x in kv]
        argv = ["--config-file", entry.KEYPOINT_YAML, "--seed", "0"]
        clear_counts()
        t0 = time.perf_counter()
        state, meters = train_net.main(argv + ["--skip-test",
                                               "--log-period", "1"] + opts)
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        launches = read_counts(PER_KP_TRAIN_STEP, KP_CLI_STEPS, name, "steps")
        loss_kp = [float(v) for v in meters.meters["loss_kp"].deque]
        totals = [float(v) for v in meters.meters["loss_total"].deque]
        if state.step != KP_CLI_STEPS or len(loss_kp) != KP_CLI_STEPS \
                or not all(np.isfinite(loss_kp + totals)) \
                or min(loss_kp) <= 0:
            raise AssertionError(f"{name}: {state.step} steps, loss_kp "
                                 f"{loss_kp}, loss_total {totals}")
        del state, meters
        run_dir = os.path.join(root, "out", "run")
        clear_counts()
        t0 = time.perf_counter()
        res = test_net.main(argv + ["--ckpt", run_dir] + opts)["kp_val"]
        torch.cuda.synchronize()
        eval_s = time.perf_counter() - t0
        read_counts(PER_KP_FORWARD, KP_CLI_IMAGES, name, "requests")
        if set(res) != {"bbox", "keypoints"} \
                or "AR20" not in res["keypoints"] or not os.path.exists(
                    os.path.join(run_dir, "coco_results.json")):
            raise AssertionError(f"{name}: results {set(res)}")
        results = {t: {k: v for k, v in res[t].items()
                       if k != "per_category"} for t in res}
    emit(name, config=os.path.relpath(entry.KEYPOINT_YAML, REPO),
         images=KP_CLI_IMAGES, image_hw=list(KP_CLI_HW), steps=KP_CLI_STEPS,
         base_lr=MASK_CLI_LR, train_s=train_s, launches=launches,
         loss_kp=loss_kp, loss_total=totals, eval_s=eval_s, results=results)
    return launches


def phase_demo(dev) -> dict:
    """The demo (``demo/predictor.py::COCODemo``) on the keypoint YAML,
    bfloat16, random weights from seed 0 with the score layers spread, on a
    seeded DEMO_HW BGR image: ``run_on_opencv_image`` returns an image of
    the input's shape with a request's launches; the latency of
    ``compute_prediction``; the kernel run's detections and keypoints
    against the plain run's (``match_detections``, ``keypoint_agreement``,
    relative to an f32 copy); then ``draw_detection.main`` over a folder
    of DEMO_FOLDER_IMAGES PNGs writes as many files, a request an image.
    Returns the overlay run's launches."""
    from da_detect_tpu_torch import entry
    from da_detect_tpu_torch.config import get_cfg
    from da_detect_tpu_torch.data.image_io import write_png
    from da_detect_tpu_torch.demo import COCODemo, draw_detection

    name = "demo_bf16"
    cfg = get_cfg()
    cfg.merge_from_file(entry.KEYPOINT_YAML)
    cfg.merge_from_list(["MODEL.WEIGHT", ""])
    cfg.freeze()
    demo = COCODemo(cfg, confidence_threshold=0.5, device=dev)
    spread_scores(demo.model)
    img = np.random.RandomState(5).randint(0, 256, DEMO_HW + (3,),
                                           dtype=np.uint8)
    clear_counts()
    out = demo.run_on_opencv_image(img)
    torch.cuda.synchronize()
    launches = read_counts(PER_KP_FORWARD, 1, name, "requests")
    if out.shape != img.shape or out.dtype != np.uint8:
        raise AssertionError(f"{name}: overlay {out.shape} {out.dtype}")
    boxes, scores, labels, kps = demo.compute_prediction(img)
    if kps.shape != (len(boxes), 17, 3) or not np.isfinite(kps).all():
        raise AssertionError(f"{name}: keypoints {kps.shape}")
    latency_ms = host_ms(lambda: demo.compute_prediction(img), runs=10)
    batch = demo.prepare(img)
    with torch.no_grad():
        dets_k, kps_k = demo.model(batch, with_keypoints=True)
        ref = f32_copy(demo.model, demo.cfg)
        agreement = match_detections(dets_k, demo.model(batch, impl="plain"),
                                     ref(batch, impl="plain"))
    kp_agreement = keypoint_agreement(demo.model, batch, dets_k, kps_k, ref)
    del ref, demo
    with tempfile.TemporaryDirectory(prefix="chip_smoke_demo_") as root:
        src, dst = os.path.join(root, "in"), os.path.join(root, "out")
        os.makedirs(src)
        rng = np.random.RandomState(6)
        for i in range(DEMO_FOLDER_IMAGES):
            write_png(os.path.join(src, f"frame_{i}.png"),
                      rng.randint(0, 256, DEMO_HW + (3,), dtype=np.uint8))
        clear_counts()
        t0 = time.perf_counter()
        drawn = draw_detection.main(
            ["--config-file", entry.KEYPOINT_YAML, "--input-dir", src,
             "--output-dir", dst, "--confidence-threshold", "0.0",
             "MODEL.WEIGHT", ""])
        torch.cuda.synchronize()
        folder_s = time.perf_counter() - t0
        read_counts(PER_KP_FORWARD, DEMO_FOLDER_IMAGES, f"{name} folder",
                    "requests")
        written = sorted(os.listdir(dst))
        if len(drawn) != DEMO_FOLDER_IMAGES \
                or len(written) != DEMO_FOLDER_IMAGES:
            raise AssertionError(f"{name}: drew {drawn}, wrote {written}")
    emit(name, config=os.path.relpath(entry.KEYPOINT_YAML, REPO),
         image_hw=list(DEMO_HW), canvas=list(batch.images.shape[2:]),
         launches=launches, detections=len(boxes),
         compute_prediction_ms=latency_ms, plain_agreement=agreement,
         keypoint_agreement=kp_agreement, folder_images=len(written),
         folder_s=folder_s)
    return launches


# ---------------------------------------------------------------- FBNet

def fbnet_model(dev, dtype: str, yaml: str):
    """An FBNet YAML at its own canvas in ``dtype`` through
    ``entry(cfg=fbnet_cfg(yaml))`` (with masks for a ``MASK_ON`` YAML),
    random weights from seed 0, score layers spread; and REQUESTS
    batches."""
    from da_detect_tpu_torch import entry

    cfg = entry.fbnet_cfg(yaml, dtype)
    cfg.freeze()
    fn, (model, _) = entry.entry(device=str(dev), seed=0, cfg=cfg,
                                 with_masks=cfg.MODEL.MASK_ON)
    spread_scores(model)
    batches = [entry.make_batch(cfg, 1, seed=s, device=dev)[0]
               for s in range(REQUESTS)]
    return cfg, fn, model, batches


def pooled_maps(captured, channels: int) -> list:
    """The captured ROIAlign maps' dtypes and channels; raises unless every
    map is float32 (FBNet's BatchNorm output, in either compute dtype) with
    ``channels`` channels."""
    seen = sorted({(str(m.dtype)[6:], m.shape[1])
                   for maps, _, _, _ in captured["roi_align_fwd"]
                   for m in maps})
    if seen != [("float32", channels)]:
        raise AssertionError(f"FBNet pooler maps {seen}, expected float32 "
                             f"with {channels} channels")
    return [list(s) for s in seen]


def phase_fbnet(dev, dtype: str = "float32") -> tuple[dict, dict]:
    """The FBNet models in ``dtype`` (their poolers run the float32
    ROIAlign kernels in both: FBNet's BatchNorm outputs float32). Eval:
    the xirb16d_dsmask Mask R-CNN at 320x640, REQUESTS requests with masks
    and exact launch counts, kernel run against plain run (detections and,
    on the kernel run's detections, mask probabilities), its sites timed.
    Train: its source-only step on the per-card batch (16 images, 512 ROIs
    each) through ``source_train_entry``: kernel-run against plain-run
    step 1 (``compare_steps``), FBNET_TRAIN_STEPS timed steps with exact
    launches, a profile, peak memory, one step's kernel inputs checked and
    timed. Then the chamv1a Faster R-CNN at 600x1000 (an 88-channel map,
    not a multiple of the kernels' 32-channel slice): REQUESTS requests,
    kernel run against plain run, its sites timed. Returns ({path: (sites,
    launches)}, the largest error a kernel)."""
    from da_detect_tpu_torch import entry

    name, bf16 = label("fbnet", dtype), dtype == "bfloat16"
    cfg, fn, model, batches = fbnet_model(dev, dtype, entry.FBNET_MASK_YAML)
    answers, launches, seconds = serve_requests(fn, model, batches,
                                                PER_FBNET_FORWARD, name)
    side = cfg.MODEL.ROI_MASK_HEAD.RESOLUTION
    summary = []
    for dets, probs in answers:
        row = check_detections(cfg, dets)
        if tuple(probs.shape) != (1, dets.boxes.shape[1], side, side) \
                or probs.dtype != torch.float32 \
                or not bool(((probs >= 0) & (probs <= 1)).all()):
            raise AssertionError(f"{name}: mask probabilities "
                                 f"{tuple(probs.shape)} {probs.dtype}")
        summary.append(dict(row, mask_shape=list(probs.shape)))
    with record_kernel_inputs() as captured:
        dets_k, probs_k = fn(model, batches[0])
    maps = pooled_maps(captured, FBNET_CHANNELS)
    ref = f32_copy(model, cfg) if bf16 else None
    agreement = match_detections(
        dets_k, model(batches[0], impl="plain"),
        ref(batches[0], impl="plain") if bf16 else None)
    masks = mask_agreement(model, batches[0], dets_k, probs_k, ref)
    del ref
    errs = check_captured(captured)
    eval_sites = time_sites(captured, label("fbnet_eval", dtype),
                            FBNET_NMS_SITES if not bf16 else ())
    forward_ms = host_ms(lambda: fn(model, batches[0]), runs=10)
    emit(name, config=os.path.relpath(entry.FBNET_MASK_YAML, REPO),
         dtype=dtype, canvas=list(cfg.TPU.IMAGE_SHAPE), requests=REQUESTS,
         seconds=seconds, launches=launches, detections=summary,
         plain_agreement=agreement, mask_agreement=masks,
         forward_ms=forward_ms, sites=eval_sites, pooled_maps=maps,
         main_path_inputs={"roi_align_fwd": fwd_inputs(captured)},
         max_abs_err=errs)
    del model, fn, batches, captured, answers

    t_name = label("fbnet_train", dtype)
    cfg = entry.fbnet_cfg(entry.FBNET_MASK_YAML, dtype)
    cfg.freeze()
    step, (state, args) = entry.source_train_entry(device=str(dev), seed=0,
                                                   cfg=cfg)
    if args[0].images.shape[0] != FBNET_TRAIN_IMAGES:
        raise AssertionError(f"{t_name}: {args[0].images.shape[0]} images")
    t_agreement = compare_steps(
        train_step_one(state, args, "cuda"),
        train_step_one(state, args, "plain"),
        f32_step_one(state, cfg, args) if bf16 else None)
    state, record, t_captured = measure_train_path(
        step, state, args, t_name, bf16, FBNET_TRAIN_STEPS,
        PER_FBNET_TRAIN_STEP, FBNET_PROFILE_STEPS)
    del step, state
    pooled_maps(t_captured, FBNET_CHANNELS)
    merge_errs(errs, check_captured(t_captured))
    train_sites = time_sites(t_captured, t_name,
                             FBNET_NMS_SITES[:1] if not bf16 else ())
    if not all(m["loss_mask"] > 0 for m in record["losses"]):
        raise AssertionError(f"{t_name}: loss_mask {record['losses']}")
    emit(t_name, config=os.path.relpath(entry.FBNET_MASK_YAML, REPO),
         dtype=dtype, canvas=list(cfg.TPU.IMAGE_SHAPE),
         images=FBNET_TRAIN_IMAGES, plain_agreement=t_agreement,
         sites=train_sites, main_path_inputs=train_inputs(t_captured),
         max_abs_err=errs, **record)
    del t_captured

    c_name = label("fbnet_cham", dtype)
    cfg, fn, model, batches = fbnet_model(dev, dtype, entry.FBNET_CHAM_YAML)
    answers, c_launches, seconds = serve_requests(
        fn, model, batches, PER_FBNET_FASTER_FORWARD, c_name)
    c_summary = [check_detections(cfg, dets) for dets in answers]
    with record_kernel_inputs() as c_captured:
        dets_k = fn(model, batches[0])
    c_maps = pooled_maps(c_captured, CHAM_CHANNELS)
    c_agreement = match_detections(
        dets_k, model(batches[0], impl="plain"),
        f32_copy(model, cfg)(batches[0], impl="plain") if bf16 else None)
    merge_errs(errs, check_captured(c_captured))
    cham_sites = time_sites(c_captured, c_name,
                            FBNET_NMS_SITES if not bf16 else ())
    emit(c_name, config=os.path.relpath(entry.FBNET_CHAM_YAML, REPO),
         dtype=dtype, canvas=list(cfg.TPU.IMAGE_SHAPE), requests=REQUESTS,
         seconds=seconds, launches=c_launches, detections=c_summary,
         plain_agreement=c_agreement, pooled_maps=c_maps,
         forward_ms=host_ms(lambda: fn(model, batches[0]), runs=10),
         sites=cham_sites,
         main_path_inputs={"roi_align_fwd": fwd_inputs(c_captured)},
         max_abs_err=errs)
    return {label("fbnet_eval", dtype): (eval_sites, launches),
            t_name: (train_sites, record["launches"]),
            c_name: (cham_sites, c_launches)}, errs


# ---------------------------------------------------------------- RetinaNet

def retina_model(dev, dtype: str):
    """The RetinaNet R-50-FPN YAML at 800x1344 in ``dtype`` through
    ``entry(cfg=retinanet_cfg())``, random weights from seed 0, its class
    logits spread: the prior bias zeroed and the weights times SCORE_SCALE
    (at the prior, 0.01, every random-weight score stays under
    INFERENCE_TH 0.05 and nothing reaches the NMS); and REQUESTS
    batches."""
    from da_detect_tpu_torch import entry

    cfg = entry.retinanet_cfg(dtype)
    cfg.freeze()
    fn, (model, _) = entry.entry(device=str(dev), seed=0, cfg=cfg)
    with torch.no_grad():
        head = model.rpn["head"]
        head.cls_logits.bias.zero_()
        head.cls_logits.weight.mul_(SCORE_SCALE)
    batches = [entry.make_batch(cfg, 1, seed=s, device=dev)[0]
               for s in range(REQUESTS)]
    return cfg, fn, model, batches


def retina_selection(model, batch) -> dict:
    """The time of the per-level candidate selection (sigmoid, threshold,
    the exact top 1000 with ties to the lower index, decode) of one
    request: P3-P7 and P3 alone, CUDA events; and the candidates it
    keeps."""
    from da_detect_tpu_torch.models.retinanet import retinanet_candidates

    with torch.no_grad():
        logits, regs, anchors = model._forward(batch, "cuda")
    sizes = batch.sizes.float()
    kw = {k: model.infer_cfg[k] for k in ("pre_nms_thresh", "pre_nms_top_n")}
    cand = retinanet_candidates(anchors, logits, regs, sizes, **kw)
    return dict(
        ms=time_ms(lambda: retinanet_candidates(anchors, logits, regs, sizes,
                                                **kw), runs=10),
        p3_ms=time_ms(lambda: retinanet_candidates(
            anchors[:1], logits[:1], regs[:1], sizes, **kw), runs=10),
        p3_scores=int(logits[0].numel()), candidates=list(cand[0].shape[:2]),
        valid_candidates=int(cand[3].sum()))


def phase_retinanet(dev, dtype: str = "float32") -> tuple[dict, dict]:
    """RetinaNet R-50-FPN at 800x1344 in ``dtype``. Eval: REQUESTS
    requests with exact launch counts (one class-offset NMS a request),
    kernel run against plain run, the NMS site timed beside the candidate
    selection. Train: the source-only step on the per-card batch (2
    images): kernel-run against plain-run step 1, RETINA_TRAIN_STEPS timed
    steps with every kernel's launches asserted 0, a profile, peak memory.
    Returns ({path: (sites, launches)}, the largest error a kernel)."""
    from da_detect_tpu_torch import entry

    name, bf16 = label("retinanet", dtype), dtype == "bfloat16"
    cfg, fn, model, batches = retina_model(dev, dtype)
    answers, launches, seconds = serve_requests(fn, model, batches,
                                                PER_RETINA_FORWARD, name)
    summary = [check_detections(cfg, dets, cfg.TEST.DETECTIONS_PER_IMG)
               for dets in answers]
    with record_kernel_inputs() as captured:
        dets_k = fn(model, batches[0])
    agreement = match_detections(
        dets_k, model(batches[0], impl="plain"),
        f32_copy(model, cfg)(batches[0], impl="plain") if bf16 else None)
    errs = check_captured(captured)
    eval_sites = time_sites(captured, label("retina_eval", dtype),
                            RETINA_NMS_SITES if not bf16 else ())
    selection = retina_selection(model, batches[0])
    forward_ms = host_ms(lambda: fn(model, batches[0]), runs=10)
    emit(name, config=os.path.relpath(entry.RETINANET_YAML, REPO),
         dtype=dtype, canvas=list(cfg.TPU.IMAGE_SHAPE), requests=REQUESTS,
         seconds=seconds, launches=launches, detections=summary,
         plain_agreement=agreement, forward_ms=forward_ms,
         candidate_selection=selection, sites=eval_sites,
         main_path_inputs={"nms": [
             dict(shape=list(b.shape), iou=t, valid=int(v.sum()),
                  max_keep=k, max_coordinate=float(b.abs().max()))
             for b, v, t, k in captured["nms"]]},
         max_abs_err=errs)
    del model, fn, batches, captured, answers

    t_name = label("retina_train", dtype)
    step, (state, args) = entry.source_train_entry(device=str(dev), seed=0,
                                                   cfg=cfg)
    t_agreement = compare_steps(
        train_step_one(state, args, "cuda"),
        train_step_one(state, args, "plain"),
        f32_step_one(state, cfg, args) if bf16 else None)
    state, record, t_captured = measure_train_path(
        step, state, args, t_name, bf16, RETINA_TRAIN_STEPS,
        PER_RETINA_TRAIN_STEP, RETINA_PROFILE_STEPS)
    del step, state
    if any(t_captured.values()):
        raise AssertionError(f"{t_name}: a kernel ran in the train step")
    emit(t_name, config=os.path.relpath(entry.RETINANET_YAML, REPO),
         dtype=dtype, canvas=list(cfg.TPU.IMAGE_SHAPE),
         images=args[0].images.shape[0], plain_agreement=t_agreement,
         **record)
    return {label("retina_eval", dtype): (eval_sites, launches),
            t_name: ([], record["launches"])}, errs


def phase_retina_fbnet_cli(dev) -> tuple[dict, dict]:
    """The FBNet mask and RetinaNet YAMLs from files, bfloat16: a gtFine
    tree (MASK_CLI_IMAGES images at Cityscapes geometry) through
    ``convert_cityscapes_to_coco``, named through a user catalog; on each
    YAML ``train_net.main`` for MASK_CLI_STEPS steps of CLI_IMAGES images
    with exact launches a step, then ``test_net.main`` reporting bbox AP
    (and segm for the mask YAML; random weights: printed only) with exact
    launches a request. Returns the FBNet runs' launches and the RetinaNet
    runs' (train and eval summed, each)."""
    from da_detect_tpu_torch import entry
    from da_detect_tpu_torch.tools import (convert_cityscapes_to_coco,
                                           test_net, train_net)

    name = "retina_fbnet_cli_bf16"
    runs, totals = {}, {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_rf_") as root:
        clean, gt = cityscapes_tree(root, MASK_CLI_IMAGES, DATA_HW, seed=4)
        ann_dir = os.path.join(root, "annotations")
        convert_cityscapes_to_coco.main(
            ["--gt-dir", gt, "--out-dir", ann_dir, "--splits", "train"])
        ann = os.path.join(ann_dir, "instancesonly_filtered_gtFine_train.json")
        catalog = os.path.join(root, "rf_catalog.py")
        with open(catalog, "w") as f:
            f.write(USER_CATALOG.format(names={"rf_train": (clean, ann),
                                               "rf_val": (clean, ann)}))
        for key, yaml, per_step, per_request, types in (
                ("fbnet", entry.FBNET_MASK_YAML, PER_FBNET_TRAIN_STEP,
                 PER_FBNET_FORWARD, {"bbox", "segm"}),
                ("retinanet", entry.RETINANET_YAML, PER_RETINA_TRAIN_STEP,
                 PER_RETINA_FORWARD, {"bbox"})):
            opts = {"MODEL.WEIGHT": "", "TPU.COMPUTE_DTYPE": "bfloat16",
                    "TPU.APPROX_TOPK": "False", "PATHS_CATALOG": catalog,
                    "DATASETS.TRAIN": "('rf_train',)",
                    "DATASETS.TEST": "('rf_val',)",
                    "SOLVER.IMS_PER_BATCH": str(CLI_IMAGES),
                    "SOLVER.BASE_LR": str(MASK_CLI_LR),
                    "SOLVER.MAX_ITER": str(MASK_CLI_STEPS),
                    "SOLVER.CHECKPOINT_PERIOD": str(MASK_CLI_STEPS),
                    "TEST.IMS_PER_BATCH": "1",
                    "DATALOADER.STAGE_CACHE": "False",
                    "MODEL.OUTPUT_DIR": os.path.join(root, f"out_{key}"),
                    "MODEL.OUTPUT_SAVE_NAME": "run"}
            opts = [x for kv in opts.items() for x in kv]
            argv = ["--config-file", yaml, "--seed", "0"]
            clear_counts()
            t0 = time.perf_counter()
            state, meters = train_net.main(argv + ["--skip-test",
                                                   "--log-period", "1"]
                                           + opts)
            torch.cuda.synchronize()
            train_s = time.perf_counter() - t0
            train = read_counts(per_step, MASK_CLI_STEPS, f"{name} {key}",
                                "steps")
            loss = [float(v) for v in meters.meters["loss_total"].deque]
            if state.step != MASK_CLI_STEPS or len(loss) != MASK_CLI_STEPS \
                    or not all(np.isfinite(loss)):
                raise AssertionError(f"{name} {key}: {state.step} steps, "
                                     f"loss_total {loss}")
            del state, meters
            run_dir = os.path.join(root, f"out_{key}", "run")
            clear_counts()
            t0 = time.perf_counter()
            res = test_net.main(argv + ["--ckpt", run_dir] + opts)["rf_val"]
            torch.cuda.synchronize()
            eval_s = time.perf_counter() - t0
            served = read_counts(per_request, MASK_CLI_IMAGES,
                                 f"{name} {key} eval", "requests")
            if set(res) != types:
                raise AssertionError(f"{name} {key}: results {set(res)}")
            runs[key] = dict(
                config=os.path.relpath(yaml, REPO), train_s=train_s,
                eval_s=eval_s, loss_total=loss, train_launches=train,
                eval_launches=served,
                results={t: {k: res[t][k] for k in ("AP", "AP50", "AP75")}
                         for t in sorted(types)})
            totals[key] = {k: train[k] + served[k] for k in train}
    emit(name, images=MASK_CLI_IMAGES, image_hw=list(DATA_HW),
         steps=MASK_CLI_STEPS, images_a_step=CLI_IMAGES,
         base_lr=MASK_CLI_LR, runs=runs)
    return totals["fbnet"], totals["retinanet"]


DCN_YAML = os.path.join(
    REPO, "configs", "da_faster_rcnn",
    "e2e_triplet_da_faster_rcnn_X_101_32x8d_FPN_dcn_cityscapes_to_foggy_"
    "cityscapes.yaml")
# the smoke datasets: an aligned clean / foggy / rainy triple at Cityscapes
# geometry, 8 images a domain, 8 to 40 boxes an image in 2 classes
DATA_IMAGES, DATA_HW, DATA_BOXES = 8, (1024, 2048), (8, 41)
LOADER_BATCHES = 16       # two epochs of triples (IMS_PER_BATCH 2)
CLI_STEPS, CLI_PERIOD = 8, 4
TTA_IMAGES = 2
USER_CATALOG = '''"""The smoke run's datasets (PATHS_CATALOG)."""

NAMES = {names!r}


class DatasetCatalog:
    @staticmethod
    def get(name):
        img_dir, ann_file = NAMES[name]
        return {{"factory": "COCODataset",
                 "args": {{"root": img_dir, "ann_file": ann_file}}}}
'''
# the flagship train step's median (ms) from the train phases, by name
STEP_MEDIANS: dict = {}
# the warm loader-fed training run of phase 16: steps (all of them read
# canvases the stage CLI wrote); the --profile run of phase 15: its steps
# (the trace covers iterations 10-19, as the JAX package's profile_range)
STAGE_STEPS, PROFILE_RUN_STEPS = 8, 21

# the sanity gate (tools/sanity_check.py): the JAX package's own ablation
# gate, seeds, data and thresholds unchanged (tests/test_end_to_end.py)
SANITY_ABLATION = ["--ablation", "--iters", "200", "--min-gap", "0.2"]
# launches a sanity train step makes (no instance triplet: no re-pooling):
# NMS in each domain batch's RPN (one launch over the batch's images),
# ROIAlign forward in each box-head pass, its backward once a pass; float32
# ROIAlign (the GN body's C4 map is float32) in the bfloat16 model
PER_SANITY_STEP = {"source_only": {"nms": 1, "roi_align_fwd": 1,
                                   "roi_align_bwd": 1},
                   "da": {"nms": 2, "roi_align_fwd": 2, "roi_align_bwd": 2}}
# an eval batch of the sanity test set (TEST.IMS_PER_BATCH 2 images): NMS in
# the RPN and the box head, one ROIAlign
PER_SANITY_EVAL_BATCH = {"nms": 2, "roi_align_fwd": 1}


def paeth_png(path: str, img: np.ndarray) -> None:
    """Write uint8 BGR [H, W, 3] as an RGB PNG whose every row takes the
    Paeth filter (the reader's sequential, by-diagonal path)."""
    import struct
    import zlib

    from da_detect_tpu_torch.data.image_io import PNG_SIGNATURE

    h, w = img.shape[:2]
    x = img[:, :, ::-1].reshape(h, w * 3).astype(np.int16)
    a = np.zeros_like(x)
    a[:, 3:] = x[:, :-3]
    b = np.zeros_like(x)
    b[1:] = x[:-1]
    c = np.zeros_like(x)
    c[1:] = a[:-1]
    pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
    pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    rows = np.full((h, 1 + w * 3), 4, np.uint8)
    rows[:, 1:] = (x - pred) & 0xFF

    def chunk(kind: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    with open(path, "wb") as f:
        f.write(PNG_SIGNATURE
                + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(rows.tobytes(), 1))
                + chunk(b"IEND", b""))


def smoke_datasets(root: str) -> dict:
    """Write the triple with the port's PNG writer and a user catalog module
    naming it; returns the catalog's path, its names and the directories."""
    from da_detect_tpu_torch.data.synthetic import write_triplet_datasets

    t0 = time.perf_counter()
    dirs = write_triplet_datasets(
        os.path.join(root, "data"), n_images=DATA_IMAGES, h=DATA_HW[0],
        w=DATA_HW[1], boxes=DATA_BOXES, box_side=(24, 240), seed=0)
    with open(dirs["foggy"][1]) as f:
        ann = json.load(f)
    few = [im["id"] for im in ann["images"][:TTA_IMAGES]]
    ann["images"] = ann["images"][:TTA_IMAGES]
    ann["annotations"] = [a for a in ann["annotations"]
                          if a["image_id"] in few]
    few_ann = os.path.join(root, "data", "instances_few.json")
    with open(few_ann, "w") as f:
        json.dump(ann, f)
    names = {f"smoke_{d}_train": dirs[d] for d in dirs}
    names["smoke_foggy_val"] = dirs["foggy"]
    names["smoke_foggy_val_few"] = (dirs["foggy"][0], few_ann)
    catalog = os.path.join(root, "smoke_catalog.py")
    with open(catalog, "w") as f:
        f.write(USER_CATALOG.format(names=names))
    return dict(catalog=catalog, names=names, dirs=dirs, root=root,
                write_s=time.perf_counter() - t0)


def smoke_opts(data: dict, out_dir: str, **extra) -> list:
    """Config options that point a YAML at the smoke datasets, with random
    weights (no MODEL.WEIGHT), bfloat16, outputs under ``out_dir``."""
    opts = {"MODEL.WEIGHT": "", "TPU.COMPUTE_DTYPE": "bfloat16",
            "PATHS_CATALOG": data["catalog"],
            "DATASETS.SOURCE_TRAIN": "('smoke_clean_train',)",
            "DATASETS.TARGET_TRAIN": "('smoke_foggy_train',)",
            "DATASETS.TARGET_TRAIN_negative": "('smoke_rainy_train',)",
            "DATASETS.TEST": "('smoke_foggy_val',)",
            "DATALOADER.STAGE_DIR": os.path.join(data["root"], "stage"),
            "MODEL.OUTPUT_DIR": out_dir, "MODEL.OUTPUT_SAVE_NAME": "run"}
    opts.update(extra)
    return [str(x) for kv in opts.items() for x in kv]


def smoke_cfg(yaml: str, opts: list):
    """The config the CLIs build from ``yaml`` and ``opts``, with the user
    catalog loaded."""
    from da_detect_tpu_torch.config import get_cfg
    from da_detect_tpu_torch.config.catalog import load_user_catalog

    cfg = get_cfg()
    cfg.merge_from_file(yaml)
    cfg.merge_from_list(opts)
    load_user_catalog(cfg.PATHS_CATALOG)
    return cfg


def batches_equal(got, want) -> bool:
    """Two loader items (tuples of ImageBatch / Targets), tensor for
    tensor, on the CPU; an absent leaf (``Targets.masks`` None) on both
    sides."""
    def same(a, b):
        if a is None or b is None:
            return a is b
        return torch.equal(a.cpu(), b.cpu())

    return all(same(getattr(g, f), getattr(w, f))
               for g, w in zip(got, want) for f in vars(w))


def loader_rate(cfg, dev, batches: int) -> dict:
    """The triplet loader alone on the card: batches a second over
    ``batches`` after the first, and the host seconds a step by stage."""
    from da_detect_tpu_torch.data import make_data_loader_da

    loader = make_data_loader_da(cfg, device=dev, seed=0, packed=True,
                                 aligned=cfg.MODEL.DA_HEADS.ALIGNMENT)
    first = next(loader)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(batches - 1):
        next(loader)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    stats = loader.stats
    loader.close()
    made = stats["batches"]
    per_step = {k: v / made for k, v in stats.items()
                if k.endswith("_s")}
    return dict(first=first, batches_per_s=(batches - 1) / seconds,
                seconds=seconds, host_s_per_step=per_step,
                decoder=stats["decoder"], step_copy_bytes=stats["bytes"],
                batches_made=made, stage_hits=stats.get("stage_hits"),
                stage_misses=stats.get("stage_misses"),
                workers=cfg.DATALOADER.NUM_WORKERS)


def phase_data(dev, data: dict) -> dict:
    """The smoke datasets on disk, the PNG reader's speed on a filter-0 and
    a Paeth-filtered 1024x2048 image, and the flagship YAML's triplet loader
    alone (canvas 608x1216, one triple a step, uint8, packed) at the YAML's
    workers and at 4, and with the port's PNG reader where cv2 decodes; its
    first batch on the card equals the CPU loader's."""
    from da_detect_tpu_torch.data import image_io, make_data_loader_da
    from da_detect_tpu_torch.data.transforms import canvas_for

    cfg = smoke_cfg(FLAGSHIP_YAML, smoke_opts(
        data, os.path.join(data["root"], "out_data"),
        **{"DATALOADER.STAGE_CACHE": False}))
    clean = os.path.join(data["dirs"]["clean"][0], "img_0000.png")
    img = image_io.load_image_bgr(clean, "png")
    paeth = os.path.join(data["root"], "paeth.png")
    paeth_png(paeth, img)
    if not np.array_equal(image_io.load_image_bgr(paeth, "png"), img):
        raise AssertionError("the PNG reader misread a Paeth-filtered file")
    decode_ms = {}
    for name, path in (("filter0", clean), ("paeth", paeth)):
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            image_io.load_image_bgr(path, "png")
            times.append((time.perf_counter() - t0) * 1e3)
        decode_ms[name] = statistics.median(times)
    rates = {}
    for workers in (cfg.DATALOADER.NUM_WORKERS, 4):
        cfg.DATALOADER.NUM_WORKERS = workers
        rates[f"workers_{workers}"] = loader_rate(cfg, dev, LOADER_BATCHES)
    yaml_rate = next(iter(rates.values()))
    if image_io.DECODER != "png":  # the port's own reader in the loader
        decoder = image_io.DECODER
        image_io.DECODER = "png"
        try:
            rates["png_workers_4"] = loader_rate(cfg, dev, LOADER_BATCHES)
        finally:
            image_io.DECODER = decoder
    cpu = make_data_loader_da(cfg, device="cpu", seed=0,
                              aligned=cfg.MODEL.DA_HEADS.ALIGNMENT)
    if not batches_equal(yaml_rate["first"], next(cpu)):
        raise AssertionError("data: the packed card loader's first batch "
                             "differs from the CPU loader's")
    cpu.close()
    for r in rates.values():
        del r["first"]
    emit("data", images_per_domain=DATA_IMAGES, image_hw=list(DATA_HW),
         write_s=data["write_s"], decoder=yaml_rate["decoder"],
         png_decode_ms=decode_ms, canvas=list(canvas_for(cfg, True)),
         loader=rates)
    return rates


# the dataset tools' phase: a Cityscapes-like train split written at run
# time (Cityscapes geometry), TOOLS_IMAGES images in two cities
TOOLS_IMAGES, TOOLS_STEPS = 4, 2
# phase mask_cli_bf16: a gtFine tree of MASK_CLI_IMAGES at Cityscapes
# geometry, MASK_CLI_STEPS train_net steps of MASK_TRAIN_IMAGES images
MASK_CLI_IMAGES, MASK_CLI_STEPS = 4, 2
# its learning rate: random weights on 0-255 pixels give a mask loss near
# 100 at step 1, which the YAML's 0.01 turns into a diverged step 2 (the
# phase checks the wiring, not learning)
MASK_CLI_LR = 1e-4


def cityscapes_tree(root: str, n: int, hw, seed: int) -> tuple[str, str]:
    """``root/leftImg8bit/train/<city>/*_leftImg8bit.png`` (the port's PNG
    writer) and ``root/gtFine/train/<city>/*_gtFine_polygons.json``: cars
    and persons as filled rectangles and their polygons, plus a cargroup
    crowd, a 2-point car polygon and a road, which the converter keeps as a
    crowd, drops and drops. Returns (image root, gtFine root)."""
    from da_detect_tpu_torch.data.image_io import write_png

    rng = np.random.RandomState(seed)
    h, w = hw
    images, gt = (os.path.join(root, d) for d in ("leftImg8bit", "gtFine"))
    for i in range(n):
        city = ("aachen", "bochum")[i % 2]
        stem = f"{city}_{i:06d}_000019"
        for d in (images, gt):
            os.makedirs(os.path.join(d, "train", city), exist_ok=True)
        img = rng.randint(0, 60, (h, w, 3), dtype=np.uint8)
        objects = []
        for j in range(int(rng.randint(6, 16))):
            bw, bh = (int(v) for v in rng.randint(40, 240, 2))
            x1 = int(rng.randint(0, w - bw - 1))
            y1 = int(rng.randint(0, h - bh - 1))
            car = j % 2 == 0
            img[y1:y1 + bh, x1:x1 + bw] = (220, 40, 40) if car \
                else (40, 220, 40)
            objects.append({"label": "car" if car else "person",
                            "polygon": [[x1, y1], [x1 + bw, y1],
                                        [x1 + bw, y1 + bh], [x1, y1 + bh]]})
        objects += [
            {"label": "cargroup", "polygon": [[10, 10], [200, 12],
                                              [150, 90]]},
            {"label": "car", "polygon": [[5, 5], [9, 9]]},
            {"label": "road", "polygon": [[0, h - 1], [w - 1, h - 1],
                                          [w // 2, h // 2]]}]
        write_png(os.path.join(images, "train", city,
                               f"{stem}_leftImg8bit.png"), img)
        with open(os.path.join(gt, "train", city,
                               f"{stem}_gtFine_polygons.json"), "w") as f:
            json.dump({"imgHeight": h, "imgWidth": w, "objects": objects}, f)
    return os.path.join(images, "train"), gt


def phase_tools(dev) -> dict:
    """The dataset tools into the loader and DDP, bfloat16: a gtFine tree
    through ``convert_cityscapes_to_coco``, the clean PNG tree copied as the
    foggy domain and through ``generate_rainy_dataset`` as the rainy one;
    the flagship YAML's triplet loader reads the three domains (named in a
    user catalog) and feeds TOOLS_STEPS steps through DDP at world size 1
    (NCCL), with the train phase's launch counts."""
    import shutil

    from da_detect_tpu_torch.data import make_data_loader_da
    from da_detect_tpu_torch.data.image_io import load_image_bgr
    from da_detect_tpu_torch.engine.trainer import (create_train_state,
                                                    make_train_step)
    from da_detect_tpu_torch.parallel import wrap_train_forward
    from da_detect_tpu_torch.tools import (convert_cityscapes_to_coco,
                                           generate_rainy_dataset)
    from da_detect_tpu_torch.tools.train_core import build_model

    with tempfile.TemporaryDirectory(prefix="chip_smoke_tools_") as root:
        t0 = time.perf_counter()
        clean, gt = cityscapes_tree(root, TOOLS_IMAGES, DATA_HW, seed=1)
        ann_dir = os.path.join(root, "annotations")
        counts = convert_cityscapes_to_coco.main(
            ["--gt-dir", gt, "--out-dir", ann_dir, "--splits", "train"])
        ann = os.path.join(ann_dir, "instancesonly_filtered_gtFine_train.json")
        with open(ann) as f:
            coco = json.load(f)
        crowds = sum(a["iscrowd"] for a in coco["annotations"])
        if counts["train"][0] != TOOLS_IMAGES or crowds != TOOLS_IMAGES:
            raise AssertionError(f"tools: converted {counts}, {crowds} "
                                 "crowds")
        foggy = shutil.copytree(clean, os.path.join(root, "foggy"))
        rainy = os.path.join(root, "rainy")
        written = generate_rainy_dataset.main(
            ["--src", clean, "--dst", rainy, "--seed", "0"])
        for im in coco["images"]:
            a, b = (load_image_bgr(os.path.join(d, im["file_name"]), "png")
                    for d in (clean, rainy))
            if a.shape != b.shape or np.array_equal(a, b):
                raise AssertionError(f"tools: rainy {im['file_name']}")
        tools_s = time.perf_counter() - t0
        names = {"tools_clean_train": (clean, ann),
                 "tools_foggy_train": (foggy, ann),
                 "tools_rainy_train": (rainy, ann)}
        catalog = os.path.join(root, "tools_catalog.py")
        with open(catalog, "w") as f:
            f.write(USER_CATALOG.format(names=names))
        opts = {"MODEL.WEIGHT": "", "TPU.COMPUTE_DTYPE": "bfloat16",
                "PATHS_CATALOG": catalog,
                "DATASETS.SOURCE_TRAIN": "('tools_clean_train',)",
                "DATASETS.TARGET_TRAIN": "('tools_foggy_train',)",
                "DATASETS.TARGET_TRAIN_negative": "('tools_rainy_train',)",
                "DATALOADER.STAGE_CACHE": "False"}
        cfg = smoke_cfg(FLAGSHIP_YAML, [x for kv in opts.items()
                                        for x in kv])
        aligned = cfg.MODEL.DA_HEADS.ALIGNMENT
        loader = make_data_loader_da(cfg, device=dev, seed=0, packed=True,
                                     aligned=aligned)
        state = create_train_state(cfg, build_model(cfg, dev, 0), 0, "cosine")
        try:
            with nccl_world1(dev):
                step = make_train_step(
                    state.model, state.optimizer, aligned=aligned,
                    forward=wrap_train_forward(state.model, "da_triplet"))
                clear_counts()
                losses = []
                for _ in range(TOOLS_STEPS):
                    state, m = step(state, *next(loader))
                    losses.append({k: v.item() for k, v in m.items()})
                launches = read_counts(PER_TRAIN_STEP, TOOLS_STEPS,
                                       "tools_ddp_bf16", "steps")
        finally:
            loader.close()
    if not all(np.isfinite(x["loss_total"]) for x in losses):
        raise AssertionError(f"tools_ddp_bf16: losses {losses}")
    emit("tools_ddp_bf16", images=TOOLS_IMAGES, image_hw=list(DATA_HW),
         converted=dict(images=counts["train"][0],
                        annotations=counts["train"][1], crowds=crowds),
         rainy_written=written, tools_s=tools_s, steps=TOOLS_STEPS,
         launches=launches, losses=losses)
    return launches


def phase_cli_train(dev, data: dict) -> dict:
    """``train_net_triplet.main`` on the flagship YAML, bfloat16, random
    weights: 8 loader-fed steps with a checkpoint every 4, exact launch
    counts a step; then again from the step-4 checkpoint to 8; a profile of
    loader-fed steps (the device's busy share)."""
    from da_detect_tpu_torch.data import make_data_loader_da
    from da_detect_tpu_torch.engine.trainer import make_train_step
    from da_detect_tpu_torch.tools import train_net_triplet

    out = os.path.join(data["root"], "out_train")
    opts = smoke_opts(data, out, **{"SOLVER.MAX_ITER": CLI_STEPS,
                                    "SOLVER.CHECKPOINT_PERIOD": CLI_PERIOD})
    argv = ["--config-file", FLAGSHIP_YAML, "--skip-test", "--seed", "0",
            "--log-period", "1"] + opts
    clear_counts()
    t0 = time.perf_counter()
    state, meters = train_net_triplet.main(argv)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = read_counts(PER_TRAIN_STEP, CLI_STEPS, "cli_train_bf16",
                           "steps")
    run_dir = os.path.join(out, "run")
    for step in (CLI_PERIOD, CLI_STEPS):
        if not os.path.exists(os.path.join(run_dir, f"model_{step:07d}.pth")):
            raise AssertionError(f"cli_train_bf16: no checkpoint at {step}")
    step_ms = [t * 1e3 for t in meters.meters["time"].deque]
    data_ms = [t * 1e3 for t in meters.meters["data"].deque]
    losses = [float(v) for v in meters.meters["loss_total"].deque]
    if len(step_ms) != CLI_STEPS or state.step != CLI_STEPS \
            or not all(np.isfinite(losses)):
        raise AssertionError(f"cli_train_bf16: {state.step} steps, "
                             f"{len(step_ms)} timed, losses {losses}")

    # a run cut after its step-4 checkpoint, started again
    with open(os.path.join(run_dir, "last_checkpoint"), "w") as f:
        f.write(f"model_{CLI_PERIOD:07d}.pth")
    clear_counts()
    resumed, r_meters = train_net_triplet.main(argv)
    torch.cuda.synchronize()
    r_launches = read_counts(PER_TRAIN_STEP, CLI_STEPS - CLI_PERIOD,
                             "cli_train_bf16 resumed", "steps")
    with open(os.path.join(run_dir, "log_rank0.txt")) as f:
        started = f"start training at iteration {CLI_PERIOD}" in f.read()
    resumed_to = resumed.step
    if resumed_to != CLI_STEPS or not started \
            or r_meters.meters["time"].count != CLI_STEPS - CLI_PERIOD:
        raise AssertionError(f"cli_train_bf16: the resumed run reached "
                             f"{resumed_to}, started at {CLI_PERIOD}: "
                             f"{started}")

    # loader-fed steps under the profiler
    cfg = smoke_cfg(FLAGSHIP_YAML, opts)
    loader = make_data_loader_da(cfg, device=dev, seed=0, packed=True,
                                 aligned=cfg.MODEL.DA_HEADS.ALIGNMENT)
    step = make_train_step(resumed.model, resumed.optimizer)
    holder = [resumed]

    def loader_fed_step():
        holder[0], _ = step(holder[0], *next(loader))

    for _ in range(2):
        loader_fed_step()
    profile = device_profile(loader_fed_step, PROFILE_STEPS)
    loader.close()
    resident = STEP_MEDIANS.get("train_bf16")
    STEP_MEDIANS["cli_train_bf16"] = statistics.median(step_ms[2:])
    emit("cli_train_bf16", config=os.path.relpath(FLAGSHIP_YAML, REPO),
         steps=CLI_STEPS, seconds=seconds, step_ms=step_ms,
         loader_fed_step_ms_median=statistics.median(step_ms[2:]),
         loader_fed_step_ms_mean=statistics.mean(step_ms[2:]),
         device_resident_step_ms_median=resident,
         data_wait_ms=data_ms, launches=launches,
         launches_per_step={k: v / CLI_STEPS for k, v in launches.items()},
         losses=losses, resumed=dict(from_step=CLI_PERIOD,
                                     to_step=resumed_to,
                                     launches=r_launches),
         profile=profile)
    del step, holder, state, resumed
    return dict(run_dir=run_dir, opts=opts)


def phase_cli_eval(dev, data: dict, trained: dict) -> None:
    """``test_net.main --ckpt`` on the foggy split: coco_results.json and
    the bbox AP (random weights: printed, not judged), exact launch counts
    a request; one image's detections from ``compute_on_dataset`` equal
    ``model(batch)`` on the same loader batch and checkpoint; images a
    second, loader-fed and from batches already on the card; the same
    checkpoint under ``TEST.EVAL_STYLE cityscapes``; ``test_net_batch`` over
    the run's two checkpoints; a ``--profile`` training run's trace."""
    from da_detect_tpu_torch.data import make_data_loader
    from da_detect_tpu_torch.engine.inference import compute_on_dataset
    from da_detect_tpu_torch.tools import (test_net, test_net_batch,
                                           train_net_triplet)
    from da_detect_tpu_torch.tools.train_core import build_model
    from da_detect_tpu_torch.utils.checkpoint import Checkpointer

    run_dir, opts = trained["run_dir"], trained["opts"]
    clear_counts()
    t0 = time.perf_counter()
    results = test_net.main(["--config-file", FLAGSHIP_YAML, "--ckpt",
                             run_dir, "--seed", "0"] + opts)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = read_counts(PER_FORWARD, DATA_IMAGES, "cli_eval_bf16",
                           "requests")
    if not os.path.exists(os.path.join(run_dir, "coco_results.json")):
        raise AssertionError("cli_eval_bf16: no coco_results.json")
    bbox = results["smoke_foggy_val"]["bbox"]

    # the checkpoint's model with no score threshold, so that the first
    # image has its 100 detections to compare
    cfg = smoke_cfg(FLAGSHIP_YAML, opts)
    cfg.MODEL.ROI_HEADS.SCORE_THRESH = 0.0
    model = build_model(cfg, dev, 0)
    Checkpointer(run_dir).resume_model(model)

    def loader():
        return make_data_loader(cfg, is_train=False, device=dev,
                                packed=True)[0]

    batches = list(loader())
    preds = compute_on_dataset(model, batches, progress_every=0)
    batch, ids = batches[0]
    dets = model(batch)
    valid = dets.valid[0].cpu().numpy()
    orig, size = batch.orig_sizes[0].cpu().numpy(), batch.sizes[0].cpu(
    ).numpy()
    scale = np.array([orig[1] / size[1], orig[0] / size[0]] * 2, np.float32)
    same = (np.array_equal(preds[ids[0]]["boxes"],
                           dets.boxes[0].cpu().numpy()[valid] * scale)
            and np.array_equal(preds[ids[0]]["scores"],
                               dets.scores[0].cpu().numpy()[valid])
            and np.array_equal(preds[ids[0]]["labels"],
                               dets.labels[0].cpu().numpy()[valid]))
    if not same or not valid.any():
        raise AssertionError(f"cli_eval_bf16: compute_on_dataset's "
                             f"{int(valid.sum())} detections differ from "
                             "model(batch), or there are none")
    rates = {}
    for name, source in (("loader_fed", loader), ("on_card", lambda: batches)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        compute_on_dataset(model, source(), progress_every=0)
        torch.cuda.synchronize()
        rates[name] = DATA_IMAGES / (time.perf_counter() - t0)
    del model, batches

    # the same checkpoint's predictions under the Cityscapes protocol
    # (TEST.EVAL_STYLE cityscapes, through inference's dispatch)
    argv = ["--config-file", FLAGSHIP_YAML, "--seed", "0"]
    clear_counts()
    cs = test_net.main(argv + ["--ckpt", run_dir] + opts
                       + ["TEST.EVAL_STYLE", "cityscapes"])
    read_counts(PER_FORWARD, DATA_IMAGES, "cli_eval_bf16 cityscapes",
                "requests")
    cs_bbox = cs["smoke_foggy_val"]["bbox"]
    if not os.path.exists(os.path.join(run_dir, "cityscapes_results.json")) \
            or set(cs_bbox) != {"allAp", "allAp50%", "allAp75%", "classes"}:
        raise AssertionError(f"cli_eval_bf16: cityscapes results {cs_bbox}")

    # every checkpoint the training run left, oldest first
    clear_counts()
    batch_results = test_net_batch.main(argv + ["--ckpt-dir", run_dir]
                                        + opts)
    read_counts(PER_FORWARD, 2 * DATA_IMAGES, "cli_eval_bf16 batch",
                "requests")
    if list(batch_results) != [CLI_PERIOD, CLI_STEPS]:
        raise AssertionError(f"cli_eval_bf16: test_net_batch evaluated "
                             f"{list(batch_results)}")
    batch_bbox = {step: r["smoke_foggy_val"]["bbox"]
                  for step, r in batch_results.items()}

    # a --profile run: a trace of iterations 10-19
    prof_dir = os.path.join(data["root"], "profile")
    t0 = time.perf_counter()
    train_net_triplet.main(
        ["--config-file", FLAGSHIP_YAML, "--skip-test", "--seed", "0",
         "--profile", prof_dir] + smoke_opts(
            data, os.path.join(data["root"], "out_profile"),
            **{"SOLVER.MAX_ITER": PROFILE_RUN_STEPS,
               "SOLVER.CHECKPOINT_PERIOD": 1000}))
    profile_run_s = time.perf_counter() - t0
    traces = os.listdir(prof_dir)
    if traces != ["trace_10-19.json"]:
        raise AssertionError(f"cli_eval_bf16: --profile left {traces}")
    with open(os.path.join(prof_dir, traces[0]), "rb") as f:
        trace = f.read()
    emit("cli_eval_bf16", config=os.path.relpath(FLAGSHIP_YAML, REPO),
         images=DATA_IMAGES, seconds=seconds, launches=launches,
         launches_per_request={k: v / DATA_IMAGES
                               for k, v in launches.items()},
         bbox=bbox, images_per_s=rates,
         detections_first_image=int(valid.sum()),
         cityscapes_bbox=dict(allAp=cs_bbox["allAp"],
                              allAp50=cs_bbox["allAp50%"],
                              allAp75=cs_bbox["allAp75%"]),
         test_net_batch={step: dict(AP=b["AP"], AP50=b["AP50"])
                         for step, b in batch_bbox.items()},
         profile_run=dict(steps=PROFILE_RUN_STEPS, seconds=profile_run_s,
                          trace=traces[0], trace_bytes=len(trace),
                          kernel_events=trace.count(b'"cat": "kernel"')))


def phase_stage(dev, data: dict, cold: dict) -> dict:
    """``tools/stage_dataset.main`` on the smoke datasets (the flagship
    YAML's geometry: every image of the three domains, both flips), then
    the triplet loader warm at the YAML's workers and at 4: it must decode
    nothing (every canvas a staging hit); batches a second and host seconds
    by stage beside phase 13's cold numbers; then ``train_net_triplet`` fed
    by the warm loader: its median step and data wait."""
    from da_detect_tpu_torch.tools import stage_dataset, train_net_triplet

    out = os.path.join(data["root"], "out_stage")
    opts = smoke_opts(data, out, **{
        "DATASETS.TRAIN": "('smoke_clean_train',)",
        "DATALOADER.STAGE_CACHE": True,
        "DATALOADER.STAGE_DIR": os.path.join(data["root"], "stage_warm"),
        "SOLVER.MAX_ITER": STAGE_STEPS, "SOLVER.CHECKPOINT_PERIOD": 1000})
    argv = ["--config-file", FLAGSHIP_YAML, "--seed", "0"]
    cfg = smoke_cfg(FLAGSHIP_YAML, opts)
    want = DATA_IMAGES * 3 * len(cfg.INPUT.MIN_SIZE_TRAIN) * 2
    t0 = time.perf_counter()
    staged = stage_dataset.main(argv + opts)
    stage_s = time.perf_counter() - t0
    if staged != want:
        raise AssertionError(f"stage: {staged} canvases staged, expected "
                             f"{want}")
    rates = {}
    for workers in (cfg.DATALOADER.NUM_WORKERS, 4):
        cfg.DATALOADER.NUM_WORKERS = workers
        r = loader_rate(cfg, dev, LOADER_BATCHES)
        del r["first"]
        if r["stage_misses"] != 0 or "decode_s" in r["host_s_per_step"] \
                or not r["stage_hits"]:
            raise AssertionError(f"stage: the warm loader decoded: {r}")
        rates[f"workers_{workers}"] = r
    clear_counts()
    state, meters = train_net_triplet.main(
        argv + ["--skip-test", "--log-period", "1"] + opts)
    torch.cuda.synchronize()
    launches = read_counts(PER_TRAIN_STEP, STAGE_STEPS, "stage", "steps")
    step_ms = [t * 1e3 for t in meters.meters["time"].deque]
    data_ms = [t * 1e3 for t in meters.meters["data"].deque]
    if state.step != STAGE_STEPS or len(step_ms) != STAGE_STEPS:
        raise AssertionError(f"stage: {state.step} steps, {len(step_ms)} "
                             "timed")
    cold_batches = {k: v["batches_per_s"] for k, v in cold.items()}
    emit("stage", config=os.path.relpath(FLAGSHIP_YAML, REPO),
         canvases=staged, stage_s=stage_s, loader_warm=rates,
         loader_cold_batches_per_s=cold_batches,
         loader_cold_host_s_per_step={
             k: v["host_s_per_step"] for k, v in cold.items()},
         loader_fed_warm=dict(
             steps=STAGE_STEPS, step_ms=step_ms,
             step_ms_median=statistics.median(step_ms[2:]),
             data_wait_ms=data_ms,
             data_wait_ms_median=statistics.median(data_ms[2:]),
             launches=launches),
         loader_fed_cold_step_ms_median=STEP_MEDIANS.get("cli_train_bf16"))
    return rates


def sanity_step(dev, root: str):
    """Step 1 of the ablation's triplet-DA arm (the GN model in bfloat16)
    on a batch of its loader: kernel-run twice, bit for bit the same, and
    against plain-run, relative to an f32 copy (``compare_steps``); then one train step with its kernels'
    inputs recorded, the ROIAlign maps and gradients float32, each kernel
    held to its plain version on them and timed (the kernel line's sanity
    sites); the step's profile (3 steps), its peak memory and the model's
    parameter and buffer bytes."""
    from da_detect_tpu_torch.data import make_data_loader_da
    from da_detect_tpu_torch.engine.trainer import (create_train_state,
                                                    make_train_step)
    from da_detect_tpu_torch.tools import sanity_check
    from da_detect_tpu_torch.tools.train_core import build_model

    sanity_check.build_synthetic(root, 16, seed=3, fog=(0.8, 10.0),
                                 invert=True)
    os.environ["DA_DETECT_DATA_DIR"] = root
    cfg = sanity_check.ablation_cfg(True, 200)
    loader = make_data_loader_da(cfg, device=dev, aligned=True, seed=0,
                                 packed=True)
    args = next(loader)
    loader.close()
    state = create_train_state(cfg, build_model(cfg, dev, 0), 0, "cosine")
    kernel_run = train_step_one(state, args, "cuda")
    again = train_step_one(state, args, "cuda")
    if kernel_run[0] != again[0] or any(
            not torch.equal(g, again[1][n]) for n, g in kernel_run[1].items()):
        raise AssertionError("sanity: the kernel-run step is not "
                             "reproducible: two runs differ")
    agreement = compare_steps(kernel_run, train_step_one(state, args, "plain"),
                              f32_step_one(state, cfg, args))
    del kernel_run, again  # two copies of the gradients: not the step's peak
    step = make_train_step(state.model, state.optimizer, aligned=True)
    holder = [state]

    def one_step():
        holder[0], _ = step(holder[0], *args)

    for _ in range(2):
        one_step()
    profile = device_profile(one_step, PROFILE_STEPS)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with record_kernel_inputs() as captured:
        one_step()
        torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    model_bytes = sum(t.numel() * t.element_size() for t in
                      list(state.model.parameters())
                      + list(state.model.buffers()))
    dtypes = ([maps[0].dtype for maps, _, _, _ in captured["roi_align_fwd"]]
              + [g.dtype for g, *_ in captured["roi_align_bwd"]])
    if dtypes != [torch.float32] * 4:
        raise AssertionError(f"sanity: the GN model's ROIAlign ran on "
                             f"{dtypes}, not 4 float32 launches")
    errs = check_captured(captured)
    sites = time_sites(captured, "sanity_bf16", ("rpn_source",
                                                 "rpn_target"))
    del state, step, args, captured, holder
    return dict(plain_agreement=agreement, profile=profile,
                max_memory_allocated=peak, model_bytes=model_bytes), \
        errs, sites


def run_sanity(argv: list, arms: dict, label: str) -> dict:
    """``sanity_check.main(argv)`` with the counts set to 0 before it and
    read after: each arm's training and evaluation launches exact
    (``arms``: arm -> steps per step's launches)."""
    from da_detect_tpu_torch.tools import sanity_check

    clear_counts()
    t0 = time.perf_counter()
    out = sanity_check.main(argv)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    total = {}
    for arm, run in out["arms"].items():
        want = {k: v * run["iters"] for k, v in arms[arm].items()}
        want_eval = {k: v * run["eval_images"] // 2
                     for k, v in PER_SANITY_EVAL_BATCH.items()}
        if run["train_launches"] != want or run["eval_launches"] != want_eval:
            raise AssertionError(
                f"{label} {arm}: launches {run['train_launches']} training, "
                f"{run['eval_launches']} evaluating; expected {want}, "
                f"{want_eval}")
        for k, v in list(want.items()) + list(want_eval.items()):
            total[k] = total.get(k, 0) + v
    launches = read_counts(total, 1, label, "runs")
    return dict(out, seconds=seconds, launches=launches)


def phase_sanity(dev) -> tuple:
    """The from-scratch learning gate on the card: step 1 of its GN DA
    model against the plain run; ``sanity_check.main`` with the JAX
    package's ablation gate (DA AP50 - source-only AP50 >= 0.2 at 200
    iterations a arm). Returns (the sanity sites, the ablation's launches,
    the kernels' largest errors)."""
    with tempfile.TemporaryDirectory(prefix="chip_sanity_") as root:
        before = os.environ.get("DA_DETECT_DATA_DIR")
        try:
            step1, errs, sites = sanity_step(dev,
                                             os.path.join(root, "step"))
            ablation = run_sanity(
                SANITY_ABLATION + ["--data-dir", os.path.join(root, "abl")],
                PER_SANITY_STEP, "sanity_bf16 ablation")
            data_bytes = sum(
                os.path.getsize(os.path.join(d, f))
                for d, _, files in os.walk(os.path.join(root, "abl"))
                for f in files)
        finally:
            if before is None:
                os.environ.pop("DA_DETECT_DATA_DIR", None)
            else:
                os.environ["DA_DETECT_DATA_DIR"] = before
    arms = {arm: dict(ap50=run["ap50"], iters=run["iters"],
                      train_s=run["train_s"],
                      steps_per_s=run["steps_per_s"],
                      launches_per_step={k: v / run["iters"] for k, v in
                                         run["train_launches"].items()},
                      eval_launches=run["eval_launches"])
            for arm, run in ablation["arms"].items()}
    emit("sanity_bf16", gate=" ".join(SANITY_ABLATION),
         verdict=ablation["sanity_check"], source_only=ablation["source_only"],
         da=ablation["da"], gap=ablation["gap"],
         min_gap=ablation["min_gap"], margin_img=ablation["margin_img"],
         arms=arms, seconds=ablation["seconds"], data_bytes=data_bytes,
         launches=ablation["launches"], da_step=step1,
         max_abs_err=errs, sites=sites)
    return sites, ablation["launches"], errs


# --gate-spread: the conditions of the DA arm's runs under last-bit changes
# of its initial weights: the kernels (the gate as it runs); the kernels,
# each ROIAlign launch also held to its plain version on its inputs
# (``kernels_checked``: the same runs as ``kernels``); the kernels with the
# ROIAlign backward's plain version in place of its kernel, its dF in the
# plain version's memory order or (``plain_bwd_cl``) in the kernel's,
# channels-last; the plain versions of all three
SPREAD_CONDITIONS = ("kernels", "kernels_checked", "plain_bwd",
                     "plain_bwd_cl", "plain")


def nudge_weights(model, seed: int) -> None:
    """One element of each floating parameter of ``model``, drawn from
    ``seed``, moved by one ulp toward +inf: an independent last-bit change
    of the initial weights."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in model.parameters():
            if not p.is_floating_point() or not p.numel():
                continue
            i = np.unravel_index(
                int(torch.randint(p.numel(), (1,), generator=gen)), p.shape)
            p[i] = torch.nextafter(p[i], torch.full_like(p[i], np.inf))


@contextlib.contextmanager
def roi_align_swapped(condition: str, worst: dict):
    """Inside the kernels' autograd function, per ``condition``: the
    ROIAlign backward's plain version (autograd of the plain forward, on
    the card) in place of its kernel (``plain_bwd``; ``plain_bwd_cl``: its
    dF copied to channels-last memory, the kernel's); or each ROIAlign
    launch held to the plain version run in float64 on its own inputs
    (``kernels_checked``), ``worst`` keeping for each kernel the largest
    error over max |output|, and the mean over its launches of
    sum(out - exact) / sum |exact| of the kernel's and of the float32 plain
    version's output (the signed bias of their rounding)."""
    from da_detect_tpu_torch.ops import roi_align, roi_align_cuda

    fwd, bwd = roi_align_cuda.roi_align_forward, \
        roi_align_cuda.roi_align_backward

    def plain_bwd(grad, rois, **kw):
        d = roi_align.roi_align_grad(grad, rois, **kw)
        return (d.contiguous(memory_format=torch.channels_last)
                if condition == "plain_bwd_cl" else d)

    def held(name, kernel, plain):
        def run(x, rois, **kw):
            got = kernel(x, rois, **kw)
            exact = plain(x.double(), rois, **kw)
            scale = exact.abs().max().clamp(min=1e-300)
            total = exact.abs().sum().clamp(min=1e-300)
            rec = worst.setdefault(name, dict(
                max_rel_err=0.0, bias_kernel=0.0, bias_plain=0.0,
                launches=0))
            n = rec["launches"] + 1
            for who, val in (("kernel", got), ("plain", plain(x, rois, **kw))):
                diff = val.double() - exact
                if who == "kernel":
                    rec["max_rel_err"] = max(rec["max_rel_err"],
                                             float(diff.abs().max() / scale))
                key = f"bias_{who}"
                rec[key] += (float(diff.sum() / total) - rec[key]) / n
            rec["launches"] = n
            return got
        return run

    if condition.startswith("plain_bwd"):
        roi_align_cuda.roi_align_backward = plain_bwd
    elif condition == "kernels_checked":
        roi_align_cuda.roi_align_forward = held(
            "roi_align_fwd", fwd, roi_align.roi_align)
        roi_align_cuda.roi_align_backward = held(
            "roi_align_bwd", bwd, roi_align.roi_align_grad)
    try:
        yield
    finally:
        roi_align_cuda.roi_align_forward = fwd
        roi_align_cuda.roi_align_backward = bwd


def weights_digest(model) -> str:
    """sha256 of every parameter's bytes, in order: equal digests, equal
    models."""
    import hashlib

    h = hashlib.sha256()
    for p in model.parameters():
        h.update(p.detach().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def da_arm_run(dev, condition: str, nudge: int) -> dict:
    """The ablation's triplet-DA arm trained once under ``condition``
    (SPREAD_CONDITIONS), its initial weights nudged from seed ``nudge`` (0:
    as built), on the data of DA_DETECT_DATA_DIR: AP50 on the inverted
    target, steps a second, training launches, the final weights' digest
    (``kernels_checked``: and each ROIAlign kernel's largest relative error
    against its plain version over the run's launches, and its mean signed
    bias)."""
    from da_detect_tpu_torch.tools import sanity_check
    from da_detect_tpu_torch.tools.train_core import build_model

    cfg = sanity_check.ablation_cfg(True, 200)
    model = build_model(cfg, dev, 0)
    if nudge:
        nudge_weights(model, nudge)
    if condition == "plain":
        model.impl = "plain"
    worst = {}
    with roi_align_swapped(condition, worst):
        ap50, state, run = sanity_check.train_and_eval(
            cfg, True, 200, logging.getLogger("chip_smoke.gate_spread"),
            test_dataset="sanity_foggy_cocostyle", model=model)
    if any(v["max_rel_err"] > ROI_BWD_REL for v in worst.values()):
        raise AssertionError(f"gate_spread: a ROIAlign kernel left its "
                             f"plain version during training: {worst}")
    return dict(condition=condition, nudge=nudge, ap50=ap50,
                steps_per_s=run["steps_per_s"],
                train_launches=run["train_launches"],
                digest=weights_digest(state.model), against_plain=worst)


def gate_spread(dev, gates_n: int, n: int, conditions: list) -> None:
    """The learning gate's reproducibility on the card: the unchanged
    ablation gate ``gates_n`` times (with exact launches); then the DA arm
    ``n`` times under each of ``conditions`` (``"NAME"`` or
    ``"NAME:FIRST"``, NAME in SPREAD_CONDITIONS), nudged from seeds FIRST
    (default 0: as built) to FIRST + n - 1. A line a run, then the pass
    rates (DA AP50 minus the gate's source-only AP50 >= 0.2)."""
    gates = []
    with tempfile.TemporaryDirectory(prefix="chip_gate_") as root:
        before = os.environ.get("DA_DETECT_DATA_DIR")
        try:
            for i in range(gates_n):
                try:
                    out = run_sanity(
                        SANITY_ABLATION + ["--data-dir", root],
                        PER_SANITY_STEP, f"gate_spread gate {i}")
                except SystemExit:  # FAIL: the tool printed its verdict
                    out = dict(sanity_check="FAIL")
                gates.append(out)
                emit("gate_run", run=i, **{k: out.get(k) for k in (
                    "sanity_check", "source_only", "da", "gap",
                    "margin_img", "seconds")})
            source_only = next((g["source_only"] for g in gates
                                if "source_only" in g), 0.0)
            runs = []
            for spec in conditions:
                condition, _, first = spec.partition(":")
                for k in range(int(first or 0), int(first or 0) + n):
                    t0 = time.perf_counter()
                    run = da_arm_run(dev, condition, k)
                    run["passes"] = run["ap50"] - source_only >= 0.2
                    emit("gate_spread", seconds=time.perf_counter() - t0,
                         **run)
                    runs.append(run)
        finally:
            if before is None:
                os.environ.pop("DA_DETECT_DATA_DIR", None)
            else:
                os.environ["DA_DETECT_DATA_DIR"] = before
    summary = {}
    for condition in dict.fromkeys(r["condition"] for r in runs):
        mine = [r for r in runs if r["condition"] == condition]
        aps = sorted(r["ap50"] for r in mine)
        summary[condition] = dict(
            runs=len(mine), passes=sum(r["passes"] for r in mine),
            ap50_min=aps[0], ap50_median=statistics.median(aps),
            ap50_max=aps[-1], nudges=[mine[0]["nudge"], mine[-1]["nudge"]],
            digests=len({r["digest"] for r in mine}))
    emit("gate_spread_summary", gate_runs=gates_n,
         gate_passes=sum(g["sanity_check"] == "PASS" for g in gates),
         gate_outcomes=len({(g.get("source_only"), g.get("da"))
                            for g in gates}),
         source_only=source_only, conditions=summary)


def numpy_tta_merge(boxes, scores, labels, thresh, max_dets) -> np.ndarray:
    """The JAX package's TTA merge rule in numpy (``_np_per_class_nms`` with
    its native NMS): greedy per-class NMS in float32 over a stable sort by
    score, legacy +1 widths, suppression at IoU > thresh; kept indices
    ascending, stable sorted by score descending, the first max_dets."""
    b = boxes.astype(np.float32)
    one, t = np.float32(1), np.float32(thresh)
    area = (b[:, 2] - b[:, 0] + one) * (b[:, 3] - b[:, 1] + one)
    suppressed = np.zeros(len(b), bool)
    kept = []
    for i in np.argsort(-scores, kind="stable"):
        if suppressed[i]:
            continue
        kept.append(i)
        j = np.flatnonzero((labels == labels[i]) & ~suppressed)
        j = j[j != i]
        iw = np.minimum(b[j, 2], b[i, 2]) - np.maximum(b[j, 0], b[i, 0]) + one
        ih = np.minimum(b[j, 3], b[i, 3]) - np.maximum(b[j, 1], b[i, 1]) + one
        inter = np.maximum(iw, 0) * np.maximum(ih, 0)
        iou = inter / (area[i] + area[j] - inter)
        suppressed[j[(iou > t) & (iw > 0) & (ih > 0)]] = True
    kept = np.sort(np.asarray(kept, np.int64))
    return kept[np.argsort(-scores[kept], kind="stable")][:max_dets]


def phase_tta(dev, data: dict) -> dict:
    """``train_core.run_eval`` on the X-101-32x8d-FPN-DCN YAML (bfloat16,
    TEST.BBOX_AUG as the YAML sets it: 8 passes) over 2 foggy images, on a
    model built here with random weights and offsets drawn as
    ``e2e_pairs.spread_dcn`` draws them: each pass's canvas, latency and
    launches (270 row gathers a forward at every scale); the merge's NMS
    kernel against its plain version on the merged candidates (exact keep
    masks); the merged order against ``numpy_tta_merge``."""
    from da_detect_tpu_torch import kernels
    from da_detect_tpu_torch.config.catalog import load_user_catalog
    from da_detect_tpu_torch.data import make_data_loader
    from da_detect_tpu_torch.e2e_pairs import spread_dcn
    from da_detect_tpu_torch.engine import bbox_aug, inference
    from da_detect_tpu_torch.ops import nms, nms_cuda
    from da_detect_tpu_torch.tools import train_core

    cfg, _, model = dcn_model(dev, "four", "bfloat16")
    cfg = cfg.clone()
    cfg.defrost()
    cfg.merge_from_list(smoke_opts(
        data, os.path.join(data["root"], "out_tta"),
        **{"DATASETS.TEST": "('smoke_foggy_val_few',)"}))
    cfg.MODEL.OUTPUT_DIR = os.path.join(cfg.MODEL.OUTPUT_DIR, "run")
    cfg.freeze()
    load_user_catalog(cfg.PATHS_CATALOG)
    loader, _ = make_data_loader(cfg, is_train=False, device=dev)
    raw_std = spread_dcn(model, next(loader)[0])
    loader.close()

    passes, merges = [], []
    plain_cod, plain_merge = inference.compute_on_dataset, \
        bbox_aug.merge_per_class

    def timed_pass(model, data_loader, progress_every=50):
        canvases = []

        def watch(items):
            for batch, ids in items:
                canvases.append(list(batch.images.shape[2:]))
                yield batch, ids

        before = dict(kernels.LAUNCHES)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = plain_cod(model, watch(data_loader), progress_every)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = {k: kernels.LAUNCHES[k] - before.get(k, 0)
                  for k in kernels.SOURCES}
        passes.append(dict(canvas=canvases[0], images=len(out),
                           ms_per_image=seconds * 1e3 / len(out),
                           launches=counts))
        return out

    def recorded_merge(boxes, scores, labels, thresh, max_dets, **kw):
        keep = plain_merge(boxes, scores, labels, thresh, max_dets, **kw)
        merges.append((boxes, scores, labels, thresh, max_dets, keep))
        return keep

    inference.compute_on_dataset = timed_pass
    bbox_aug.merge_per_class = recorded_merge
    logger = logging.getLogger("chip_smoke.tta")
    try:
        clear_counts()
        results = train_core.run_eval(cfg, logger, model, dev)
        torch.cuda.synchronize()
    finally:
        inference.compute_on_dataset = plain_cod
        bbox_aug.merge_per_class = plain_merge
    n_pass = len(bbox_aug.tta_passes(cfg))
    expected = {k: v * TTA_IMAGES * n_pass
                for k, v in PER_DCN_FORWARD.items()}
    expected["nms"] += TTA_IMAGES  # the merge: a launch an image
    launches = read_counts(expected, 1, "tta_bf16", "runs")
    for p in passes:
        for k, v in PER_DCN_FORWARD.items():
            if p["launches"][k] != v * p["images"]:
                raise AssertionError(f"tta_bf16: pass at {p['canvas']} ran "
                                     f"{k} {p['launches'][k]} times for "
                                     f"{p['images']} images")
    if len(passes) != n_pass or len(merges) != TTA_IMAGES:
        raise AssertionError(f"tta_bf16: {len(passes)} passes, "
                             f"{len(merges)} merges")

    sites, err = [], 0
    for i, (boxes, scores, labels, thresh, max_dets, keep) in enumerate(
            merges):
        if not np.array_equal(keep, numpy_tta_merge(boxes, scores, labels,
                                                    thresh, max_dets)):
            raise AssertionError(f"tta_bf16: image {i}'s merged order "
                                 "differs from the JAX merge rule")
        row, col, shape = bbox_aug.class_rows(labels)
        b = np.zeros(shape + (4,), np.float32)
        s = np.full(shape, nms.NEG_INF, np.float32)
        v = np.zeros(shape, bool)
        b[row, col], s[row, col], v[row, col] = boxes, scores, True
        order = np.argsort(-s, axis=1, kind="stable")
        bs = torch.from_numpy(np.take_along_axis(b, order[..., None], 1)
                              ).to(dev)
        vs = torch.from_numpy(np.take_along_axis(v, order, 1)).to(dev)
        got = nms_cuda.nms_mask_sorted(bs, vs, thresh)
        want = nms.nms_mask_sorted(bs, vs, thresh)
        err = max(err, int((got != want).sum()))
        nbytes, ops = nms_work(vs, got, None)
        bound_ms, by = bound(nbytes, ops)
        sites.append(dict(
            kernel="nms", path="tta_bf16", site=f"merge{i}",
            shape=list(bs.shape), iou=thresh, candidates=len(boxes),
            kept=int(got.sum()), merged=len(keep), bytes=nbytes,
            operations=ops,
            ms=time_ms(lambda: nms_cuda.nms_mask_sorted(bs, vs, thresh)),
            plain_ms=time_ms(lambda: nms.nms_mask_sorted(bs, vs, thresh),
                             runs=NMS_PLAIN_RUNS, warmup=1),
            bound_ms=bound_ms, bound_by=by))
    if err:
        raise AssertionError(f"tta_bf16: the merge's NMS kernel's keep masks "
                             f"differ from the plain version's in {err}")
    emit("tta_bf16", config=os.path.relpath(DCN_YAML, REPO),
         images=TTA_IMAGES, passes=passes, launches=launches,
         offset_std_before_scaling=raw_std[:3],
         bbox=results["smoke_foggy_val_few"]["bbox"], merge_sites=sites)
    return dict(sites=sites, launches=launches, err=err)


# ---------------------------------------------------------------- VGG-16

# the VGG-16 DA-Faster R-CNN (``entry.vgg_cfg``: the flagship triplet-DA
# YAML on VGG-16 at 608x1216): one stride-16 map of 512 channels (38x76),
# pooled at P 7 with adaptive sampling by the FPN2MLP box head (1000 ROIs a
# request, 256 sampled ROIs an image a step); the flagship's launches a
# request and a step (NMS in the RPN and the box head; ROIAlign once a
# box-head pass)
VGG_MAP, VGG_CHANNELS, VGG_POOL = (38, 76), 512, 7
VGG_TRAIN_STEPS, VGG_PROFILE_STEPS = 6, 2
VGG_NMS_SITES = ("rpn", "box_head")


def vgg_model(dev, dtype: str):
    """``entry.vgg_cfg(dtype)`` through ``entry(cfg=...)``, random weights
    from seed 0, score layers spread; and REQUESTS batches."""
    from da_detect_tpu_torch import entry

    cfg = entry.vgg_cfg(dtype)
    cfg.freeze()
    fn, (model, _) = entry.entry(device=str(dev), seed=0, cfg=cfg)
    spread_scores(model)
    batches = [entry.make_batch(cfg, 1, seed=s, device=dev)[0]
               for s in range(REQUESTS)]
    return cfg, fn, model, batches


def vgg_pooled(captured) -> list:
    """The captured ROIAlign maps' shapes and dtypes; raises unless each is
    one [1 or 2, 512, 38, 76] map pooled at P 7 with adaptive sampling."""
    seen = []
    for maps, rois, levels, kw in captured["roi_align_fwd"]:
        m = maps[0]
        if len(maps) != 1 or levels is not None \
                or tuple(m.shape[1:]) != (VGG_CHANNELS, *VGG_MAP) \
                or kw["output_size"] != VGG_POOL \
                or kw["sampling_ratio"] != 0:
            raise AssertionError(f"VGG pooler launch on {len(maps)} maps "
                                 f"{[tuple(x.shape) for x in maps]} {kw}")
        seen.append(dict(map=list(m.shape), dtype=str(m.dtype)[6:],
                         rois=list(rois.shape)))
    return seen


def phase_vgg(dev, dtype: str = "float32") -> tuple[dict, dict]:
    """The VGG-16 DA-Faster R-CNN in ``dtype``. Eval: REQUESTS batch-1
    requests with exact launch counts (the flagship's), kernel run against
    plain run (``match_detections``), the pooler's site (one 38x76 map of
    512 channels, P 7, adaptive sampling) and the NMS sites timed, a
    profile with its busy share and convolution census, peak memory. Train:
    the triplet step (the YAML's DA settings) through ``train_entry``:
    kernel-run against plain-run step 1 (``compare_steps``; in float32 with
    the box head's ReLU flips left out), VGG_TRAIN_STEPS timed steps with
    exact launches, a profile, peak memory, one step's kernel inputs
    checked and timed; then ALIGNED_STEPS aligned steps (instance triplet
    on). Returns ({path: (sites, launches)}, the largest error a
    kernel)."""
    from da_detect_tpu_torch import entry

    name, bf16 = label("vgg", dtype), dtype == "bfloat16"
    cfg, fn, model, batches = vgg_model(dev, dtype)
    answers, launches, seconds = serve_requests(fn, model, batches,
                                                PER_FORWARD, name)
    summary = [check_detections(cfg, dets) for dets in answers]
    with record_kernel_inputs() as captured:
        dets_k = fn(model, batches[0])
    pooled = vgg_pooled(captured)
    agreement = match_detections(
        dets_k, model(batches[0], impl="plain"),
        f32_copy(model, cfg)(batches[0], impl="plain") if bf16 else None)
    errs = check_captured(captured)
    eval_sites = time_sites(captured, label("vgg_eval", dtype),
                            VGG_NMS_SITES if not bf16 else ())
    forward_ms = host_ms(lambda: fn(model, batches[0]), runs=10)
    profile = device_profile(lambda: fn(model, batches[0]), DCN_PROFILE_RUNS)
    census = conv_census(profile, bf16, name)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fn(model, batches[0])
    torch.cuda.synchronize()
    emit(name, config="entry.vgg_cfg", dtype=dtype,
         canvas=list(cfg.TPU.IMAGE_SHAPE), requests=REQUESTS,
         seconds=seconds, launches=launches, detections=summary,
         plain_agreement=agreement, forward_ms=forward_ms, sites=eval_sites,
         pooled=pooled, profile=profile, conv_kernels_by_dtype=census,
         max_memory_allocated=torch.cuda.max_memory_allocated(),
         max_abs_err=errs)
    del model, fn, batches, captured, answers

    t_name = label("vgg_train", dtype)
    cfg = train_cfg(False, cfg=entry.vgg_cfg(dtype))
    step, (state, args) = entry.train_entry(device=str(dev), seed=0, cfg=cfg)
    frozen = [n for n, p in state.model.named_parameters()
              if not p.requires_grad]
    if frozen:
        raise AssertionError(f"{t_name}: frozen parameters {frozen[:4]}: "
                             "the JAX package trains every VGG conv")
    if bf16:
        t_agreement = compare_steps(
            train_step_one(state, args, "cuda"),
            train_step_one(state, args, "plain"),
            f32_step_one(state, cfg, args))
    else:
        with relu_inputs(state.model) as pre_k:
            kernel = train_step_one(state, args, "cuda")
        with relu_inputs(state.model) as pre_p:
            plain = train_step_one(state, args, "plain")
        t_agreement = compare_steps(kernel, plain,
                                    flips=relu_flips(pre_k, pre_p))
        del kernel, plain, pre_k, pre_p
    state, record, t_captured = measure_train_path(
        step, state, args, t_name, bf16, VGG_TRAIN_STEPS, PER_TRAIN_STEP,
        VGG_PROFILE_STEPS)
    del step, state
    t_pooled = vgg_pooled(t_captured)
    merge_errs(errs, check_captured(t_captured))
    train_sites = time_sites(t_captured, t_name,
                             ("rpn_source", "rpn_target") if not bf16 else ())
    t_inputs = train_inputs(t_captured)
    del t_captured

    a_cfg = train_cfg(True, cfg=entry.vgg_cfg(dtype))
    a_step, (a_state, a_args) = entry.train_entry(device=str(dev), seed=0,
                                                  cfg=a_cfg)
    a_state, a_launches, a_times, a_metrics = run_steps(
        a_step, a_state, a_args, ALIGNED_STEPS, PER_ALIGNED_STEP,
        label("vgg_aligned", dtype))
    if not all(m["triplet_loss_instance"] >= 0 for m in a_metrics):
        raise AssertionError(f"{t_name}: aligned step without its instance "
                             f"triplet: {a_metrics}")
    del a_step, a_state
    emit(t_name, config="entry.vgg_cfg", dtype=dtype,
         canvas=list(cfg.TPU.IMAGE_SHAPE), plain_agreement=t_agreement,
         sites=train_sites, pooled=t_pooled, main_path_inputs=t_inputs,
         max_abs_err=errs, **record,
         aligned=dict(steps=ALIGNED_STEPS, launches=a_launches,
                      step_ms=a_times,
                      losses=[{k: float(v) for k, v in m.items()}
                              for m in a_metrics]))
    return {label("vgg_eval", dtype): (eval_sites, launches),
            t_name: (train_sites, record["launches"]),
            label("vgg_aligned", dtype): ([], a_launches)}, errs


# ---------------------------------------------------------------- derain

# the deraining CLI at its defaults (crop 224, batch 8) for DERAIN_ITERS
# iterations on DERAIN_IMAGES clean PNGs of DERAIN_HW written at run time
# (rain synthesized on the fly, cv2); the step's device split measured on
# DERAIN_TIMED_STEPS steps of one batch; the learning check (base 8, 32x32,
# 200 Adam steps); KPNRef's forward at 224 against the same weights on the
# CPU (KPNREF_REL of its largest |output|: float32 sums in another order)
DERAIN_ITERS, DERAIN_IMAGES, DERAIN_HW = 40, 12, (512, 1024)
DERAIN_CROP, DERAIN_BATCH = 224, 8      # the CLI's defaults
DERAIN_TIMED_STEPS = 10
KPNREF_HW, KPNREF_REL = 224, 1e-4


def derain_images(root: str, n: int, hw, seed: int) -> str:
    """``n`` smooth RGB PNGs of ``hw`` with coloured discs, written with the
    port's PNG writer under ``root/clean``."""
    from da_detect_tpu_torch.data.image_io import write_png

    rng = np.random.RandomState(seed)
    out = os.path.join(root, "clean")
    os.makedirs(out)
    h, w = hw
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    for i in range(n):
        img = 96 + 60 * np.sin(2 * np.pi * (yy / h + xx / w * rng.uniform(
            0.5, 2.0)))[..., None] * rng.uniform(0.3, 1.0, 3)
        for _ in range(6):
            cy, cx, r = rng.uniform(0, h), rng.uniform(0, w), rng.uniform(
                20, 120)
            disc = (yy - cy) ** 2 + (xx - cx) ** 2 <= r * r
            img[disc] = rng.uniform(0, 255, 3)
        write_png(os.path.join(out, f"{i:03d}.png"),
                  np.clip(img, 0, 255).astype(np.uint8))
    return out


def derain_step_split(dev) -> dict:
    """The CLI's step (``train_derain.make_train_step``: KPN base 32, Adam)
    on one batch of 8 224x224 crops: its device time (CUDA events, median of
    DERAIN_TIMED_STEPS), peak memory, a profile (busy share, top kernels),
    and the per-pixel filtering's forward and backward alone on the step's
    shapes (events) as a share of the step."""
    from da_detect_tpu_torch.models.derain import KPN, apply_per_pixel_kernels
    from da_detect_tpu_torch.tools import train_derain

    gen = torch.Generator().manual_seed(0)
    model = KPN()
    train_derain.init_kpn(model, gen)
    model = model.to(dev)
    opt = torch.optim.Adam(model.parameters(), lr=2e-4, betas=(0.5, 0.999))
    step = train_derain.make_train_step(
        model, opt, 0.0, train_derain.lr_schedule(2e-4, 2000, 1000))
    shape = (DERAIN_BATCH, 3, DERAIN_CROP, DERAIN_CROP)
    rainy = torch.rand(*shape, generator=gen).to(dev)
    clean = torch.rand(*shape, generator=gen).to(dev)
    step_ms = time_ms(lambda: step(rainy, clean), runs=DERAIN_TIMED_STEPS)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step(rainy, clean)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    profile = device_profile(lambda: step(rainy, clean), 3)
    kernels_ = torch.softmax(torch.randn(
        DERAIN_BATCH, 25, DERAIN_CROP, DERAIN_CROP, generator=gen), 1).to(
        dev).requires_grad_()
    x = rainy.clone().requires_grad_()

    def filtering():
        out = apply_per_pixel_kernels(x, kernels_, 5)
        torch.autograd.grad(out.sum(), (x, kernels_))

    filter_ms = time_ms(filtering, runs=DERAIN_TIMED_STEPS)
    return dict(step_ms=step_ms, max_memory_allocated=peak, profile=profile,
                filter_fwd_bwd_ms=filter_ms,
                filter_share_of_step=filter_ms / step_ms)


def derain_learning_check(dev) -> dict:
    """The JAX package's ``test_kpn_reduces_rain`` on the card: KPN base 8
    on two smooth 32x32 images with rain every 4th column, 200 Adam steps
    (lr 1e-3) of derain_loss; the loss must halve and the MSE to the clean
    images fall below a fifth of the rain's."""
    from da_detect_tpu_torch.models.derain import KPN, derain_loss
    from da_detect_tpu_torch.tools import train_derain

    rng = np.random.RandomState(2)
    yy, xx = np.mgrid[0:32, 0:32].astype(np.float32) / 32.0
    base_img = 0.5 + 0.4 * np.sin(2 * np.pi * (yy + 0.5 * xx))
    clean = np.stack([np.clip(base_img + 0.05 * rng.randn(32, 32), 0, 1)
                      for _ in range(2)], 0).astype(np.float32)
    clean = np.repeat(clean[..., None], 3, axis=-1)
    rain = clean.copy()
    rain[:, :, ::4, :] = np.minimum(rain[:, :, ::4, :] + 0.7, 1.0)
    clean_t = train_derain.to_nchw(clean, dev)
    rain_t = train_derain.to_nchw(rain, dev)
    model = KPN(base=8)
    train_derain.init_kpn(model, torch.Generator().manual_seed(0))
    model = model.to(dev)
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)
    losses = []
    t0 = time.perf_counter()
    for _ in range(200):
        opt.zero_grad(set_to_none=True)
        loss = derain_loss(model(rain_t), clean_t)
        loss.backward()
        opt.step()
        losses.append(loss.detach())
    losses = [float(v) for v in losses]
    seconds = time.perf_counter() - t0
    base_err = float(torch.mean((rain_t - clean_t) ** 2))
    with torch.no_grad():
        final_err = float(torch.mean((model(rain_t) - clean_t) ** 2))
    if not (losses[-1] < losses[0] * 0.5 and final_err < base_err * 0.2):
        raise AssertionError(f"derain learning check: losses {losses[:3]} "
                             f"... {losses[-3:]}, MSE {final_err} against "
                             f"the rain's {base_err}")
    return dict(first_loss=losses[0], last_loss=losses[-1],
                final_mse=final_err, rain_mse=base_err, seconds=seconds)


def kpnref_check(dev) -> dict:
    """KPNRef (its reference widths, 3x3 kernels at rates 1-4) forward on a
    1x3x224x224 image on the card, against the same weights on the CPU;
    its time."""
    from da_detect_tpu_torch.models.derain import KPNRef
    from da_detect_tpu_torch.tools import train_derain

    model = KPNRef()
    train_derain.init_kpn(model, torch.Generator().manual_seed(1))
    x = torch.rand(1, 3, KPNREF_HW, KPNREF_HW,
                   generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        want = model(x)
        model = model.to(dev)
        got = model(x.to(dev))
        ms = time_ms(lambda: model(x.to(dev)), runs=10)
    scale = float(want.abs().max())
    err = float((got.cpu() - want).abs().max())
    if tuple(got.shape) != (1, 3, KPNREF_HW, KPNREF_HW) \
            or not bool(torch.isfinite(got).all()) \
            or not err <= KPNREF_REL * scale:
        raise AssertionError(f"KPNRef on the card: {tuple(got.shape)}, "
                             f"err {err} of max {scale}")
    return dict(shape=list(got.shape), max_abs_err=err, max_abs=scale,
                forward_ms=ms)


def phase_derain(dev) -> None:
    """The deraining path in float32 (no NMS, ROIAlign or gather kernel:
    its per-pixel filtering is stock PyTorch): ``train_derain.main`` at
    its defaults but DERAIN_ITERS iterations (crop 224, batch 8, rain
    synthesized) on PNGs written at run time, its checkpoint's keys and
    validation; the step's device split (``derain_step_split``); the
    learning check on the card; KPNRef at 224 against the CPU."""
    from da_detect_tpu_torch.tools import train_derain

    with tempfile.TemporaryDirectory(prefix="chip_smoke_derain_") as root:
        clean = derain_images(root, DERAIN_IMAGES, DERAIN_HW, seed=5)
        out = os.path.join(root, "out")
        t0 = time.perf_counter()
        cli = train_derain.main([
            "--clean-dir", clean, "--iters", str(DERAIN_ITERS), "--crop",
            str(DERAIN_CROP), "--batch", str(DERAIN_BATCH), "--out", out])
        cli_s = time.perf_counter() - t0
        with np.load(cli["checkpoint"]) as saved:
            keys = sorted(saved.files)
            head = saved["['kernel_head']['kernel']"].shape \
                if "['kernel_head']['kernel']" in keys else None
        if len(keys) != 30 or head != (3, 3, 32, 25):
            raise AssertionError(f"kpn_final.npz keys {keys[:4]}...")
        if not (np.isfinite(cli["loss"]) and cli["psnr"] > 0
                and 0 < cli["ssim"] <= 1):
            raise AssertionError(f"derain CLI: {cli}")
    emit("derain", cli=dict(iters=DERAIN_ITERS, crop=DERAIN_CROP,
                            batch=DERAIN_BATCH,
                            images=DERAIN_IMAGES, image_hw=list(DERAIN_HW),
                            seconds=cli_s, loop_seconds=cli["seconds"],
                            iters_per_s=DERAIN_ITERS / cli["seconds"],
                            loss=cli["loss"], val_psnr=cli["psnr"],
                            val_ssim=cli["ssim"], npz_keys=len(keys)),
         step=derain_step_split(dev),
         learning_check=derain_learning_check(dev),
         kpnref=kpnref_check(dev))


# ---------------------------------------------------------------- aux

# deformable PS-ROI pooling at DCN's R-FCN head shape on the VGG model's
# stride-16 map of 608x1216: 38x76 score maps of P*P*C' = 49 * 9 channels,
# 256 ROIs, P 7, 4 x 4 samples a bin, offsets from a drawn (nonzero)
# offset_fc2; the module pools twice (without offsets, then with them), so
# a forward gathers twice and its backward scatter-adds twice (the
# features take both pools' gradients), each scatter-add building its CSR
AUX_POOL = dict(spatial_scale=1 / 16, output_size=7, out_channels=9)
AUX_ROIS, AUX_SAMPLES = 256, 4
PER_AUX_POOL = {"row_gather": 2, "row_scatter_add": 2, "row_csr": 2}
AUX_REL = 1e-5
# the deform pool's gathers and scatter-adds are timed AUX_CALLS calls back
# to back between two CUDA events, AUX_RUNS times: where a launch is longer
# than the host's work to launch it the queue stays full and the time a
# call is its device time; a shorter one (the narrow-row gather) gives the
# host's time, so the gathers' device time is also read from AUX_PROFILES
# profiles of AUX_PROFILE_RUNS passes each (profiles of a pass or two now
# and then recorded none of the launches)
AUX_CALLS, AUX_RUNS = 50, 5
AUX_PROFILE_RUNS, AUX_PROFILES = 20, 3


def batched_ms(fn) -> float:
    """Median over AUX_RUNS of the time of AUX_CALLS back-to-back calls of
    ``fn`` (CUDA events at the ends), a call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(AUX_RUNS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(AUX_CALLS):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / AUX_CALLS)
    return statistics.median(times)


def aux_device_ms(gathers, records) -> tuple[dict, dict]:
    """A forward's gathers (``gathers``: each launch's table, detached, and
    indices) and a backward's scatter-adds (``records`` from
    ``record_kernel_inputs``, random rows of the recorded shapes) timed by
    ``batched_ms``: the kernel, the plain version and the library call
    (``index_select``; ``torch.zeros`` + ``index_add_``); the scatter-add
    with its CSR built ahead (``ms``) and by the wrapper, as the path
    calls it (``csr_build_ms``)."""
    from da_detect_tpu_torch.ops import gather, gather_cuda

    def each(fn, calls):
        return lambda: [fn(*c) for c in calls]

    g = {"ms": batched_ms(each(gather_cuda.row_gather, gathers)),
         "plain_ms": batched_ms(each(gather.row_gather, gathers)),
         "library_ms": batched_ms(each(
             lambda t, i: torch.index_select(t, 0, i), gathers))}
    gen = torch.Generator(device=records[0]["idx"].device).manual_seed(0)
    calls = [(rec["shape"][0], torch.randn(
        rec["idx"].numel(), rec["shape"][1], generator=gen,
        device=rec["idx"].device), rec["idx"]) for rec in records]
    csr = [(s, grad, idx, gather.row_csr(idx, s)) for s, grad, idx in calls]
    sc = {"ms": batched_ms(each(
              lambda s, grad, idx, c: gather_cuda.row_scatter_add(
                  grad, idx, s, c), csr)),
          "csr_build_ms": batched_ms(each(
              lambda s, grad, idx: gather_cuda.row_scatter_add(grad, idx, s),
              calls)),
          "plain_ms": batched_ms(each(
              lambda s, grad, idx: gather.row_scatter_add(grad, idx, s),
              calls)),
          "library_ms": batched_ms(each(
              lambda s, grad, idx: torch.zeros(
                  s, grad.shape[1], device=grad.device).index_add_(
                  0, idx, grad), calls))}
    return g, sc


def aux_pool_inputs(dev):
    """The score maps [38, 76, 441] (needing a gradient), the ROIs [256, 4]
    over the 608x1216 canvas, the module with its offset layers drawn, and a
    cotangent [256, 7, 7, 9], all from seeds."""
    from da_detect_tpu_torch.layers.deform_pool import DeformRoIPooling

    gen = torch.Generator().manual_seed(7)
    p, c = AUX_POOL["output_size"], AUX_POOL["out_channels"]
    feats = torch.randn(*VGG_MAP, p * p * c, generator=gen).to(dev)
    rng = np.random.RandomState(7)
    xy = rng.uniform(-40, (CANVAS[1] - 40, CANVAS[0] - 40), (AUX_ROIS, 2))
    side = rng.uniform(16, 400, (AUX_ROIS, 2))
    rois = torch.from_numpy(np.concatenate([xy, xy + side], -1).astype(
        np.float32)).to(dev)
    module = DeformRoIPooling(**AUX_POOL)
    with torch.no_grad():
        module.offset_fc2.weight.normal_(0.0, 0.01, generator=gen)
        module.offset_fc2.bias.normal_(0.0, 0.1, generator=gen)
    cot = torch.randn(AUX_ROIS, p, p, c, generator=gen).to(dev)
    return feats, rois, module.to(dev), cot


def aux_pool_run(module, feats, rois, cot, impl: str):
    """The module's forward and its gradients (features and every
    parameter) under ``cot``."""
    f = feats.clone().requires_grad_()
    module.zero_grad(set_to_none=True)
    out = module(f, rois, impl=impl)
    (out * cot).sum().backward()
    torch.cuda.synchronize()
    return out.detach(), f.grad, {n: p.grad.clone()
                                  for n, p in module.named_parameters()}


def phase_aux(dev) -> tuple[dict, dict, dict]:
    """The remaining single-card modules on the card. ``DeformRoIPooling``
    (``layers/deform_pool.py``) at AUX_POOL with nonzero offsets: the main
    path (counts set to 0, one forward and backward through the row-gather
    kernel and the scatter-add kernel, counts read: PER_AUX_POOL), its
    kernels checked on its own inputs (``record_kernel_inputs``), the
    output and every gradient against the plain run (the output bit for
    bit: the gather is a copy; the gradients within AUX_REL of each one's
    largest, the plain one adding with atomics), the kernel run's gradients
    again bit for bit, the gather and scatter-add sites timed against the
    plain versions and the library calls (``aux_device_ms``), and the
    gathers' profiler device time and share of their bound
    (``gather_device_ms``; the kernel line's numbers). Then one
    call each of PAM, CAM and MultiLevelDAModule on the card against the
    CPU, and Boxes' methods.
    Returns ({path: (sites, launches, the gathers' device times)},
    errors, the scatter-add's summary)."""
    from da_detect_tpu_torch.layers.deform_pool import deform_ps_roi_pool
    from da_detect_tpu_torch.models import attention, da_fpn
    from da_detect_tpu_torch.structures import Boxes, concat_boxes

    feats, rois, module, cot = aux_pool_inputs(dev)
    clear_counts()
    out_k, gf_k, gp_k = aux_pool_run(module, feats, rois, cot, "cuda")
    launches = read_counts(PER_AUX_POOL, 1, "aux_deform_pool",
                           "forward and backward")
    with record_kernel_inputs() as captured:
        aux_pool_run(module, feats, rois, cot, "cuda")
    out_p, gf_p, gp_p = aux_pool_run(module, feats, rois, cot, "plain")
    if not torch.equal(out_k, out_p):
        raise AssertionError("deform pool: kernel-run output differs from "
                             "the plain run")
    grads = {"features": (gf_k, gf_p), **{n: (gp_k[n], gp_p[n])
                                          for n in gp_p}}
    rel = {}
    for n, (a, b) in grads.items():
        scale = float(b.abs().max())
        rel[n] = float((a - b).abs().max()) / scale if scale else 0.0
        if not rel[n] <= AUX_REL:
            raise AssertionError(f"deform pool gradient of {n}: "
                                 f"{rel[n]:.3e} of its largest")
    _, gf_again, gp_again = aux_pool_run(module, feats, rois, cot, "cuda")
    rerun = torch.equal(gf_again, gf_k) and all(
        torch.equal(gp_again[n], gp_k[n]) for n in gp_k)
    if not rerun:
        raise AssertionError("deform pool: the kernel run's gradients "
                             "differ from their rerun")
    with torch.no_grad():
        unmoved = deform_ps_roi_pool(feats, rois, None, impl="plain",
                                     sample_per_part=AUX_SAMPLES, **AUX_POOL)
    offsets_moved = float((out_k - unmoved).abs().max())
    if not offsets_moved > 0:
        raise AssertionError("deform pool: the offsets moved nothing")
    errs = check_captured(captured)
    sites = time_sites(captured, "aux_deform_pool")
    records = captured["row_scatter_add"]
    gather_inputs = [(t.detach(), i) for t, i in captured["row_gather"]]
    events, device = aux_device_ms(gather_inputs, records)
    # the gathers' own device time: at ~15 us a launch the events' time
    # above also holds the operator's host path on each call
    gathers = gather_device_ms(gather_inputs, "row_gather",
                               runs=AUX_PROFILE_RUNS,
                               profiles=AUX_PROFILES)
    gather_bound = sum(s["bound_ms"] for s in sites
                       if s["kernel"] == "row_gather")
    gathers.update(bound_ms=gather_bound, events=events, **{
        key.replace("ms", "share_of_bound"): (
            gather_bound / gathers[key] if gathers[key] else None)
        for key in ("ms", "plain_ms", "library_ms")})
    bound_ms, by = bound(scatter_work(records), 0)
    scatter = dict(launches=launches["row_scatter_add"], **device,
                   bound_ms=bound_ms, bound_by=by,
                   bit_checks=[r["bits"] for r in records if "bits" in r])
    del captured, records
    emit("aux_deform_pool", pool=dict(AUX_POOL, rois=AUX_ROIS,
                                      sample_per_part=AUX_SAMPLES,
                                      features=list(feats.shape)),
         launches=launches, grad_rel_err=rel, rerun_identical=rerun,
         output_identical=True, offsets_moved=offsets_moved, sites=sites,
         gather_device=gathers, scatter=scatter, max_abs_err=errs)

    gen = torch.Generator().manual_seed(9)
    # std 0.1: CAM's channel energies of std-1 maps over 722 positions
    # reach ~10^3, where its softmax turns float32 rounding of an energy
    # into a 1e-4 relative change of the output on either device
    x = 0.1 * torch.randn(2, 64, 19, 38, generator=gen)
    checks = {}
    for name, mod in (("PAM", attention.PAM(64)), ("CAM", attention.CAM())):
        with torch.no_grad():
            mod.gamma.fill_(0.5)
            want = mod(x)
            got = mod.to(dev)(x.to(dev).contiguous(
                memory_format=torch.channels_last)).cpu()
        checks[name] = float((got - want).abs().max()) / float(
            want.abs().max())
    levels = [torch.randn(2, 64, h, w, generator=gen)
              for h, w in ((76, 152), (38, 76), (19, 38))]
    is_source = torch.tensor([True, False])
    mlvl = da_fpn.MultiLevelDAModule(64, 3)
    want = {k: float(v) for k, v in mlvl(levels, is_source).items()}
    mlvl = mlvl.to(dev)
    got = {k: float(v) for k, v in mlvl([f.to(dev) for f in levels],
                                         is_source.to(dev)).items()}
    checks["MultiLevelDAModule"] = max(abs(got[k] - want[k]) / abs(want[k])
                                       for k in want)
    xyxy = torch.rand(2, 50, 4, generator=gen) * 600
    xyxy[..., 2:] += xyxy[..., :2]
    boxes = Boxes(xyxy=xyxy.to(dev), valid=torch.ones(2, 50, dtype=torch.bool,
                                                      device=dev),
                  fields={"scores": torch.rand(2, 50, generator=gen).to(dev)})
    done = concat_boxes([boxes.clip_to_image(608, 1216).hflip(1216)
                         .scale(0.5, 0.5).prune_small(8.0),
                         boxes.take(torch.arange(10, device=dev)
                                    .expand(2, 10))])
    cpu = Boxes(xyxy=xyxy, valid=torch.ones(2, 50, dtype=torch.bool),
                fields={"scores": boxes.fields["scores"].cpu()})
    want_b = concat_boxes([cpu.clip_to_image(608, 1216).hflip(1216)
                           .scale(0.5, 0.5).prune_small(8.0),
                           cpu.take(torch.arange(10).expand(2, 10))])
    checks["Boxes"] = float((done.xyxy.cpu() - want_b.xyxy).abs().max())
    if not (torch.equal(done.valid.cpu(), want_b.valid)
            and checks["Boxes"] == 0.0
            and all(v <= AUX_REL for k, v in checks.items()
                    if k != "Boxes")):
        raise AssertionError(f"aux modules on the card: {checks}")
    emit("aux", rel_err_against_cpu=checks, boxes_area=float(
        done.area().sum()))
    return {"aux_deform_pool": (sites, launches,
                                {"row_gather": gathers})}, errs, scatter


# ---------------------------------------------------------------- serving
# the device kernel whose calls count one launch of each forward kernel in
# a profile (an NMS launch runs its mask kernel, then its walk kernel)
LAUNCH_KERNEL_NAMES = {"nms": "nms_walk_kernel",
                       "roi_align_fwd": "roi_align_fwd_kernel",
                       "row_gather": "row_gather_kernel",
                       "row_gather_bulk": "row_gather_bulk_kernel"}
# steady requests a mode, taken in turns; requests a busy-share profile
SERVING_ROUNDS, SERVING_PROFILE_RUNS = 5, 3
COLD_START_TIMEOUT = 300
# a process from its start to its first detection (cold start, as the JAX
# package's scripts/bench_serving.py defines it): the flagship's weights
# from a file, then the eager model built from its YAML or an artifact
# loaded, one request, and its valid count on the host
COLD_CHILD = r"""
import time
started = time.time()
import json, sys
import numpy as np
import torch
repo, mode, art, weights, yaml, h, w, dtype = sys.argv[1:9]
sys.path.insert(0, repo)
h, w = int(h), int(w)
from da_detect_tpu_torch.structures.image_batch import ImageBatch
dev = torch.device("cuda", 0)
rng = np.random.RandomState(0)
images = torch.from_numpy(rng.uniform(-100, 100, (1, h, w, 3)).astype(
    np.float32)).to(dev).permute(0, 3, 1, 2)
sizes = torch.tensor([[h, w]], dtype=torch.int32, device=dev)
batch = ImageBatch(images, sizes, sizes,
                   torch.ones(1, dtype=torch.bool, device=dev))
variables = torch.load(weights, map_location=dev, weights_only=True)
if mode == "eager":
    from da_detect_tpu_torch.config import get_cfg
    from da_detect_tpu_torch.entry import prepare_model
    from da_detect_tpu_torch.models import build_detection_model
    cfg = get_cfg()
    cfg.merge_from_file(yaml)
    cfg.TPU.IMAGE_SHAPE = (h, w)
    cfg.TPU.COMPUTE_DTYPE = dtype
    model = prepare_model(build_detection_model(cfg), dev)
    model.load_state_dict(variables)
    dets = model(batch)
else:
    from da_detect_tpu_torch.engine.serving import load_serving
    dets = load_serving(art)(variables, batch)
valid = int(dets.valid.sum())
first = time.time()
print(json.dumps(dict(mode=mode, started=started, first=first, valid=valid,
                      model_code="da_detect_tpu_torch.models" in sys.modules)))
"""


def flat_outputs(out) -> list:
    """Detections, or (Detections, masks or keypoints), as a tensor list."""
    if isinstance(out, tuple) and not hasattr(out, "_fields"):
        return list(out[0]) + [out[1]]
    return list(out)


def output_difference(a, b) -> dict | None:
    """Where two outputs first differ (field index, largest difference),
    or None when they are equal bit for bit."""
    for i, (x, y) in enumerate(zip(flat_outputs(a), flat_outputs(b))):
        if x.shape != y.shape or x.dtype != y.dtype or not torch.equal(x, y):
            diff = (x.double() - y.double()).abs() if x.shape == y.shape \
                else None
            return dict(field=i, shape=[list(x.shape), list(y.shape)],
                        max_abs_diff=None if diff is None
                        else float(diff.max()))
    return None


def request_profile(run, runs: int = SERVING_PROFILE_RUNS) -> dict:
    """``runs`` calls of ``run()`` under ``torch.profiler``: the forward
    kernels' launches a call, read by kernel name (a CUDA graph's replay
    included), the device time a call and the device's busy share of the
    wall clock (under the profiler's own overhead)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(runs):
            run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kern = device_kernels(prof)
    counts = {k: sum(e.count for e in kern if name in e.key) / runs
              for k, name in LAUNCH_KERNEL_NAMES.items()}
    device_ms = sum(e.self_device_time_total for e in kern) / 1e3
    return dict(launches={k: n for k, n in counts.items() if n},
                device_ms=device_ms / runs, wall_ms=wall_ms / runs,
                busy_share=device_ms / wall_ms)


def in_turns(calls: dict, rounds: int = SERVING_ROUNDS) -> dict:
    """Each call's median host time to a synchronize (ms) over ``rounds``
    rounds, one call of each in turn a round, and its spread."""
    for fn in calls.values():
        fn()
    torch.cuda.synchronize()
    times = {k: [] for k in calls}
    for _ in range(rounds):
        for k, fn in calls.items():
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times[k].append((time.perf_counter() - t0) * 1e3)
    return {k: dict(median_ms=statistics.median(v), min_ms=min(v),
                    max_ms=max(v)) for k, v in times.items()}


def cold_starts(art: dict, weights: str, yaml: str, canvas, dtype: str
                ) -> dict:
    """Seconds from a fresh process's start to its first detection, for
    the eager model and each format (``COLD_CHILD``)."""
    out = {}
    for mode in ("eager", *art):
        t0 = time.time()
        proc = subprocess.run(
            [sys.executable, "-c", COLD_CHILD, REPO, mode,
             art.get(mode, ""), weights, yaml, str(canvas[0]),
             str(canvas[1]), dtype], capture_output=True, text=True,
            cwd=REPO, timeout=COLD_START_TIMEOUT)
        if proc.returncode != 0:
            raise RuntimeError(f"cold start {mode}: rc {proc.returncode}\n"
                               f"{proc.stderr[-3000:]}")
        got = json.loads(proc.stdout.strip().splitlines()[-1])
        if not got["valid"]:
            raise AssertionError(f"cold start {mode}: no detection")
        if mode != "eager" and got["model_code"]:
            raise AssertionError(f"cold start {mode}: the artifact's process "
                                 "imported the model code")
        out[mode] = dict(cold_start_s=got["first"] - t0,
                         in_process_s=got["first"] - got["started"],
                         valid=got["valid"])
    return out


def serve_artifact(name: str, cfg, model, fn, batch, expected: dict,
                   fmt: str, path: str, kw: dict, before_load=None,
                   **export_kw):
    """Export ``model``'s eval forward (``kw``: with_masks or
    with_keypoints) to ``path`` in ``fmt``, load it, and hold one request
    of it to the eager kernel route on ``batch``: the same outputs bit for
    bit, the same launches read from a profile of one call, and
    ``kernels.LAUNCHES``: a stablehlo call counts its launches, an aot
    artifact counts those of its warm-up and capture only (a replay runs
    no Python). ``before_load``, where given, is called between the
    export and the load. Returns (the loaded artifact, a summary)."""
    from da_detect_tpu_torch import kernels
    from da_detect_tpu_torch.engine.serving import (WARMUP_RUNS,
                                                    export_serving,
                                                    load_serving)

    variables = model.state_dict()
    t0 = time.perf_counter()
    meta = export_serving(cfg, model, variables, path, fmt=fmt, **kw,
                          **export_kw)
    export_s = time.perf_counter() - t0
    if before_load is not None:
        before_load()
    clear_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    serving = load_serving(path)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    load_peak = torch.cuda.max_memory_allocated()
    at_load = {k: kernels.LAUNCHES[k] for k in expected}
    want_at_load = {k: n * (WARMUP_RUNS + 1 if fmt == "aot" else 0)
                    for k, n in expected.items()}
    if at_load != want_at_load:
        raise AssertionError(f"{name}: launches at load {at_load}, "
                             f"expected {want_at_load}")
    eager = fn(model, batch)
    clear_counts()
    torch.cuda.reset_peak_memory_stats()
    got = serving(variables, batch)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    counted = read_counts(expected if fmt == "stablehlo" else {}, 1, name,
                          "requests")
    diff = output_difference(eager, got)
    if diff:
        raise AssertionError(f"{name}: the artifact's output differs from "
                             f"the eager forward's: {diff}")
    eager_profile = request_profile(lambda: fn(model, batch))
    profile = request_profile(lambda: serving(variables, batch))
    launches = profile.pop("launches")
    want = {k: n for k, n in expected.items() if n}
    if launches != want or eager_profile["launches"] != want:
        raise AssertionError(f"{name}: launches a request, profiled: "
                             f"artifact {launches}, eager "
                             f"{eager_profile['launches']}, expected {want}")
    return serving, dict(
        format=fmt, export_s=export_s, artifact_bytes=os.path.getsize(path),
        load_s=load_s, load_peak_bytes=load_peak, request_peak_bytes=peak,
        bit_for_bit=True, launches_profiled=launches,
        eager_launches_profiled=eager_profile.pop("launches"),
        profile=profile, eager_profile=eager_profile,
        launches_counted_at_load=at_load, launches_counted_request=counted,
        image_dtype=meta["image_dtype"], outputs=meta["outputs"],
        device_kind=meta["device_kind"])


def phase_serving(dev) -> dict:
    """Serving export on the card, bfloat16 at full width and canvas: the
    flagship R-50-C4 at 608x1216 in both formats and as a uint8 ``aot``
    artifact, the X-101-32x8d-FPN-DCN at 608x1216 (its YAML's "four"
    gathers), the Cityscapes Mask R-CNN at 800x1344 with masks and
    Keypoint R-CNN at 800x1344 with keypoints as ``aot`` artifacts. Each is
    held to the eager kernel route
    (``serve_artifact``: outputs, launches, the device time and busy share
    of a request), its export and load timed and its peaks read; the
    steady request in turns (eager, stablehlo, aot), the aot device guard,
    and the flagship's cold starts (``cold_starts``: one child process at a
    time, run while this process traces the DCN model's export, which
    keeps one host core busy and the card all but idle). Returns the
    kernel line's serving paths: path -> (no sites, launches a request
    read from the aot replay's profile, no device times)."""
    from concurrent.futures import ThreadPoolExecutor

    from da_detect_tpu_torch import entry
    from da_detect_tpu_torch.e2e_pairs import spread_dcn
    from da_detect_tpu_torch.engine.serving import load_serving

    paths, out = {}, {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_serving_") as root, \
            ThreadPoolExecutor(1) as pool:
        cfg, fn, model, batches = flagship_model(dev, "bfloat16")
        batch = batches[0]
        art = {fmt: os.path.join(root, f"flagship_{fmt}.pt2")
               for fmt in ("stablehlo", "aot")}
        shlo, out["flagship_stablehlo"] = serve_artifact(
            "serving flagship stablehlo", cfg, model, fn, batch, PER_FORWARD,
            "stablehlo", art["stablehlo"], {})
        aot, out["flagship_aot"] = serve_artifact(
            "serving flagship aot", cfg, model, fn, batch, PER_FORWARD, "aot",
            art["aot"], {})
        variables = model.state_dict()
        out["flagship_steady"] = in_turns(dict(
            eager=lambda: fn(model, batch),
            stablehlo=lambda: shlo(variables, batch),
            aot=lambda: aot(variables, batch)))
        paths[label("serving_flagship", "bfloat16")] = (
            [], out["flagship_aot"]["launches_profiled"], {})
        guard = os.path.join(root, "guard.pt2")
        rewrite_meta(art["aot"], guard, device_kind="GPU v99")
        try:
            load_serving(guard)
        except RuntimeError as e:
            if "GPU v99" not in str(e):
                raise
            out["device_guard"] = str(e)[:200]
        else:
            raise AssertionError("the aot load took an artifact whose "
                                 "device kind was edited")
        del shlo, aot
        u8 = entry.make_batch(cfg, 1, seed=7, device=dev)[0]
        raw = torch.randint(0, 256, u8.images.shape, dtype=torch.uint8,
                            generator=torch.Generator().manual_seed(7))
        u8.images = raw.to(dev).contiguous(memory_format=torch.channels_last)
        u8_aot, out["flagship_uint8_aot"] = serve_artifact(
            "serving flagship uint8 aot", cfg, model, fn, u8, PER_FORWARD,
            "aot", os.path.join(root, "flagship_u8.pt2"), {},
            image_dtype=torch.uint8)
        del u8_aot
        weights = os.path.join(root, "flagship_weights.pt")
        torch.save(variables, weights)
        cold = pool.submit(cold_starts, art, weights, FLAGSHIP_YAML, CANVAS,
                           "bfloat16")
        del fn, model, batches, batch, variables
        torch.cuda.empty_cache()

        cfg, fn, model = dcn_model(dev, "four", "bfloat16")
        batch = entry.make_batch(cfg, 1, seed=0, device=dev)[0]
        spread_dcn(model, batch)
        aot, out["dcn_aot"] = serve_artifact(
            "serving dcn aot", cfg, model, fn, batch, PER_DCN_FORWARD, "aot",
            os.path.join(root, "dcn_aot.pt2"), {}, before_load=cold.result)
        out["cold_start"] = cold.result()
        variables = model.state_dict()
        out["dcn_steady"] = in_turns(dict(
            eager=lambda: fn(model, batch),
            aot=lambda: aot(variables, batch)))
        paths[label("serving_dcn", "bfloat16")] = (
            [], out["dcn_aot"]["launches_profiled"], {})
        del aot, fn, model, batch, variables
        torch.cuda.empty_cache()

        for head, make, per, kw in (
                ("mask", mask_model, PER_MASK_FORWARD, "with_masks"),
                ("keypoint", keypoint_model, PER_KP_FORWARD,
                 "with_keypoints")):
            cfg, fn, model, batches = make(dev, "bfloat16")
            batch = batches[0]
            aot, out[f"{head}_aot"] = serve_artifact(
                f"serving {head} aot", cfg, model, fn, batch, per, "aot",
                os.path.join(root, f"{head}_aot.pt2"), {kw: True})
            variables = model.state_dict()
            out[f"{head}_steady"] = in_turns(dict(
                eager=lambda: fn(model, batch),
                aot=lambda: aot(variables, batch)))
            paths[label(f"serving_{head}", "bfloat16")] = (
                [], out[f"{head}_aot"]["launches_profiled"], {})
            del aot, fn, model, batches, batch, variables
            torch.cuda.empty_cache()
    emit("serving_bf16", canvas=dict(flagship=list(CANVAS), dcn=list(CANVAS),
                                     mask=list(MASK_CANVAS),
                                     keypoint=list(MASK_CANVAS)),
         note="launches_counted_at_load: kernels.LAUNCHES counts an aot "
              "artifact's warm-up and capture only (a replay runs no "
              "Python); launches_profiled: read by kernel name from a "
              "profile of a call", **out)
    return paths


def phase_serving_move(dev) -> dict:
    """``load_serving(path, device=...)`` at the flagship's full width (its
    YAML, R-50-C4 at 608x1216, random weights from seed 0, scores spread),
    in float32 and bfloat16. A ``stablehlo`` artifact exported on the card
    and loaded on the CPU, against the eager forward of a CPU copy of the
    model on the same weights and batch (the operators' plain versions run);
    one exported on the CPU from that copy and loaded on the card, against
    the card-exported artifact's request on the card, its launches counted
    (kernels.LAUNCHES, set to 0 before the request) and profiled. Both
    comparisons bit for bit. Export, load and CPU forward seconds; the two
    artifacts' requests on the card in turns. Returns the kernel line's
    paths: path -> (no sites, launches of the CPU-exported artifact's
    request, no device times)."""
    from da_detect_tpu_torch.engine.serving import (export_serving,
                                                    load_serving)

    cpu = torch.device("cpu")
    paths, faults = {}, []
    with tempfile.TemporaryDirectory(prefix="chip_smoke_move_") as root:
        for dtype in ("float32", "bfloat16"):
            name = label("serving_move", dtype)
            cfg, fn, model, batches = flagship_model(dev, dtype)
            batch, variables = batches[0], model.state_dict()
            card_art = os.path.join(root, f"card_{dtype}.pt2")
            cpu_art = os.path.join(root, f"cpu_{dtype}.pt2")
            out = dict(dtype=dtype, canvas=list(CANVAS))
            t0 = time.perf_counter()
            export_serving(cfg, model, variables, card_art, fmt="stablehlo")
            out["card_export_s"] = time.perf_counter() - t0
            on_card = load_serving(card_art)
            card_out = on_card(variables, batch)

            host = cpu_model_copy(model, cfg)
            host_vars, host_batch = host.state_dict(), batch.to(cpu)
            t0 = time.perf_counter()
            with torch.no_grad():
                eager_cpu = host(host_batch)
            out["cpu_eager_s"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            to_cpu = load_serving(card_art, device="cpu")
            out["card_to_cpu_load_s"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            got_cpu = to_cpu(host_vars, host_batch)
            out["card_to_cpu_request_s"] = time.perf_counter() - t0
            out["card_to_cpu"] = dict(
                device=str(to_cpu.device), exported_on=to_cpu.meta.get(
                    "exported_on"),
                valid=int(got_cpu.valid.sum()),
                first_difference=output_difference(eager_cpu, got_cpu))
            del to_cpu, eager_cpu, got_cpu

            t0 = time.perf_counter()
            export_serving(cfg, host, host_vars, cpu_art, fmt="stablehlo")
            out["cpu_export_s"] = time.perf_counter() - t0
            del host, host_vars, host_batch
            t0 = time.perf_counter()
            to_card = load_serving(cpu_art, device=dev)
            out["cpu_to_card_load_s"] = time.perf_counter() - t0
            clear_counts()
            got_card = to_card(variables, batch)
            torch.cuda.synchronize()
            counted = read_counts(PER_FORWARD, 1, name, "requests")
            profile = request_profile(lambda: to_card(variables, batch))
            out["cpu_to_card"] = dict(
                device=str(to_card.device),
                exported_on=to_card.meta.get("exported_on"),
                valid=int(got_card.valid.sum()), launches_counted=counted,
                launches_profiled=profile.pop("launches"), profile=profile,
                first_difference=output_difference(card_out, got_card),
                eager_first_difference=output_difference(
                    fn(model, batch), got_card))
            out["steady"] = in_turns(dict(
                card_export=lambda: on_card(variables, batch),
                cpu_export=lambda: to_card(variables, batch)))
            emit(name, **out)
            want = {k: n for k, n in PER_FORWARD.items() if n}
            if out["card_to_cpu"]["first_difference"] \
                    or out["cpu_to_card"]["first_difference"] \
                    or out["cpu_to_card"]["launches_profiled"] != want:
                faults.append(name)
            paths[name] = ([], counted, {})
            del on_card, to_card, fn, model, batches, batch, variables
            torch.cuda.empty_cache()
    if faults:
        raise AssertionError(f"moved serving artifacts differ: {faults}")
    return paths


def cpu_model_copy(model, cfg):
    """A copy of ``model`` (built for ``cfg``: its parameters and buffers)
    on the CPU, channels-last, as ``entry.prepare_model`` puts a model
    there."""
    from da_detect_tpu_torch.entry import prepare_model
    from da_detect_tpu_torch.models import build_detection_model

    host = build_detection_model(cfg)
    host.load_state_dict(model.state_dict())
    return prepare_model(host, torch.device("cpu"))


def rewrite_meta(src: str, dst: str, **changes) -> None:
    """Copy serving artifact ``src`` to ``dst`` with its metadata
    changed."""
    import zipfile

    from da_detect_tpu_torch.engine.serving import META_FILE

    with zipfile.ZipFile(src) as zin, zipfile.ZipFile(dst, "w") as zout:
        for item in zin.infolist():
            data = zin.read(item.filename)
            if item.filename.endswith(f"extra/{META_FILE}"):
                data = json.dumps({**json.loads(data), **changes}).encode()
            zout.writestr(item, data)


def path_summary(sites, launches: int, device=None) -> dict:
    """A kernel's launches in a path's run, and its times and bound summed
    over the sites of one forward or step of that path: CUDA events around
    each call or, where ``device`` gives them (the gathers), device times
    from the profiler, the event times then kept as ``*call_ms``. A path
    that launched the kernel but timed no site of it gives its launches
    alone."""
    if not sites and not device:
        return dict(launches=launches)
    bound_ms, by = bound(sum(s["bytes"] for s in sites),
                         sum(s["operations"] for s in sites))
    library = [s.get("library_ms") for s in sites]
    out = dict(
        launches=launches, ms=sum(s["ms"] for s in sites),
        plain_ms=sum(s["plain_ms"] for s in sites), bound_ms=bound_ms,
        bound_by=by,
        library_ms=(sum(library) if library and None not in library
                    else None))
    if sites and all(s.get("device_ms") is not None for s in sites):
        # the kernels' own device time (profiler) beside the event time
        out["device_ms"] = sum(s["device_ms"] for s in sites)
    if device:
        for key in ("ms", "plain_ms", "library_ms"):
            out[key.replace("ms", "call_ms")] = out[key]
            out[key] = device[key]
    return out


def kernel_line(paths: dict, errs: dict, summaries: dict) -> dict:
    """One row a kernel and dtype: float32 rows named as the kernel,
    bfloat16 rows "<kernel>_bf16" (BF16_KERNELS). ``paths``: path -> (sites
    of one forward or step, launches of the path's run, device times by
    kernel), bfloat16 paths named "<path>_bf16"; ``errs``: row name -> its
    largest error; ``summaries``: row name -> path -> a summary made
    elsewhere (the scatter-add's). The row's own numbers are those of its
    main path (MAIN_PATH, or its bfloat16 run): ``launches`` counts that
    path's whole run (train: TRAIN_STEPS steps; dcn: 4 requests; dcn_quad:
    1 request; dcn_train: DCN_TRAIN_STEPS or BF16_DCN_TRAIN_STEPS steps),
    ms, plain_ms, library_ms and the bound sum one step's or forward's
    launches. Every path of the row's dtype that ran the kernel stands
    under ``paths`` (NMS, float32 in both dtypes: every path)."""
    rows = []
    for name, (source, replaces) in SOURCES.items():
        for dtype in ("float32", "bfloat16"):
            if dtype == "bfloat16" and name not in BF16_KERNELS:
                continue
            row_name = label(name, dtype)
            per_path = {}
            for path, (sites, launches, device) in paths.items():
                if name in BF16_KERNELS and path.endswith("_bf16") != (
                        dtype == "bfloat16"):
                    continue
                mine = [s for s in sites if s["kernel"] == name]
                if mine or launches.get(name):
                    per_path[path] = path_summary(
                        mine, launches.get(name, 0), device.get(name))
            per_path.update(summaries.get(row_name, {}))
            main = label(MAIN_PATH[name], dtype)
            row = dict(name=row_name, route="cuda", source=source,
                       replaces=replaces, dtype=dtype, **per_path[main],
                       max_abs_err=errs[row_name], main_path=main,
                       paths=per_path)
            if not name.startswith("row_"):
                row["sites"] = [
                    {k: s[k] for k in ("path", "site", "ms", "device_ms",
                                       "plain_ms", "bound_ms", "bound_by")
                     if k in s}
                    for path, (sites, _, _) in paths.items()
                    if path in per_path for s in sites
                    if s["kernel"] == name]
            rows.append(row)
    return {"kernels": rows}


def run_dtype(dev, dtype: str) -> tuple[dict, dict, dict, list]:
    """Every main path in ``dtype``: the flagship eval forward and its
    times, the flagship train step and its kernels' times, the step through
    DDP (and, in float32, over two ranks), the DCN eval forward ("four" and
    "quad") and its times, the DCN train step, the Cityscapes Mask R-CNN's
    eval forward with masks and its source-only train step, Keypoint
    R-CNN's eval forward with keypoints and its train step, the FBNet
    models' eval forwards and the FBNet mask model's train step,
    RetinaNet's eval forward and train step, and the VGG-16 DA-Faster
    R-CNN's eval forward and triplet train steps. Returns (paths for
    ``kernel_line``, the largest error a kernel, the scatter-add's summary,
    the paths whose float32 ROIAlign and NMS launches a bfloat16 model made:
    (path, sites, launches, errors) each, for ``add_f32_path``)."""
    model, fn, batches, captured, eval_launches, eval_errs = phase_slice(
        dev, dtype)
    eval_sites = phase_times(model, fn, batches, captured, dtype)
    phase_roi_pool(captured, dtype)
    del model, fn, batches, captured
    captured, train_launches, train_errs = phase_train(dev, dtype)
    train_sites = time_sites(captured, label("train", dtype),
                             ("rpn_source", "rpn_target")
                             if dtype == "float32" else ())
    emit(label("train_times", dtype), sites=train_sites)
    del captured
    ddp = {label("ddp", dtype): ([], phase_ddp(dev, dtype), {})}
    if dtype == "float32":
        ddp.update({path: ([], launches, {}) for path, launches in
                    phase_ddp2(dev).items()})
    (model, fn, q_model, q_fn, batch, captured, q_captured, dcn_launches,
     quad_launches, dcn_errs) = phase_dcn(dev, dtype)
    dcn_sites, quad_sites, device = phase_dcn_times(
        model, fn, q_model, q_fn, batch, captured, q_captured, dtype)
    del model, fn, q_model, q_fn, batch, captured, q_captured
    dcn_train_sites, dcn_train_launches, scatter, dcn_train_errs = \
        phase_dcn_train(dev, dtype)
    (mask_sites, mask_launches, mask_train_sites, mask_train_launches,
     mask_errs) = phase_mask(dev, dtype)
    (kp_sites, kp_launches, kp_train_sites, kp_train_launches,
     kp_errs) = phase_keypoint(dev, dtype)
    fbnet_paths, fbnet_errs = phase_fbnet(dev, dtype)
    retina_paths, retina_errs = phase_retinanet(dev, dtype)
    vgg_paths, vgg_errs = phase_vgg(dev, dtype)
    errs = {}
    parts = [eval_errs, train_errs, dcn_errs, dcn_train_errs, mask_errs,
             kp_errs, retina_errs, vgg_errs]
    f32_paths = []
    if dtype == "float32":
        parts.append(fbnet_errs)
    else:
        # the bfloat16 FBNet model pools float32 maps (its BatchNorm's):
        # its launches belong to the float32 rows
        f32_paths = [(path, sites, launches, fbnet_errs)
                     for path, (sites, launches) in fbnet_paths.items()]
        fbnet_paths = {}
    for part in parts:
        merge_errs(errs, part)
    paths = {label("eval", dtype): (eval_sites, eval_launches, {}),
             label("train", dtype): (train_sites, train_launches, {}),
             label("dcn", dtype): (dcn_sites, dcn_launches, device),
             label("dcn_quad", dtype): (quad_sites, quad_launches, device),
             label("dcn_train", dtype): (dcn_train_sites, dcn_train_launches,
                                         {}),
             label("mask_eval", dtype): (mask_sites, mask_launches, {}),
             label("mask_train", dtype): (mask_train_sites,
                                          mask_train_launches, {}),
             label("keypoint_eval", dtype): (kp_sites, kp_launches, {}),
             label("keypoint_train", dtype): (kp_train_sites,
                                              kp_train_launches, {}), **ddp,
             **{path: (sites, launches, {}) for path, (sites, launches) in
                {**fbnet_paths, **retina_paths, **vgg_paths}.items()}}
    return paths, errs, scatter, f32_paths


def run_data_path(dev) -> tuple[dict, dict]:
    """The data, CLI and TTA phases on the smoke datasets (written to a
    temporary directory, removed at the end), then the dataset tools'
    phase. Returns the TTA merge's NMS site and the tools phase's
    launches."""
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as root:
        data = smoke_datasets(root)
        cold = phase_data(dev, data)
        trained = phase_cli_train(dev, data)
        phase_cli_eval(dev, data, trained)
        phase_stage(dev, data, cold)
        tta = phase_tta(dev, data)
    return tta, phase_tools(dev)


def add_f32_path(line: dict, path: str, sites: list, launches: dict,
                 errs: dict) -> None:
    """A bfloat16 model's path that runs the float32 NMS and ROIAlign
    kernels ("sanity_bf16", the GN model's ablation run; the bfloat16 FBNet
    paths, whose BatchNorm outputs float32) in the float32 rows of the
    kernels it ran: its launches, its sites' times and bound, its
    errors."""
    for row in line["kernels"]:
        if row["name"] not in ("nms", "roi_align_fwd", "roi_align_bwd"):
            continue
        mine = [s for s in sites if s["kernel"] == row["name"]]
        if not mine and not launches.get(row["name"]):
            continue
        row["paths"][path] = path_summary(mine, launches[row["name"]])
        row["sites"] += [{k: s[k] for k in ("path", "site", "ms",
                                            "device_ms", "plain_ms",
                                            "bound_ms", "bound_by")
                          if k in s} for s in mine]
        row["max_abs_err"] = max(row["max_abs_err"],
                                 errs.get(row["name"], 0.0))


def tta_row(tta: dict) -> dict:
    """The kernel line's row of the TTA merge's NMS site (float32 boxes):
    its launches in the TTA run, times and bound summed over its images."""
    source, replaces = SOURCES["nms"]
    summary = path_summary(tta["sites"], len(tta["sites"]))
    return dict(name="nms_tta_merge", route="cuda", source=source,
                replaces=replaces, dtype="float32", **summary,
                max_abs_err=float(tta["err"]), main_path="tta_bf16",
                paths={"tta_bf16": summary},
                sites=[{k: s[k] for k in ("path", "site", "ms", "plain_ms",
                                          "bound_ms", "bound_by",
                                          "candidates")}
                       for s in tta["sites"]])


def main(argv=None) -> int:
    args = sys.argv[1:] if argv is None else argv
    data_only = args == ["--data-only"]
    spread = len(args) >= 3 and args[0] == "--gate-spread" \
        and args[1].isdigit() and int(args[1]) > 0 and args[2].isdigit() \
        and all(a.partition(":")[0] in SPREAD_CONDITIONS
                and (a.partition(":")[2] or "0").isdigit() for a in args[3:])
    if args and not data_only and not spread:
        print("usage: chip_smoke.py [--data-only | --gate-spread GATES RUNS "
              "[CONDITION[:FIRST] ...]]", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card only",
              file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = phase_env()
    phase_build()
    if data_only or spread:  # no kernel line
        if spread:
            gate_spread(dev, int(args[1]), int(args[2]),
                        args[3:] or list(SPREAD_CONDITIONS))
        else:  # the sanity, data, CLI, TTA and model CLI phases
            phase_sanity(dev)
            run_data_path(dev)
            phase_mask_cli(dev)
            phase_retina_fbnet_cli(dev)
            phase_keypoint_cli(dev)
            phase_demo(dev)
        emit("done", seconds=time.perf_counter() - t_start)
        print(smi)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0
    errs = phase_kernels(dev)
    phase_gather_sweep(dev)
    serving_paths = phase_serving(dev)
    serving_paths.update(phase_serving_move(dev))
    paths, f32_errs, scatter, _ = run_dtype(dev, "float32")
    for k, v in f32_errs.items():
        errs[k] = max(errs[k], v)
    bf16_paths, bf16_errs, bf16_scatter, f32_paths = run_dtype(dev,
                                                               "bfloat16")
    paths.update(bf16_paths)
    paths.update(serving_paths)
    for k, v in bf16_errs.items():
        key = label(k, "bfloat16") if k in BF16_KERNELS else k
        errs[key] = max(errs.get(key, 0.0), v)
    phase_derain(dev)
    aux_paths, aux_errs, aux_scatter = phase_aux(dev)
    for k, v in aux_errs.items():
        errs[k] = max(errs.get(k, 0.0), v)
    paths.update(aux_paths)
    sanity_sites, sanity_launches, sanity_errs = phase_sanity(dev)
    tta, tools_launches = run_data_path(dev)
    paths["tools_ddp_bf16"] = ([], tools_launches, {})
    paths["mask_cli_bf16"] = ([], phase_mask_cli(dev), {})
    fbnet_cli, retina_cli = phase_retina_fbnet_cli(dev)
    paths["retina_cli_bf16"] = ([], retina_cli, {})
    paths["keypoint_cli_bf16"] = ([], phase_keypoint_cli(dev), {})
    paths["demo_bf16"] = ([], phase_demo(dev), {})
    line = kernel_line(
        paths, errs, {"row_scatter_add": {"dcn_train": scatter,
                                          "aux_deform_pool": aux_scatter},
                      "row_scatter_add_bf16": {"dcn_train_bf16":
                                               bf16_scatter}})
    add_f32_path(line, "sanity_bf16", sanity_sites, sanity_launches,
                 sanity_errs)
    for path, sites, launches, path_errs in f32_paths:
        add_f32_path(line, path, sites, launches, path_errs)
    add_f32_path(line, "fbnet_cli_bf16", [], fbnet_cli, {})
    row = tta_row(tta)
    nms_row = next(r for r in line["kernels"] if r["name"] == "nms")
    nms_row["paths"]["tta_bf16"] = row["paths"]["tta_bf16"]
    line["kernels"].append(row)
    print(json.dumps(line))
    emit("done", seconds=time.perf_counter() - t_start)
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
