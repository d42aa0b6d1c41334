#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port (``sipmask_tpu_torch``) on one
NVIDIA GPU:

    python3 chip_smoke.py

It drives seven presets at full width with random weights from a seed
through the port's entry points, serving and then training each: the
high-accuracy ``sipmask_r50_fpn_gn_1x``, SipMask++
``sipmaskpp_r101_fpn_ssd_6x``, the real-time ``sipmask_r50_fpn_ssd_6x`` and
SipMask-VIS ``sipmask_vis_r50``, then all four again with
``compute_dtype="bfloat16"``; then ResNeXt-101 ``sipmask_x101_fpn_gn_ms_2x``
and HRNet-W32 ``sipmask_hrnet_w32_fpn_gn_1x`` in f32 and bf16, and the
SipMask-benchmark fork ``sipmask_benchmark_r50_fpn_1x``.

1. finds the card (no CUDA is an error), prints ``nvidia-smi``'s name and
   power limit and the backend flags it sets (TF32 off: plain f32; bf16
   products summed in f32, no reduced-precision reductions; cuDNN
   benchmark mode on, as for fixed shapes);
2. builds the kernels from ``sipmask_tpu_torch/csrc`` with nvcc, one nvcc
   per source, and the mask codec (``sipmask_tpu_torch/native/maskops.cpp``)
   and the JPEG codec (``native/jpeg.cpp``) with g++, all at once;
3. holds the serving kernels (K1, K4a) against their plain PyTorch versions
   at the slice's shapes, and times both at the batch-4 shapes (K1's and
   K4a's device time by kernel beside their event time; a K1 call must be
   its two kernels, the transpose of x into channels-last rows and the
   gather, a K4a call two kernels, and a K6 call at the decode's shapes at
   most one, its own);
4. answers 3 requests of one 800x1333 image through ``init_detector`` /
   ``inference_detector`` and runs one batch of 4 at 800x1344 twice through
   ``Detector.infer``, counting kernel launches;
5. runs the batch again with the plain versions and compares;
6. holds the training kernels (K2, K3a, K3b, K4b) against their plain
   versions at the train step's shapes, and times both at batch 4; splits
   one K2 sweep, one K3a and one K3b call, and one K4b sweep and call into
   their device kernels with ``torch.profiler`` (a K3a call must be two
   kernels and a K3b call three, each giving the same bits twice; a K4b
   call two kernels), and
   times ``torch.matmul`` on K2's two products as a yardstick of its GEMMs;
7. runs 3 SGD steps at 800x1344, batch 4, through ``create_train_state`` /
   ``make_train_step``, counting kernel launches, and checks the losses,
   the frozen stages and the gradients;
8. runs the first step again from the same weights with the plain versions
   and compares losses and gradients;
9. holds SipMask++'s kernels (K5 p-major deformable sampling, K5c its
   backward, K6 SP mask assembly) against their plain versions at the
   slice's shapes (the R101 DCN stages at 544x544 and at 576x576, batch 8;
   the decode's and the rescoring loss's mask grids, K6's masks a
   detection-major view with the plain version's zeros; K5c's d positions
   the same bits twice), and times them (K5c also at 576x576, with its
   device kernels by launch: a call must be its kernel after the zeroing
   of dx; K6 at both mask grids);
10. serves SipMask++: 3 requests of one 544x544 image and a batch of 8 twice
    through ``Detector.infer``, counting launches, then the batch with the
    plain versions (head outputs, detections and mask_scores compared);
11. trains SipMask++ for 3 SGD steps at 576x576, batch 8, counting
    launches, checks losses (loss_iou included), frozen stages and every
    DCN offset conv's gradient, then runs the first step again, the
    backbone's ReLUs pinned to one set of masks in every run: with the
    kernels, with the plain versions, with only K5 or only K5c launching
    (the rest plain), and with the plain versions in float64; compares each
    f32 run with the plain one and reads each against the float64 one;
12. writes a synthetic COCO set of 8 JPEG images (640x480, 640x427,
    500x375, 612x612, twice each, 8-16 instances, polygons and RLE;
    quality 95, 4:2:0) with ``tools/synth_coco.py``, times the loader's
    host work per batch and its JPEG reads, and
    trains the flagship through ``train_detector`` (batch 4, 800x1344
    buckets, 2 steps an epoch): 4 steps from bumped weights given as
    ``load_from``, then a resume that must start at step 4 from epoch_2
    with its weights and momentum and end at step 6; checks the losses
    (finite, loss_mask > 0), the frozen stages, the train log and
    last_checkpoint; profiles the resumed steps (the device's idle share)
    and times the driver's steps against a bare ``make_train_step`` on the
    same batches;
13. runs ``run_inference`` over the set at batch 4 from the last
    checkpoint and ``evaluate_coco`` (bbox, segm), and holds every image's
    results against ``inference_detector`` (boxes, labels, pasted masks,
    RLEs that decode);
14. serves the real-time preset (R50, FPN 256, a norm-free 2-conv head
    with ``ssd_flag``, fast NMS) at 544x544: 3 requests of 480x640,
    427x640 and 640x480 images (stretched, sx != sy) and a batch of 8
    twice, K1 launching 5 times a forward and K6 once a decode, then the
    batch with the plain versions (head outputs and detections compared);
15. trains the real-time preset through ``train_detector`` on phase 12's
    set as the preset stands (the SSD augmentations, repeat_times 3, the
    576x576 stretch, batch 8) for 6 steps from bumped weights whose frozen
    BN is fitted to a loader batch: finite losses, loss_mask > 0, no
    GroupNorm launch; the loader's host ms, the driver's steps against a
    bare ``make_train_step`` on the same batches and the device's idle
    share;
16. tracks one in-memory video with SipMask-VIS (8 frames of 720x1280,
    four shapes moving, two crossing; 360x640 padded to 384x640) through
    ``run_video_inference`` (batch 1 a frame, the tracker on the device,
    masks pasted and RLE-encoded), launches counted exactly (K1 5, K4a 36
    and K6 1 a frame), ms per frame by section, the video again under the
    profiler (the device's idle share, frames/s), then with the plain
    versions: head outputs (track_feats included), detections per frame and
    the object ids of matched detections compared;
17. trains SipMask-VIS for 3 SGD steps at 384x640, batch 4, current and
    reference frames (``vis_pair_batch``): finite losses, loss_mask and
    loss_match > 0, match_acc, frozen stages, non-zero track-branch
    gradients, step ms and peak memory; then the first step with the plain
    versions (losses and gradients compared);
18. writes a synthetic YouTube-VIS set (``tools/synth_ytvis.py``, 4 videos
    of 6 JPEG frames at 360x360), trains SipMask-VIS on it through
    ``train_detector`` for 4 steps from bumped weights and resumes it to
    step 6 (train log, last_checkpoint, YTVIS classes in the checkpoint,
    the driver's steps against a bare ``make_train_step``, idle share), then
    tracks its videos from the last checkpoint with ``run_video_inference``
    and scores them with ``YTVOSEvaluator`` (frames/s; every RLE decodes);
19. holds the bf16 variants of K1, K2, K4a and K4b
    (``compute_dtype="bfloat16"``: bf16 activations, f32 offsets,
    statistics, sums and weight gradients) against their plain bf16
    versions at the flagship's shapes, each within one bf16 unit of its
    output's max (K1 bf16 also at the 544, 576, VIS and HRFPN levels, at
    far and zero offsets, giving the same bits twice), checks that a K1
    bf16 call is its two kernels, by name, and that the
    bf16 tap contraction (``torch.matmul``) sums in f32, and times them at
    batch 4 (bounds with bf16 tensors at 2 bytes an element and K2's
    products at the dense bf16 tensor-core rate; F.grid_sample and
    F.group_norm with ReLU and its autograd in bf16 as the library calls;
    K1 bf16's sweep split by device kernel and level, and the 544 levels'
    sweep at batch 8 timed the same way);
    K2 bf16 (wgmma GEMMs fed by TMA, a float4 scatter) also gives
    the same d offsets and dw2 bits in two calls, logs its sweep's split
    by device kernel with its GEMMs' TFLOP/s beside ``torch.matmul`` in
    bf16 on the same two products (a yardstick), and runs the kernels the
    source states in one call at P3 (six) and at P5 (seven: the copy of dy
    and cols into padded rows); K4a and K4b bf16 are held at every
    flagship level, a VIS and an HRFPN level and a slab past what a
    cluster holds, with and without the ReLU, each giving the same bits
    twice; a call at P3 must be one device kernel each (the cluster
    kernels) and past capacity two each (the two-pass kernels), and their
    sweeps' device ms are split by level and kernel;
20. serves the flagship in bf16: 3 requests of one 800x1333 image and a
    batch of 4 at 800x1344 twice, launches counted (bf16 kernels only), the
    head outputs bf16 but the f32 box regressions, then the batch with the
    plain versions, and in f32 on the same weights (head outputs and
    detections compared);
21. trains the flagship in bf16 for 3 SGD steps at 800x1344, batch 4: f32
    parameters with finite f32 gradients, finite losses, loss_mask > 0,
    frozen stages unchanged, step ms and peak memory; then the first step
    with the plain versions (losses and gradients compared);
22. serves the real-time preset in bf16 at 544x544 as phase 14 (3
    requests, a batch of 8 twice), then plain and f32 as phase 20;
23. holds the bf16 variants of K5 and K5c (bf16 rows and cotangents, f32
    positions, an f32 dx scratch rounded once) against their plain bf16
    versions at the R101 DCN stages' shapes at 544x544 and 576x576, batch
    8 (random offsets with a third +-300 px out, and zero offsets), on the
    vector path at Cg = 36 and on the scalar path (Cg = 18), each within
    one bf16 unit of its output's max, d positions the same bits twice,
    and times them (bounds at 2 bytes a bf16 element; F.grid_sample in
    bf16 and its autograd as the library calls); each stage's call split
    by device kernel (a K5 call its gather, a K5c call the memset of its
    f32 dx, its scatter and its rounding, or the phase fails), with the
    device ms of a SipMask++ pass's 2 + 8 + 1 DCN convs;
24. serves SipMask++ in bf16 (3 requests at 544x544, a batch of 8 twice;
    no f32 kernel variant may launch), then the batch again with the
    kernels, each K5 call held within one bf16 unit of its plain version
    on the call's own inputs, and with the plain versions, the backbone's
    ReLUs and DCN sampling floors pinned in both to those of one plain
    forward (the calibrated random R101 puts pre-activations and positions
    within rounding of a kink): head outputs and detections (scores and
    mask scores), kernels vs plain, within stated bf16 bounds; bf16 vs f32
    on the same weights logged;
25. trains SipMask++ in bf16 for 3 SGD steps at 576x576, batch 8 (f32
    parameters and gradients, every DCN offset conv and the rescoring head
    train), then the first step with the kernels (each K5 and K5c call held
    as in phase 24) and with the plain versions, pinned as in phase 24:
    losses and gradients, kernels vs plain, within stated bf16 bounds;
26. tracks phase 16's video with SipMask-VIS in bf16 (launches exactly as
    phase 16's, in their bf16 variants; kernels vs plain within the bf16
    bounds of phase 20, the matched detections' object ids too), and
    trains it in bf16 for 3 steps at 384x640, batch 4, with reference
    frames (first step kernels vs plain: losses and gradients within
    stated bounds);
27. serves ResNeXt-101 32x4d (grouped conv2s) as phases 4-5 (3 requests at
    800x1333, a batch of 4 at 800x1344 twice, then plain) and trains it as
    phases 7-8 (3 SGD steps at batch 4, then plain), each path with one
    more batch or step under the profiler (peak memory, the device's idle
    share); then one bf16 batch twice with plain and f32 comparisons as
    phase 20, and 3 bf16 steps as phase 21;
28. the same for HRNet-W32 with HRFPN (levels 100x168 ... 12x21, 6x10:
    floor pools), its first step with every K1, K2, K4a and K4b call held
    against its plain version on the call's own inputs (CHECKED_TOL), and
    those calls replayed through each kernel and its plain version in
    turns (ms a five-level sweep at HRFPN's shapes);
29. trains the benchmark fork (GIoU on ltrb, the NMS-0.9 dedup of the mask
    positives, the x0.5 cap) as phase 7-8, logging the dedup's selected and
    kept positives and its ms, the kept counts of the kernel and plain runs
    compared (within 1%, and fewer kept than selected), then serves it as
    phases 4-5 (hard NMS at IoU 0.6);
30. (run after phase 18, on phase 12's set) the test path: the C++ mask
    codec (built with g++ in phase 2 beside the kernels; ``g++ --version``;
    the library loaded must be this checkout's build under build/native)
    against its plain numpy versions on seeded random masks (1x1, 7x13,
    480x640; empty, full, noise, rectangles) and on phase 13's results and
    gts: counts byte for byte, areas, IoUs (crowd too), intersections and
    greedy matches equal; ``run_inference`` from phase 12's last checkpoint
    (device paste, one copy of the thresholded masks a batch, one
    ``encode_masks`` call an image: images/s, paste and encode ms, MB
    copied), then each batch's detections through that post-processing and
    through the plain host path (the f32 masks copied, resized in numpy,
    the numpy codec): every RLE decodes to the other path's mask with
    PASTE_SAME_MIN of its pixels equal (differing pixels counted), images/s
    and MB a batch of each; ``evaluate_coco`` (bbox, segm, proposal_fast)
    through the codec and through the plain versions, equal stats; the
    flagship served with soft-NMS, linear and gaussian (phase 4's batch of
    4 at 800x1344 twice through ``Detector.infer``: K1 5, K4a 40 and K6 1
    launches a forward and decode exactly; the decode's ms and its
    synchronising CUDA calls), its NMS candidates read back and the
    detections held against a float64 host oracle of sequential per-class
    soft-NMS (the same (row, label) set, scores within SOFT_SCORE_RTOL);
    and phase 16's paste ms a frame;
31. (run after phase 2) the JPEG codec on the host: every fixture of
    ``tests/data/jpeg`` decoded (progressive, 4:4:0, 4:1:1, restarts,
    grey, CMYK, RGB, EXIF orientation 6, stray bytes, a file cut short)
    and every seeded image encoded, each digest held against the one cv2
    gave (``digests.json``); the median ms of 20 decodes and of 20 encodes
    of a 640x480 quality-95 4:2:0 image, logged with ``lscpu``'s model
    name beside the card's name and power limit; the library loaded must
    be this checkout's build under build/native.

Each path (phases 4, 7, 10, 11, 12, 13, 14, 15, 16, 17, 18's two, 20-22,
24-29 and 30's soft-NMS serving) is driven with every launch count set to
0 just before it and read just after;
a kernel of the path that did not launch fails the run, and so does an f32
kernel variant on a bf16 path. Any failure raises (non-zero exit, no
result). Each phase's seconds are logged. The second-to-last line is a JSON
object of the kernels, the six bf16 variants as kernels of their own
(launches summed over the thirty paths, with each path's count beside them;
errors and times from phases 3, 6, 9, 19 and 23; each kernel's bound and a
one-call PyTorch equivalent's time where there is one); the last is the
device line.
"""

import contextlib
import json
import os
import shutil
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import torch

SEED = 0
CONFIG = "sipmask_r50_fpn_gn_1x"
IMAGE_HW = (800, 1333)   # at the test scale: padded to 800x1344, no resize
BATCH = 4
LEVELS = [(100, 168), (50, 84), (25, 42), (13, 21), (7, 11)]  # 800x1344
CHANNELS, DEFORM_GROUPS, GN_GROUPS = 256, 4, 32
# phase 19's K4 shapes beside LEVELS: a VIS level (384x640's P3), an HRFPN
# level (floor-pooled) and a slab past what a cluster holds (the two-pass
# kernels)
VIS_GN_LEVEL, HRFPN_GN_LEVEL, GN_PAST_CAPACITY = (48, 80), (12, 21), (
    256, 272)
# phase 19's K1 bf16 level sets beside LEVELS (batch 2): SipMask++ and the
# real-time preset serving at 544x544 and training at 576x576, VIS at
# 384x640, HRFPN's floor-pooled levels; the 544 set is also timed at batch
# 8 (the SipMask++ and real-time serving batch)
K1_BF16_SETS = {"544x544": [(68, 68), (34, 34), (17, 17), (9, 9), (5, 5)],
                "576x576": [(72, 72), (36, 36), (18, 18), (9, 9), (5, 5)],
                "384x640": [(48, 80), (24, 40), (12, 20), (6, 10), (3, 5)],
                "HRFPN": [(12, 21), (6, 10)]}
K1_TOL = 1e-5     # abs: the same four f32 products, FMA-fused in the kernel
K4_TOL = 1e-4     # abs: f32 sums over up to 134400 elements, reordered
HEAD_TOL = 1e-3   # relative to max |x|: the above through up to 9 layers
MATCH_MIN = 0.98  # share of detections the plain run must reproduce
# relative to each output's max |value|: K2's 3xTF32 GEMMs drop the
# small*small products and sum 256 or B*P products in another order than
# cuBLAS, and its dX atomics add in run-to-run order; K3 sums 32-term dots
# over up to 268800 pixels in another order than the plain matmuls; K4b sums
# up to 16800 elements per channel, reordered
TRAIN_KERNEL_TOL = 1e-5
LOSS_TOL = 1e-4   # relative: forward values differ by the kernels' rounding
# relative to each tensor's max |g|: the kernels' rounding through the
# backward of ~70 layers, and cuDNN's algorithm picks in the two runs
GRAD_TOL = 1e-3
MASK_HW, MAX_POS, MAX_GTS, TRAIN_STEPS = (400, 672), 512, 64, 3
# phases 27-29: the last three image presets, at the flagship's shapes
X101_CONFIG = "sipmask_x101_fpn_gn_ms_2x"
HR_CONFIG = "sipmask_hrnet_w32_fpn_gn_1x"
FORK_CONFIG = "sipmask_benchmark_r50_fpn_1x"
# each K1, K2, K4a and K4b call of an HRNet step against its plain version
# on the call's own inputs, relative to each output's max: phase 3's K1
# bound; K2 and K4 ten times phase 6's, as the path's activations span
# more magnitudes than phase 6's unit normals
CHECKED_TOL = {"deform_im2col": 1e-5, "deform_conv_backward": 1e-4,
               "gn_relu_forward": 1e-4, "gn_relu_backward": 1e-4}
PP_CONFIG = "sipmaskpp_r101_fpn_ssd_6x"
PP_HW, PP_TRAIN_HW, PP_BATCH, PP_MAX_POS = (544, 544), (576, 576), 8, 256
# the R101 DCN stages' conv2 at 544x544 (serving) and 576x576 (training):
# (channels = Cg = O, h, w)
PP_DCN = [(128, 68, 68), (256, 34, 34), (512, 17, 17)]
# DCN convs of those stages in one SipMask++ pass (DCN on blocks b % 3 == 0
# of R101's 4, 23 and 3 blocks)
PP_DCN_CALLS = (2, 8, 1)
PP_DCN_TRAIN = [(128, 72, 72), (256, 36, 36), (512, 18, 18)]
K5_TOL = 1e-5     # abs: the same four f32 products, FMA-fused in the kernel
K6_TOL = 1e-5     # abs: sigmoid of a 32-term f32 dot summed in another order
# SipMask++'s train step against the plain versions. Losses: relative; the
# rescoring target thresholds assembled masks at 0.4, where the kernels'
# rounding may flip a pixel, so loss_iou gets more room. Gradients,
# relative to each tensor's max |g|, with the backbone's ReLUs pinned to one
# set of masks in both runs: unpinned, the calibrated random backbone puts
# pre-activations within rounding of 0, the two runs' f32 rounding sends
# some to opposite sides, and each such kink moves a row of a weight
# gradient (3.7e-2 to 7.5e-2 of a tensor's max read on the card; on the CPU
# tests/test_torch_pp_train.py traces the same spread to the ReLU kinks).
# Pinned, the head, neck and rescoring gradients read 4.3e-3; the
# backbone's 1.0e-2, its DCN offset convs' 1.9e-2. Not separated in what
# is left: the one-sided floor derivative of the sampling positions, which
# jumps where the two runs' offsets put a position on either side of an
# integer (the run counts such positions per DCN block: 8 of 3.0M read),
# the head's own ReLU kinks, and the kernels' rounding through ~100
# layers. The limits are twice the readings; a dX or d-offsets dropped in
# one DCN block moves the gradients by their whole size.
PP_LOSS_TOL = {"loss_iou": 1e-2}
PP_GRAD_TOL, PP_BACKBONE_GRAD_TOL = 1e-2, 4e-2
# the pinned comparison's split: the same step with only K5 (the sampled
# route's forward) or only K5c (its backward) launching, the rest plain, and
# the plain step in float64 as the reference each f32 run is read against
PP_SPLIT = (("K5 only", ("deform_rows",)),
            ("K5c only", ("deform_rows_backward",)))
RT_CONFIG = "sipmask_r50_fpn_ssd_6x"
RT_HW, RT_TRAIN_HW, RT_BATCH = (544, 544), (576, 576), 8
# the real-time requests: COCO's common sizes (h, w), each stretched to
# 544x544 (sx != sy)
RT_SIZES = [(480, 640), (427, 640), (640, 480), (375, 500)]
RT_DRIVER_STEPS = 6   # 2 epochs of 3 (8 images, repeat_times 3, batch 8)
VIS_CONFIG = "sipmask_vis_r50"
# the VIS video: 8 frames of 720x1280, scaled to 360x640 and padded to the
# 384x640 bucket; training pairs at 384x640, batch 4
VIS_VIDEO_HW, VIS_FRAMES, VIS_HW, VIS_BATCH = (720, 1280), 8, (384, 640), 4
VIS_MAX_POS, VIS_MAX_GTS = 256, 64
# the train driver: 4 videos x 6 frames at 360x360, 6 steps an epoch
VIS_DRIVER_VIDEOS, VIS_DRIVER_FRAMES, VIS_DRIVER_SIZE = 4, 6, 360
# H100 SXM data sheet: HBM, f32 on the CUDA cores, dense TF32 and bf16
# tensor cores
HBM_BYTES_PER_S, F32_FLOP_PER_S, TF32_FLOP_PER_S = 3.35e12, 67e12, 495e12
BF16_FLOP_PER_S = 989e12
# bfloat16 (compute_dtype="bfloat16"): the flagship and the real-time
# preset. A bf16 kernel and its plain version round the same f32 values to
# bf16, but their f32 sums differ in order, so a value near a rounding
# boundary may land one bf16 unit apart: 2**-7 of the output's max bounds
# one unit anywhere (relative to each output's max |value|)
BF16_KERNEL_TOL = 2.0 ** -7
# the bf16 paths, kernels vs plain: such one-unit differences carried
# through the head (relative to each output's max), the detections they
# move, and the first step's losses (relative) and gradients (relative to
# each tensor's max), where a ReLU input on the other side of 0 in one run
# moves a row of a weight gradient. Read on the card: head 6.5e-3 to
# 7.4e-3, detections 0.96 or more, losses 1.4e-5 to 1.9e-5, gradients
# 7.2e-3 to 7.6e-3; the limits are about three times the readings
BF16_HEAD_TOL = 2e-2
BF16_MATCH, BF16_MATCH_MIN = (1.0, 1e-2), 0.9
# HRNet-W32 in bf16, kernels vs plain: the same one-unit differences of K1
# and K4a in the head (each call held within BF16_KERNEL_TOL on its own
# inputs: read 2.8e-3 to 5.0e-3) move more of its detections past
# BF16_MATCH than the flagship's: 0.81-1.0 of an image's matched in three
# calls (head outputs 8.2e-3 to 1.0e-2 apart); the limit lets about 2.5
# times the largest miss share (0.19) through
BF16_HR_MATCH_MIN = 0.5
# and its first step: each K1, K2, K4a and K4b call within BF16_KERNEL_TOL
# of its plain version on its own inputs (read 1.8e-3 to 5.3e-3); the
# head's one-unit differences then reach the stem through HRNet's backward
# (~250 convs): loss_mask 7.4e-5 and 1.3e-4 relative in two calls,
# gradients 3.5e-2 and 3.6e-2 of a tensor's max at the stem's conv2 (the
# rest up to 2.1e-2, the median over the tensors 4.4e-3 and 4.5e-3). About
# three to four times the readings
BF16_HR_LOSS_TOL, BF16_HR_GRAD_TOL = 5e-4, 0.1
BF16_HR_GRAD_MEDIAN_TOL = 1.5e-2
BF16_LOSS_TOL, BF16_GRAD_TOL = 1e-4, 2.5e-2
# SipMask++ in bf16, kernels vs plain. Every K5 and K5c call of the path is
# held against its plain version on the call's own inputs within
# BF16_KERNEL_TOL (read 5.6e-4 to 3.4e-3). End to end, the backbone's ReLUs
# and DCN sampling floors are pinned in both runs to those of one plain bf16
# forward, but that does not tame the calibrated random R101: it amplifies
# the kernels' one-unit differences of K5's and K1's samples through its
# ~100 linear layers (positions pinned, ReLUs pinned, three calls: head
# outputs read 0.30 to 0.45 of their max apart, detections 0.71-0.99
# matched; the first step's losses up to 1.1e-3 relative, loss_iou 2.1e-3,
# gradients up to 0.58 of a tensor's max, median over the tensors 0.12 to
# 0.125). One f32 forward's pins
# would pin bf16 to another network's kinks: f32 puts thousands of
# positions a DCN conv in another cell than bf16 and 9% of the backbone's
# ReLU inputs on the other side of 0 (the phases log it). So these bounds
# catch gross errors only; about twice the readings, the losses three
# times.
BF16_PP_HEAD_TOL = 0.9
BF16_PP_MATCH_MIN = 0.5
BF16_PP_LOSS_TOL, BF16_PP_LOSS_TOLS = 3e-3, {"loss_iou": 1e-2}
BF16_PP_GRAD_TOL, BF16_PP_GRAD_MEDIAN_TOL = 1.0, 0.3
# SipMask-VIS in bf16, the first step's losses, kernels vs plain
# (relative): loss_mask read 1.5e-4 in three calls and 2.4e-5 in one (the
# other losses 1.6e-5 at most); bf16 itself moves it 1.9e-3 from f32. The
# flagship's 1e-4 (phase 21) failed on it; about three times the reading
BF16_VIS_LOSS_TOL = 5e-4
# bf16 against f32 on the same weights, relative to the f32 output's max:
# a check for gross errors (the JAX package's own bf16 graph moves its
# outputs by 1-5% of their max on the CPU tests' shapes)
BF16_F32_TOL = 0.25
# phase 30: the share of a mask's pixels on which the device paste and the
# host's numpy resize must agree (they differ only where a probability
# rounds to either side of the 0.4 threshold), and the soft-NMS decode's
# scores against a float64 oracle (relative: f32 IoUs and decays, each
# ~1e-7, compounded over a candidate's few decays)
PASTE_SAME_MIN = 0.999
SOFT_SCORE_RTOL = 1e-5
# phase 16's paste ms a frame, for phase 30's log
VIS_TIMINGS = {}
KERNELS = {   # wrapper: (source, the TPU kernel it replaces)
    "deform_im2col": ("deform_im2col.cu",
                      "sipmask_tpu/ops/pallas/deform_gather.py:465"),
    "deform_conv_backward": ("deform_col2im.cu",
                             "sipmask_tpu/ops/pallas/deform_gather.py:878"),
    "mask_bce_forward": ("mask_bce.cu",
                         "sipmask_tpu/ops/pallas/mask_loss.py:248"),
    "mask_bce_backward": ("mask_bce.cu",
                          "sipmask_tpu/ops/pallas/mask_loss.py:282"),
    "gn_relu": ("gn_relu.cu", "sipmask_tpu/ops/pallas/group_norm.py:124"),
    "gn_relu_backward": ("gn_relu.cu",
                         "sipmask_tpu/ops/pallas/group_norm.py:174"),
    "deform_rows": ("deform_rows.cu",
                    "sipmask_tpu/ops/pallas/deform_gather.py:288, :381"),
    "deform_rows_backward": ("deform_rows.cu",
                             "sipmask_tpu/ops/pallas/deform_gather.py:724"),
    "assemble_masks": ("mask_assembly.cu",
                       "sipmask_tpu/ops/pallas/mask_assembly.py:66"),
    # the bf16 variants (compute_dtype="bfloat16"): the same sources and
    # wrappers, counted apart
    "deform_im2col_bf16": ("deform_im2col.cu",
                           "sipmask_tpu/ops/pallas/deform_gather.py:465"),
    "deform_conv_backward_bf16": (
        "deform_col2im.cu", "sipmask_tpu/ops/pallas/deform_gather.py:878"),
    "gn_relu_bf16": ("gn_relu.cu",
                     "sipmask_tpu/ops/pallas/group_norm.py:124"),
    "gn_relu_backward_bf16": ("gn_relu.cu",
                              "sipmask_tpu/ops/pallas/group_norm.py:174"),
    "deform_rows_bf16": ("deform_rows.cu",
                         "sipmask_tpu/ops/pallas/deform_gather.py:288, :381"),
    "deform_rows_backward_bf16": (
        "deform_rows.cu", "sipmask_tpu/ops/pallas/deform_gather.py:724"),
}
PATH_KERNELS = {   # the kernels each driven path must launch
    "hi-acc serving": ("deform_im2col", "gn_relu", "assemble_masks"),
    "hi-acc training": ("deform_im2col", "deform_conv_backward",
                        "mask_bce_forward", "mask_bce_backward", "gn_relu",
                        "gn_relu_backward"),
    "sipmask++ serving": ("deform_im2col", "deform_rows", "assemble_masks"),
    "sipmask++ training": ("deform_im2col", "deform_conv_backward",
                           "mask_bce_forward", "mask_bce_backward",
                           "deform_rows", "deform_rows_backward",
                           "assemble_masks"),
    "hi-acc train driver": ("deform_im2col", "deform_conv_backward",
                            "mask_bce_forward", "mask_bce_backward",
                            "gn_relu", "gn_relu_backward"),
    "hi-acc test driver": ("deform_im2col", "gn_relu", "assemble_masks"),
    "rt serving": ("deform_im2col", "assemble_masks"),
    "rt train driver": ("deform_im2col", "deform_conv_backward",
                        "mask_bce_forward", "mask_bce_backward"),
    "vis serving": ("deform_im2col", "gn_relu", "assemble_masks"),
    "vis training": ("deform_im2col", "deform_conv_backward",
                     "mask_bce_forward", "mask_bce_backward", "gn_relu",
                     "gn_relu_backward"),
    "vis train driver": ("deform_im2col", "deform_conv_backward",
                         "mask_bce_forward", "mask_bce_backward", "gn_relu",
                         "gn_relu_backward"),
    "vis test driver": ("deform_im2col", "gn_relu", "assemble_masks"),
    "hi-acc bf16 serving": ("deform_im2col_bf16", "gn_relu_bf16",
                            "assemble_masks"),
    "hi-acc bf16 training": ("deform_im2col_bf16",
                             "deform_conv_backward_bf16", "mask_bce_forward",
                             "mask_bce_backward", "gn_relu_bf16",
                             "gn_relu_backward_bf16"),
    "rt bf16 serving": ("deform_im2col_bf16", "assemble_masks"),
    "sipmask++ bf16 serving": ("deform_im2col_bf16", "deform_rows_bf16",
                               "assemble_masks"),
    "sipmask++ bf16 training": ("deform_im2col_bf16",
                                "deform_conv_backward_bf16",
                                "mask_bce_forward", "mask_bce_backward",
                                "deform_rows_bf16",
                                "deform_rows_backward_bf16",
                                "assemble_masks"),
    "vis bf16 serving": ("deform_im2col_bf16", "gn_relu_bf16",
                         "assemble_masks"),
    "vis bf16 training": ("deform_im2col_bf16", "deform_conv_backward_bf16",
                          "mask_bce_forward", "mask_bce_backward",
                          "gn_relu_bf16", "gn_relu_backward_bf16"),
}
# ResNeXt-101, HRNet-W32 with HRFPN and the benchmark fork run the
# flagship's kernels on each path
for _p in ("x101", "hrnet", "fork"):
    for _kind in ("serving", "training"):
        PATH_KERNELS[f"{_p} {_kind}"] = PATH_KERNELS[f"hi-acc {_kind}"]
        if _p != "fork":
            PATH_KERNELS[f"{_p} bf16 {_kind}"] = \
                PATH_KERNELS[f"hi-acc bf16 {_kind}"]
# phase 30: soft-NMS serving drives the hi-acc serving path's kernels
PATH_KERNELS["hi-acc soft-nms serving"] = PATH_KERNELS["hi-acc serving"]
# the f32 variants, none of which a bf16 path may launch
F32_VARIANTS = ("deform_im2col", "deform_conv_backward", "gn_relu",
                "gn_relu_backward", "deform_rows", "deform_rows_backward")


def log(*args):
    print(*args, flush=True)


def wrappers():
    """The kernel wrappers by name, each with the attribute that holds its
    launch count: ``launches`` (f32), ``bf16_launches`` (the bf16
    variants)."""
    from sipmask_tpu_torch.ops import deform_conv, deform_sample, gn_relu
    from sipmask_tpu_torch.ops import mask_assembly, mask_loss
    fns = {"deform_im2col": deform_sample.deform_im2col,
           "deform_conv_backward": deform_conv.deform_conv_backward,
           "mask_bce_forward": mask_loss.mask_bce_forward,
           "mask_bce_backward": mask_loss.mask_bce_backward,
           "gn_relu": gn_relu.gn_relu,
           "gn_relu_backward": gn_relu.gn_relu_backward,
           "deform_rows": deform_sample.deform_rows,
           "deform_rows_backward": deform_sample.deform_rows_backward,
           "assemble_masks": mask_assembly.assemble_masks}
    out = {k: (fn, "launches") for k, fn in fns.items()}
    for k in F32_VARIANTS:
        out[k + "_bf16"] = (fns[k], "bf16_launches")
    return out


def reset_launches():
    for fn, attr in wrappers().values():
        setattr(fn, attr, 0)


def read_launches():
    return {k: getattr(fn, attr) for k, (fn, attr) in wrappers().items()}


def check_no_f32_variant(path, launches):
    """Raise if the bf16 ``path`` launched an f32 variant of a kernel."""
    f32_launched = [k for k in F32_VARIANTS if launches[k]]
    if f32_launched:
        raise AssertionError(f"the {path} path launched f32 kernels: "
                             f"{f32_launched}")


def check_path_launches(path, launches):
    """Raise unless every kernel of ``path`` launched in its run."""
    log(f"kernel launches in the {path} run: {launches}")
    idle = [k for k in PATH_KERNELS[path] if launches[k] <= 0]
    if idle:
        raise AssertionError(f"kernels of the {path} path never ran: {idle}")


def bound(nbytes, flops, tf32_flops=0.0, tc_rate=TF32_FLOP_PER_S):
    """(ms, 'bytes' or 'operations'): the least time the card could take to
    move ``nbytes`` (each input read once, each output written once) at the
    HBM rate, do ``flops`` f32 operations at the CUDA-core rate and
    ``tf32_flops`` tensor-core operations at ``tc_rate`` (TF32 by default;
    BF16_FLOP_PER_S for bf16 products; the two units run side by side, so
    the larger of the two times)."""
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    tf = max(flops / F32_FLOP_PER_S, tf32_flops / tc_rate) * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def last_runs(kern, want, reps):
    """The kernels of the last run of fn() among a session's ``kern`` (in
    launch order) of ``reps`` runs of ``want`` kernels each, where the
    profiler dropped only a prefix: the last two whole runs must match
    name for name (a run of another length than ``want`` never does), else
    []."""
    names = [e.name for e in kern]
    k = min(len(kern) // want, reps)
    if k < 2 or any(names[len(names) - i * want:len(names) - (i - 1) * want]
                    != names[len(names) - want:] for i in range(2, k + 1)):
        return []
    return kern[len(kern) - want:]


def launch_split(label, fn, attempts=3, want=None, reps=1):
    """Profile one fn() after a warm-up: log the launches and device ms of
    each device kernel it runs; return ({name: (launches, ms)}, kernels).

    The profiler in the card's sandbox sometimes misses kernels of a
    session (the first ones, or all), never adds any: each session starts
    with a marker kernel, and of ``attempts`` sessions (more, up to
    4 * ``attempts``, while every one has seen nothing, or fewer than
    ``want`` kernels where fn() is known to run ``want``) the one that saw
    the most kernels counts. With ``reps`` (and ``want``, the kernels of
    one fn()), a session runs fn() ``reps`` times and counts only with
    whole last runs (``last_runs``): late in a long run the profiler
    dropped the first 10 to 41 kernels of a session, which one fn() alone
    cannot outlast."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    seen, raw = [], []
    while len(seen) < attempts or (
            max(map(len, seen)) < (want or 1) and len(seen) < 4 * attempts):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            torch.cuda._sleep(1000)
            torch.cuda.synchronize()
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        kern = sorted((e for e in prof.events()
                       if e.device_type == DeviceType.CUDA
                       and "spin_kernel" not in e.name),
                      key=lambda e: e.time_range.start)
        raw.append(len(kern))
        seen.append(last_runs(kern, want, reps) if reps > 1 else kern)
    kern = max(seen, key=len)
    split = {}
    for e in kern:
        n, ms = split.get(e.name, (0, 0.0))
        split[e.name] = (n + 1, ms + e.device_time / 1e3)
    log(f"split of {label}: {len(kern)} device kernels (sessions saw "
        f"{raw}" + (f" in {reps} runs, one whole run in "
                    f"{sum(map(bool, seen))}" if reps > 1 else "") + "), "
        f"{sum(ms for _, ms in split.values()):.4f} ms device time: "
        + "; ".join(f"{name[:70]} x{n} {ms:.4f} ms" for name, (n, ms) in
                    sorted(split.items(), key=lambda kv: -kv[1][1])))
    if not kern:
        raise AssertionError(f"the profiler saw no device kernel of {label}")
    return split, len(kern)


def sweep_split(label, calls, names, per_call, reps=4, attempts=5):
    """Profile a sweep (one call of each of ``calls``, of ``per_call``
    device kernels each) ``reps`` times a session, as :func:`launch_split`
    does, and log each call's device ms by kernel from the last whole run;
    return the sweep's device ms (0 when no session held two whole runs
    alike, which is logged)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for fn in calls:
        fn()
    torch.cuda.synchronize()
    want = sum(per_call)
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            torch.cuda._sleep(1000)
            torch.cuda.synchronize()
            for _ in range(reps):
                for fn in calls:
                    fn()
            torch.cuda.synchronize()
        kern = last_runs(sorted(
            (e for e in prof.events() if e.device_type == DeviceType.CUDA
             and "spin_kernel" not in e.name),
            key=lambda e: e.time_range.start), want, reps)
        if kern:
            break
    else:
        log(f"split of {label}: no session held two whole runs of {want} "
            f"kernels")
        return 0.0
    i = 0
    for name, n in zip(names, per_call):
        log(f"  {label} {name}: " + "; ".join(
            f"{kernel_name(e.name)} {e.device_time / 1e3:.4f} ms"
            for e in kern[i:i + n]))
        i += n
    return sum(e.device_time for e in kern) / 1e3


def kernel_name(name):
    """A device kernel's name without its namespace and arguments."""
    import re
    m = re.search(r"([A-Za-z_]\w*)(<[^(]*>)?\(", name)
    return (m.group(1) + (m.group(2) or ""))[:50] if m else name[:50]


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def grid_sample_rows(x_rows, pyx, h, w):
    """``F.grid_sample`` set up to compute K5/K1's bilinear sampling (zero
    outside, corner-aligned): x_rows (N, h*w, Cg) -> NCHW input, pyx ->
    normalised grid. Returns (call, its input, its grid); the set-up is
    outside the call. Timed as the one-call library equivalent only."""
    import torch.nn.functional as F
    n, _, cg = x_rows.shape
    inp = x_rows.reshape(n, h, w, cg).permute(0, 3, 1, 2).contiguous()
    grid = torch.stack([pyx[..., 1] / (w - 1) * 2 - 1,
                        pyx[..., 0] / (h - 1) * 2 - 1], -1).contiguous()

    def call(i=inp, g=grid):
        return F.grid_sample(i, g, mode="bilinear", padding_mode="zeros",
                             align_corners=True)
    return call, inp, grid


def turns(name, plain, kernel, iters=20):
    """Mean CUDA-event ms of kernel and plain, in the order plain, kernel,
    kernel, plain (means of the two turns each)."""
    p1, k1, k2, p2 = (cuda_ms(plain, iters), cuda_ms(kernel, iters),
                      cuda_ms(kernel, iters), cuda_ms(plain, iters))
    log(f"time {name}: kernel {k1:.4f} / {k2:.4f} ms, plain "
        f"{p1:.4f} / {p2:.4f} ms")
    return (k1 + k2) / 2, (p1 + p2) / 2


def cuda_ms(fn, iters=20, warmup=3):
    """Mean device milliseconds of fn() over iters, by CUDA events."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def errors(got, want):
    diff = float((got - want).abs().max())
    return diff, diff / max(float(want.abs().max()), 1e-30)


def k1_inputs(b, h, w, gen, dev):
    """FeatureAlign's deform-conv inputs at one level: offsets ~2 px, a
    third of the pixels +-300 px out of the map."""
    x = torch.randn((b, CHANNELS, h, w), generator=gen).to(dev)
    off = torch.randn((b, DEFORM_GROUPS * 18, h, w), generator=gen) * 2.0
    third = (h * w) // 3
    off.view(b, DEFORM_GROUPS * 18, h * w)[:, :, :third] *= 150.0
    return x, off.to(dev)


def phase_kernels(dev):
    from sipmask_tpu_torch.ops import deform_sample, gn_relu

    gen = torch.Generator().manual_seed(SEED)
    k1_err, k4_err = 0.0, 0.0
    for h, w in LEVELS:   # K1 at every FeatureAlign level, batch 2
        x, off = k1_inputs(2, h, w, gen, dev)
        got = deform_sample.deform_im2col(x, off, (3, 3), 1, 1, 1,
                                          DEFORM_GROUPS)
        want = deform_sample.deform_im2col_plain(x, off, (3, 3), 1, 1, 1,
                                                 DEFORM_GROUPS)
        torch.cuda.synchronize()
        ab, rel = errors(got, want)
        log(f"K1 deform_im2col {h}x{w} C={CHANNELS} G={DEFORM_GROUPS} bs2: "
            f"max_abs_err {ab:.3e} rel {rel:.3e} (tol abs {K1_TOL})")
        if not ab <= K1_TOL:
            raise AssertionError(f"K1 disagrees with its plain version at "
                                 f"{h}x{w}: {ab}")
        k1_err = max(k1_err, ab)
    for (h, w) in (LEVELS[0], LEVELS[2]):   # K4: towers at P3 and P5
        for act in (True, False):
            x = (torch.randn((2, CHANNELS, h, w), generator=gen) * 3 + 1
                 ).to(dev)
            wt = (torch.rand(CHANNELS, generator=gen) + 0.5).to(dev)
            bs = (torch.randn(CHANNELS, generator=gen) * 0.2).to(dev)
            got = gn_relu.gn_relu(x, wt, bs, GN_GROUPS, 1e-5, act)
            want = gn_relu.gn_relu_plain(x, wt, bs, GN_GROUPS, 1e-5, act)
            torch.cuda.synchronize()
            ab, rel = errors(got, want)
            log(f"K4 gn_relu {h}x{w} C={CHANNELS} act={act} bs2: max_abs_err "
                f"{ab:.3e} rel {rel:.3e} (tol abs {K4_TOL})")
            if not ab <= K4_TOL:
                raise AssertionError(f"K4 disagrees with its plain version "
                                     f"at {h}x{w} act={act}: {ab}")
            k4_err = max(k4_err, ab)

    # times at the batch-4 shapes of the main path, summed over the levels
    # (one FeatureAlign sweep; one GN site of a tower): plain, kernel,
    # kernel, plain, reporting the mean of the two turns of each
    k1_in = [k1_inputs(BATCH, h, w, gen, dev) for h, w in LEVELS]
    k4_in = [(torch.randn((BATCH, CHANNELS, h, w), generator=gen).to(dev),)
             for h, w in LEVELS]
    wt = torch.ones(CHANNELS, device=dev)
    bs = torch.zeros(CHANNELS, device=dev)
    runs = {
        "deform_im2col": (
            lambda: [deform_sample.deform_im2col(x, o, (3, 3), 1, 1, 1,
                                                 DEFORM_GROUPS)
                     for x, o in k1_in],
            lambda: [deform_sample.deform_im2col_plain(
                x, o, (3, 3), 1, 1, 1, DEFORM_GROUPS) for x, o in k1_in]),
        "gn_relu": (
            lambda: [gn_relu.gn_relu(x, wt, bs, GN_GROUPS) for (x,) in k4_in],
            lambda: [gn_relu.gn_relu_plain(x, wt, bs, GN_GROUPS)
                     for (x,) in k4_in]),
    }
    times = {name: turns(name + f" all 5 levels bs{BATCH}", plain, kernel)
             for name, (kernel, plain) in runs.items()}
    # K4a's event time is mostly its host's enqueue: its device time beside
    # it, and a call must be two kernels
    split, _ = launch_split(f"K4a gn_relu all 5 levels bs{BATCH}",
                            runs["gn_relu"][0])
    log(f"K4a gn_relu all 5 levels bs{BATCH}: CUDA events "
        f"{times['gn_relu'][0]:.4f} ms, device "
        f"{sum(ms for _, ms in split.values()):.4f} ms")
    _, n_kern = launch_split(
        f"K4a gn_relu, one call at {LEVELS[0]} bs{BATCH}",
        lambda: gn_relu.gn_relu(k4_in[0][0], wt, bs, GN_GROUPS))
    if n_kern != 2:
        raise AssertionError(f"a K4a call ran {n_kern} device kernels, not "
                             f"its two")
    # K1's device time by kernel, and a call must be its two kernels: the
    # transpose of x into channels-last rows, then the gather
    split, _ = launch_split(f"K1 deform_im2col all 5 levels bs{BATCH}",
                            runs["deform_im2col"][0])
    log(f"K1 deform_im2col all 5 levels bs{BATCH}: CUDA events "
        f"{times['deform_im2col'][0]:.4f} ms, device "
        f"{sum(ms for _, ms in split.values()):.4f} ms")
    split, n_kern = launch_split(
        f"K1 deform_im2col, one call at {LEVELS[0]} bs{BATCH}",
        lambda: deform_sample.deform_im2col(*k1_in[0], (3, 3), 1, 1, 1,
                                            DEFORM_GROUPS), attempts=5)
    names = list(split)
    if n_kern != 2 or not (
            any("deform_im2col_rows_kernel" in n for n in names) and
            any("deform_im2col_kernel" in n for n in names)):
        raise AssertionError(f"a K1 call ran {n_kern} device kernels, not "
                             f"its transpose and gather: {names}")
    # a K6 call at the decode's shapes must be its kernel and no other
    # device work. Checked here: late in the run (phase 9) the card's
    # profiler dropped K6's kernel from most sessions, where the checks of
    # this phase lost none. 4 calls a session: every kernel seen must be
    # K6's, at most one a call.
    from sipmask_tpu_torch.ops import mask_assembly as ma
    k6_in = k6_inputs(PP_BATCH, 272, 272, 100,
                      torch.Generator().manual_seed(SEED + 3), dev)
    split, n_kern = launch_split(
        f"K6 assemble_masks, 4 calls at 272x272 N=100 bs{PP_BATCH}",
        lambda: [ma.assemble_masks(*k6_in) for _ in range(4)], attempts=8)
    if not (1 <= n_kern <= 4 and all("assemble_masks_kernel" in name
                                     for name in split)):
        raise AssertionError(f"4 K6 calls ran {n_kern} device kernels, not "
                             f"one each: {list(split)}")
    del k6_in

    # bounds and one-call library equivalents, on the same inputs
    from sipmask_tpu_torch.ops import deform_sample as ds
    import torch.nn.functional as F
    cols = sum(BATCH * 9 * CHANNELS * h * w for h, w in LEVELS)
    k1_bytes = sum(nbytes(x, o) for x, o in k1_in) + 4 * cols
    k1_lib = []
    for x, o in k1_in:
        b, c, h, w = x.shape
        pyx = ds.positions(o, 3, 3, 1, 1, 1, DEFORM_GROUPS)
        rows = x.reshape(b * DEFORM_GROUPS, c // DEFORM_GROUPS, h * w
                         ).transpose(1, 2)
        k1_lib.append(grid_sample_rows(rows, pyx, h, w)[0])
    k4_elems = sum(x.numel() for (x,) in k4_in)
    extra = {
        "deform_im2col": (bound(k1_bytes, 7 * cols),
                          cuda_ms(lambda: [f() for f in k1_lib])),
        # two passes over x (sums, then normalise and ReLU): ~8 flops each
        "gn_relu": (bound(8 * k4_elems + 8 * CHANNELS, 8 * k4_elems),
                    cuda_ms(lambda: [torch.relu(F.group_norm(
                        x, GN_GROUPS, wt, bs)) for (x,) in k4_in])),
    }
    for name, (bnd, lib) in extra.items():
        log(f"{name}: bound {bnd[0]:.4f} ms ({bnd[1]}), one-call library "
            f"equivalent {lib:.4f} ms")
    return {"deform_im2col": k1_err, "gn_relu": k4_err}, times, extra


def k2_inputs(b, h, w, gen, dev, zero_offsets=False):
    """K2's inputs at one FeatureAlign level: K1's (offsets ~2 px, a third
    +-300 px; or all zero, as conv_offset starts), the weight in the row
    order of cols, and a cotangent."""
    x, off = k1_inputs(b, h, w, gen, dev)
    if zero_offsets:
        off.zero_()
    w2 = (torch.randn((CHANNELS, 9 * CHANNELS), generator=gen) * 0.01
          ).to(dev)
    dy = torch.randn((b, CHANNELS, h, w), generator=gen).to(dev)
    return x, off, w2, dy


def k3_inputs(b, gen, dev):
    """K3's inputs at the train step's shapes: 32 bases on the 400x672
    mask grid, MAX_POS positives with boxes covering 5-60% of the map (a
    fifth of them invalid), MAX_GTS gt masks, and a cotangent with zeros."""
    h, w = MASK_HW
    basis = torch.randn((b, 32, h, w), generator=gen)
    cofs = torch.randn((b, MAX_POS, 128), generator=gen) * 0.3
    frac = torch.sqrt(torch.rand((b, MAX_POS, 1), generator=gen) * 0.55
                      + 0.05)
    wh = frac * torch.tensor([w, h], dtype=torch.float32)
    ctr = torch.rand((b, MAX_POS, 2), generator=gen) * torch.tensor(
        [w, h], dtype=torch.float32)
    boxes = torch.cat([ctr - wh / 2, ctr + wh / 2], -1)
    gt = (torch.rand((b, MAX_GTS, h, w), generator=gen) > 0.5).to(
        torch.uint8)
    gt_idx = torch.randint(0, MAX_GTS, (b, MAX_POS), generator=gen)
    valid = torch.rand((b, MAX_POS), generator=gen) > 0.2
    grad = torch.rand((b, MAX_POS), generator=gen)
    grad[:, ::5] = 0.0
    return ([t.to(dev) for t in (basis, cofs, boxes, gt, gt_idx, valid)],
            grad.to(dev))


def in_box_pixels(boxes, valid, h, w):
    """Pixels inside the valid boxes (CropSplit: col >= x1, col < x2)."""
    def count(lo, hi, n):
        return (torch.ceil(hi).clamp(0, n) - torch.ceil(lo).clamp(0, n)
                ).clamp(min=0)
    cnt = count(boxes[..., 0], boxes[..., 2], w) * count(
        boxes[..., 1], boxes[..., 3], h)
    return float((cnt * valid).sum())


def check_outputs(label, got, want, tol):
    """Max abs error over the outputs; raises beyond tol relative to each
    output's max |value|."""
    worst_ab, worst_rel = 0.0, 0.0
    for g, e in zip(got, want):
        check_finite(label, g)
        ab, rel = errors(g, e)
        worst_ab, worst_rel = max(worst_ab, ab), max(worst_rel, rel)
    log(f"{label}: max_abs_err {worst_ab:.3e}, max rel (to max |value|) "
        f"{worst_rel:.3e} (tol {tol})")
    if not worst_rel <= tol:
        raise AssertionError(f"{label} disagrees with its plain version: "
                             f"{worst_rel}")
    return worst_ab


def phase_train_kernels(dev):
    """Phase 6: K2, K3a, K3b and K4b against their plain versions at the
    train step's shapes (batch 2), then times at batch 4."""
    from sipmask_tpu_torch.ops import deform_conv, deform_sample, gn_relu
    from sipmask_tpu_torch.ops import mask_loss

    gen = torch.Generator().manual_seed(SEED + 1)
    g = DEFORM_GROUPS
    errs = {"deform_conv_backward": 0.0}
    for h, w in LEVELS:
        for zero in (False, True):
            x, off, w2, dy = k2_inputs(2, h, w, gen, dev, zero)
            cols = deform_sample.deform_im2col(x, off, (3, 3), 1, 1, 1, g)
            got = deform_conv.deform_conv_backward(x, off, cols, w2, dy,
                                                   (3, 3), 1, 1, 1, g)
            want = deform_conv.deform_conv_backward_plain(
                x, off, w2, dy, (3, 3), 1, 1, 1, g)
            torch.cuda.synchronize()
            errs["deform_conv_backward"] = max(
                errs["deform_conv_backward"], check_outputs(
                    f"K2 deform_conv_backward {h}x{w} bs2 "
                    f"{'zero' if zero else 'random'} offsets (dx, doffsets, "
                    f"dw2)", got, want, TRAIN_KERNEL_TOL))
            if zero and not float(got[1].abs().max()) > 0:
                raise AssertionError("K2 gives zero offset gradients at "
                                     "zero offsets")
    args, grad = k3_inputs(2, gen, dev)
    pre = mask_loss.mask_bce_forward(*args)
    dbasis, dcofs = mask_loss.mask_bce_backward(*args, grad)
    want_pre = mask_loss.mask_bce_loss_plain(*args)
    want_db, want_dc = mask_loss.mask_bce_backward_plain(*args, grad)
    torch.cuda.synchronize()
    errs["mask_bce_forward"] = check_outputs(
        f"K3a mask_bce_forward {MASK_HW} K={MAX_POS} G={MAX_GTS} bs2",
        [pre], [want_pre], TRAIN_KERNEL_TOL)
    errs["mask_bce_backward"] = check_outputs(
        "K3b mask_bce_backward (dbasis, dcofs)", [dbasis, dcofs],
        [want_db, want_dc], TRAIN_KERNEL_TOL)
    del args, grad, pre, dbasis, dcofs, want_pre, want_db, want_dc
    errs["gn_relu_backward"] = 0.0
    for h, w in (LEVELS[0], LEVELS[2]):
        for act in (True, False):
            x = (torch.randn((2, CHANNELS, h, w), generator=gen) * 3 + 1
                 ).to(dev)
            dy = torch.randn((2, CHANNELS, h, w), generator=gen).to(dev)
            wt = (torch.rand(CHANNELS, generator=gen) + 0.5).to(dev)
            bs = (torch.randn(CHANNELS, generator=gen) * 0.2).to(dev)
            _, stats = gn_relu.gn_relu_forward(x, wt, bs, GN_GROUPS, 1e-5,
                                               act)
            got = gn_relu.gn_relu_backward(x, wt, bs, stats, dy, GN_GROUPS,
                                           act)
            want = gn_relu.gn_relu_backward_plain(x, wt, bs, stats, dy,
                                                  GN_GROUPS, act)
            torch.cuda.synchronize()
            errs["gn_relu_backward"] = max(
                errs["gn_relu_backward"], check_outputs(
                    f"K4b gn_relu_backward {h}x{w} act={act} bs2 (dx, "
                    f"dweight, dbias)", got, want, TRAIN_KERNEL_TOL))

    # times at batch 4. The plain backwards are autograd over graphs built
    # once (retain_graph), so their times hold no forward.
    times = {}
    k2_in = []
    for h, w in LEVELS:
        x, off, w2, dy = k2_inputs(BATCH, h, w, gen, dev)
        cols = deform_sample.deform_im2col(x, off, (3, 3), 1, 1, 1, g)
        leaves = [t.detach().requires_grad_(True) for t in (x, off, w2)]
        out = torch.matmul(leaves[2], deform_sample.deform_im2col_plain(
            leaves[0], leaves[1], (3, 3), 1, 1, 1, g))
        k2_in.append((x, off, w2, dy, cols, leaves, out))
    def k2_sweep():
        return [deform_conv.deform_conv_backward(x, off, cols, w2, dy, (3, 3),
                                                 1, 1, 1, g)
                for x, off, w2, dy, cols, _, _o in k2_in]
    times["deform_conv_backward"] = turns(
        f"K2 deform_conv_backward all 5 levels bs{BATCH}",
        lambda: [torch.autograd.grad(out, leaves, dy.reshape(out.shape),
                                     retain_graph=True)
                 for *_, dy, _c, leaves, out in k2_in], k2_sweep, iters=10)
    # K2's two GEMMs: 2*KC*O*P flops per image each; col2im ~16 per cols
    # entry on the CUDA cores
    gemm_flops = sum(4 * cols.numel() * w2.shape[0]
                     for x, off, w2, dy, cols, _, _o in k2_in)
    split, _ = launch_split(f"K2 deform_conv_backward all 5 levels "
                            f"bs{BATCH}", k2_sweep)
    gemm_ms = sum(ms for name, (_, ms) in split.items() if "gemm" in name)
    log(f"K2 GEMMs: {gemm_ms:.4f} ms device time for "
        f"{gemm_flops / 1e9:.1f} GFLOP of f32 products, "
        f"{gemm_flops / gemm_ms / 1e9:.1f} TFLOP/s")
    # yardstick of the GEMM part (not K2's function, so not library_ms):
    # torch.matmul in f32, TF32 off, on the same two products
    mm_dcols = cuda_ms(lambda: [
        torch.matmul(w2.t(), dy.reshape(dy.shape[0], dy.shape[1], -1))
        for x, off, w2, dy, cols, _, _o in k2_in], iters=5)
    mm_dw2 = cuda_ms(lambda: [
        torch.matmul(dy.reshape(dy.shape[0], dy.shape[1], -1),
                     cols.transpose(1, 2)).sum(0)
        for x, off, w2, dy, cols, _, _o in k2_in], iters=5)
    log(f"yardstick, torch.matmul f32 (allow_tf32="
        f"{torch.backends.cuda.matmul.allow_tf32}) on K2's products, 5 "
        f"levels bs{BATCH}: dcols {mm_dcols:.4f} ms "
        f"({gemm_flops / 2 / mm_dcols / 1e9:.1f} TFLOP/s), dW2 "
        f"{mm_dw2:.4f} ms ({gemm_flops / 2 / mm_dw2 / 1e9:.1f} TFLOP/s)")
    # bound: f32-accurate products on the tensor cores are 3 TF32 products
    # each (3xTF32); the col2im's f32 operations on the CUDA cores
    col_flops = sum(16 * cols.numel() for *_, cols, _l, _o in k2_in)
    k2_bound = bound(sum(2 * nbytes(x, off, w2) + nbytes(dy, cols)
                         for x, off, w2, dy, cols, _, _o in k2_in),
                     col_flops, 3 * gemm_flops)
    extra = {"deform_conv_backward": (k2_bound, None)}
    log(f"K2 bound: {k2_bound[0]:.4f} ms ({k2_bound[1]}: 3 TF32 products "
        f"per f32 product at {TF32_FLOP_PER_S / 1e12:.0f} TFLOP/s); all on "
        f"the CUDA cores at {F32_FLOP_PER_S / 1e12:.0f} TFLOP/s: "
        f"{(gemm_flops + col_flops) / F32_FLOP_PER_S * 1e3:.4f} ms")
    del k2_in
    args, grad = k3_inputs(BATCH, gen, dev)

    def k3a_plain():
        with torch.no_grad():
            return mask_loss.mask_bce_loss_plain(*args)
    def k3a_call():
        return mask_loss.mask_bce_forward(*args)
    times["mask_bce_forward"] = turns(
        f"K3a mask_bce_forward {MASK_HW} K={MAX_POS} bs{BATCH}", k3a_plain,
        k3a_call, iters=5)
    # a K3a call is its two kernels (pixel tiles, fold), a K3b call its
    # three (d basis tiles, d cofs tiles, fold); each gives the same bits
    # every time
    def k3b_call():
        return mask_loss.mask_bce_backward(*args, grad)
    if not torch.equal(k3a_call(), k3a_call()):
        raise AssertionError("two K3a calls gave different bits")
    if not all(torch.equal(a, b) for a, b in zip(k3b_call(), k3b_call())):
        raise AssertionError("two K3b calls gave different bits")
    for label, call, want in (("K3a mask_bce_forward", k3a_call, 2),
                              ("K3b mask_bce_backward", k3b_call, 3)):
        _, n_kern = launch_split(f"{label}, one call at {MASK_HW} "
                                 f"K={MAX_POS} bs{BATCH}", call)
        if n_kern != want:
            raise AssertionError(f"a {label} call ran {n_kern} device "
                                 f"kernels, not its {want}")
    # the work is the in-box pixels of the valid positives: a 32-term dot
    # and a BCE (~76 flops) each forward, ~200 backward
    inbox = in_box_pixels(args[2], args[5], *MASK_HW)
    extra["mask_bce_forward"] = (bound(nbytes(*args) + 4 * grad.numel(),
                                       76 * inbox), None)
    extra["mask_bce_backward"] = (bound(
        2 * nbytes(args[0], args[1]) + nbytes(*args[2:], grad),
        200 * inbox), None)
    leaves = [t.detach().requires_grad_(True) for t in args[:2]]
    pre_p = mask_loss.mask_bce_loss_plain(*leaves, *args[2:])
    times["mask_bce_backward"] = turns(
        f"K3b mask_bce_backward {MASK_HW} K={MAX_POS} bs{BATCH}",
        lambda: torch.autograd.grad(pre_p, leaves, grad, retain_graph=True),
        k3b_call, iters=5)
    del args, grad, leaves, pre_p
    k4_in = []
    for h, w in LEVELS:
        x = torch.randn((BATCH, CHANNELS, h, w), generator=gen).to(dev)
        dy = torch.randn((BATCH, CHANNELS, h, w), generator=gen).to(dev)
        wt = torch.ones(CHANNELS, device=dev)
        bs = torch.zeros(CHANNELS, device=dev)
        _, stats = gn_relu.gn_relu_forward(x, wt, bs, GN_GROUPS)
        k4_in.append((x, wt, bs, stats, dy))
    def k4b_sweep():
        return [gn_relu.gn_relu_backward(*a, GN_GROUPS, True) for a in k4_in]
    times["gn_relu_backward"] = turns(
        f"K4b gn_relu_backward all 5 levels bs{BATCH}",
        lambda: [gn_relu.gn_relu_backward_plain(*a, GN_GROUPS, True)
                 for a in k4_in], k4b_sweep)
    launch_split(f"K4b gn_relu_backward all 5 levels bs{BATCH}", k4b_sweep)
    _, n_kern = launch_split(
        f"K4b gn_relu_backward, one call at {LEVELS[0]} bs{BATCH}",
        lambda: gn_relu.gn_relu_backward(*k4_in[0], GN_GROUPS, True))
    if n_kern != 2:
        raise AssertionError(f"a K4b call ran {n_kern} device kernels, not "
                             f"its two")
    # K4b's one-call equivalent: autograd of F.group_norm + ReLU, over
    # graphs built once
    import torch.nn.functional as F
    gn_graphs = []
    for x, wt, bs, _, dy in k4_in:
        leaves = [t.detach().requires_grad_(True) for t in (x, wt, bs)]
        gn_graphs.append((torch.relu(F.group_norm(leaves[0], GN_GROUPS,
                                                  leaves[1], leaves[2])),
                          leaves, dy))
    k4b_lib = cuda_ms(lambda: [torch.autograd.grad(y, lv, dy,
                                                   retain_graph=True)
                               for y, lv, dy in gn_graphs])
    k4_elems = sum(a[0].numel() for a in k4_in)
    extra["gn_relu_backward"] = (bound(12 * k4_elems, 10 * k4_elems),
                                 k4b_lib)
    del k4_in, gn_graphs
    torch.cuda.empty_cache()
    for name, (bnd, lib) in extra.items():
        log(f"{name}: bound {bnd[0]:.4f} ms ({bnd[1]}), one-call library "
            f"equivalent " + ("none" if lib is None else f"{lib:.4f} ms"))
    return errs, times, extra


# ------------------------------------------------------------- bfloat16

def bf16_k1_inputs(b, h, w, gen, dev):
    """K1's phase-3 inputs with x in bf16 (offsets stay f32)."""
    x, off = k1_inputs(b, h, w, gen, dev)
    return x.to(torch.bfloat16), off


def phase_bf16_kernels(dev):
    """Phase 19: the bf16 variants of K1, K2, K4a and K4b against their
    plain bf16 versions at the flagship's shapes (batch 2), then times at
    batch 4 with bounds (bf16 tensors 2 bytes an element; K2's products at
    the dense bf16 tensor-core rate) and one-call library equivalents."""
    import torch.nn.functional as F
    from sipmask_tpu_torch.ops import deform_conv, deform_sample, gn_relu

    bf = torch.bfloat16
    gen = torch.Generator().manual_seed(SEED + 5)
    g = DEFORM_GROUPS
    errs = {k: 0.0 for k in ("deform_im2col_bf16",
                             "deform_conv_backward_bf16", "gn_relu_bf16",
                             "gn_relu_backward_bf16")}
    for h, w in LEVELS:
        x, off = bf16_k1_inputs(2, h, w, gen, dev)
        got = deform_sample.deform_im2col(x, off, (3, 3), 1, 1, 1, g)
        want = deform_sample.deform_im2col_plain(x, off, (3, 3), 1, 1, 1, g)
        torch.cuda.synchronize()
        if got.dtype != bf:
            raise AssertionError(f"K1 bf16 gave {got.dtype}")
        errs["deform_im2col_bf16"] = max(
            errs["deform_im2col_bf16"], check_outputs(
                f"K1 bf16 deform_im2col {h}x{w} bs2", [got.float()],
                [want.float()], BF16_KERNEL_TOL))
        for zero in (False, True):
            w2 = (torch.randn((CHANNELS, 9 * CHANNELS), generator=gen) * 0.01
                  ).to(dev).to(bf)
            dy = torch.randn((2, CHANNELS, h, w), generator=gen).to(dev
                                                                    ).to(bf)
            o = torch.zeros_like(off) if zero else off
            cols = deform_sample.deform_im2col(x, o, (3, 3), 1, 1, 1, g)
            got = deform_conv.deform_conv_backward(x, o, cols, w2, dy,
                                                   (3, 3), 1, 1, 1, g)
            want = deform_conv.deform_conv_backward_plain(x, o, w2, dy,
                                                          (3, 3), 1, 1, 1, g)
            torch.cuda.synchronize()
            if [t.dtype for t in got] != [bf, torch.float32, torch.float32]:
                raise AssertionError(f"K2 bf16 gave {[t.dtype for t in got]}")
            errs["deform_conv_backward_bf16"] = max(
                errs["deform_conv_backward_bf16"], check_outputs(
                    f"K2 bf16 deform_conv_backward {h}x{w} bs2 "
                    f"{'zero' if zero else 'random'} offsets (dx, doffsets, "
                    f"dw2)", [t.float() for t in got],
                    [t.float() for t in want], BF16_KERNEL_TOL))
            rel = [errors(a.float(), e.float())[1]
                   for a, e in zip(got, want)]
            log(f"K2 bf16 {h}x{w} {'zero' if zero else 'random'}: relative "
                f"to max |plain| dx {rel[0]:.3e}, doffsets {rel[1]:.3e}, "
                f"dw2 {rel[2]:.3e}")
            if zero and not float(got[1].abs().max()) > 0:
                raise AssertionError("K2 bf16 gives zero offset gradients "
                                     "at zero offsets")
            # dW2 (partials folded in order) and d offsets (fixed shuffle
            # trees) take no atomics: the same bits from call to call
            again = deform_conv.deform_conv_backward(x, o, cols, w2, dy,
                                                     (3, 3), 1, 1, 1, g)
            if not (torch.equal(again[1], got[1])
                    and torch.equal(again[2], got[2])):
                raise AssertionError("two K2 bf16 calls gave different "
                                     "d offsets or dw2 bits")
    # K1 bf16 at every level set, far and zero offsets, the same bits twice
    # (its own generator: the inputs above and below stay as they were)
    k1_gen = torch.Generator().manual_seed(SEED + 19)
    for label, levels in [("800x1344", LEVELS)] + list(K1_BF16_SETS.items()):
        for h, w in levels:
            x, off = bf16_k1_inputs(2, h, w, k1_gen, dev)
            for zero in (False, True):
                o = torch.zeros_like(off) if zero else off
                got = deform_sample.deform_im2col(x, o, (3, 3), 1, 1, 1, g)
                again = deform_sample.deform_im2col(x, o, (3, 3), 1, 1, 1, g)
                want = deform_sample.deform_im2col_plain(x, o, (3, 3), 1, 1,
                                                         1, g)
                torch.cuda.synchronize()
                if not torch.equal(got, again):
                    raise AssertionError(f"two K1 bf16 calls at {h}x{w} "
                                         f"gave different bits")
                errs["deform_im2col_bf16"] = max(
                    errs["deform_im2col_bf16"], check_outputs(
                        f"K1 bf16 deform_im2col {label} {h}x{w} bs2 "
                        f"{'zero' if zero else 'far'} offsets (route "
                        f"{deform_sample.im2col_bf16_route(64, h * w)})",
                        [got.float()], [want.float()], BF16_KERNEL_TOL))
    del x, off, got, again, want
    # the tap contraction after K1 is a bf16 torch.matmul: it must sum in
    # f32 (JAX's preferred_element_type) and round once
    x, off = bf16_k1_inputs(BATCH, *LEVELS[0], gen, dev)
    cols = deform_sample.deform_im2col(x, off, (3, 3), 1, 1, 1, g)
    w2 = (torch.randn((CHANNELS, 9 * CHANNELS), generator=gen) * 0.01
          ).to(dev).to(bf)
    want = torch.matmul(w2.float(), cols.float()).to(bf)
    # with the flag this script sets, and with PyTorch's default (which the
    # CLIs keep): cuBLAS may then reduce split sums in bf16
    flags = torch.backends.cuda.matmul
    for reduced in (False, True):
        flags.allow_bf16_reduced_precision_reduction = reduced
        got = torch.matmul(w2, cols)
        torch.cuda.synchronize()
        check_outputs(f"bf16 tap contraction torch.matmul at {LEVELS[0]} "
                      f"bs{BATCH} against an f32-summed product rounded once "
                      f"(allow_bf16_reduced_precision_reduction={reduced})",
                      [got.float()], [want.float()], BF16_KERNEL_TOL)
    flags.allow_bf16_reduced_precision_reduction = False
    del x, off, cols, w2, got, want
    # K4a and K4b at every flagship level, a VIS level, an HRFPN level and a
    # slab past what a cluster holds (the two-pass kernels), each giving
    # the same bits twice
    for b, (h, w) in [(2, hw) for hw in LEVELS + [VIS_GN_LEVEL,
                                                  HRFPN_GN_LEVEL]] + [
            (1, GN_PAST_CAPACITY)]:
        plan = gn_relu.gn_schedule(b, CHANNELS, h * w, GN_GROUPS,
                                   offsets=False)
        path = [plan[d]["path"] for d in ("forward", "backward")]
        for act in (True, False):
            x = ((torch.randn((b, CHANNELS, h, w), generator=gen) * 3 + 1)
                 .to(dev).to(bf))
            dy = torch.randn((b, CHANNELS, h, w), generator=gen).to(dev
                                                                    ).to(bf)
            wt = (torch.rand(CHANNELS, generator=gen) + 0.5).to(dev)
            bs = (torch.randn(CHANNELS, generator=gen) * 0.2).to(dev)
            y, stats = gn_relu.gn_relu_forward(x, wt, bs, GN_GROUPS, 1e-5,
                                               act)
            want, want_stats = gn_relu._forward_plain(x, wt, bs, GN_GROUPS,
                                                      1e-5, act)
            got_b = gn_relu.gn_relu_backward(x, wt, bs, stats, dy, GN_GROUPS,
                                             act)
            want_b = gn_relu.gn_relu_backward_plain(x, wt, bs, stats, dy,
                                                    GN_GROUPS, act)
            y2, stats2 = gn_relu.gn_relu_forward(x, wt, bs, GN_GROUPS, 1e-5,
                                                 act)
            again_b = gn_relu.gn_relu_backward(x, wt, bs, stats, dy,
                                               GN_GROUPS, act)
            torch.cuda.synchronize()
            if y.dtype != bf or got_b[0].dtype != bf:
                raise AssertionError("K4 bf16 gave another dtype")
            if not (torch.equal(y, y2) and torch.equal(stats, stats2)
                    and all(map(torch.equal, got_b, again_b))):
                raise AssertionError(f"two K4 bf16 calls at {h}x{w} gave "
                                     f"different bits")
            errs["gn_relu_bf16"] = max(errs["gn_relu_bf16"], check_outputs(
                f"K4a bf16 gn_relu {h}x{w} act={act} bs{b} ({path[0]}; y, "
                f"stats)", [y.float(), stats], [want.float(), want_stats],
                BF16_KERNEL_TOL))
            errs["gn_relu_backward_bf16"] = max(
                errs["gn_relu_backward_bf16"], check_outputs(
                    f"K4b bf16 gn_relu_backward {h}x{w} act={act} bs{b} "
                    f"({path[1]}; dx, dweight, dbias)",
                    [t.float() for t in got_b],
                    [t.float() for t in want_b], BF16_KERNEL_TOL))
        # a call is the kernels its path states: one-pass one cluster
        # kernel, two-pass its two kernels
        for label, fn, kernels in (
                ("K4a bf16 gn_relu", lambda: gn_relu.gn_relu_forward(
                    x, wt, bs, GN_GROUPS), {
                    "one-pass": ["gn_fwd_cluster_kernel"],
                    "two-pass": ["gn_stats_kernel", "gn_apply_kernel"]}[
                        path[0]]),
                ("K4b bf16 gn_relu_backward", lambda: gn_relu.gn_relu_backward(
                    x, wt, bs, stats, dy, GN_GROUPS, True), {
                    "one-pass": ["gn_bwd_cluster_kernel"],
                    "two-pass": ["gn_bwd_reduce_kernel",
                                 "gn_bwd_apply_kernel"]}[path[1]])):
            if (h, w) not in (LEVELS[0], GN_PAST_CAPACITY):
                continue
            split, n_kern = launch_split(
                f"{label}, one call at {h}x{w} bs{b}", fn, attempts=5,
                want=len(kernels), reps=4)
            names = [n for n, (c, _) in split.items() for _ in range(c)]
            if n_kern != len(kernels) or any(
                    sum(k in n for n in names) != 1 for k in kernels):
                raise AssertionError(f"a {label} call at {h}x{w} ran "
                                     f"{names}, not {kernels}")

    # times at batch 4 over the five levels: plain, kernel, kernel, plain
    times, extra = {}, {}
    k1_in = [bf16_k1_inputs(BATCH, h, w, gen, dev) for h, w in LEVELS]
    times["deform_im2col_bf16"] = turns(
        f"K1 bf16 deform_im2col all 5 levels bs{BATCH}",
        lambda: [deform_sample.deform_im2col_plain(x, o, (3, 3), 1, 1, 1, g)
                 for x, o in k1_in],
        lambda: [deform_sample.deform_im2col(x, o, (3, 3), 1, 1, 1, g)
                 for x, o in k1_in])
    # a call is its transpose and its gather, on the TMA route (P3) and on
    # register stores (P7)
    for i in (0, len(LEVELS) - 1):
        split, n_kern = launch_split(
            f"K1 bf16 deform_im2col, one call at {LEVELS[i]} bs{BATCH}",
            lambda: deform_sample.deform_im2col(*k1_in[i], (3, 3), 1, 1, 1,
                                                g), attempts=5, want=2,
            reps=4)
        names = [n for n, (c, _) in split.items() for _ in range(c)]
        if n_kern != 2 or any(
                sum(k in n for n in names) != 1 for k in (
                    "deform_im2col_rows_bf16_kernel",
                    "deform_im2col_bf16_kernel")):
            raise AssertionError(f"a K1 bf16 call at {LEVELS[i]} ran "
                                 f"{names}, not its transpose and gather")
    device = sweep_split(
        f"K1 bf16 deform_im2col all 5 levels bs{BATCH}",
        [lambda x=x, o=o: deform_sample.deform_im2col(x, o, (3, 3), 1, 1, 1,
                                                      g) for x, o in k1_in],
        [f"{h}x{w}" for h, w in LEVELS], [2] * len(LEVELS))
    log(f"K1 bf16 all 5 levels bs{BATCH}: CUDA events "
        f"{times['deform_im2col_bf16'][0]:.4f} ms, device {device:.4f} ms")
    pp_in = [bf16_k1_inputs(PP_BATCH, h, w, k1_gen, dev)
             for h, w in K1_BF16_SETS["544x544"]]
    label = f"K1 bf16 deform_im2col 544x544's 5 levels bs{PP_BATCH}"
    times["deform_im2col_bf16 544x544"] = turns(
        label,
        lambda: [deform_sample.deform_im2col_plain(x, o, (3, 3), 1, 1, 1, g)
                 for x, o in pp_in],
        lambda: [deform_sample.deform_im2col(x, o, (3, 3), 1, 1, 1, g)
                 for x, o in pp_in])
    device = sweep_split(
        label, [lambda x=x, o=o: deform_sample.deform_im2col(
            x, o, (3, 3), 1, 1, 1, g) for x, o in pp_in],
        [f"{h}x{w}" for h, w in K1_BF16_SETS["544x544"]], [2] * len(pp_in))
    log(f"{label}: CUDA events "
        f"{times['deform_im2col_bf16 544x544'][0]:.4f} ms, device "
        f"{device:.4f} ms")
    del pp_in
    ncols = sum(BATCH * 9 * CHANNELS * h * w for h, w in LEVELS)
    k1_lib = []
    for x, o in k1_in:
        b, c, h, w = x.shape
        pyx = deform_sample.positions(o, 3, 3, 1, 1, 1, g)
        rows = x.reshape(b * g, c // g, h * w).transpose(1, 2)
        k1_lib.append(grid_sample_rows(rows, pyx.to(bf), h, w)[0])
    extra["deform_im2col_bf16"] = (
        bound(sum(nbytes(x, o) for x, o in k1_in) + 2 * ncols, 7 * ncols),
        cuda_ms(lambda: [f() for f in k1_lib]))
    del k1_lib

    k2_in = []
    for x, o in k1_in:
        b, _, h, w = x.shape
        w2 = (torch.randn((CHANNELS, 9 * CHANNELS), generator=gen) * 0.01
              ).to(dev).to(bf)
        dy = torch.randn((b, CHANNELS, h, w), generator=gen).to(dev).to(bf)
        cols = deform_sample.deform_im2col(x, o, (3, 3), 1, 1, 1, g)
        k2_in.append((x, o, w2, dy, cols))
    del k1_in

    def k2_sweep():
        return [deform_conv.deform_conv_backward(x, o, cols, w2, dy, (3, 3),
                                                 1, 1, 1, g)
                for x, o, w2, dy, cols in k2_in]
    times["deform_conv_backward_bf16"] = turns(
        f"K2 bf16 deform_conv_backward all 5 levels bs{BATCH}",
        lambda: [deform_conv.deform_conv_backward_plain(
            x, o, w2, dy, (3, 3), 1, 1, 1, g)
            for x, o, w2, dy, _c in k2_in], k2_sweep, iters=5)
    gemm_flops = sum(4 * cols.numel() * w2.shape[0]
                     for x, o, w2, dy, cols in k2_in)
    # a call is 6 device kernels, 7 where P % 8 != 0 (below)
    sweep_kernels = sum(6 + (h * w % 8 != 0) for h, w in LEVELS)
    split, n_kern = launch_split(f"K2 bf16 deform_conv_backward all 5 "
                                 f"levels bs{BATCH}", k2_sweep,
                                 want=sweep_kernels, reps=4)
    gemm_ms = sum(ms for name, (_, ms) in split.items() if "gemm" in name)
    pad_ms = sum(ms for name, (_, ms) in split.items() if "pad_rows" in name)
    if n_kern == sweep_kernels:
        log(f"K2 bf16 GEMMs: {gemm_ms:.4f} ms device time for "
            f"{gemm_flops / 1e9:.1f} GFLOP of bf16 products, "
            f"{gemm_flops / max(gemm_ms, 1e-9) / 1e9:.1f} TFLOP/s; with "
            f"the copies of dy and cols into padded rows ({pad_ms:.4f} ms) "
            f"{gemm_flops / max(gemm_ms + pad_ms, 1e-9) / 1e9:.1f} "
            f"TFLOP/s; device time a sweep "
            f"{sum(ms for _, ms in split.values()):.4f} ms")
    else:
        log(f"K2 bf16 GEMMs: no profiler session saw all {sweep_kernels} "
            f"kernels of the sweep (the most: {n_kern}); no rate")
    # a call is the kernels csrc/deform_col2im.cu states: at P3 (P % 8 ==
    # 0) the transpose of x (zeroing the dX scratch), the wgmma dcols and
    # dW2 GEMMs on TMA, the fold, the scatter and the transpose of dX; at
    # P5 (P % 8 == 2) the copy of dy and cols into padded rows before the
    # GEMMs
    call_kernels = ["deform_bwd_transpose_kernel"] * 2 + [
        "deform_bwd_gemm_wgmma_dcols", "deform_bwd_gemm_wgmma_dw2",
        "fold_partials_kernel", "deform_col2im_bf16x4_kernel"]
    for i, want in ((0, call_kernels),
                    (2, call_kernels + ["pad_rows_kernel"])):
        x, o, w2, dy, cols = k2_in[i]
        split, n_kern = launch_split(
            f"K2 bf16 deform_conv_backward, one call at {LEVELS[i]} "
            f"bs{BATCH}", lambda: deform_conv.deform_conv_backward(
                x, o, cols, w2, dy, (3, 3), 1, 1, 1, g), attempts=5,
            want=len(want), reps=4)
        names = [n for n, (c, _) in split.items() for _ in range(c)]
        if n_kern != len(want) or any(
                sum(k in n for n in names) != want.count(k)
                for k in set(want)):
            raise AssertionError(f"a K2 bf16 call at {LEVELS[i]} ran "
                                 f"{names}, not {want}")
    # yardstick of the GEMM part (not K2's function, so not library_ms):
    # torch.matmul in bf16 on the same two products
    mm_dcols = cuda_ms(lambda: [
        torch.matmul(w2.t(), dy.reshape(dy.shape[0], dy.shape[1], -1))
        for x, o, w2, dy, cols in k2_in], iters=5)
    mm_dw2 = cuda_ms(lambda: [
        torch.matmul(dy.reshape(dy.shape[0], dy.shape[1], -1),
                     cols.transpose(1, 2)).sum(0)
        for x, o, w2, dy, cols in k2_in], iters=5)
    log(f"yardstick, torch.matmul bf16 on K2's products, 5 levels "
        f"bs{BATCH}: dcols {mm_dcols:.4f} ms "
        f"({gemm_flops / 2 / mm_dcols / 1e9:.1f} TFLOP/s), dW2 "
        f"{mm_dw2:.4f} ms ({gemm_flops / 2 / mm_dw2 / 1e9:.1f} TFLOP/s)")
    col_flops = sum(16 * cols.numel() for *_, cols in k2_in)
    # read x, offsets, cols, w2, dy; write dx (bf16), d offsets and dw2 (f32)
    k2_bytes = sum(nbytes(x, o, cols, w2, dy) + nbytes(x) + nbytes(o)
                   + 4 * w2.numel() for x, o, w2, dy, cols in k2_in)
    extra["deform_conv_backward_bf16"] = (
        bound(k2_bytes, col_flops, gemm_flops, BF16_FLOP_PER_S), None)
    log(f"K2 bf16 bound: {extra['deform_conv_backward_bf16'][0][0]:.4f} ms "
        f"({extra['deform_conv_backward_bf16'][0][1]}: the products at the "
        f"H100 SXM's dense bf16 tensor-core rate, "
        f"{BF16_FLOP_PER_S / 1e12:.0f} TFLOP/s; the col2im's f32 operations "
        f"at {F32_FLOP_PER_S / 1e12:.0f} TFLOP/s)")
    del k2_in

    k4_in = []
    for h, w in LEVELS:
        x = torch.randn((BATCH, CHANNELS, h, w), generator=gen).to(dev).to(bf)
        dy = torch.randn((BATCH, CHANNELS, h, w), generator=gen).to(dev
                                                                    ).to(bf)
        wt = torch.ones(CHANNELS, device=dev)
        bs = torch.zeros(CHANNELS, device=dev)
        _, stats = gn_relu.gn_relu_forward(x, wt, bs, GN_GROUPS)
        k4_in.append((x, wt, bs, stats, dy))
    times["gn_relu_bf16"] = turns(
        f"K4a bf16 gn_relu all 5 levels bs{BATCH}",
        lambda: [gn_relu.gn_relu_plain(x, wt, bs, GN_GROUPS)
                 for x, wt, bs, _s, _d in k4_in],
        lambda: [gn_relu.gn_relu(x, wt, bs, GN_GROUPS)
                 for x, wt, bs, _s, _d in k4_in])
    # a call's device kernels: one on the one-pass path, else two
    plans = [gn_relu.gn_schedule(BATCH, CHANNELS, h * w, GN_GROUPS,
                                 offsets=False) for h, w in LEVELS]
    k4_kernels = [[1 if plan[d]["path"] == "one-pass" else 2
                   for plan in plans] for d in ("forward", "backward")]
    device = sweep_split(
        f"K4a bf16 gn_relu all 5 levels bs{BATCH}",
        [lambda x=x, wt=wt, bs=bs: gn_relu.gn_relu(x, wt, bs, GN_GROUPS)
         for x, wt, bs, _s, _d in k4_in], [f"{h}x{w}" for h, w in LEVELS],
        k4_kernels[0])
    log(f"K4a bf16 all 5 levels bs{BATCH}: CUDA events "
        f"{times['gn_relu_bf16'][0]:.4f} ms, device {device:.4f} ms")

    def k4b_sweep():
        return [gn_relu.gn_relu_backward(*a, GN_GROUPS, True) for a in k4_in]
    times["gn_relu_backward_bf16"] = turns(
        f"K4b bf16 gn_relu_backward all 5 levels bs{BATCH}",
        lambda: [gn_relu.gn_relu_backward_plain(*a, GN_GROUPS, True)
                 for a in k4_in], k4b_sweep)
    device = sweep_split(
        f"K4b bf16 gn_relu_backward all 5 levels bs{BATCH}",
        [lambda a=a: gn_relu.gn_relu_backward(*a, GN_GROUPS, True)
         for a in k4_in], [f"{h}x{w}" for h, w in LEVELS], k4_kernels[1])
    log(f"K4b bf16 all 5 levels bs{BATCH}: CUDA events "
        f"{times['gn_relu_backward_bf16'][0]:.4f} ms, device "
        f"{device:.4f} ms")
    gn_graphs = []
    for x, wt, bs, _, dy in k4_in:
        leaves = [t.detach().requires_grad_(True) for t in (x, wt, bs)]
        gn_graphs.append((torch.relu(F.group_norm(
            leaves[0], GN_GROUPS, leaves[1].to(bf), leaves[2].to(bf))),
            leaves, dy))
    k4_elems = sum(a[0].numel() for a in k4_in)
    extra["gn_relu_bf16"] = (
        bound(4 * k4_elems + 8 * CHANNELS, 8 * k4_elems),
        cuda_ms(lambda: [torch.relu(F.group_norm(
            x, GN_GROUPS, wt.to(bf), bs.to(bf))) for x, wt, bs, _s, _d
            in k4_in]))
    extra["gn_relu_backward_bf16"] = (
        bound(6 * k4_elems, 10 * k4_elems),
        cuda_ms(lambda: [torch.autograd.grad(y, lv, dy, retain_graph=True)
                         for y, lv, dy in gn_graphs]))
    del k4_in, gn_graphs
    torch.cuda.empty_cache()
    for name, (bnd, lib) in extra.items():
        log(f"{name}: bound {bnd[0]:.4f} ms ({bnd[1]}), one-call library "
            f"equivalent " + ("none" if lib is None else f"{lib:.4f} ms"))
    return errs, times, extra


def bf16_config(preset):
    """``preset`` with ``model.compute_dtype="bfloat16"``."""
    from sipmask_tpu_torch.config import _r, get_config
    return _r(get_config(preset), "model", compute_dtype="bfloat16")


def check_bf16_head(head):
    """Every head output is bf16 but bbox_preds (f32, as in JAX)."""
    for key, val in head.items():
        want = torch.float32 if key == "bbox_preds" else torch.bfloat16
        for t in (val if isinstance(val, list) else [val]):
            if t.dtype != want:
                raise AssertionError(f"bf16 head output {key} is {t.dtype}")


def bf16_serving(dev, name, smi, label, preset, imgs, batch_n, path,
                 prepare=None, f32_tol=BF16_F32_TOL, pin=False,
                 head_tol=BF16_HEAD_TOL, match_min=BF16_MATCH_MIN,
                 checked=()):
    """The serving path of ``preset`` in bf16: 3 requests through
    ``inference_detector`` (``imgs[:3]``), a batch of ``batch_n``
    (``imgs[3:]``) twice through ``Detector.infer``, launches counted; then
    the batch with the plain versions, and with the same weights in f32
    (head outputs within ``f32_tol`` of f32's max; None: logged only).
    Kernels vs plain: head outputs within ``head_tol`` of their max, and
    each image's detections matched (label, box and scores within
    BF16_MATCH) both ways in a share of at least ``match_min``.
    ``prepare(det, images)`` adjusts the random weights (both runs).
    ``pin``: the kernels run again for the comparison, each K5 call held
    against its plain version on the same inputs (:func:`checked_calls`),
    and that run and the plain run have the backbone's ReLUs and DCN
    sampling floors pinned to those of one plain forward
    (:func:`plain_pins`); how far the f32 forward's lie from them is
    logged. ``checked``: kernel wrappers (no pins) whose every call is held
    against its plain version on the same inputs in such a rerun."""
    from sipmask_tpu_torch.apis.inference import (inference_detector,
                                                  init_detector, preprocess)
    from sipmask_tpu_torch.utils.demo_inputs import bump_weights

    det = init_detector(bf16_config(preset), dev, seed=SEED)
    cfg = det.cfg
    bump_weights(det.model, torch.Generator().manual_seed(SEED))
    prepped = [preprocess(im, cfg) for im in imgs[3:]]
    images = torch.stack([torch.from_numpy(p[0]).permute(2, 0, 1)
                          for p in prepped]).to(dev)
    batch = (images, torch.from_numpy(np.stack([p[1] for p in prepped])),
             torch.from_numpy(np.stack([p[2] for p in prepped])))
    if prepare is not None:
        prepare(det, images)
    for n, p in det.model.named_parameters():
        if p.dtype != torch.float32:
            raise AssertionError(f"bf16 model parameter {n} is {p.dtype}")
    capture = {}
    det.model.bbox_head.register_forward_hook(
        lambda mod, inp, out: capture.update(out))

    reset_launches()
    for i in range(3):
        t0 = time.perf_counter()
        res = inference_detector(det, imgs[i])
        ms = (time.perf_counter() - t0) * 1e3
        n, hw = len(res["labels"]), imgs[i].shape[:2]
        log(f"{label} request {i}: {hw} image -> {n} detections, "
            f"{ms:.1f} ms wall on {name} ({smi})")
        if n == 0 or not np.isfinite(res["boxes"]).all():
            raise AssertionError(f"{label} request {i}: no valid or finite "
                                 f"result")
        if res["masks"].shape != (n, *hw):
            raise AssertionError(f"{label} request {i}: masks "
                                 f"{res['masks'].shape}")
    torch.cuda.reset_peak_memory_stats()
    for _ in range(2):   # the first run is the first at the batch shapes
        t0 = time.perf_counter()
        head_k, dec_k = run_batch(det, batch, capture)
        ms = (time.perf_counter() - t0) * 1e3
        log(f"{label} batch of {tuple(images.shape)} through "
            f"Detector.infer: {ms:.1f} ms wall on {name} ({smi}); peak "
            f"memory {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
    launches = read_launches()
    check_path_launches(path, launches)
    check_no_f32_variant(path, launches)
    valid = dec_k["valid"].sum(1).tolist()
    log(f"valid detections per image of the {label} batch: {valid}")
    if min(valid) <= 0:
        raise AssertionError("an image of the batch has no detection")
    check_head_finite(head_k)
    check_bf16_head(head_k)
    for key in ("boxes", "scores", "masks"):
        check_finite(key, dec_k[key])
    if "mask_scores" in dec_k:   # SipMask++'s rescoring, f32 as in JAX
        ms = dec_k["mask_scores"]
        check_finite("mask_scores", ms)
        if ms.dtype != torch.float32 or not float(ms[dec_k["valid"]].min()
                                                  ) > 0:
            raise AssertionError(f"{label} mask_scores: {ms.dtype}, a valid "
                                 f"detection with mask score 0")

    det32 = init_detector(preset, dev, seed=SEED)
    det32.model.load_state_dict(det.model.state_dict())
    cap32 = {}
    det32.model.bbox_head.register_forward_hook(
        lambda mod, inp, out: cap32.update(out))
    pin_plain, how = contextlib.nullcontext, ""
    if pin:
        pins = plain_pins(det.model.backbone, images)
        log_pin_gap(label, pins, plain_pins(det32.model.backbone, images))

        def pin_plain():
            return pinned(det.model.backbone, *pins)
        how = ", the backbone's ReLUs and sampling floors pinned"
        with pinned(det.model.backbone, *pins) as moved, \
                checked_calls(("deform_rows",)) as errs:
            head_k, dec_k = run_batch(det, batch, capture)
        log(f"{label} kernels{how}: positions moved per DCN conv {moved}; "
            f"each K5 call against its plain version on the same inputs, "
            f"max relative error "
            f"{', '.join(f'{e:.2e}' for e in errs['deform_rows'])} (tol "
            f"{BF16_KERNEL_TOL})")
    elif checked:
        with checked_calls(checked) as errs:
            head_k, dec_k = run_batch(det, batch, capture)
        log_checked(label, errs)
    before = read_launches()
    with plain_kernels(), pin_plain():
        head_p, dec_p = run_batch(det, batch, capture)
    if read_launches() != before:
        raise AssertionError("the plain run launched a kernel")
    worst = head_error(head_k, head_p)
    shares = [min(matched_share(dec_k, dec_p, i, *BF16_MATCH),
                  matched_share(dec_p, dec_k, i, *BF16_MATCH))
              for i in range(batch_n)]
    log(f"{label} kernels vs plain{how}: head outputs max relative error "
        f"{worst:.3e} (tol {head_tol}); detections reproduced both ways "
        f"(label, box within {BF16_MATCH[0]} px, scores within "
        f"{BF16_MATCH[1]}): {shares} (min {match_min})")
    if not (worst <= head_tol and min(shares) >= match_min):
        raise AssertionError(f"head outputs or detections disagree: "
                             f"{worst}, {shares}")

    # the same weights in f32: how far bf16 moves the outputs
    del det
    torch.cuda.empty_cache()
    head_f, dec_f = run_batch(det32, batch, cap32)
    by_key = {}
    for (k, a), (_, b) in zip(head_outputs(head_k), head_outputs(head_f)):
        by_key[k] = errors(a.float(), b)[1]
    log(f"{label} head outputs, bf16{how} vs f32 on the same weights: "
        f"relative error (to max |f32|) by output: " + ", ".join(
            f"{k} {v:.3e}" for k, v in by_key.items()))
    shares = [matched_share(dec_f, dec_k, i, 2.0, 0.02)
              for i in range(batch_n)]
    log(f"{label} f32 detections that the bf16 run also has (label, box "
        f"within 2 px, scores within 0.02): {shares}; valid bf16 "
        f"{dec_k['valid'].sum(1).tolist()}, f32 "
        f"{dec_f['valid'].sum(1).tolist()}")
    worst = max(by_key.values())
    if f32_tol is not None and not worst <= f32_tol:
        raise AssertionError(f"bf16 and f32 head outputs differ by {worst}")
    del det32
    torch.cuda.empty_cache()
    return launches


def phase_bf16_serving(dev, name, smi):
    """Phase 20: the flagship in bf16: 3 requests of one 800x1333 image, a
    batch of 4 at 800x1344 twice, then the batch with the plain versions
    and in f32 on the same weights."""
    rng = np.random.RandomState(SEED)
    imgs = [(rng.rand(*IMAGE_HW, 3) * 255).astype(np.uint8)
            for _ in range(3 + BATCH)]
    return bf16_serving(dev, name, smi, "bf16 hi-acc", CONFIG, imgs, BATCH,
                        "hi-acc bf16 serving")


def phase_bf16_rt_serving(dev, name, smi):
    """Phase 22: the real-time preset in bf16 at 544x544: 3 requests of
    COCO-sized images (stretched), a batch of 8 twice, then plain and f32
    as phase 20. The f32 comparison is logged, not held: the calibrated
    random backbone (``calibrate_frozen_bn``) centres every pre-activation
    on 0 and amplifies rounding ~100x on its way to the norm-free head, so
    bf16 moves its outputs by 4-66% of their max (read on the card), as it
    moves the JAX package's own bf16 graph on such weights (14% and 56% on
    cls_scores and centernesses at 256x256 on the CPU)."""
    from sipmask_tpu_torch.utils.demo_inputs import calibrate_frozen_bn
    rng = np.random.RandomState(SEED)
    imgs = [(rng.rand(*RT_SIZES[i % len(RT_SIZES)], 3) * 255)
            .astype(np.uint8) for i in range(3 + RT_BATCH)]
    return bf16_serving(
        dev, name, smi, "bf16 RT", RT_CONFIG, imgs, RT_BATCH,
        "rt bf16 serving",
        prepare=lambda det, images: calibrate_frozen_bn(det.model.backbone,
                                                        images),
        f32_tol=None)


def phase_bf16_preset_train(dev, name, smi, label, preset):
    """Phases 27e and 28e: ``preset`` in bf16, as phase 21 trains the
    flagship, each K1, K2, K4a and K4b call of the kernels' first step held
    within BF16_KERNEL_TOL of its plain version on the same inputs; HRNet
    with its own end-to-end bounds (BF16_HR_*)."""
    from sipmask_tpu_torch.utils.demo_inputs import train_batch
    hr = preset == HR_CONFIG
    return bf16_train(dev, name, smi, f"bf16 {label}", preset,
                      f"{label} bf16 training",
                      lambda cfg: train_batch(BATCH, 800, 1344, MAX_GTS, SEED,
                                              dev),
                      ("bbox_head.feat_align.conv_offset.weight",),
                      loss_tol=BF16_HR_LOSS_TOL if hr else BF16_LOSS_TOL,
                      grad_tol=BF16_HR_GRAD_TOL if hr else BF16_GRAD_TOL,
                      grad_median_tol=BF16_HR_GRAD_MEDIAN_TOL if hr else None,
                      checked=("deform_im2col", "deform_conv_backward",
                               "gn_relu_forward", "gn_relu_backward"))


def time_recorded(record, path):
    """K1, K2, K4a and K4b at the path's own shapes: the calls of one step
    recorded by :func:`checked_calls`, replayed through each kernel and its
    plain version in turns; ms a five-level sweep (a step's calls over the
    five levels)."""
    specs = checkable()
    for n, calls in record.items():
        mod, plain, _ = specs[n]
        kern = getattr(mod, n)
        with torch.no_grad():   # the forward wrappers record no gradient
            k, p = turns(f"{n}, the {len(calls)} calls of one {path} step",
                         lambda: [plain(*a) for a in calls],
                         lambda: [kern(*a) for a in calls], iters=3)
        sweeps = len(calls) / 5
        shapes = sorted({tuple(a[0].shape[2:]) for a in calls})
        log(f"{n} at the {path} shapes {shapes}: kernel {k / sweeps:.4f} "
            f"ms, plain {p / sweeps:.4f} ms a five-level sweep")
    record.clear()
    torch.cuda.empty_cache()


def phase_bf16_train(dev, name, smi):
    """Phase 21: the flagship in bf16: TRAIN_STEPS SGD steps at 800x1344,
    batch 4, launches counted, losses, frozen stages and f32 gradients
    checked; then the first step with the plain versions."""
    from sipmask_tpu_torch.utils.demo_inputs import train_batch
    return bf16_train(dev, name, smi, "bf16", CONFIG, "hi-acc bf16 training",
                      lambda cfg: train_batch(BATCH, 800, 1344, MAX_GTS, SEED,
                                              dev),
                      ("bbox_head.feat_align.conv_offset.weight",))


@contextlib.contextmanager
def cudnn_heuristics():
    """Within the context cuDNN picks its algorithms by heuristics, the
    same in every process (benchmark mode off, deterministic algorithms);
    the other backend flags stay as they are."""
    cudnn = torch.backends.cudnn
    saved = cudnn.benchmark, cudnn.deterministic
    cudnn.benchmark, cudnn.deterministic = False, True
    try:
        yield
    finally:
        cudnn.benchmark, cudnn.deterministic = saved


def bf16_train(dev, name, smi, label, preset, path, make_batch, trains,
               calibrate=False, pin=False, loss_tol=BF16_LOSS_TOL,
               loss_tols=None, grad_tol=BF16_GRAD_TOL,
               grad_median_tol=None, checked=()):
    """The train step of ``preset`` in bf16: TRAIN_STEPS SGD steps on
    ``make_batch(cfg)``, launches counted (no f32 variant), finite losses
    with loss_mask > 0, frozen stages unchanged, f32 parameters with
    finite f32 gradients, each of ``trains`` with a non-zero one; then the
    first step again from the same weights with the kernels and with the
    plain versions, compared: each loss relative (``loss_tols`` by name,
    else ``loss_tol``) and each gradient relative to its tensor's max
    (``grad_tol``; and, where given, the median of those errors over the
    tensors within ``grad_median_tol``). The two compared steps run with
    cuDNN's heuristic, deterministic algorithms (benchmark mode off): in
    benchmark mode a conv whose input layout differs between the runs gets
    its own algorithm timed and picked, and the comparison then also
    measures cuDNN's choice, which varies from process to process (bf16
    X101's loss_mask read 2.8e-05 to 1.1e-04 apart over five processes).
    ``calibrate``: fit the frozen BN
    to the batch (SipMask++); ``pin``: in that comparison the backbone's
    ReLUs and DCN sampling floors are pinned in both runs to those of one
    plain forward (:func:`plain_pins`; how far the f32 forward's lie is
    logged), and each K5 and K5c call of the kernels' step is held
    against its plain version on the same inputs (:func:`checked_calls`).
    ``checked``: kernel wrappers (no pins) held so in the kernels' step.
    """
    from sipmask_tpu_torch.config import get_config
    from sipmask_tpu_torch.train import create_train_state, make_train_step
    from sipmask_tpu_torch.utils.demo_inputs import (bump_weights,
                                                     calibrate_frozen_bn)

    cfg = bf16_config(preset)
    state = create_train_state(cfg, dev, seed=SEED)
    bump_weights(state.model, torch.Generator().manual_seed(SEED),
                 training=True)
    batch = make_batch(cfg)
    if calibrate:
        calibrate_frozen_bn(state.model.backbone, batch["images"])
    init = {k: v.detach().clone() for k, v in state.model.state_dict().items()}
    params = dict(state.model.named_parameters())
    frozen = {n: p.detach().clone() for n, p in params.items()
              if not p.requires_grad}
    step = make_train_step(state, cfg)
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    losses, peaks = [], []
    for i in range(TRAIN_STEPS):
        vals, _ = run_step(step, batch, f"{label} train step {i}", name, smi)
        losses.append(vals)
        peaks.append(torch.cuda.max_memory_allocated() / 2 ** 30)
        torch.cuda.reset_peak_memory_stats()
    launches = read_launches()
    check_path_launches(path, launches)
    check_no_f32_variant(path, launches)
    log(f"{label} peak device memory per train step (step 0 holds cuDNN's "
        f"algorithm search): " + ", ".join(f"{p:.2f} GiB" for p in peaks))
    for i, vals in enumerate(losses):
        if not all(np.isfinite(v) for v in vals.values()):
            raise AssertionError(f"{label} step {i}: non-finite losses "
                                 f"{vals}")
        if not vals["loss_mask"] > 0:
            raise AssertionError(f"{label} step {i}: loss_mask is "
                                 f"{vals['loss_mask']}")
    for n, v in frozen.items():
        if not torch.equal(params[n].detach(), v):
            raise AssertionError(f"frozen parameter {n} moved")
    for n, p in params.items():
        if p.dtype != torch.float32:
            raise AssertionError(f"parameter {n} is {p.dtype}")
        if p.requires_grad:
            if p.grad is None or p.grad.dtype != torch.float32:
                raise AssertionError(f"{n} has no f32 gradient")
            check_finite(f"gradient of {n}", p.grad)
    for n in trains:
        if not float(params[n].grad.abs().max()) > 0:
            raise AssertionError(f"{n} has a zero gradient")
    log(f"{label} train checks passed: finite losses, loss_mask > 0, frozen "
        f"stages unchanged, f32 parameters with finite f32 gradients, "
        f"{len(trains)} named tensors train")
    del state, step, params
    torch.cuda.empty_cache()

    runs = {}
    how = ""
    if pin:
        pins = plain_pins(
            create_train_state(cfg, dev, state_dict=init).model.backbone,
            batch["images"])
        log_pin_gap(label, pins, plain_pins(create_train_state(
            get_config(preset), dev, state_dict=init).model.backbone,
            batch["images"]))
        how = ", backbone ReLUs and sampling floors pinned"
    for run, ctx in (("kernels", contextlib.nullcontext),
                     ("plain", plain_kernels)):
        before = read_launches()
        state = create_train_state(cfg, dev, state_dict=init)
        step = make_train_step(state, cfg)
        with contextlib.ExitStack() as stack:
            stack.enter_context(cudnn_heuristics())
            stack.enter_context(ctx())
            if pin:
                moved = stack.enter_context(pinned(state.model.backbone,
                                                   *pins))
            if (pin or checked) and run == "kernels":
                errs = stack.enter_context(checked_calls(
                    checked or ("deform_rows", "deform_rows_backward")))
            vals, _ = run_step(step, batch, f"{label} {run} train step 0"
                               + how, name, smi)
        if pin:
            log(f"{label} {run}: positions moved per DCN conv {moved}")
        if checked and run == "kernels":
            log_checked(label, errs)
        elif pin and run == "kernels":
            log(f"{label}: each K5 and K5c call of the step against its "
                f"plain version on the same inputs, max relative error "
                + "; ".join(f"{n} " + ", ".join(f"{e:.2e}" for e in v)
                            for n, v in errs.items())
                + f" (tol {BF16_KERNEL_TOL})")
        if (read_launches() != before) != (run == "kernels"):
            raise AssertionError(f"the {run} train step launched "
                                 f"{'no' if run == 'kernels' else 'a'} "
                                 f"kernel")
        runs[run] = ({k: v for k, v in vals.items() if k != "match_acc"},
                     {n: p.grad.detach().clone() for n, p in
                      state.model.named_parameters() if p.requires_grad})
        del state, step
    (vals_k, grads_k), (vals_p, grads_p) = runs["kernels"], runs["plain"]
    tols = {k: (loss_tols or {}).get(k, loss_tol) for k in vals_p}
    rel = {k: abs(vals_p[k] - vals_k[k]) / max(abs(vals_p[k]), 1e-12)
           for k in vals_p}
    worst = worst_by_part(grads_k, grads_p)
    median = float(np.median([errors(grads_k[n], g)[1]
                              for n, g in grads_p.items()]))
    log(f"{label} kernels vs plain{how}: losses relative difference "
        + ", ".join(f"{k} {v:.3e} (tol {tols[k]})" for k, v in rel.items())
        + f"; gradients max relative error (to each tensor's max |g|) "
        f"{show_parts(worst)} (tol {grad_tol}), median over tensors "
        f"{median:.3e} (tol {grad_median_tol})")
    if not (all(rel[k] <= tols[k] for k in rel)
            and max(e for e, _ in worst.values()) <= grad_tol
            and (grad_median_tol is None or median <= grad_median_tol)):
        raise AssertionError(f"{label} step 0 disagrees: losses {rel} "
                             f"(tol {tols}), gradients {worst}, median "
                             f"{median} (tol {grad_tol}, median "
                             f"{grad_median_tol})")
    torch.cuda.empty_cache()
    return launches


def run_step(step, batch, label, name, smi):
    """One train step, timed on the host clock up to a synchronise."""
    t0 = time.perf_counter()
    metrics = step(batch)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    vals = {k: float(v) for k, v in metrics.items()}
    log(f"{label}: {ms:.1f} ms wall on {name} ({smi}); " + ", ".join(
        f"{k} {v:.6f}" for k, v in vals.items()))
    return vals, ms


def phase_train(dev, name, smi, preset=CONFIG, path="hi-acc training",
                checked=(), record=None, profile=False, reg_bias=None):
    """Phases 7 and 8: TRAIN_STEPS SGD steps of ``preset`` with the kernels,
    then the first step again from the same weights with the plain
    versions. ``checked``: kernel wrappers whose every call of the first
    step is held against its plain version on the call's own inputs
    (:func:`checked_calls`, CHECKED_TOL; ``record`` keeps their
    arguments). ``profile``: one more step under ``torch.profiler`` gives
    the device's idle share. With the benchmark fork's loss, the dedup's
    counts and ms are logged and its kept counts compared. ``reg_bias``:
    the fcos_reg bias in place of bump_weights' 2 (distances of reg_bias
    strides a side)."""
    from sipmask_tpu_torch.config import get_config
    from sipmask_tpu_torch.train import create_train_state, make_train_step
    from sipmask_tpu_torch.utils.demo_inputs import bump_weights, train_batch

    cfg = get_config(preset)
    fork = cfg.model.head.benchmark_loss_extras
    if (cfg.train.max_pos, cfg.data.max_gts, cfg.train.imgs_per_device) != (
            MAX_POS, MAX_GTS, BATCH):
        raise AssertionError("the preset's max_pos, max_gts or batch moved")
    # ---- 7. the train step
    state = create_train_state(cfg, dev, seed=SEED)
    bump_weights(state.model, torch.Generator().manual_seed(SEED))
    if reg_bias is not None:
        with torch.no_grad():
            state.model.bbox_head.fcos_reg.bias.fill_(reg_bias)
    init = {k: v.detach().clone() for k, v in state.model.state_dict().items()}
    params = dict(state.model.named_parameters())
    frozen = {n: p.detach().clone() for n, p in params.items()
              if not p.requires_grad}
    # demo_batch-style images with 8-16 gts each, padded to MAX_GTS
    batch = train_batch(BATCH, 800, 1344, MAX_GTS, SEED, dev)
    log(f"train batch: images {tuple(batch['images'].shape)}, gts per image "
        f"{(batch['gt_labels'] > 0).sum(1).tolist()}, {len(frozen)} frozen "
        f"and {len(params) - len(frozen)} trainable parameter tensors")
    step = make_train_step(state, cfg)
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    losses, peaks = [], []
    for i in range(TRAIN_STEPS):
        with contextlib.ExitStack() as stack:
            if i == 0 and checked:
                errs = stack.enter_context(checked_calls(
                    checked, CHECKED_TOL, record))
            if i == 0 and fork:
                dedup_k = stack.enter_context(dedup_counts())
            vals, _ = run_step(step, batch, f"{path} step {i}", name, smi)
        if i == 0 and checked:
            log_checked(f"{path} step 0 (tol {CHECKED_TOL})", errs)
        losses.append(vals)
        if i == 0:
            first_grads = {n: p.grad.detach().clone()
                           for n, p in params.items() if p.requires_grad}
        peaks.append(torch.cuda.max_memory_allocated() / 2 ** 30)
        torch.cuda.reset_peak_memory_stats()
    launches = read_launches()
    check_path_launches(path, launches)
    log("peak device memory per train step (torch.cuda.max_memory_allocated;"
        " step 0 holds cuDNN's algorithm search): " + ", ".join(
            f"{p:.2f} GiB" for p in peaks))
    for i, vals in enumerate(losses):
        if not all(np.isfinite(v) for v in vals.values()):
            raise AssertionError(f"step {i}: non-finite losses {vals}")
        if not vals["loss_mask"] > 0:
            raise AssertionError(f"step {i}: loss_mask is {vals['loss_mask']}")
    for n, v in frozen.items():
        if not torch.equal(params[n].detach(), v):
            raise AssertionError(f"frozen parameter {n} moved")
    for n, p in params.items():
        if p.requires_grad:
            if p.grad is None:
                raise AssertionError(f"{n} has no gradient")
            check_finite(f"gradient of {n}", p.grad)
    off_g = float(params["bbox_head.feat_align.conv_offset.weight"].grad
                  .abs().max())
    log(f"max |grad| of feat_align.conv_offset: {off_g:.3e}")
    if not off_g > 0:
        raise AssertionError("feat_align.conv_offset has a zero gradient")
    log(f"{path} checks passed: finite losses, loss_mask > 0, frozen "
        f"stages unchanged, finite gradients everywhere")
    if profile:
        idle_share(f"{path} step", lambda: step(batch), name, smi)
    del state, step, params
    torch.cuda.empty_cache()

    # ---- 8. the first step again with the plain versions
    state = create_train_state(cfg, dev, state_dict=init)
    step = make_train_step(state, cfg)
    before = read_launches()
    with plain_kernels(), (dedup_counts() if fork
                           else contextlib.nullcontext()) as dedup_p:
        vals, _ = run_step(step, batch, f"{path} plain step 0", name, smi)
    if read_launches() != before:
        raise AssertionError("the plain train step launched a kernel")
    if fork:
        log(f"{path}: the dedup (NMS-0.9 over each image's selected "
            f"positives) in step 0, (selected, kept, ms) kernels "
            f"{dedup_k}, plain {dedup_p}")
        kept_k, kept_p = dedup_k[0][1], dedup_p[0][1]
        if not (dedup_k[0][0] == dedup_p[0][0] and kept_k < dedup_k[0][0]
                and abs(kept_k - kept_p) <= max(2, 0.01 * kept_p)):
            raise AssertionError(f"the dedup's counts disagree or it kept "
                                 f"every positive: {dedup_k} vs {dedup_p}")
    worst_loss = max(abs(vals[k] - losses[0][k]) / max(abs(vals[k]), 1e-12)
                     for k in vals)
    log(f"losses, kernels vs plain: max relative difference "
        f"{worst_loss:.3e} (tol {LOSS_TOL})")
    if not worst_loss <= LOSS_TOL:
        raise AssertionError(f"losses disagree: {losses[0]} vs {vals}")
    worst, worst_name = 0.0, ""
    for n, p in state.model.named_parameters():
        if p.requires_grad:
            rel = errors(first_grads[n], p.grad)[1]
            if rel > worst:
                worst, worst_name = rel, n
    log(f"gradients, kernels vs plain: max relative error (to each tensor's "
        f"max |g|) {worst:.3e} at {worst_name} (tol {GRAD_TOL})")
    if not worst <= GRAD_TOL:
        raise AssertionError(f"gradients disagree: {worst} at {worst_name}")
    return launches


@contextlib.contextmanager
def plain_kernels():
    """Swap the model's kernel entry points for their plain versions at the
    call sites' module attributes: the deformable convs (K1 + K2, K5 + K5c),
    GroupNorm (K4a + K4b), the mask loss (K3a + K3b) and the mask assembly
    (K6)."""
    from sipmask_tpu_torch.ops import (deform_conv, gn_relu, mask_assembly,
                                       mask_loss)
    swaps = [(deform_conv, "deform_conv2d", deform_conv.deform_conv2d_plain),
             (deform_conv, "deform_conv2d_rows",
              deform_conv.deform_conv2d_rows_plain),
             (gn_relu, "gn_relu", gn_relu.gn_relu_plain),
             (mask_loss, "mask_bce_loss", mask_loss.mask_bce_loss_plain),
             (mask_assembly, "assemble_masks",
              mask_assembly.assemble_masks_plain)]
    saved = [getattr(mod, name) for mod, name, _ in swaps]
    for mod, name, plain in swaps:
        setattr(mod, name, plain)
    try:
        yield
    finally:
        for (mod, name, _), fn in zip(swaps, saved):
            setattr(mod, name, fn)


@contextlib.contextmanager
def kernel_subset(keep):
    """``plain_kernels()``, except that the sampled deformable route keeps
    its autograd function and launches the row-sampling kernels named in
    ``keep`` ("deform_rows" K5, "deform_rows_backward" K5c), each other one
    replaced by its plain version. ``keep`` empty: ``plain_kernels()``."""
    from sipmask_tpu_torch.ops import deform_conv
    from sipmask_tpu_torch.ops import deform_sample as ds
    routed = deform_conv.deform_conv2d_rows
    swaps = [(name, getattr(ds, name), getattr(ds, name + "_plain"))
             for name in ("deform_rows", "deform_rows_backward")
             if name not in keep]
    with plain_kernels():
        if keep:
            deform_conv.deform_conv2d_rows = routed
        for name, _, plain in swaps:
            setattr(ds, name, plain)
        try:
            yield
        finally:
            for name, real, _ in swaps:
                setattr(ds, name, real)


def run_batch(det, batch, capture):
    images, shapes, scales = batch
    capture.clear()
    out = det.infer(images, shapes, scales)
    torch.cuda.synchronize()
    return dict(capture), out


def check_finite(name, t):
    if not bool(torch.isfinite(t).all()):
        raise AssertionError(f"{name} has non-finite values")


def head_outputs(head):
    """(name, tensor) for every head output of a captured forward."""
    for key, val in head.items():
        for j, t in enumerate(val if isinstance(val, list) else [val]):
            yield f"{key}[{j}]", t


def check_head_finite(head):
    for name, t in head_outputs(head):
        check_finite(name, t)


def head_error(head_k, head_p):
    """Max relative error (to each output's max |x|) of run k's head
    outputs against run p's."""
    return max(errors(a, b)[1] for (_, a), (_, b) in
               zip(head_outputs(head_k), head_outputs(head_p)))


def matched_share(a, b, i, box_px=0.01, score_abs=1e-4):
    """Share of run a's detections of image i that run b also has: same
    label, boxes within ``box_px``, scores (and SipMask++'s mask_scores)
    within ``score_abs``."""
    va, vb = a["valid"][i], b["valid"][i]
    la, lb = a["labels"][i][va], b["labels"][i][vb]
    ba, bb = a["boxes"][i][va], b["boxes"][i][vb]
    if len(la) == 0:
        return 1.0
    same = ((la[:, None] == lb[None]) &
            ((ba[:, None] - bb[None]).abs().amax(-1) <= box_px))
    for key in ("scores", "mask_scores"):
        if key in a:
            sa, sb = a[key][i][va], b[key][i][vb]
            same &= (sa[:, None] - sb[None]).abs() <= score_abs
    return float(same.any(1).float().mean())


def phase_serving(dev, name, smi, preset=CONFIG, path="hi-acc serving",
                  profile=False):
    """Phases 4 and 5: the serving path of ``preset`` with the kernels,
    then the same batch with the plain versions. ``profile``: one more
    batch under ``torch.profiler`` gives the device's idle share."""
    from sipmask_tpu_torch.apis.inference import (inference_detector,
                                                  init_detector, preprocess)
    from sipmask_tpu_torch.utils.demo_inputs import bump_weights

    # ---- 4. the serving path
    gen = torch.Generator().manual_seed(SEED)
    det = init_detector(preset, dev, seed=SEED)
    bump_weights(det.model, gen)
    rng = np.random.RandomState(SEED)
    imgs = [(rng.rand(*IMAGE_HW, 3) * 255).astype(np.uint8)
            for _ in range(3 + BATCH)]
    prepped = [preprocess(im, det.cfg) for im in imgs[3:]]
    images = torch.stack([torch.from_numpy(p[0]).permute(2, 0, 1)
                          for p in prepped]).to(dev)
    batch = (images, torch.from_numpy(np.stack([p[1] for p in prepped])),
             torch.from_numpy(np.stack([p[2] for p in prepped])))
    capture = {}
    det.model.bbox_head.register_forward_hook(
        lambda mod, inp, out: capture.update(out))

    reset_launches()
    for i in range(3):
        t0 = time.perf_counter()
        res = inference_detector(det, imgs[i])
        ms = (time.perf_counter() - t0) * 1e3
        n = len(res["labels"])
        log(f"{path} request {i}: {IMAGE_HW} image -> {n} detections, "
            f"masks {res['masks'].shape}, {ms:.1f} ms wall on {name} ({smi})")
        if n == 0 or not np.isfinite(res["boxes"]).all():
            raise AssertionError(f"request {i}: no valid or finite result")
        if res["masks"].shape != (n, *IMAGE_HW):
            raise AssertionError(f"request {i}: masks {res['masks'].shape}")
    torch.cuda.reset_peak_memory_stats()
    for _ in range(2):   # the first run is the first at the batch shapes
        t0 = time.perf_counter()
        head_k, dec_k = run_batch(det, batch, capture)
        ms = (time.perf_counter() - t0) * 1e3
        log(f"{path} batch of {tuple(images.shape)} through Detector.infer: "
            f"{ms:.1f} ms wall on {name} ({smi}); peak memory "
            f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
    launches = read_launches()
    check_path_launches(path, launches)
    valid = dec_k["valid"].sum(1).tolist()
    log(f"valid detections per image of the batch: {valid}")
    if min(valid) <= 0:
        raise AssertionError("an image of the batch has no detection")
    check_head_finite(head_k)
    for key in ("boxes", "scores", "masks"):
        check_finite(key, dec_k[key])
    m = dec_k["masks"]
    if not (float(m.min()) >= 0.0 and float(m.max()) <= 1.0):
        raise AssertionError("mask probabilities outside [0, 1]")
    if tuple(m.shape) != (BATCH, det.cfg.model.test.max_per_img,
                          images.shape[2] // 2, images.shape[3] // 2):
        raise AssertionError(f"masks {tuple(m.shape)}")
    log("finite-output checks passed: head outputs, boxes, scores, masks "
        "in [0, 1]")

    # ---- 5. the same batch with the plain versions
    with plain_kernels():
        head_p, dec_p = run_batch(det, batch, capture)
    if read_launches() != launches:
        raise AssertionError("the plain run launched a kernel")
    worst = head_error(head_k, head_p)
    log(f"head outputs, kernels vs plain: max relative error {worst:.3e} "
        f"(tol {HEAD_TOL})")
    if not worst <= HEAD_TOL:
        raise AssertionError(f"head outputs disagree: {worst}")
    shares = [min(matched_share(dec_k, dec_p, i),
                  matched_share(dec_p, dec_k, i)) for i in range(BATCH)]
    log(f"decoded detections reproduced by the plain run (label, box within "
        f"0.01 px, score within 1e-4): {shares} (min {MATCH_MIN})")
    if min(shares) < MATCH_MIN or \
            dec_k["valid"].sum(1).tolist() != dec_p["valid"].sum(1).tolist():
        raise AssertionError("decoded detections disagree")
    if profile:
        idle_share(f"{path} batch", lambda: run_batch(det, batch, capture),
                   name, smi)
    del det
    torch.cuda.empty_cache()
    return launches


def idle_share(label, fn, name, smi):
    """Log the wall ms, the device's busy ms (the union of its kernels'
    intervals) and idle share of one fn() under ``torch.profiler`` (after
    a synchronise)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    from sipmask_tpu_torch.tools.measure import busy_ms, kernel_events
    busy = busy_ms(kernel_events(prof))
    log(f"{label} under the profiler: {wall:.1f} ms wall, device busy "
        f"{busy:.1f} ms (kernel time {device_busy_ms(prof):.1f} ms), "
        f"device idle share {1 - busy / wall:.3f} on {name} ({smi})")


@contextlib.contextmanager
def dedup_counts():
    """Within the context each call of the loss's ``hard_nms`` (the
    benchmark fork's NMS-0.9 dedup) is timed to a synchronise and its
    counts kept: yields a list of (selected positives, kept, ms)."""
    import sipmask_tpu_torch.models.loss as loss_mod
    from sipmask_tpu_torch.ops.nms import NEG
    real, calls = loss_mod.hard_nms, []

    def counted(boxes, scores, thr, max_out):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real(boxes, scores, thr, max_out)
        torch.cuda.synchronize()
        calls.append((int((scores > NEG / 2).sum()), int(out[2].sum()),
                      (time.perf_counter() - t0) * 1e3))
        return out
    loss_mod.hard_nms = counted
    try:
        yield calls
    finally:
        loss_mod.hard_nms = real


# ------------------------------------------------------------- SipMask++

def pp_positions(b, c, h, w, gen, dev, zero=False):
    """x_rows (B, h*w, C) and pyx (B, 9, h*w, 2) of a DCN conv2 (3x3, pad 1,
    deform_groups 1): offsets ~2 px, a third of the pixels +-300 px out
    (or all zero, DeformConvPack's initial state)."""
    from sipmask_tpu_torch.ops import deform_sample as ds
    x = torch.randn((b, h * w, c), generator=gen).to(dev)
    off = torch.randn((b, 18, h, w), generator=gen) * 2.0
    off.view(b, 18, h * w)[:, :, : (h * w) // 3] *= 150.0
    if zero:
        off.zero_()
    return x, ds.positions(off.to(dev), 3, 3, 1, 1, 1, 1).contiguous()


def k6_inputs(b, h, w, n, gen, dev):
    """A basis (NCHW view, as the head gives it), coefficients and boxes of
    5-60% of the grid, a fifth degenerate (zero width)."""
    basis = torch.randn((b, 32, h, w), generator=gen).to(dev)
    cofs = (torch.randn((b, n, 128), generator=gen) * 0.3).to(dev)
    frac = torch.sqrt(torch.rand((b, n, 1), generator=gen) * 0.55 + 0.05)
    wh = frac * torch.tensor([w, h], dtype=torch.float32)
    ctr = torch.rand((b, n, 2), generator=gen) * torch.tensor(
        [w, h], dtype=torch.float32)
    boxes = torch.cat([ctr - wh / 2, ctr + wh / 2], -1)
    boxes[:, ::5, 2] = boxes[:, ::5, 0]
    return basis.permute(0, 2, 3, 1), cofs, boxes.to(dev)


def phase_pp_kernels(dev):
    """Phase 9: K5 and K5c at the R101 DCN stages' shapes at 544x544 and
    576x576, batch 8 (random offsets with a third +-300 px out, and zero
    offsets), K6 at
    the decode's (272x272 grid, 100 detections) and the rescoring loss's
    (288x288, K = 256) shapes, batch 8; then times, bounds and library
    equivalents."""
    from sipmask_tpu_torch.ops import deform_sample as ds
    from sipmask_tpu_torch.ops import mask_assembly as ma

    gen = torch.Generator().manual_seed(SEED + 2)
    errs = {"deform_rows": 0.0, "deform_rows_backward": 0.0}
    for (c, h, w), path in [(s, "serving") for s in PP_DCN] + [
            (s, "training") for s in PP_DCN_TRAIN]:
        for zero in (False, True):
            x, pyx = pp_positions(PP_BATCH, c, h, w, gen, dev, zero)
            g = torch.randn((PP_BATCH, h * w, 9, c), generator=gen).to(dev)
            got = ds.deform_rows(x, pyx, h, w)
            dx, dp = ds.deform_rows_backward(x, pyx, g, h, w)
            if not torch.equal(dp, ds.deform_rows_backward(x, pyx, g, h,
                                                           w)[1]):
                raise AssertionError("two K5c calls gave different d "
                                     "positions")
            want = ds.deform_rows_plain(x, pyx, h, w)
            wdx, wdp = ds.deform_rows_backward_plain(x, pyx, g, h, w)
            torch.cuda.synchronize()
            label = (f"{path} {(PP_BATCH, c, h, w)} "
                     f"{'zero' if zero else 'random'}")
            ab = errors(got, want)[0]
            log(f"K5 deform_rows {label} offsets: max_abs_err {ab:.3e} "
                f"(tol abs {K5_TOL})")
            if not ab <= K5_TOL:
                raise AssertionError(f"K5 disagrees with its plain version "
                                     f"at {label}: {ab}")
            errs["deform_rows"] = max(errs["deform_rows"], ab)
            errs["deform_rows_backward"] = max(
                errs["deform_rows_backward"], check_outputs(
                    f"K5c deform_rows_backward {label} offsets (dx, dpyx)",
                    [dx, dp], [wdx, wdp], TRAIN_KERNEL_TOL))
            if zero and not float(dp.abs().max()) > 0:
                raise AssertionError("K5c gives zero offset gradients at "
                                     "zero offsets")
            del x, pyx, g, got, dx, dp, want, wdx, wdp
    errs["assemble_masks"] = 0.0
    for hw, n in (((272, 272), 100), ((288, 288), PP_MAX_POS)):
        args = k6_inputs(PP_BATCH, *hw, n, gen, dev)
        got = ma.assemble_masks(*args)
        want = ma.assemble_masks_plain(*args)
        torch.cuda.synchronize()
        ab = errors(got, want)[0]
        same_zeros = bool(torch.equal(got == 0, want == 0))
        # detection-major: the callers' (B, N, h, w) masks with no copy
        nchw = got.permute(0, 3, 1, 2)
        in_place = nchw.is_contiguous() and \
            nchw.contiguous().data_ptr() == got.data_ptr()
        log(f"K6 assemble_masks {hw} N={n} bs{PP_BATCH}: max_abs_err "
            f"{ab:.3e} (tol abs {K6_TOL}), same zeros {same_zeros}, "
            f"(B, N, h, w) in place {in_place}")
        if not (ab <= K6_TOL and same_zeros and in_place):
            raise AssertionError(f"K6 disagrees with its plain version at "
                                 f"{hw}: {ab}, same zeros {same_zeros}, "
                                 f"(B, N, h, w) in place {in_place}")
        errs["assemble_masks"] = max(errs["assemble_masks"], ab)
        del args, got, want

    # times at the serving shapes: one DCN conv of each stage (K5, K5c), the
    # decode's assembly of a batch of 8 (K6)
    k5_in = [pp_positions(PP_BATCH, c, h, w, gen, dev) + (h, w)
             for c, h, w in PP_DCN]
    k5c_g = [torch.randn((PP_BATCH, h * w, 9, c), generator=gen).to(dev)
             for c, h, w in PP_DCN]
    times = {"deform_rows": turns(
        f"K5 deform_rows, one DCN conv of each stage bs{PP_BATCH}",
        lambda: [ds.deform_rows_plain(*a) for a in k5_in],
        lambda: [ds.deform_rows(*a) for a in k5_in])}
    graphs = []
    for (x, pyx, h, w), g in zip(k5_in, k5c_g):
        leaves = [t.detach().requires_grad_(True) for t in (x, pyx)]
        graphs.append((ds.deform_rows_plain(*leaves, h, w), leaves, g))
    times["deform_rows_backward"] = turns(
        f"K5c deform_rows_backward, one DCN conv of each stage bs{PP_BATCH}",
        lambda: [torch.autograd.grad(o, lv, g, retain_graph=True)
                 for o, lv, g in graphs],
        lambda: [ds.deform_rows_backward(x, pyx, g, h, w)
                 for (x, pyx, h, w), g in zip(k5_in, k5c_g)], iters=10)
    del graphs
    # K5c at the train step's shapes, and one call split into its device
    # kernels: the kernel after the zeroing of dx
    k5c_train = []
    for c, h, w in PP_DCN_TRAIN:
        x, pyx = pp_positions(PP_BATCH, c, h, w, gen, dev)
        k5c_train.append((x, pyx, torch.randn((PP_BATCH, h * w, 9, c),
                                              generator=gen).to(dev), h, w))
    def k5c_train_sweep():
        return [ds.deform_rows_backward(*a) for a in k5c_train]
    log(f"time K5c deform_rows_backward, one DCN conv of each stage at "
        f"{PP_TRAIN_HW} bs{PP_BATCH}: kernel {cuda_ms(k5c_train_sweep):.4f}"
        f" / {cuda_ms(k5c_train_sweep):.4f} ms")
    for label, sweep in (("serving", lambda: [
            ds.deform_rows_backward(x, pyx, g, h, w)
            for (x, pyx, h, w), g in zip(k5_in, k5c_g)]),
                         ("training", k5c_train_sweep)):
        launch_split(f"K5c deform_rows_backward, {label} shapes "
                     f"bs{PP_BATCH}", sweep)
    # the profiler may miss the kernel that zeroes dx (at this size it did
    # in every session of one run), and never adds one
    split, n_kern = launch_split(
        f"K5c deform_rows_backward, one call at {PP_DCN_TRAIN[0]} "
        f"bs{PP_BATCH}", lambda: ds.deform_rows_backward(*k5c_train[0]))
    n_k5c = sum(n for name, (n, _) in split.items()
                if "deform_rows_bwd_kernel" in name)
    if n_k5c != 1 or n_kern - n_k5c > 1:
        raise AssertionError(f"a K5c call ran {n_kern} device kernels, not "
                             f"its kernel after the zeroing of dx: {split}")
    del k5c_train
    # K6 at the rescoring loss's mask grid (288x288, K = 256), then at the
    # decode's (the unit of the kernels line)
    k6_in = k6_inputs(PP_BATCH, 288, 288, PP_MAX_POS, gen, dev)
    turns(f"K6 assemble_masks 288x288 N={PP_MAX_POS} bs{PP_BATCH}",
          lambda: ma.assemble_masks_plain(*k6_in),
          lambda: ma.assemble_masks(*k6_in), iters=10)
    k6_in = k6_inputs(PP_BATCH, 272, 272, 100, gen, dev)
    times["assemble_masks"] = turns(
        f"K6 assemble_masks 272x272 N=100 bs{PP_BATCH}",
        lambda: ma.assemble_masks_plain(*k6_in),
        lambda: ma.assemble_masks(*k6_in))

    out_elems = sum(x.shape[0] * x.shape[1] * 9 * x.shape[2]
                    for x, *_ in k5_in)
    libs = [grid_sample_rows(x, pyx, h, w) for x, pyx, h, w in k5_in]
    lib_graphs = []
    for (call, inp, grid), g in zip(libs, k5c_g):
        leaves = [inp.detach().requires_grad_(True),
                  grid.detach().requires_grad_(True)]
        out = call(*leaves)
        lib_graphs.append((out, leaves, g.permute(0, 3, 2, 1).reshape(
            out.shape).contiguous()))
    k6_inbox = in_box_pixels(k6_in[2], torch.ones_like(k6_in[2][..., 0]),
                             272, 272)
    extra = {
        "deform_rows": (bound(sum(nbytes(x, pyx) for x, pyx, *_ in k5_in)
                              + 4 * out_elems, 7 * out_elems),
                        cuda_ms(lambda: [c() for c, *_ in libs])),
        # reads x, pyx and dsampled; writes dx (up to 4 adds an element,
        # vector atomics) and dpyx; ~18 flops an element
        "deform_rows_backward": (bound(
            sum(2 * nbytes(x, pyx) for x, pyx, *_ in k5_in)
            + 4 * out_elems, 18 * out_elems), cuda_ms(
                lambda: [torch.autograd.grad(o, lv, g, retain_graph=True)
                         for o, lv, g in lib_graphs], iters=10)),
        # a 32-term dot and a sigmoid (~68 flops) per in-box pair
        "assemble_masks": (bound(nbytes(*k6_in) + 4 * PP_BATCH * 272 * 272
                                 * 100, 68 * k6_inbox), None),
    }
    for name, (bnd, lib) in extra.items():
        log(f"{name}: bound {bnd[0]:.4f} ms ({bnd[1]}), one-call library "
            f"equivalent " + ("none" if lib is None else f"{lib:.4f} ms"))
    del k5_in, k5c_g, libs, lib_graphs, k6_in
    torch.cuda.empty_cache()
    return errs, times, extra


def pp_batch_images(n, seed):
    """n random 544x544 BGR uint8 images."""
    rng = np.random.RandomState(seed)
    return [(rng.rand(*PP_HW, 3) * 255).astype(np.uint8) for _ in range(n)]


def phase_pp_serving(dev, name, smi):
    """Phase 10: SipMask++ serving with the kernels, then the batch with
    the plain versions."""
    from sipmask_tpu_torch.apis.inference import (inference_detector,
                                                  init_detector, preprocess)
    from sipmask_tpu_torch.utils.demo_inputs import (bump_weights,
                                                     calibrate_frozen_bn)

    det = init_detector(PP_CONFIG, dev, seed=SEED)
    bump_weights(det.model, torch.Generator().manual_seed(SEED))
    imgs = pp_batch_images(3 + PP_BATCH, SEED)
    prepped = [preprocess(im, det.cfg) for im in imgs[3:]]
    images = torch.stack([torch.from_numpy(p[0]).permute(2, 0, 1)
                          for p in prepped]).to(dev)
    batch = (images, torch.from_numpy(np.stack([p[1] for p in prepped])),
             torch.from_numpy(np.stack([p[2] for p in prepped])))
    # a pretrained backbone's BN standardises its activations; random
    # weights with identity BN grow them ~3x a block (see the function)
    calibrate_frozen_bn(det.model.backbone, images)
    capture = {}
    det.model.bbox_head.register_forward_hook(
        lambda mod, inp, out: capture.update(out))

    reset_launches()
    req_ms = []
    for i in range(3):
        t0 = time.perf_counter()
        res = inference_detector(det, imgs[i])
        req_ms.append((time.perf_counter() - t0) * 1e3)
        n = len(res["labels"])
        log(f"SipMask++ request {i}: {PP_HW} image -> {n} detections, "
            f"mask_scores {res['mask_scores'][:3]}, {req_ms[-1]:.1f} ms "
            f"wall on {name} ({smi})")
        if n == 0 or not np.isfinite(res["mask_scores"]).all():
            raise AssertionError(f"request {i}: no valid or finite result")
        if res["masks"].shape != (n, *PP_HW):
            raise AssertionError(f"request {i}: masks {res['masks'].shape}")
    torch.cuda.reset_peak_memory_stats()
    for _ in range(2):   # the first run is the first at the batch shapes
        t0 = time.perf_counter()
        head_k, dec_k = run_batch(det, batch, capture)
        ms = (time.perf_counter() - t0) * 1e3
        log(f"SipMask++ batch of {tuple(images.shape)} through "
            f"Detector.infer: {ms:.1f} ms wall on {name} ({smi}); peak "
            f"memory {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
    launches = read_launches()
    check_path_launches("sipmask++ serving", launches)
    valid = dec_k["valid"].sum(1).tolist()
    log(f"valid detections per image of the batch: {valid}")
    if min(valid) <= 0:
        raise AssertionError("an image of the batch has no detection")
    check_head_finite(head_k)
    for key in ("boxes", "scores", "masks", "mask_scores"):
        check_finite(key, dec_k[key])
    ms_valid = dec_k["mask_scores"][dec_k["valid"]]
    if not float(ms_valid.min()) > 0:
        raise AssertionError("a valid detection has mask score 0")

    with plain_kernels():
        head_p, dec_p = run_batch(det, batch, capture)
    if read_launches() != launches:
        raise AssertionError("the plain run launched a kernel")
    worst = head_error(head_k, head_p)
    log(f"SipMask++ head outputs, kernels vs plain: max relative error "
        f"{worst:.3e} (tol {HEAD_TOL})")
    if not worst <= HEAD_TOL:
        raise AssertionError(f"head outputs disagree: {worst}")
    shares = [min(matched_share(dec_k, dec_p, i),
                  matched_share(dec_p, dec_k, i))
              for i in range(PP_BATCH)]
    log(f"SipMask++ detections reproduced by the plain run (label, box "
        f"within 0.01 px, score and mask score within 1e-4): {shares} "
        f"(min {MATCH_MIN})")
    if min(shares) < MATCH_MIN or \
            dec_k["valid"].sum(1).tolist() != dec_p["valid"].sum(1).tolist():
        raise AssertionError("decoded detections disagree")
    del det
    torch.cuda.empty_cache()
    return launches


def phase_pp_train(dev, name, smi):
    """Phase 11: SipMask++ SGD steps with the kernels, then the first step
    again from the same weights with the plain versions."""
    from sipmask_tpu_torch.config import get_config
    from sipmask_tpu_torch.train import create_train_state, make_train_step
    from sipmask_tpu_torch.utils.demo_inputs import (bump_weights,
                                                     calibrate_frozen_bn,
                                                     train_batch_for)

    cfg = get_config(PP_CONFIG)
    if (cfg.data.train_size, cfg.train.imgs_per_device,
            cfg.train.max_pos) != (PP_TRAIN_HW, PP_BATCH, PP_MAX_POS):
        raise AssertionError("the preset's train size, batch or max_pos "
                             "moved")
    state = create_train_state(cfg, dev, seed=SEED)
    bump_weights(state.model, torch.Generator().manual_seed(SEED),
                 training=True)
    batch = train_batch_for(cfg, SEED, dev)
    calibrate_frozen_bn(state.model.backbone, batch["images"])
    init = {k: v.detach().clone() for k, v in state.model.state_dict().items()}
    params = dict(state.model.named_parameters())
    frozen = {n: p.detach().clone() for n, p in params.items()
              if not p.requires_grad}
    offsets = [n for n in params if n.startswith("backbone.")
               and n.endswith("conv2.conv_offset.weight")]
    log(f"SipMask++ train batch: images {tuple(batch['images'].shape)}, gts "
        f"per image {(batch['gt_labels'] > 0).sum(1).tolist()}, "
        f"{len(offsets)} DCN blocks, {len(frozen)} frozen and "
        f"{len(params) - len(frozen)} trainable parameter tensors")
    if len(offsets) != 11:
        raise AssertionError(f"R101 with DCN in stages 2-4 has 11 DCN "
                             f"blocks, not {len(offsets)}")
    step = make_train_step(state, cfg)
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    losses, peaks = [], []
    for i in range(TRAIN_STEPS):
        vals, _ = run_step(step, batch, f"SipMask++ train step {i}", name,
                           smi)
        losses.append(vals)
        if i == 0:
            first_grads = {n: p.grad.detach().clone()
                           for n, p in params.items() if p.requires_grad}
        peaks.append(torch.cuda.max_memory_allocated() / 2 ** 30)
        torch.cuda.reset_peak_memory_stats()
    launches = read_launches()
    check_path_launches("sipmask++ training", launches)
    log("SipMask++ peak device memory per train step: " + ", ".join(
        f"{p:.2f} GiB" for p in peaks))
    for i, vals in enumerate(losses):
        if not all(np.isfinite(v) for v in vals.values()):
            raise AssertionError(f"step {i}: non-finite losses {vals}")
        if not (vals["loss_mask"] > 0 and "loss_iou" in vals):
            raise AssertionError(f"step {i}: loss_mask {vals['loss_mask']}, "
                                 f"losses {sorted(vals)}")
    for n, v in frozen.items():
        if not torch.equal(params[n].detach(), v):
            raise AssertionError(f"frozen parameter {n} moved")
    for n, g in first_grads.items():
        check_finite(f"gradient of {n}", g)
    off_g = {n: float(first_grads[n].abs().max()) for n in offsets}
    log(f"max |grad| of the DCN conv_offset weights, step 0: "
        f"{min(off_g.values()):.3e} .. {max(off_g.values()):.3e}")
    if not min(off_g.values()) > 0:
        raise AssertionError(f"a DCN conv_offset has a zero gradient: "
                             f"{off_g}")
    log("SipMask++ train checks passed: finite losses, loss_mask > 0, "
        "loss_iou present, frozen stages unchanged, every DCN offset conv "
        "trains")
    del state, step, params, first_grads
    torch.cuda.empty_cache()

    # the first step again, the backbone's ReLUs pinned to the masks of one
    # forward: with the kernels, with the plain versions, with only K5 or
    # only K5c launching, and with the plain versions in float64
    variants = [("kernels", None), ("plain", ())] + list(PP_SPLIT) + [
        ("plain f64", ())]
    snapshot = read_launches()
    runs, floors = {}, {}
    for label, keep in variants:
        state = create_train_state(cfg, dev, state_dict=init)
        run_batch64 = batch
        if label == "plain f64":
            state.model.double()
            run_batch64 = {k: v.double() if v.is_floating_point() else v
                           for k, v in batch.items()}
        step = make_train_step(state, cfg)
        if not runs:
            masks = relu_masks(state.model.backbone, batch["images"])
        with contextlib.ExitStack() as stack:
            if keep is not None:
                stack.enter_context(kernel_subset(keep))
            stack.enter_context(pinned_relus(state.model.backbone, masks))
            floors[label] = stack.enter_context(recorded_floors())
            vals, _ = run_step(
                step, run_batch64, f"SipMask++ {label} train step 0, "
                f"backbone ReLUs pinned", name, smi)
        now = read_launches()
        ran = sorted(k for k in now if now[k] != snapshot[k])
        if keep is not None and ran != sorted(keep):
            raise AssertionError(f"the {label} train step launched {ran}")
        snapshot = now
        runs[label] = (vals, {
            n: p.grad.detach().clone()
            for n, p in state.model.named_parameters() if p.requires_grad})
        del state, step
    del masks, run_batch64
    for label in ("plain", "plain f64"):
        flips = [int((a != b).sum()) for a, b in
                 zip(floors["kernels"], floors[label])]
        log(f"sampling positions whose floor differs between the kernels "
            f"and the {label} run, per DCN block: {flips} of "
            f"{[a.numel() for a in floors['kernels']]}")
    del floors
    vals = runs["plain"][0]
    for label in ["kernels"] + [lb for lb, _ in PP_SPLIT]:
        for k in vals:
            rel = abs(vals[k] - runs[label][0][k]) / max(abs(vals[k]), 1e-12)
            tol = PP_LOSS_TOL.get(k, LOSS_TOL)
            log(f"{k}, {label} vs plain, pinned: relative difference "
                f"{rel:.3e} (tol {tol})")
            if not rel <= tol:
                raise AssertionError(f"{k} disagrees: {label} "
                                     f"{runs[label][0][k]} vs plain {vals[k]}")
    for k in vals:
        rel = abs(vals[k] - losses[0][k]) / max(abs(vals[k]), 1e-12)
        tol = PP_LOSS_TOL.get(k, LOSS_TOL)
        log(f"{k}, unpinned kernels vs pinned plain: relative difference "
            f"{rel:.3e} (tol {tol})")
        if not rel <= tol:
            raise AssertionError(f"{k} disagrees: {losses[0][k]} vs "
                                 f"{vals[k]}")

    grads = runs["plain"][1]
    for label in ["kernels"] + [lb for lb, _ in PP_SPLIT]:
        worst = worst_by_part(runs[label][1], grads)
        log(f"SipMask++ gradients, {label} vs plain with the backbone's "
            f"ReLUs pinned: max relative error (to each tensor's max |g|) "
            f"{show_parts(worst)} (tol backbone {PP_BACKBONE_GRAD_TOL}, rest "
            f"{PP_GRAD_TOL})")
        if not (max(rel for part, (rel, _) in worst.items()
                    if part != "rest") <= PP_BACKBONE_GRAD_TOL
                and worst["rest"][0] <= PP_GRAD_TOL):
            raise AssertionError(f"gradients disagree, {label}: {worst}")
    ref64 = runs["plain f64"][1]
    for label in ["plain", "kernels"] + [lb for lb, _ in PP_SPLIT]:
        worst = worst_by_part(runs[label][1], ref64)
        log(f"SipMask++ gradients, f32 {label} vs plain f64, pinned: max "
            f"relative error {show_parts(worst)}; "
            f"loss_total {runs[label][0]['loss_total']:.9f} against "
            f"{runs['plain f64'][0]['loss_total']:.9f}")
    del batch, runs, grads, ref64
    torch.cuda.empty_cache()
    return launches


def worst_by_part(grads, ref):
    """{part: (max relative error to the tensor's max |g|, its name)} of
    ``grads`` against ``ref`` by part: "backbone conv_offset" (the DCN
    offset convs), "backbone" and "rest" (neck, head)."""
    worst = {}
    for n, g in ref.items():
        part = ("rest" if not n.startswith("backbone.") else
                "backbone conv_offset" if ".conv_offset." in n
                else "backbone")
        rel = errors(grads[n].to(g.dtype), g)[1]
        if rel >= worst.get(part, (0.0, ""))[0]:
            worst[part] = (rel, n)
    return worst


def show_parts(worst):
    return ", ".join(f"{part} {rel:.3e} at {n}"
                     for part, (rel, n) in sorted(worst.items()))


def relu_masks(backbone, images):
    """The sign masks (x > 0) of ``backbone``'s ReLU calls, in call order,
    from one forward without gradients."""
    real, masks = torch.relu, []

    def record(x):
        masks.append(x > 0)
        return real(x)
    torch.relu = record
    try:
        with torch.no_grad():
            backbone(images)
    finally:
        torch.relu = real
    return masks


@contextlib.contextmanager
def recorded_floors():
    """Within the context, the floor of every sampling position the
    sampled route computes (one tensor per DCN conv, in call order) is
    appended to the yielded list."""
    from sipmask_tpu_torch.ops import deform_sample as ds
    real, out = ds.positions, []

    def positions(*args):
        pyx = real(*args)
        out.append(torch.floor(pyx.detach()))
        return pyx
    ds.positions = positions
    try:
        yield out
    finally:
        ds.positions = real


@contextlib.contextmanager
def pinned_relus(backbone, masks):
    """Within the context, the i-th ReLU call of each forward of
    ``backbone`` returns ``x * masks[i]``: the same piecewise-linear
    function in every run, whatever side of 0 each run's rounding puts a
    pre-activation on. Raises unless each forward made len(masks) calls."""
    real, calls = torch.relu, [0]

    def pinned(x):
        m = masks[calls[0] % len(masks)]
        calls[0] += 1
        if m.shape != x.shape:
            raise AssertionError(f"ReLU call {calls[0]}: mask {m.shape}, "
                                 f"input {x.shape}")
        return x * m

    def on(*_):
        torch.relu = pinned

    def off(*_):
        torch.relu = real
    hooks = [backbone.register_forward_pre_hook(on),
             backbone.register_forward_hook(off)]
    try:
        yield
    finally:
        for h in hooks:
            h.remove()
        torch.relu = real
    if calls[0] % len(masks) or not calls[0]:
        raise AssertionError(f"{calls[0]} pinned ReLU calls, "
                             f"{len(masks)} a forward")


class _HeldInCell(torch.autograd.Function):
    """pyx clamped into [floors, floors + 1); the gradient passes as it
    came."""

    @staticmethod
    def forward(ctx, pyx, floors):
        return torch.minimum(torch.maximum(pyx, floors),
                             torch.nextafter(floors + 1, floors))

    @staticmethod
    def backward(ctx, g):
        return g, None


@contextlib.contextmanager
def pinned_floors(floors):
    """Within the context, the i-th sampling-position tensor that the
    sampled route computes in each forward (in call order, as
    :func:`recorded_floors` records them) is held in the unit cell whose
    corner is ``floors[i]``, its gradient passed unchanged: the same
    corners and the same one-sided floor derivative in every run, whatever
    side of an integer each run's rounding puts a position on. Yields a
    list to which each call appends how many positions it moved; raises
    unless each forward made len(floors) calls."""
    from sipmask_tpu_torch.ops import deform_sample as ds
    real, moved = ds.positions, []

    def positions(*args):
        pyx = real(*args)
        f = floors[len(moved) % len(floors)]
        if f.shape != pyx.shape:
            raise AssertionError(f"sampling call {len(moved) + 1}: floors "
                                 f"{f.shape}, positions {pyx.shape}")
        moved.append(int((torch.floor(pyx.detach()) != f).sum()))
        return _HeldInCell.apply(pyx, f)
    ds.positions = positions
    try:
        yield moved
    finally:
        ds.positions = real
    if len(moved) % len(floors) or not moved:
        raise AssertionError(f"{len(moved)} pinned sampling calls, "
                             f"{len(floors)} a forward")


@contextlib.contextmanager
def pinned(backbone, masks, floors):
    """:func:`pinned_relus` and :func:`pinned_floors` together; yields the
    positions moved per sampling call."""
    with pinned_relus(backbone, masks), pinned_floors(floors) as moved:
        yield moved


def plain_pins(backbone, images):
    """The ReLU masks and sampling floors of one forward of ``backbone``
    on ``images`` with the plain versions: what both runs of a
    kernels-vs-plain comparison are pinned to."""
    with plain_kernels(), recorded_floors() as floors:
        masks = relu_masks(backbone, images)
    return masks, floors


def log_pin_gap(label, pins, other):
    """Logs how far the pins of another forward (``other``: the f32
    model's) lie from ``pins``: positions in another cell per DCN conv,
    and the share of ReLU inputs on the other side of 0."""
    cells = [int((a != b).any(-1).sum()) for a, b in zip(pins[1], other[1])]
    flips = (sum(int((a != b).sum()) for a, b in zip(pins[0], other[0]))
             / sum(m.numel() for m in pins[0]))
    log(f"{label}: the f32 forward puts sampling positions in another cell "
        f"than the plain bf16 forward, per DCN conv, {cells} of "
        f"{[f.shape[0] * f.shape[1] * f.shape[2] for f in pins[1]]}, and "
        f"{flips:.3e} of the backbone's ReLU inputs on the other side of 0")


def log_checked(label, errs):
    """Log :func:`checked_calls`' errors: the calls and the worst of each
    kernel."""
    log(f"{label}: each call against its plain version on the same inputs, "
        + "; ".join(f"{n} {len(v)} calls, max relative error "
                    f"{max(v, default=0.0):.2e}" for n, v in errs.items()))


def checkable():
    """{wrapper: (module, plain version on the wrapper's arguments, number
    of leading outputs compared)} of the kernel wrappers
    :func:`checked_calls` can hold call by call: K1, K2, K4a (its y; the
    statistics it keeps feed K4b, held too), K4b, K5 and K5c."""
    from sipmask_tpu_torch.ops import deform_conv as dc
    from sipmask_tpu_torch.ops import deform_sample as ds
    from sipmask_tpu_torch.ops import gn_relu as gn
    return {
        "deform_im2col": (ds, ds.deform_im2col_plain, 1),
        "deform_conv_backward": (
            dc, lambda x, off, cols, w2, dy, *conf:
            dc.deform_conv_backward_plain(x, off, w2, dy, *conf), 3),
        "gn_relu_forward": (
            gn, lambda x, w, b, groups, eps, act, keep=True:
            gn._forward_plain(x, w, b, groups, eps, act), 1),
        "gn_relu_backward": (gn, gn.gn_relu_backward_plain, 3),
        "deform_rows": (ds, ds.deform_rows_plain, 2),
        "deform_rows_backward": (ds, ds.deform_rows_backward_plain, 2),
    }


@contextlib.contextmanager
def checked_calls(names, tol=BF16_KERNEL_TOL, record=None):
    """Within the context every call of the named kernel wrappers (keys of
    :func:`checkable`) is also computed by its plain version on the same
    inputs; each compared output must lie within ``tol`` (a float, or
    {name: tol}) of its max. Yields {name: [max relative error a call]};
    raises on the first call beyond its tol. ``record``: a dict that gets
    each call's arguments, a list by name (to time the calls after)."""
    specs = checkable()
    real = {n: getattr(specs[n][0], n) for n in names}
    errs = {n: [] for n in names}
    tols = tol if isinstance(tol, dict) else {n: tol for n in names}

    def checked(n):
        _, plain, n_cmp = specs[n]

        def call(*args):
            got = real[n](*args)
            want = plain(*args)
            if record is not None:
                record.setdefault(n, []).append(args)
            pairs = list(zip(*(t if isinstance(t, tuple) else (t,)
                               for t in (got, want))))[:n_cmp]
            each = [errors(g.float(), w.float())[1] for g, w in pairs]
            errs[n].append(max(each))
            if not errs[n][-1] <= tols[n]:
                raise AssertionError(f"{n} call {len(errs[n])} on the path's "
                                     f"inputs: {errs[n][-1]} of its max "
                                     f"from the plain version (tol "
                                     f"{tols[n]}; by output "
                                     f"{[f'{e:.3e}' for e in each]}, input "
                                     f"shape {tuple(args[0].shape)})")
            return got
        return call
    # a wrapper counts its launches on its module name
    counts = ("launches", "bf16_launches")
    for n in names:
        call = checked(n)
        for c in counts:
            if hasattr(real[n], c):
                setattr(call, c, getattr(real[n], c))
        setattr(specs[n][0], n, call)
    try:
        yield errs
    finally:
        for n, fn in real.items():
            for c in counts:
                if hasattr(fn, c):
                    setattr(fn, c, getattr(getattr(specs[n][0], n), c))
            setattr(specs[n][0], n, fn)


# ------------------------------------------------ the train and test drivers

def loader_host_ms(dataset, cfg, batch):
    """Host ms a loader batch: each batch of the set made on one thread
    (image reads, annotations with their polygon fills and RLE decodes,
    transforms, the stack) and, of that, the image reads (JPEG decodes);
    and the mean ms between batches that ``build_train_loader`` delivers
    with the config's worker threads once its queue is drained (6 batches
    after 2)."""
    from sipmask_tpu_torch.data.loader import _stack_batch, build_train_loader
    from sipmask_tpu_torch.data.transforms import TrainTransform
    transform = TrainTransform(cfg.data, SEED)
    one, reads = [], []
    for start in range(0, len(dataset) - batch + 1, batch):
        t0 = time.perf_counter()
        imgs = [dataset.load_image(i) for i in range(start, start + batch)]
        t1 = time.perf_counter()
        _stack_batch([transform(img, *dataset.get_ann(i),
                                image_id=dataset.image_id(i))
                      for i, img in zip(range(start, start + batch), imgs)])
        one.append((time.perf_counter() - t0) * 1e3)
        reads.append((t1 - t0) * 1e3)
    loader, _ = build_train_loader(dataset, transform, batch, seed=SEED,
                                   num_workers=cfg.data.num_workers)
    try:
        for _ in range(2):
            next(loader)
        t0 = time.perf_counter()
        for _ in range(6):
            next(loader)
        threaded = (time.perf_counter() - t0) * 1e3 / 6
    finally:
        loader.close()
    return one, reads, threaded


@contextlib.contextmanager
def timed_driver(record):
    """Within the context, each of ``train_detector``'s steps calls
    record["before"](state), runs, synchronises when it ends an even step
    (so that two-step windows end on the device's clock), calls
    record["after"](state), and appends (step, host start, host end) to
    record["steps"], its metrics to record["metrics"] and a clone of its
    batch to record["batches"]."""
    from sipmask_tpu_torch.apis import train as drv
    real = drv.make_train_step

    def make_train_step(state, cfg):
        step = real(state, cfg)

        def run(batch):
            record["before"](state)
            record["batches"].append({k: v.clone() for k, v in batch.items()})
            t0 = time.perf_counter()
            metrics = step(batch)
            if state.step % 2 == 0:
                torch.cuda.synchronize()
            record["steps"].append((state.step, t0, time.perf_counter()))
            record["metrics"].append(metrics)
            record["after"](state)
            return metrics
        return run
    drv.make_train_step = make_train_step
    try:
        yield
    finally:
        drv.make_train_step = real


def driver_vs_bare(cfg, dev, weights, record):
    """A bare ``make_train_step`` from ``weights`` on the batches that
    ``timed_driver`` recorded; returns (driver ms, bare ms) a step over
    windows of two steps each, from a step's start to the synchronise
    after the next one (the driver's with its loader fetch and copy in
    between), skipping the first window."""
    from sipmask_tpu_torch.train import create_train_state, make_train_step
    state = create_train_state(cfg, dev, seed=SEED)
    state.model.load_state_dict(
        torch.load(weights, map_location=dev, weights_only=False)
        ["state_dict"])
    step = make_train_step(state, cfg)
    bare = []
    for i, batch in enumerate(record["batches"]):
        t0 = time.perf_counter()
        step(batch)
        if i % 2:
            torch.cuda.synchronize()
        bare.append((state.step, t0, time.perf_counter()))

    def windows(steps):
        return [(b[2] - a[1]) * 1e3 / 2 for a, b in
                zip(steps[2::2], steps[3::2])]
    return windows(record["steps"]), windows(bare)


def device_busy_ms(prof):
    """Summed device time of the profiled CUDA kernels and copies, ms."""
    from torch.autograd import DeviceType
    return sum(e.device_time for e in prof.events()
               if e.device_type == DeviceType.CUDA
               and "spin_kernel" not in e.name) / 1e3


def phase_train_driver(dev, name, smi, work):
    """Phase 12: ``train_detector`` on a synthetic COCO set at full width
    (800x1344 buckets, batch 4), 4 steps from bumped weights through
    ``load_from``, then a resume from epoch_2 to step 6; against a bare
    ``make_train_step`` on the same batches."""
    from sipmask_tpu_torch.apis.train import train_detector
    from sipmask_tpu_torch.config import _r, get_config
    from sipmask_tpu_torch.data.coco import CocoDataset
    from sipmask_tpu_torch.tools.synth_coco import make_dataset
    from sipmask_tpu_torch.train import create_train_state
    from sipmask_tpu_torch.utils.checkpoint import (latest_checkpoint,
                                                    save_checkpoint)
    from sipmask_tpu_torch.utils.demo_inputs import bump_weights
    from torch.profiler import ProfilerActivity, profile

    cfg = _r(get_config(CONFIG), "train", log_interval=1)
    ann, images = make_dataset(os.path.join(work, "coco"), seed=SEED)
    ds = CocoDataset(ann, images)
    n_gts = [len(ds.get_ann(i)[1]) for i in range(len(ds))]
    if len(ds) != 2 * BATCH or min(n_gts) < 8:
        raise AssertionError(f"synthetic set: {len(ds)} images, gts {n_gts}")
    check_jpeg_set(images, [im["file_name"] for im in ds.images])
    host, reads, threaded = loader_host_ms(ds, cfg, BATCH)
    sizes = [(im["width"], im["height"]) for im in ds.images]
    log(f"synthetic COCO set: {len(ds)} JPEG images (q95, 4:2:0) {sizes}, "
        f"gts {n_gts}; loader host ms per batch of {BATCH} on one thread "
        f"(read, fill, transform, stack): "
        + ", ".join(f"{m:.1f}" for m in host) + "; of which JPEG reads: "
        + ", ".join(f"{m:.1f}" for m in reads) + f"; delivered by "
        f"build_train_loader with {cfg.data.num_workers} threads: "
        f"{threaded:.1f} ms a batch")

    state = create_train_state(cfg, dev, seed=SEED)
    bump_weights(state.model, torch.Generator().manual_seed(SEED))
    bumped = os.path.join(work, "weights", "bumped.pth")
    save_checkpoint(bumped, state)
    frozen = {n: p.detach().clone() for n, p in
              state.model.named_parameters() if not p.requires_grad}
    del state
    wd = os.path.join(work, "work_dir")
    record = dict(steps=[], metrics=[], batches=[],
                  before=lambda state: None, after=lambda state: None)

    # ---- 12a. 4 steps, 2 epochs of 2, a checkpoint each
    reset_launches()
    t0 = time.perf_counter()
    with timed_driver(record):
        state = train_detector(cfg, ann, images, wd, load_from=bumped,
                               max_steps=4, device=dev)
    first_s = time.perf_counter() - t0
    epoch2 = latest_checkpoint(wd)
    if state.step != 4 or epoch2 != os.path.join(wd, "epoch_2.pth"):
        raise AssertionError(f"step {state.step}, last checkpoint {epoch2}")
    for n, v in frozen.items():
        if not torch.equal(dict(state.model.named_parameters())[n], v):
            raise AssertionError(f"frozen parameter {n} moved")
    saved = torch.load(epoch2, map_location=dev, weights_only=False)
    del state

    # ---- 12b. the resume: epoch_2's weights and momentum at step 4, its
    # two steps profiled from the first one's start to the last one's sync
    prof = profile(activities=[ProfilerActivity.CUDA])   # no host tracing
    seen = {}

    def before(state):
        if seen:
            return
        sd = state.model.state_dict()
        bad = [k for k in sd if not torch.equal(sd[k],
                                                saved["state_dict"][k])]
        mom = state.optimizer.state_dict()["state"]
        bad += [f"momentum {k}" for k in mom if not torch.equal(
            mom[k]["momentum_buffer"],
            saved["optimizer"]["state"][k]["momentum_buffer"])]
        if state.step != 4 or bad or len(mom) != len(
                saved["optimizer"]["state"]):
            raise AssertionError(f"resumed at step {state.step}, differing "
                                 f"from epoch_2: {bad[:5]}")
        seen["step"] = state.step
        torch.cuda.synchronize()
        prof.start()
        # a marker: the profiler may miss a session's first kernel
        torch.cuda._sleep(1000)
        seen["t0"] = time.perf_counter()

    def after(state):
        if state.step == 6:
            seen["wall"] = (time.perf_counter() - seen["t0"]) * 1e3
            prof.stop()
    record.update(before=before, after=after)
    t0 = time.perf_counter()
    with timed_driver(record):
        state = train_detector(cfg, ann, images, wd, max_steps=6, device=dev)
    second_s = time.perf_counter() - t0
    launches = read_launches()
    check_path_launches("hi-acc train driver", launches)
    last = latest_checkpoint(wd)
    if state.step != 6 or last != os.path.join(wd, "epoch_3.pth"):
        raise AssertionError(f"resume ended at step {state.step}, {last}")
    wall, busy = seen["wall"], device_busy_ms(prof)
    idle = 1 - busy / wall
    log(f"train_detector: 4 steps in {first_s:.1f} s, resumed at step "
        f"{seen['step']} from epoch_2 and ran to step 6 in {second_s:.1f} s "
        f"(model build, loader start and checkpoints included); profiled "
        f"steps 5-6 to the last synchronise: wall {wall:.1f} ms, device time "
        f"{busy:.1f} ms, device idle share {idle:.3f} on {name} ({smi})")
    for i, m in enumerate(record["metrics"]):
        vals = {k: float(v) for k, v in m.items()}
        log(f"driver step {i + 1}: " + ", ".join(f"{k} {v:.6f}"
                                                for k, v in vals.items()))
        if not all(np.isfinite(v) for v in vals.values()) or \
                not vals["loss_mask"] > 0:
            raise AssertionError(f"driver step {i + 1}: losses {vals}")
    with open(os.path.join(wd, "train.log.json")) as f:
        lines = [json.loads(line) for line in f]
    if [r["step"] for r in lines] != list(range(1, 7)) or not all(
            np.isfinite(r["loss_total"]) and r["lr"] > 0 for r in lines):
        raise AssertionError(f"train log: {lines}")
    for n, v in frozen.items():
        if not torch.equal(dict(state.model.named_parameters())[n], v):
            raise AssertionError(f"frozen parameter {n} moved")
    del state, saved

    # ---- 12c. bare make_train_step on the same 6 batches
    drv_ms, bare_ms = driver_vs_bare(cfg, dev, bumped, record)
    log(f"ms a step (host clock, two-step windows ending in a synchronise, "
        f"steps 3-4 and 5-6): train_detector {drv_ms[0]:.1f} / "
        f"{drv_ms[1]:.1f}, bare make_train_step on the same batches "
        f"{bare_ms[0]:.1f} / {bare_ms[1]:.1f} (steps 5-6 of the driver ran "
        f"under the profiler); the loader delivers a batch every "
        f"{threaded:.1f} ms, on {name} ({smi})")
    del record
    torch.cuda.empty_cache()
    return launches, dict(ann=ann, images=images, last=last)


def phase_test_driver(dev, name, smi, ann, images, ckpt):
    """Phase 13: ``run_inference`` over the synthetic set at batch 4 from
    the last checkpoint, against ``inference_detector`` image by image,
    then ``evaluate_coco``."""
    from sipmask_tpu_torch.apis.inference import (inference_detector,
                                                  init_detector)
    from sipmask_tpu_torch.apis.test import evaluate_coco, run_inference
    from sipmask_tpu_torch.data.coco import CocoDataset
    from sipmask_tpu_torch.eval.rle import decode_mask, rle_area
    from sipmask_tpu_torch.utils.checkpoint import load_weights

    det = init_detector(CONFIG, dev, seed=SEED)
    load_weights(ckpt, det.model)
    ds = CocoDataset(ann, images, test_mode=True)
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    results = run_inference(det, ds, batch_size=BATCH, progress=False)
    infer_s = time.perf_counter() - t0
    launches = read_launches()
    check_path_launches("hi-acc test driver", launches)
    t0 = time.perf_counter()
    stats = evaluate_coco(results, ann)
    eval_s = time.perf_counter() - t0
    log(f"run_inference: {len(ds)} images, {len(results)} results in "
        f"{infer_s:.2f} s, {len(ds) / infer_s:.2f} images/s (device paste, "
        f"the copy and the codec's RLE included); evaluate_coco (bbox, "
        f"segm) {eval_s:.2f} s, on "
        f"{name} ({smi})")
    for it, s in stats.items():
        if not all(np.isfinite(v) and -1 <= v <= 1 for v in s.values()):
            raise AssertionError(f"{it} stats {s}")
    cat2label = {c: lab - 1 for lab, c in ds.label2cat.items()}
    for i in range(len(ds)):
        mine = [r for r in results if r["image_id"] == ds.image_id(i)]
        ref = inference_detector(det, ds.load_image(i))
        if not mine:
            raise AssertionError(f"image {i}: no results")
        masks = np.stack([decode_mask(r["segmentation"]) for r in mine])
        oh, ow = ds.images[i]["height"], ds.images[i]["width"]
        if masks.shape != (len(mine), oh, ow):
            raise AssertionError(f"image {i}: masks {masks.shape}")
        for r, m in zip(mine, masks):
            if int(m.sum()) != rle_area(r["segmentation"]):
                raise AssertionError(f"image {i}: an RLE does not decode")
        boxes = torch.tensor([[x, y, x + w, y + h] for x, y, w, h in
                              (r["bbox"] for r in mine)])
        labels = torch.tensor([cat2label[r["category_id"]] for r in mine])
        near = (((boxes[:, None] - torch.from_numpy(ref["boxes"])[None])
                 .abs().amax(-1) <= 1e-3)
                & (labels[:, None] == torch.from_numpy(ref["labels"])[None]))
        share = min(float(near.any(1).float().mean()),
                    float(near.any(0).float().mean()))
        pairs = [(a, int(near[a].nonzero()[0])) for a in range(len(mine))
                 if near[a].any()]
        same = np.mean([(masks[a] == ref["masks"][b]).mean()
                        for a, b in pairs])
        log(f"image {i} ({oh}x{ow}): {len(mine)} results, "
            f"{len(ref['labels'])} from inference_detector; matched "
            f"(label, box within 1e-3) {share:.3f}, matched masks' pixels "
            f"equal {same:.5f}")
        if len(mine) != len(ref["labels"]) or share < MATCH_MIN \
                or same < 0.99:
            raise AssertionError(f"image {i}: run_inference and "
                                 "inference_detector disagree")
    return launches, results


# ------------------------------------------------ the real-time preset

def phase_rt_serving(dev, name, smi):
    """Phase 14: ``sipmask_r50_fpn_ssd_6x`` serving at 544x544 (the
    non-square requests stretched, sx != sy): 3 requests at batch 1, then
    a batch of 8 twice, with the kernels; the batch with the plain versions
    (head outputs and detections compared)."""
    from sipmask_tpu_torch.apis.inference import (inference_detector,
                                                  init_detector, preprocess)
    from sipmask_tpu_torch.utils.demo_inputs import (bump_weights,
                                                     calibrate_frozen_bn)

    det = init_detector(RT_CONFIG, dev, seed=SEED)
    cfg = det.cfg
    if (cfg.data.fixed_size, cfg.model.head.norm,
            cfg.model.head.stacked_convs, cfg.model.head.ssd_flag) != (
            RT_HW, None, 2, True):
        raise AssertionError("the real-time preset moved")
    bump_weights(det.model, torch.Generator().manual_seed(SEED))
    rng = np.random.RandomState(SEED)
    imgs = [(rng.rand(*RT_SIZES[i % len(RT_SIZES)], 3) * 255)
            .astype(np.uint8) for i in range(3 + RT_BATCH)]
    prepped = [preprocess(im, cfg) for im in imgs[3:]]
    if any(p[2][0] == p[2][1] for p in prepped):
        raise AssertionError("a request was not stretched (sx == sy)")
    images = torch.stack([torch.from_numpy(p[0]).permute(2, 0, 1)
                          for p in prepped]).to(dev)
    batch = (images, torch.from_numpy(np.stack([p[1] for p in prepped])),
             torch.from_numpy(np.stack([p[2] for p in prepped])))
    # a norm-free head saturates on a random backbone's raw activations
    calibrate_frozen_bn(det.model.backbone, images)
    capture = {}
    det.model.bbox_head.register_forward_hook(
        lambda mod, inp, out: capture.update(out))

    reset_launches()
    for i in range(3):
        t0 = time.perf_counter()
        res = inference_detector(det, imgs[i])
        ms = (time.perf_counter() - t0) * 1e3
        n, hw = len(res["labels"]), imgs[i].shape[:2]
        log(f"RT request {i}: {hw} image -> {RT_HW} (sx, sy "
            f"{preprocess(imgs[i], cfg)[2][:2].tolist()}) -> {n} "
            f"detections, {ms:.1f} ms wall on {name} ({smi})")
        if n == 0 or not np.isfinite(res["boxes"]).all():
            raise AssertionError(f"RT request {i}: no valid or finite "
                                 f"result")
        if res["masks"].shape != (n, *hw):
            raise AssertionError(f"RT request {i}: masks "
                                 f"{res['masks'].shape}")
    torch.cuda.reset_peak_memory_stats()
    for _ in range(2):   # the first run is the first at the batch shapes
        t0 = time.perf_counter()
        head_k, dec_k = run_batch(det, batch, capture)
        ms = (time.perf_counter() - t0) * 1e3
        log(f"RT batch of {tuple(images.shape)} through Detector.infer: "
            f"{ms:.1f} ms wall on {name} ({smi}); peak memory "
            f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
    launches = read_launches()
    check_path_launches("rt serving", launches)
    # 5 forwards (3 requests, 2 batches): K1 at each of the 5 FPN levels,
    # K6 once a decode, no GroupNorm
    want = {k: 0 for k in launches}
    want.update(deform_im2col=25, assemble_masks=5)
    if launches != want:
        raise AssertionError(f"RT serving launches {launches}, not {want}")
    valid = dec_k["valid"].sum(1).tolist()
    log(f"valid detections per image of the RT batch: {valid}")
    if min(valid) <= 0:
        raise AssertionError("an image of the batch has no detection")
    check_head_finite(head_k)
    for key in ("boxes", "scores", "masks"):
        check_finite(key, dec_k[key])
    m = dec_k["masks"]
    if tuple(m.shape) != (RT_BATCH, cfg.model.test.max_per_img,
                          RT_HW[0] // 2, RT_HW[1] // 2):
        raise AssertionError(f"masks {tuple(m.shape)}")

    with plain_kernels():
        head_p, dec_p = run_batch(det, batch, capture)
    if read_launches() != launches:
        raise AssertionError("the plain run launched a kernel")
    worst = head_error(head_k, head_p)
    log(f"RT head outputs, kernels vs plain: max relative error "
        f"{worst:.3e} (tol {HEAD_TOL})")
    if not worst <= HEAD_TOL:
        raise AssertionError(f"head outputs disagree: {worst}")
    shares = [min(matched_share(dec_k, dec_p, i),
                  matched_share(dec_p, dec_k, i)) for i in range(RT_BATCH)]
    log(f"RT detections reproduced by the plain run (label, box within "
        f"0.01 px, score within 1e-4): {shares} (min {MATCH_MIN})")
    if min(shares) < MATCH_MIN or \
            dec_k["valid"].sum(1).tolist() != dec_p["valid"].sum(1).tolist():
        raise AssertionError("decoded detections disagree")
    del det
    torch.cuda.empty_cache()
    return launches


def phase_rt_train_driver(dev, name, smi, work, ann, images):
    """Phase 15: ``train_detector`` on phase 12's set with the real-time
    preset as it stands (the SSD augmentations, repeat_times 3, the 576x576
    stretch, batch 8; 3 steps an epoch): RT_DRIVER_STEPS steps from bumped
    weights whose frozen BN is fitted to a loader batch; the loader's host
    ms, the driver's steps against a bare ``make_train_step`` on the same
    batches, and the device's idle share over the last two steps."""
    from sipmask_tpu_torch.apis.train import train_detector
    from sipmask_tpu_torch.config import _r, get_config
    from sipmask_tpu_torch.data.coco import CocoDataset
    from sipmask_tpu_torch.data.loader import build_train_loader
    from sipmask_tpu_torch.data.transforms import TrainTransform
    from sipmask_tpu_torch.train import create_train_state
    from sipmask_tpu_torch.utils.checkpoint import save_checkpoint
    from sipmask_tpu_torch.utils.demo_inputs import (batch_to_tensors,
                                                     bump_weights,
                                                     calibrate_frozen_bn)
    from torch.profiler import ProfilerActivity, profile

    cfg = _r(get_config(RT_CONFIG), "train", log_interval=1)
    d = cfg.data
    if (d.ssd_augs, d.train_size, d.fixed_size, d.repeat_times,
            cfg.train.imgs_per_device) != (True, RT_TRAIN_HW, RT_HW, 3,
                                           RT_BATCH):
        raise AssertionError("the real-time preset's training moved")
    ds = CocoDataset(ann, images)
    host, reads, threaded = loader_host_ms(ds, cfg, RT_BATCH)
    log(f"RT loader host ms per batch of {RT_BATCH} on one thread (JPEG "
        f"read, fill, photometric distortion, expand, min-IoU crop, 576 "
        f"stretch, stack): " + ", ".join(f"{m:.1f}" for m in host)
        + "; of which JPEG reads: " + ", ".join(f"{m:.1f}" for m in reads)
        + f"; delivered by build_train_loader with {d.num_workers} "
        f"threads: {threaded:.1f} ms a batch")

    state = create_train_state(cfg, dev, seed=SEED)
    loader, steps_per_epoch = build_train_loader(
        ds, TrainTransform(d, SEED), RT_BATCH, seed=SEED,
        repeat_times=d.repeat_times, num_workers=1)
    try:
        first = batch_to_tensors(next(loader), dev)
    finally:
        loader.close()
    if steps_per_epoch != len(ds) * d.repeat_times // RT_BATCH or tuple(
            first["images"].shape) != (RT_BATCH, 3, *RT_TRAIN_HW):
        raise AssertionError(f"{steps_per_epoch} steps an epoch, images "
                             f"{tuple(first['images'].shape)}")
    gen = torch.Generator().manual_seed(SEED)
    calibrate_frozen_bn(state.model.backbone, first["images"])
    bump_weights(state.model, gen, training=True)
    bumped = os.path.join(work, "weights", "rt_bumped.pth")
    save_checkpoint(bumped, state)
    frozen = {n: p.detach().clone() for n, p in
              state.model.named_parameters() if not p.requires_grad}
    del state, first

    prof = profile(activities=[ProfilerActivity.CUDA])   # no host tracing
    seen = {}

    def before(state):
        if state.step == RT_DRIVER_STEPS - 2 and not seen:
            torch.cuda.synchronize()
            prof.start()
            torch.cuda._sleep(1000)   # a marker: the first kernel may drop
            seen["t0"] = time.perf_counter()

    def after(state):
        if state.step == RT_DRIVER_STEPS:
            seen["wall"] = (time.perf_counter() - seen["t0"]) * 1e3
            prof.stop()
    record = dict(steps=[], metrics=[], batches=[], before=before,
                  after=after)
    wd = os.path.join(work, "rt_work_dir")
    reset_launches()
    t0 = time.perf_counter()
    with timed_driver(record):
        state = train_detector(cfg, ann, images, wd, load_from=bumped,
                               max_steps=RT_DRIVER_STEPS, device=dev)
    drv_s = time.perf_counter() - t0
    launches = read_launches()
    check_path_launches("rt train driver", launches)
    if launches["gn_relu"] or launches["gn_relu_backward"]:
        raise AssertionError("the norm-free RT head launched GroupNorm")
    if state.step != RT_DRIVER_STEPS:
        raise AssertionError(f"the RT driver stopped at step {state.step}")
    wall, busy = seen["wall"], device_busy_ms(prof)
    log(f"RT train_detector: {RT_DRIVER_STEPS} steps in {drv_s:.1f} s "
        f"(model build, loader start and checkpoints included); profiled "
        f"steps {RT_DRIVER_STEPS - 1}-{RT_DRIVER_STEPS} to the last "
        f"synchronise: wall {wall:.1f} ms, device time {busy:.1f} ms, "
        f"device idle share {1 - busy / wall:.3f} on {name} ({smi})")
    for i, m in enumerate(record["metrics"]):
        vals = {k: float(v) for k, v in m.items()}
        log(f"RT driver step {i + 1}: " + ", ".join(
            f"{k} {v:.6f}" for k, v in vals.items()))
        if not all(np.isfinite(v) for v in vals.values()) or \
                not vals["loss_mask"] > 0:
            raise AssertionError(f"RT driver step {i + 1}: losses {vals}")
    with open(os.path.join(wd, "train.log.json")) as f:
        lines = [json.loads(line) for line in f]
    if [r["step"] for r in lines] != list(range(1, RT_DRIVER_STEPS + 1)):
        raise AssertionError(f"RT train log: {lines}")
    for n, v in frozen.items():
        if not torch.equal(dict(state.model.named_parameters())[n], v):
            raise AssertionError(f"frozen parameter {n} moved")
    del state

    drv_ms, bare_ms = driver_vs_bare(cfg, dev, bumped, record)
    log(f"RT ms a step (host clock, two-step windows ending in a "
        f"synchronise, steps 3-4 and 5-6): train_detector "
        + " / ".join(f"{v:.1f}" for v in drv_ms) + ", bare make_train_step "
        "on the same batches " + " / ".join(f"{v:.1f}" for v in bare_ms)
        + f" (steps 5-6 of the driver ran under the profiler); the loader "
        f"delivers a batch every {threaded:.1f} ms, on {name} ({smi})")
    del record
    torch.cuda.empty_cache()
    return launches


# ------------------------------------------------------------ SipMask-VIS

@contextlib.contextmanager
def recorded_tracking(det, frames_out):
    """Within the context each frame of ``run_video_inference`` appends to
    ``frames_out`` its head outputs, its detections (batch 1) and the
    tracker's object ids."""
    from sipmask_tpu_torch.apis import test_video
    real = test_video.tracker_step

    def step(state, boxes, scores, labels, valid, feats, is_first, **kw):
        state, ids = real(state, boxes, scores, labels, valid, feats,
                          is_first, **kw)
        frames_out[-1]["dets"] = dict(boxes=boxes[None], scores=scores[None],
                                      labels=labels[None], valid=valid[None])
        frames_out[-1]["ids"] = ids
        return state, ids
    hook = det.model.bbox_head.register_forward_hook(
        lambda mod, inp, out: frames_out.append({"head": dict(out)}))
    test_video.tracker_step = step
    try:
        yield
    finally:
        test_video.tracker_step = real
        hook.remove()


def check_vis_results(results, n_frames, hw, label):
    """Well-formed YTVIS results whose RLEs decode to masks of ``hw``."""
    from sipmask_tpu_torch.eval.rle import decode_mask, rle_area
    if not results:
        raise AssertionError(f"{label}: no tracks")
    for r in results:
        segs = r["segmentations"]
        if len(segs) != n_frames or all(s is None for s in segs) or \
                not 0 < r["score"] <= 1 or r["category_id"] < 1:
            raise AssertionError(f"{label}: malformed track {r}")
        for seg in segs:
            if seg is None:
                continue
            m = decode_mask(seg)
            if m.shape != hw or int(m.sum()) != rle_area(seg):
                raise AssertionError(f"{label}: an RLE does not decode")


def phase_vis_serving(dev, name, smi, bf16=False):
    """Phase 16 (26a with ``bf16``: compute_dtype="bfloat16"): SipMask-VIS
    tracking one video of VIS_FRAMES frames at 720x1280 through
    ``run_video_inference`` (batch 1 a frame, 384x640), with the kernels
    (launches counted, ms per frame by section), again under the profiler
    (the device's idle share), then with the plain versions: head outputs,
    detections and object ids compared (in bf16 within the bf16 bounds:
    a share of the detections, and of the matched detections' ids)."""
    from sipmask_tpu_torch.apis.inference import init_detector
    from sipmask_tpu_torch.apis.test_video import run_video_inference
    from sipmask_tpu_torch.utils.demo_inputs import (MemoryVideo,
                                                     bump_weights,
                                                     moving_shapes_video)
    from torch.profiler import ProfilerActivity, profile

    label, path = ("VIS bf16", "vis bf16 serving") if bf16 else (
        "VIS", "vis serving")
    sfx = "_bf16" if bf16 else ""
    head_tol, match, match_min = ((BF16_HEAD_TOL, BF16_MATCH, BF16_MATCH_MIN)
                                  if bf16 else (HEAD_TOL, (0.01, 1e-4),
                                                MATCH_MIN))
    det = init_detector(bf16_config(VIS_CONFIG) if bf16 else VIS_CONFIG, dev,
                        seed=SEED)
    cfg = det.cfg
    h = cfg.model.head
    if (h.track, h.num_classes, h.stacked_convs, cfg.data.img_scale,
            cfg.model.test.max_per_img, cfg.model.test.nms_pre) != (
            True, 40, 3, (640, 360), 10, 200):
        raise AssertionError("the VIS preset moved")
    bump_weights(det.model, torch.Generator().manual_seed(SEED))
    video = MemoryVideo(moving_shapes_video(VIS_FRAMES, *VIS_VIDEO_HW, SEED))

    runs = {}
    reset_launches()
    timings, runs["kernels"] = {}, []
    with recorded_tracking(det, runs["kernels"]):
        t0 = time.perf_counter()
        results = run_video_inference(det, video, progress=False,
                                      timings=timings)
        wall = time.perf_counter() - t0
    launches = read_launches()
    check_path_launches(path, launches)
    want = {k: 0 for k in launches}
    want.update({"deform_im2col" + sfx: 5 * VIS_FRAMES,
                 "assemble_masks": VIS_FRAMES,
                 "gn_relu" + sfx: (2 * 5 + 3 * 5 + 5 + 2 * 3) * VIS_FRAMES})
    if launches != want:
        raise AssertionError(f"{label} serving launches {launches}, not "
                             f"{want}")
    check_vis_results(results, VIS_FRAMES, VIS_VIDEO_HW, f"{label} serving")
    frames = runs["kernels"]
    tf_shape = tuple(frames[0]["head"]["track_feats"].shape)
    if tf_shape != (1, 512, VIS_HW[0] // 8, VIS_HW[1] // 8):
        raise AssertionError(f"track_feats {tf_shape}")
    for f in frames:
        check_head_finite(f["head"])
        if bf16:
            check_bf16_head(f["head"])
    n_ids = sorted({int(i) for f in frames for i in f["ids"] if i >= 0})
    log(f"{label} video of {VIS_FRAMES} frames {VIS_VIDEO_HW} -> {VIS_HW}: "
        f"{len(results)} tracks, object ids {n_ids}, valid detections per "
        f"frame {[int(f['dets']['valid'].sum()) for f in frames]}, "
        f"{wall:.2f} s for the video ({VIS_FRAMES / wall:.2f} frames/s, the "
        f"first frame's cuDNN search included), on {name} ({smi})")
    if not bf16:
        VIS_TIMINGS["paste"] = timings["paste"][1:]
    log(f"{label} ms per frame (host clock to a synchronise; frames 2-"
        f"{VIS_FRAMES}): " + "; ".join(
            f"{k} " + ", ".join(f"{v:.1f}" for v in vals[1:])
            + f" (mean {np.mean(vals[1:]):.2f})"
            for k, vals in timings.items()))

    prof = profile(activities=[ProfilerActivity.CUDA])   # no host tracing
    torch.cuda.synchronize()
    prof.start()
    torch.cuda._sleep(1000)   # a marker: the first kernel may drop
    t0 = time.perf_counter()
    run_video_inference(det, video, progress=False)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    prof.stop()
    busy = device_busy_ms(prof)
    log(f"{label} video again under the profiler: {wall:.1f} ms wall "
        f"({VIS_FRAMES * 1e3 / wall:.2f} frames/s), device time "
        f"{busy:.1f} ms, device idle share {1 - busy / wall:.3f} on {name} "
        f"({smi})")
    launches_after = read_launches()

    runs["plain"] = []
    with plain_kernels(), recorded_tracking(det, runs["plain"]):
        run_video_inference(det, video, progress=False)
    if read_launches() != launches_after:
        raise AssertionError(f"the plain {label} run launched a kernel")
    worst_head, shares, same_ids, other_ids = 0.0, [], 0, 0
    for fk, fp in zip(runs["kernels"], runs["plain"]):
        worst_head = max(worst_head, head_error(fk["head"], fp["head"]))
        dk, dp = fk["dets"], fp["dets"]
        shares.append(min(matched_share(dk, dp, 0, *match),
                          matched_share(dp, dk, 0, *match)))
        if not bf16 and int(dk["valid"].sum()) != int(dp["valid"].sum()):
            raise AssertionError("VIS decoded detections disagree")
        # object ids on the detections both runs have
        for i in torch.nonzero(dk["valid"][0]).flatten().tolist():
            near = ((dp["labels"][0] == dk["labels"][0, i])
                    & ((dp["boxes"][0] - dk["boxes"][0, i]).abs().amax(-1)
                       <= match[0]) & dp["valid"][0])
            for j in torch.nonzero(near).flatten().tolist():
                if int(fk["ids"][i]) == int(fp["ids"][j]):
                    same_ids += 1
                else:
                    other_ids += 1
    id_share = same_ids / max(same_ids + other_ids, 1)
    log(f"{label} head outputs (track_feats included), kernels vs plain: "
        f"max relative error {worst_head:.3e} (tol {head_tol}); detections "
        f"reproduced per frame {shares} (min {match_min}); {same_ids} "
        f"matched detections carry the same object id, {other_ids} another "
        f"(min share {1.0 if not bf16 else match_min})")
    if not worst_head <= head_tol:
        raise AssertionError(f"{label} head outputs disagree: {worst_head}")
    if min(shares) < match_min or same_ids == 0 or id_share < (
            match_min if bf16 else 1.0):
        raise AssertionError(f"{label} detections or ids disagree")
    del det, runs
    torch.cuda.empty_cache()
    return launches


def phase_vis_train(dev, name, smi):
    """Phase 17: TRAIN_STEPS SGD steps of SipMask-VIS at 384x640, batch 4,
    current and reference frames, through ``create_train_state`` /
    ``make_train_step``; then the first step with the plain versions."""
    from sipmask_tpu_torch.config import get_config
    from sipmask_tpu_torch.train import create_train_state, make_train_step
    from sipmask_tpu_torch.utils.demo_inputs import bump_weights

    cfg = get_config(VIS_CONFIG)
    state = create_train_state(cfg, dev, seed=SEED)
    bump_weights(state.model, torch.Generator().manual_seed(SEED),
                 training=True)
    init = {k: v.detach().clone() for k, v in state.model.state_dict().items()}
    params = dict(state.model.named_parameters())
    frozen = {n: p.detach().clone() for n, p in params.items()
              if not p.requires_grad}
    batch = vis_batch(cfg, dev)
    log(f"VIS train batch: images and ref_images "
        f"{tuple(batch['images'].shape)}, gts per image "
        f"{(batch['gt_labels'] > 0).sum(1).tolist()}, matched in the "
        f"reference frame {(batch['gt_pids'] > 0).sum(1).tolist()}")
    step = make_train_step(state, cfg)
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    losses, peaks, walls = [], [], []
    for i in range(TRAIN_STEPS):
        vals, ms = run_step(step, batch, f"VIS train step {i}", name, smi)
        losses.append(vals)
        walls.append(ms)
        if i == 0:
            first_grads = {n: p.grad.detach().clone()
                           for n, p in params.items() if p.requires_grad}
        peaks.append(torch.cuda.max_memory_allocated() / 2 ** 30)
        torch.cuda.reset_peak_memory_stats()
    launches = read_launches()
    check_path_launches("vis training", launches)
    log("VIS peak device memory per train step (step 0 holds cuDNN's "
        "algorithm search): " + ", ".join(f"{p:.2f} GiB" for p in peaks)
        + "; step ms " + ", ".join(f"{m:.1f}" for m in walls))
    for i, vals in enumerate(losses):
        if not all(np.isfinite(v) for v in vals.values()):
            raise AssertionError(f"VIS step {i}: non-finite losses {vals}")
        if not (vals["loss_mask"] > 0 and vals["loss_match"] > 0):
            raise AssertionError(f"VIS step {i}: loss_mask or loss_match is "
                                 f"0: {vals}")
    log("VIS match_acc per step: " + ", ".join(
        f"{v['match_acc']:.4f}" for v in losses))
    for n, v in frozen.items():
        if not torch.equal(params[n].detach(), v):
            raise AssertionError(f"frozen parameter {n} moved")
    for n, p in params.items():
        if p.requires_grad:
            if p.grad is None:
                raise AssertionError(f"{n} has no gradient")
            check_finite(f"gradient of {n}", p.grad)
    track = {n: float(first_grads[n].abs().max()) for n in first_grads
             if ".track_convs." in n or ".sipmask_track." in n}
    log(f"max |grad| of the track branch at step 0: min over its "
        f"{len(track)} tensors {min(track.values()):.3e}")
    if len(track) != 2 * 3 + 2 or not min(track.values()) > 0:
        raise AssertionError(f"the track branch's gradients: {track}")
    del state, step, params
    torch.cuda.empty_cache()

    state = create_train_state(cfg, dev, state_dict=init)
    step = make_train_step(state, cfg)
    with plain_kernels():
        vals, _ = run_step(step, batch, "VIS plain train step 0", name, smi)
    if read_launches() != launches:
        raise AssertionError("the plain VIS step launched a kernel")
    worst_loss = max(abs(vals[k] - losses[0][k]) / max(abs(vals[k]), 1e-12)
                     for k in vals if k != "match_acc")
    log(f"VIS losses, kernels vs plain: max relative difference "
        f"{worst_loss:.3e} (tol {LOSS_TOL}); match_acc {vals['match_acc']:.4f}"
        f" vs {losses[0]['match_acc']:.4f}")
    if not worst_loss <= LOSS_TOL:
        raise AssertionError(f"VIS losses disagree: {losses[0]} vs {vals}")
    worst, worst_name = 0.0, ""
    for n, p in state.model.named_parameters():
        if p.requires_grad:
            rel = errors(first_grads[n], p.grad)[1]
            if rel > worst:
                worst, worst_name = rel, n
    log(f"VIS gradients, kernels vs plain: max relative error (to each "
        f"tensor's max |g|) {worst:.3e} at {worst_name} (tol {GRAD_TOL})")
    if not worst <= GRAD_TOL:
        raise AssertionError(f"VIS gradients disagree: {worst} at "
                             f"{worst_name}")
    del state, step
    torch.cuda.empty_cache()
    return launches


def vis_batch(cfg, dev):
    """The VIS train step's batch: current and reference frames at
    384x640, batch 4 (``vis_pair_batch``), checked against the preset."""
    from sipmask_tpu_torch.utils.demo_inputs import vis_pair_batch
    if (cfg.train.max_pos, cfg.data.max_gts, cfg.train.imgs_per_device) != (
            VIS_MAX_POS, VIS_MAX_GTS, VIS_BATCH):
        raise AssertionError("the VIS preset's max_pos, max_gts or batch "
                             "moved")
    return vis_pair_batch(VIS_BATCH, *VIS_HW, VIS_MAX_GTS,
                          cfg.model.head.num_classes, SEED, dev)


def phase_vis_train_driver(dev, name, smi, work):
    """Phase 18a: ``train_detector`` with the VIS preset on a synthetic
    YouTube-VIS set (``tools/synth_ytvis.py``, JPEG), 4 steps from bumped
    weights through ``load_from``, then a resume to step 6; the driver's
    steps against a bare ``make_train_step`` on the same batches and the
    device's idle share over steps 5-6."""
    from sipmask_tpu_torch.apis.train import train_detector
    from sipmask_tpu_torch.config import _r, get_config
    from sipmask_tpu_torch.tools.synth_ytvis import make_dataset
    from sipmask_tpu_torch.train import create_train_state
    from sipmask_tpu_torch.utils.checkpoint import (latest_checkpoint,
                                                    save_checkpoint)
    from sipmask_tpu_torch.utils.demo_inputs import bump_weights
    from torch.profiler import ProfilerActivity, profile

    cfg = _r(get_config(VIS_CONFIG), "train", log_interval=1)
    t0 = time.perf_counter()
    ann, images = make_dataset(os.path.join(work, "ytvis"),
                               VIS_DRIVER_VIDEOS, VIS_DRIVER_FRAMES,
                               VIS_DRIVER_SIZE, seed=SEED)
    log(f"synthetic YouTube-VIS set: {VIS_DRIVER_VIDEOS} videos x "
        f"{VIS_DRIVER_FRAMES} JPEG frames (q95, 4:2:0) of {VIS_DRIVER_SIZE}x"
        f"{VIS_DRIVER_SIZE} in {time.perf_counter() - t0:.1f} s")
    with open(ann) as f:
        check_jpeg_set(images, [fn for v in json.load(f)["videos"]
                                for fn in v["file_names"]])
    state = create_train_state(cfg, dev, seed=SEED)
    bump_weights(state.model, torch.Generator().manual_seed(SEED),
                 training=True)
    bumped = os.path.join(work, "weights", "vis_bumped.pth")
    save_checkpoint(bumped, state)
    frozen = {n: p.detach().clone() for n, p in
              state.model.named_parameters() if not p.requires_grad}
    del state
    wd = os.path.join(work, "vis_work_dir")
    prof = profile(activities=[ProfilerActivity.CUDA])   # no host tracing
    seen = {}

    def before(state):
        if state.step == 4 and not seen:
            torch.cuda.synchronize()
            prof.start()
            torch.cuda._sleep(1000)   # a marker: the first kernel may drop
            seen["t0"] = time.perf_counter()

    def after(state):
        if state.step == 6:
            seen["wall"] = (time.perf_counter() - seen["t0"]) * 1e3
            prof.stop()
    record = dict(steps=[], metrics=[], batches=[], before=before,
                  after=after)
    reset_launches()
    t0 = time.perf_counter()
    with timed_driver(record):
        state = train_detector(cfg, ann, images, wd, load_from=bumped,
                               max_steps=4, device=dev)
    first_s = time.perf_counter() - t0
    if state.step != 4 or latest_checkpoint(wd) != os.path.join(
            wd, "epoch_0.pth"):
        raise AssertionError(f"VIS driver: step {state.step}, last "
                             f"checkpoint {latest_checkpoint(wd)}")
    del state
    t0 = time.perf_counter()
    with timed_driver(record):
        state = train_detector(cfg, ann, images, wd, max_steps=6, device=dev)
    second_s = time.perf_counter() - t0
    launches = read_launches()
    check_path_launches("vis train driver", launches)
    last = latest_checkpoint(wd)
    if state.step != 6 or last != os.path.join(wd, "epoch_1.pth"):
        raise AssertionError(f"VIS resume ended at step {state.step}, {last}")
    wall, busy = seen["wall"], device_busy_ms(prof)
    log(f"VIS train_detector: 4 steps in {first_s:.1f} s, resumed to step 6 "
        f"in {second_s:.1f} s (model build, loader start and checkpoints "
        f"included); profiled steps 5-6 to the last synchronise: wall "
        f"{wall:.1f} ms, device time {busy:.1f} ms, device idle share "
        f"{1 - busy / wall:.3f} on {name} ({smi})")
    for i, m in enumerate(record["metrics"]):
        vals = {k: float(v) for k, v in m.items()}
        log(f"VIS driver step {i + 1}: " + ", ".join(
            f"{k} {v:.6f}" for k, v in vals.items()))
        if not all(np.isfinite(v) for v in vals.values()) or \
                "loss_match" not in vals:
            raise AssertionError(f"VIS driver step {i + 1}: losses {vals}")
    with open(os.path.join(wd, "train.log.json")) as f:
        lines = [json.loads(line) for line in f]
    if [r["step"] for r in lines] != list(range(1, 7)) or not all(
            np.isfinite(r["loss_match"]) for r in lines):
        raise AssertionError(f"VIS train log: {lines}")
    meta = torch.load(last, map_location="cpu", weights_only=False)["meta"]
    if len(meta["classes"]) != 40 or meta["classes"][0] != "person":
        raise AssertionError(f"VIS checkpoint classes {meta['classes']}")
    for n, v in frozen.items():
        if not torch.equal(dict(state.model.named_parameters())[n], v):
            raise AssertionError(f"frozen parameter {n} moved")
    del state
    drv_ms, bare_ms = driver_vs_bare(cfg, dev, bumped, record)
    log(f"VIS ms a step (host clock, two-step windows ending in a "
        f"synchronise, steps 3-4 and 5-6): train_detector "
        + " / ".join(f"{v:.1f}" for v in drv_ms) + ", bare make_train_step "
        "on the same batches " + " / ".join(f"{v:.1f}" for v in bare_ms)
        + f" (steps 5-6 of the driver ran under the profiler), on {name} "
        f"({smi})")
    del record
    torch.cuda.empty_cache()
    return launches, dict(ann=ann, images=images, last=last)


def phase_vis_test_driver(dev, name, smi, ann, images, ckpt):
    """Phase 18b: ``run_video_inference`` over the set's videos from the
    last checkpoint, then ``YTVOSEvaluator``."""
    from sipmask_tpu_torch.apis.inference import init_detector
    from sipmask_tpu_torch.apis.test_video import run_video_inference
    from sipmask_tpu_torch.data.ytvos import YTVOSDataset
    from sipmask_tpu_torch.eval.ytvos_eval import YTVOSEvaluator
    from sipmask_tpu_torch.utils.checkpoint import load_weights

    det = init_detector(VIS_CONFIG, dev, seed=SEED)
    load_weights(ckpt, det.model)
    ds = YTVOSDataset(ann, images, test_mode=True)
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    results = run_video_inference(det, ds, progress=False)
    infer_s = time.perf_counter() - t0
    launches = read_launches()
    check_path_launches("vis test driver", launches)
    t0 = time.perf_counter()
    ev = YTVOSEvaluator(ann)
    ev.update(results)
    stats = ev.summarize()
    eval_s = time.perf_counter() - t0
    n_frames = len(ds)
    log(f"VIS run_video_inference: {VIS_DRIVER_VIDEOS} videos, {n_frames} "
        f"frames, {len(results)} tracks in {infer_s:.2f} s, "
        f"{n_frames / infer_s:.2f} frames/s (reads, paste and RLEs "
        f"included); YTVOSEvaluator {eval_s:.2f} s, on {name} ({smi})")
    if not all(np.isfinite(v) and -1 <= v <= 1 for v in stats.values()):
        raise AssertionError(f"VIS stats {stats}")
    for vid, v in enumerate(ds.videos):
        check_vis_results([r for r in results if r["video_id"] == v["id"]],
                          VIS_DRIVER_FRAMES, (v["height"], v["width"]),
                          f"VIS test driver, video {vid}")
    return launches


# ------------------------------------------------ the test path (phase 30)

def random_masks(seed):
    """{0, 1} masks of 1x1, 7x13 and 480x640: empty, full, noise and
    overlapping rectangles, uint8."""
    rng = np.random.RandomState(seed)
    out = []
    for h, w in ((1, 1), (7, 13), (480, 640)):
        ms = [np.zeros((h, w), np.uint8), np.ones((h, w), np.uint8),
              (rng.rand(h, w) > 0.5).astype(np.uint8)]
        for _ in range(5):
            m = np.zeros((h, w), np.uint8)
            for _ in range(3):
                y, x = rng.randint(0, h), rng.randint(0, w)
                m[y:y + rng.randint(1, h + 1), x:x + rng.randint(1, w + 1)] = 1
            ms.append(m)
        out.append(np.stack(ms))
    return out


def codec_checks(ann, results13):
    """Phase 30a: the codec's build (phase 2: its g++ seconds; ``g++
    --version``), the library loaded asserted to be this checkout's build
    under build/native; then the codec held against the plain numpy
    versions on seeded random masks and phase 13's results and gts: counts
    byte for byte (from the masks and from their transposes); areas, IoUs
    (crowd too), intersections and greedy matches equal."""
    from sipmask_tpu_torch import native
    from sipmask_tpu_torch.data.coco import rasterize_polygons
    from sipmask_tpu_torch.eval import maskops, rle
    from sipmask_tpu_torch.eval.coco_eval import IOU_THRS

    root = Path(__file__).resolve().parent
    src = root / "sipmask_tpu_torch" / "native" / "maskops.cpp"
    path = native.library_path()
    if path.parent != native.BUILD_DIR or \
            native.BUILD_DIR != root / "build" / "native" or \
            path.name != native.library_name() or native.SRC != src:
        raise AssertionError(f"the codec loaded {path}, not this checkout's "
                             "build of sipmask_tpu_torch/native/maskops.cpp")
    gxx = subprocess.run(["g++", "--version"], capture_output=True,
                         text=True, check=True).stdout.splitlines()[0]
    secs = native.BUILD_LOG["seconds"]
    log(f"codec: {gxx}; " + (f"built {path} in {secs:.2f} s (phase 2)"
                             if secs is not None else
                             f"{path} was built before this run"))

    with open(ann) as f:
        data = json.load(f)
    info = {im["id"]: im for im in data["images"]}
    groups = []   # (dt RLEs, gt masks, crowd flags) by image
    for img_id, im in info.items():
        dts = [r["segmentation"] for r in results13
               if r["image_id"] == img_id]
        gts = [a for a in data["annotations"] if a["image_id"] == img_id]
        masks = [rle.decode_mask(a["segmentation"]) if isinstance(
            a["segmentation"], dict) else rasterize_polygons(
                a["segmentation"], im["height"], im["width"]) for a in gts]
        groups.append((dts, np.stack(masks),
                       np.asarray([a.get("iscrowd", 0) for a in gts]) |
                       (np.arange(len(gts)) % 5 == 4)))
    masks = random_masks(SEED) + [g[1] for g in groups] + [
        np.stack([rle.decode_mask(r) for r in g[0]]) for g in groups]
    n_masks, n_pairs, n_match = 0, 0, 0
    t_codec = t_plain = 0.0
    t_cm = 0.0
    for ms in masks:
        t0 = time.perf_counter()
        got = native.encode_masks(ms)
        t_codec += time.perf_counter() - t0
        ms_t = np.ascontiguousarray(ms.transpose(0, 2, 1))
        t0 = time.perf_counter()
        got_t = native.encode_masks_t(ms_t)
        t_cm += time.perf_counter() - t0
        t0 = time.perf_counter()
        want = [rle.encode_mask(m) for m in ms]
        t_plain += time.perf_counter() - t0
        if got != want or got_t != want:
            raise AssertionError(f"codec counts differ at {ms.shape}")
        for r, m in zip(got, ms):
            if native.rle_area(r) != rle.rle_area(r) or \
                    not np.array_equal(native.decode_mask(r), m):
                raise AssertionError("codec area or decode differs")
        n_masks += len(ms)
    rng = np.random.RandomState(SEED)
    pairs = [(native.encode_masks(ms), native.encode_masks(ms[::-1]),
              rng.rand(len(ms)) > 0.7) for ms in masks[:3]]
    pairs += [(dts, native.encode_masks(gm), crowd)
              for dts, gm, crowd in groups]
    for dts, gts, crowd in pairs:
        ious = native.iou_matrix(dts, gts, crowd)
        checks = [
            (ious, maskops.iou_matrix_plain(dts, gts, crowd)),
            (native.iou_matrix(dts, gts), maskops.iou_matrix_plain(dts, gts)),
            (native.inter_matrix(dts, gts),
             maskops.inter_matrix_plain(dts, gts))]
        order = np.argsort(rng.rand(len(gts)) > 0.6, kind="stable")
        gt_ig = np.sort(rng.rand(len(gts)) > 0.6).astype(np.uint8)
        args = (ious[:, order], IOU_THRS, gt_ig, crowd[order])
        checks += list(zip(native.greedy_match(*args),
                           maskops.greedy_match_plain(*args)))
        for got, want in checks:
            if not np.array_equal(got, want):
                raise AssertionError(f"codec matrices differ at "
                                     f"{len(dts)}x{len(gts)}")
        n_pairs += ious.size
        n_match += int((checks[3][0] > 0).sum())
    log(f"codec against the plain numpy versions: {n_masks} masks (1x1, "
        f"7x13, 480x640 random; phase 13's gts and results) byte-identical "
        f"counts, equal areas and decodes; {n_pairs} IoU pairs (crowd "
        f"too), intersections and {n_match} greedy matches equal; encode "
        f"{t_codec * 1e3:.1f} ms codec (row-major), {t_cm * 1e3:.1f} ms "
        f"codec (column-major, encode_masks_t) vs {t_plain * 1e3:.1f} ms "
        f"numpy")


@contextlib.contextmanager
def timed_plain_encode(acc):
    """``eval/results.rle.encode_mask`` (the plain path's numpy codec)
    timed into ``acc['encode']``."""
    from sipmask_tpu_torch.eval import results
    real = results.rle.encode_mask

    def enc(m):
        t0 = time.perf_counter()
        out = real(m)
        acc["encode"] = acc.get("encode", 0.0) + time.perf_counter() - t0
        return out
    results.rle.encode_mask = enc
    try:
        yield
    finally:
        results.rle.encode_mask = real


def paste_paths(dev, name, smi, ann, images, ckpt):
    """Phase 30b: ``run_inference`` on phase 12's set from its last
    checkpoint (device paste, one copy, the codec), then each batch's
    detections through both post-processings: the device paste and the
    codec against the plain host path (the f32 masks copied, resized in
    numpy, the numpy codec); every RLE decodes to the other path's mask
    with PASTE_SAME_MIN of its pixels equal. Then ``evaluate_coco`` (bbox,
    segm, proposal_fast) through the codec and through the plain
    versions: equal stats."""
    from sipmask_tpu_torch.apis.inference import init_detector
    from sipmask_tpu_torch.apis.test import evaluate_coco, run_inference
    from sipmask_tpu_torch.data.coco import CocoDataset
    from sipmask_tpu_torch.data.loader import build_test_loader
    from sipmask_tpu_torch.data.transforms import TestTransform
    from sipmask_tpu_torch.eval import maskops, rle
    from sipmask_tpu_torch.eval.results import (postprocess_batch,
                                                postprocess_batch_plain)
    from sipmask_tpu_torch.utils.checkpoint import load_weights

    det = init_detector(CONFIG, dev, seed=SEED)
    load_weights(ckpt, det.model)
    ds = CocoDataset(ann, images, test_mode=True)
    thr = det.cfg.model.test.mask_thr
    reset_launches()
    timings = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    results = run_inference(det, ds, batch_size=BATCH, progress=False,
                            timings=timings)
    entry_s = time.perf_counter() - t0
    check_path_launches("hi-acc test driver", read_launches())
    log(f"run_inference (device paste, one copy, the codec): {len(ds)} "
        f"images in {entry_s:.3f} s, {len(ds) / entry_s:.2f} images/s; a "
        f"batch: paste + copy ms {fmt(timings['paste'])}, encode ms "
        f"{fmt(timings['encode'])}, copied MB {fmt(timings['copied_mb'])}, "
        f"on {name} ({smi})")

    loader = build_test_loader(ds, TestTransform(det.cfg.data),
                               batch_size=BATCH)
    ms = {k: [] for k in ("infer", "new", "copy", "old", "old_encode")}
    old_mb, n_masks, n_diff, worst = [], 0, 0, 1.0
    for batch, n_valid in loader:
        images_t = torch.from_numpy(batch["images"]).to(dev)
        args = (batch["image_ids"], batch["ori_shapes"], ds.label2cat, thr,
                n_valid)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dets = det.infer(images_t.permute(0, 3, 1, 2).contiguous(),
                         torch.from_numpy(batch["img_shapes"]),
                         torch.from_numpy(batch["scale_factors"]))
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        dets["scale_factors"] = batch["scale_factors"]
        new = postprocess_batch(dets, *args)
        t2 = time.perf_counter()
        host = {k: (v.cpu().numpy() if isinstance(v, torch.Tensor) else v)
                for k, v in dets.items()}
        t3 = time.perf_counter()
        acc = {}
        with timed_plain_encode(acc):
            old = postprocess_batch_plain(host, *args)
        t4 = time.perf_counter()
        for k, v in zip(ms, (t1 - t0, t2 - t1, t3 - t2, t4 - t3,
                             acc.get("encode", 0.0))):
            ms[k].append(v * 1e3)
        old_mb.append(host["masks"].nbytes / 2 ** 20)
        if len(new) != len(old):
            raise AssertionError("the two post-processings disagree")
        for a, b in zip(new, old):
            sa, sb = a.pop("segmentation"), b.pop("segmentation")
            if a != b:
                raise AssertionError(f"results differ: {a} vs {b}")
            ma, mb = rle.decode_mask(sa), rle.decode_mask(sb)
            if ma.shape != mb.shape:
                raise AssertionError(f"mask shapes {ma.shape} {mb.shape}")
            diff = int((ma != mb).sum())
            n_diff += diff
            n_masks += 1
            worst = min(worst, 1 - diff / ma.size)
    n_img = len(ds)
    new_s = (sum(ms["infer"]) + sum(ms["new"])) / 1e3
    old_s = (sum(ms["infer"]) + sum(ms["copy"]) + sum(ms["old"])) / 1e3
    log(f"the same detections, two post-processings ({n_img} images, "
        f"{n_masks} masks): device paste + codec {n_img / new_s:.2f} "
        f"images/s vs host resize + numpy codec {n_img / old_s:.2f} "
        f"images/s (forward + decode ms a batch {fmt(ms['infer'])}); "
        f"post-processing ms a batch {fmt(ms['new'])} vs copy "
        f"{fmt(ms['copy'])} + host {fmt(ms['old'])} (of which numpy RLE "
        f"{fmt(ms['old_encode'])}); MB copied a batch "
        f"{fmt(timings['copied_mb'])} (bool) vs {fmt(old_mb)} (f32); "
        f"{n_diff} pixels differ in all, the worst mask {worst:.6f} equal "
        f"(min {PASTE_SAME_MIN}), on {name} ({smi})")
    if worst < PASTE_SAME_MIN:
        raise AssertionError("device paste and host resize disagree")

    metrics = ("bbox", "segm", "proposal_fast")
    t0 = time.perf_counter()
    stats = evaluate_coco(results, ann, metrics, dataset=ds)
    codec_s = time.perf_counter() - t0
    swaps = {"encode_mask": rle.encode_mask, "rle_area": rle.rle_area,
             "iou_matrix": maskops.iou_matrix_plain,
             "greedy_match": maskops.greedy_match_plain}
    saved = {k: getattr(maskops, k) for k in swaps}
    for k, fn in swaps.items():
        setattr(maskops, k, fn)
    try:
        t0 = time.perf_counter()
        plain = evaluate_coco(results, ann, metrics, dataset=ds)
        plain_s = time.perf_counter() - t0
    finally:
        for k, fn in saved.items():
            setattr(maskops, k, fn)
    log(f"evaluate_coco {metrics}: {codec_s:.2f} s through the codec, "
        f"{plain_s:.2f} s through the plain versions; proposal_fast "
        f"{stats['proposal_fast']}")
    if stats != plain:
        raise AssertionError(f"evaluate_coco: codec {stats} vs plain {plain}")
    for s in stats.values():
        if not all(np.isfinite(v) and -1 <= v <= 1 for v in s.values()):
            raise AssertionError(f"stats {stats}")
    del det
    torch.cuda.empty_cache()


def fmt(vals):
    return "[" + ", ".join(f"{v:.2f}" for v in vals) + "]"


def soft_nms_oracle(boxes, scores, factors, t):
    """Float64 host oracle of the soft-NMS decode's NMS on one image's
    candidates, read back: per class, the candidates above ``score_thr``,
    their scores times the factors, those below ``soft_nms_min_score``
    dropped, then sequential soft-NMS (+1 IoU; the pick is the first index
    of the maximum; linear 1 - IoU above ``nms_iou_thr``, gaussian
    exp(-IoU² / sigma); a box decayed below min_score drops); the picks of
    all classes sorted by score, the top ``max_per_img``. Returns
    {(input row, label): score}."""
    b = boxes.astype(np.float64)
    area = (b[:, 2] - b[:, 0] + 1) * (b[:, 3] - b[:, 1] + 1)
    picks = []
    for c in range(scores.shape[1]):
        live = scores[:, c].astype(np.float64) * factors
        live[(scores[:, c] <= t.score_thr) | (live < t.soft_nms_min_score)] \
            = -np.inf
        for _ in range(t.max_per_img):
            j = int(np.argmax(live))
            if live[j] == -np.inf:
                break
            picks.append((live[j], j, c))
            wh = np.clip(np.minimum(b[j, 2:], b[:, 2:])
                         - np.maximum(b[j, :2], b[:, :2]) + 1, 0, None)
            inter = wh[:, 0] * wh[:, 1]
            iou = inter / (area[j] + area - inter)
            if t.soft_nms_method == "gaussian":
                live = live * np.exp(-(iou * iou) / t.soft_nms_sigma)
            else:
                live = np.where(iou > t.nms_iou_thr, live * (1 - iou), live)
            live[j] = -np.inf
            live[live < t.soft_nms_min_score] = -np.inf
    picks.sort(key=lambda p: (-p[0], p[2], p[1]))
    return {(j, c): s for s, j, c in picks[:t.max_per_img]}


@contextlib.contextmanager
def recorded_decode(calls, record_nms):
    """Within the context each ``Detector.infer``'s decode appends to
    ``calls`` its ms (a synchronise before and after) and, without
    ``record_nms``, its count of synchronising CUDA calls
    (``torch.cuda.set_sync_debug_mode``); with ``record_nms`` the
    candidates and detections of each ``multiclass_nms_idx`` call, read
    back (reads that would count)."""
    import warnings
    from sipmask_tpu_torch.apis import inference
    from sipmask_tpu_torch.models import decode
    real_decode, real_nms = inference.decode_batch, decode.multiclass_nms_idx

    def nms(boxes, scores, *a, score_factors=None, **kw):
        out = real_nms(boxes, scores, *a, score_factors=score_factors, **kw)
        calls[-1]["nms"].append(dict(
            boxes=boxes.cpu().numpy(), scores=scores.cpu().numpy(),
            factors=score_factors.cpu().numpy(),
            out={k: v.cpu().numpy() for k, v in out.items()}))
        return out

    def timed_decode(*a, **kw):
        call = dict(nms=[], syncs=None)
        calls.append(call)
        torch.cuda.synchronize()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            if not record_nms:
                torch.cuda.set_sync_debug_mode("warn")
            t0 = time.perf_counter()
            try:
                out = real_decode(*a, **kw)
                torch.cuda.synchronize()
            finally:
                torch.cuda.set_sync_debug_mode("default")
        call["ms"] = (time.perf_counter() - t0) * 1e3
        if not record_nms:
            call["syncs"] = sum("synchroniz" in str(w.message)
                                for w in caught)
        return out
    inference.decode_batch = timed_decode
    if record_nms:
        decode.multiclass_nms_idx = nms
    try:
        yield
    finally:
        inference.decode_batch = real_decode
        decode.multiclass_nms_idx = real_nms


def soft_nms_serving(dev, name, smi):
    """Phase 30c: the flagship served with ``test.nms_type="soft_nms"``,
    linear and gaussian: a batch of 4 at 800x1344 twice through
    ``Detector.infer`` (launches exactly K1 5, K4a 40 and K6 1 a forward
    and decode), the decode's ms and its synchronising CUDA calls; then the
    same batch once more with its NMS candidates read back, against a float64
    host oracle of sequential per-class soft-NMS: the same (row, label)
    set, scores within SOFT_SCORE_RTOL. Then the decode's ms and
    synchronising calls with the preset's hard NMS on the same batch."""
    from sipmask_tpu_torch.apis.inference import init_detector, preprocess
    from sipmask_tpu_torch.config import _r, get_config
    from sipmask_tpu_torch.utils.demo_inputs import bump_weights

    rng = np.random.RandomState(SEED)
    imgs = [(rng.rand(*IMAGE_HW, 3) * 255).astype(np.uint8)
            for _ in range(3 + BATCH)][3:]   # phase 4's batch
    total = None
    for method in ("linear", "gaussian"):
        cfg = _r(get_config(CONFIG), "model.test", nms_type="soft_nms",
                 soft_nms_method=method)
        det = init_detector(cfg, dev, seed=SEED)
        bump_weights(det.model, torch.Generator().manual_seed(SEED))
        prepped = [preprocess(im, cfg) for im in imgs]
        batch = (torch.stack([torch.from_numpy(p[0]).permute(2, 0, 1)
                              for p in prepped]).to(dev),
                 torch.from_numpy(np.stack([p[1] for p in prepped])),
                 torch.from_numpy(np.stack([p[2] for p in prepped])))
        reset_launches()
        walls = []
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = det.infer(*batch)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        launches = read_launches()
        check_path_launches("hi-acc soft-nms serving", launches)
        want = {k: 0 for k in launches}
        want.update({"deform_im2col": 10, "gn_relu": 80,
                     "assemble_masks": 2})
        if launches != want:
            raise AssertionError(f"soft-NMS serving launches {launches}, "
                                 f"not {want}")
        total = launches if total is None else {
            k: total[k] + v for k, v in launches.items()}
        for key in ("boxes", "scores", "masks"):
            check_finite(key, out[key])
        valid = out["valid"].sum(1).tolist()
        if min(valid) <= 0:
            raise AssertionError("an image of the batch has no detection")
        calls, recorded = [], []
        with recorded_decode(calls, False):
            det.infer(*batch)
            det.infer(*batch)
        with recorded_decode(recorded, True):
            det.infer(*batch)
        t = cfg.model.test
        worst, n_kept, n_decayed = 0.0, 0, 0
        for rec in recorded[0]["nms"]:
            got = rec["out"]
            v = got["valid"]
            mine = {(int(j), int(c)): float(s) for j, c, s in zip(
                got["idxs"][v], got["labels"][v], got["scores"][v])}
            oracle = soft_nms_oracle(rec["boxes"], rec["scores"],
                                     rec["factors"].astype(np.float64), t)
            if mine.keys() != oracle.keys():
                raise AssertionError(
                    f"soft-NMS ({method}) keeps {len(mine)} detections, "
                    f"the oracle {len(oracle)}; "
                    f"{len(mine.keys() - oracle.keys())} not the oracle's")
            for k, s in mine.items():
                worst = max(worst, abs(s - oracle[k]) / oracle[k])
                raw = float(rec["scores"][k[0], k[1]] * rec["factors"][k[0]])
                n_decayed += s < raw * (1 - 1e-6)
            n_kept += len(mine)
        log(f"soft-NMS ({method}) serving: batch {tuple(batch[0].shape)} "
            f"through Detector.infer {fmt(walls)} ms wall, valid "
            f"detections {valid}; the decode {fmt([c['ms'] for c in calls])}"
            f" ms with {[c['syncs'] for c in calls]} synchronising CUDA "
            f"calls; against the float64 oracle: {n_kept} detections, the "
            f"same (row, label) set, {n_decayed} of them decayed, scores "
            f"within {worst:.2e} relative (tol {SOFT_SCORE_RTOL}), on "
            f"{name} ({smi})")
        if worst > SOFT_SCORE_RTOL:
            raise AssertionError(f"soft-NMS ({method}) scores disagree")
        del det
        torch.cuda.empty_cache()
    # the preset's hard NMS on the same batch, for comparison
    det = init_detector(CONFIG, dev, seed=SEED)
    bump_weights(det.model, torch.Generator().manual_seed(SEED))
    calls = []
    with recorded_decode(calls, False):
        det.infer(*batch)
        det.infer(*batch)
    log(f"hard NMS on the same batch: the decode "
        f"{fmt([c['ms'] for c in calls])} ms with "
        f"{[c['syncs'] for c in calls]} synchronising CUDA calls")
    del det
    torch.cuda.empty_cache()
    return total


def phase_test_path(dev, name, smi, ann, images, ckpt, results13):
    """Phase 30: the codec (30a), the test driver's device paste against
    the plain host path and evaluate_coco with proposal_fast (30b), soft-NMS
    serving (30c), and phase 16's paste ms a frame. Returns the soft-NMS
    path's launches."""
    codec_checks(ann, results13)
    paste_paths(dev, name, smi, ann, images, ckpt)
    launches = soft_nms_serving(dev, name, smi)
    paste = VIS_TIMINGS.get("paste")
    log("VIS paste ms a frame (phase 16: device paste, one copy, one "
        "encode_masks call): " + ("not measured" if paste is None else
                                  f"{fmt(paste)} (mean {np.mean(paste):.2f})"))
    return launches


# ------------------------------------ SipMask++ and SipMask-VIS in bfloat16

def phase_bf16_pp_kernels(dev):
    """Phase 23: the bf16 variants of K5 and K5c against their plain bf16
    versions at the R101 DCN stages' shapes at 544x544 and 576x576, batch
    8 (random offsets with a third of the pixels +-300 px out, and zero
    offsets), on the vector path at Cg % 8 != 0 (Cg = 36) and on the
    scalar path (Cg % 4 != 0), each within one bf16 unit of its output's
    max, d positions the same bits twice; then times at the serving
    shapes, the device ms of each stage's call by kernel (a K5 call one
    kernel, a K5c call the zeroing, the scatter and the rounding) and of
    the SipMask++ pass's DCN convs (PP_DCN_CALLS), bounds (bf16 tensors 2
    bytes an element) and library equivalents (``F.grid_sample`` in bf16,
    and its autograd)."""
    from sipmask_tpu_torch.ops import deform_sample as ds

    bf = torch.bfloat16
    gen = torch.Generator().manual_seed(SEED + 6)
    errs = {"deform_rows_bf16": 0.0, "deform_rows_backward_bf16": 0.0}
    # (path, batch, Cg, h, w): the three stages serving and training,
    # Cg = 36 (lanes of 4 channels, a half-warp an item) and Cg = 18
    # (scalar loads)
    cases = ([("serving", PP_BATCH, c, h, w) for c, h, w in PP_DCN]
             + [("training", PP_BATCH, c, h, w) for c, h, w in PP_DCN_TRAIN]
             + [("vector path", 2, 36, 68, 68), ("scalar path", 2, 18, 68,
                                                 68)])
    for path, b, c, h, w in cases:
        for zero in (False, True):
            x, pyx = pp_positions(b, c, h, w, gen, dev, zero)
            x = x.to(bf)
            g = torch.randn((b, h * w, 9, c), generator=gen).to(dev).to(bf)
            got = ds.deform_rows(x, pyx, h, w)
            dx, dp = ds.deform_rows_backward(x, pyx, g, h, w)
            if not torch.equal(dp, ds.deform_rows_backward(x, pyx, g, h,
                                                           w)[1]):
                raise AssertionError("two bf16 K5c calls gave different d "
                                     "positions")
            want = ds.deform_rows_plain(x, pyx, h, w)
            wdx, wdp = ds.deform_rows_backward_plain(x, pyx, g, h, w)
            torch.cuda.synchronize()
            if (got.dtype, dx.dtype, dp.dtype) != (bf, bf, torch.float32):
                raise AssertionError(f"bf16 K5/K5c gave {got.dtype}, "
                                     f"{dx.dtype}, {dp.dtype}")
            label = (f"{path} {(b, c, h, w)} "
                     f"{'zero' if zero else 'random (+-300 px)'} offsets")
            errs["deform_rows_bf16"] = max(
                errs["deform_rows_bf16"], check_outputs(
                    f"K5 bf16 deform_rows {label}", [got.float()],
                    [want.float()], BF16_KERNEL_TOL))
            errs["deform_rows_backward_bf16"] = max(
                errs["deform_rows_backward_bf16"], check_outputs(
                    f"K5c bf16 deform_rows_backward {label} (dx, dpyx)",
                    [dx.float(), dp], [wdx.float(), wdp], BF16_KERNEL_TOL))
            if zero and not float(dp.abs().max()) > 0:
                raise AssertionError("bf16 K5c gives zero offset gradients "
                                     "at zero offsets")
            del x, pyx, g, got, dx, dp, want, wdx, wdp

    # times at the serving shapes: one DCN conv of each stage
    k5_in = []
    for c, h, w in PP_DCN:
        x, pyx = pp_positions(PP_BATCH, c, h, w, gen, dev)
        k5_in.append((x.to(bf), pyx, h, w))
    k5c_g = [torch.randn((PP_BATCH, h * w, 9, c), generator=gen).to(dev)
             .to(bf) for c, h, w in PP_DCN]
    times = {"deform_rows_bf16": turns(
        f"K5 bf16 deform_rows, one DCN conv of each stage bs{PP_BATCH}",
        lambda: [ds.deform_rows_plain(*a) for a in k5_in],
        lambda: [ds.deform_rows(*a) for a in k5_in])}
    graphs = []
    for (x, pyx, h, w), g in zip(k5_in, k5c_g):
        leaves = [t.detach().requires_grad_(True) for t in (x, pyx)]
        graphs.append((ds.deform_rows_plain(*leaves, h, w), leaves, g))

    def k5c_sweep():
        return [ds.deform_rows_backward(x, pyx, g, h, w)
                for (x, pyx, h, w), g in zip(k5_in, k5c_g)]
    times["deform_rows_backward_bf16"] = turns(
        f"K5c bf16 deform_rows_backward, one DCN conv of each stage "
        f"bs{PP_BATCH}",
        lambda: [torch.autograd.grad(o, lv, g, retain_graph=True)
                 for o, lv, g in graphs], k5c_sweep, iters=10)
    del graphs
    # each stage's call by device kernel (48 kernels a profiler session,
    # the last whole run read: late in a long run the card's profiler
    # drops up to tens of a session's first kernels): K5 its gather, K5c
    # the zeroing of the f32 dx (a memset), the scatter and the rounding
    stages = {"deform_rows_bf16": [], "deform_rows_backward_bf16": []}
    for (x, pyx, h, w), g, (c, *_) in zip(k5_in, k5c_g, PP_DCN):
        for kname, fn, parts in (
                ("deform_rows_bf16",
                 lambda x=x, pyx=pyx, h=h, w=w: ds.deform_rows(x, pyx, h, w),
                 ("deform_rows_fwd_bf16x4_kernel",)),
                ("deform_rows_backward_bf16",
                 lambda x=x, pyx=pyx, g=g, h=h, w=w: ds.deform_rows_backward(
                     x, pyx, g, h, w),
                 ("Memset", "deform_rows_bwd_bf16x4_kernel",
                  "round_bf16_kernel"))):
            split, n_kern = launch_split(
                f"{kname}, one call at Cg={c} {h}x{w} bs{PP_BATCH}", fn,
                want=len(parts), reps=48 // len(parts))
            if n_kern != len(parts) or any(
                    sum(n for name, (n, _) in split.items() if part in name)
                    != 1 for part in parts):
                raise AssertionError(f"a {kname} call at Cg={c} ran "
                                     f"{n_kern} device kernels, not "
                                     f"{', '.join(parts)}: {split}")
            stages[kname].append(sum(ms for _, ms in split.values()))
    weights = " + ".join(f"{n} x Cg {c}"
                         for n, (c, *_) in zip(PP_DCN_CALLS, PP_DCN))
    for kname, ms in stages.items():
        log(f"{kname} device ms a call by stage: "
            + ", ".join(f"Cg {c} {m:.4f}" for (c, *_), m in zip(PP_DCN, ms))
            + f"; a SipMask++ pass's DCN convs ({weights}): "
            f"{sum(n * m for n, m in zip(PP_DCN_CALLS, ms)):.4f} ms")

    out_elems = sum(x.shape[0] * x.shape[1] * 9 * x.shape[2]
                    for x, *_ in k5_in)
    libs = [grid_sample_rows(x, pyx.to(bf), h, w) for x, pyx, h, w in k5_in]
    lib_graphs = []
    for (call, inp, grid), g in zip(libs, k5c_g):
        leaves = [inp.detach().requires_grad_(True),
                  grid.detach().requires_grad_(True)]
        out = call(*leaves)
        lib_graphs.append((out, leaves, g.permute(0, 3, 2, 1).reshape(
            out.shape).contiguous()))
    extra = {
        # reads x (bf16) and pyx (f32), writes sampled (bf16)
        "deform_rows_bf16": (
            bound(sum(nbytes(x, pyx) for x, pyx, *_ in k5_in)
                  + 2 * out_elems, 7 * out_elems),
            cuda_ms(lambda: [c() for c, *_ in libs])),
        # reads x, pyx and dsampled (bf16); writes dx (bf16) and dpyx
        "deform_rows_backward_bf16": (
            bound(sum(2 * nbytes(x, pyx) for x, pyx, *_ in k5_in)
                  + 2 * out_elems, 18 * out_elems),
            cuda_ms(lambda: [torch.autograd.grad(o, lv, g, retain_graph=True)
                             for o, lv, g in lib_graphs], iters=10)),
    }
    for kname, (bnd, lib) in extra.items():
        log(f"{kname}: bound {bnd[0]:.4f} ms ({bnd[1]}), one-call library "
            f"equivalent (bf16) {lib:.4f} ms")
    del k5_in, k5c_g, libs, lib_graphs
    torch.cuda.empty_cache()
    return errs, times, extra


def phase_bf16_pp_serving(dev, name, smi):
    """Phase 24: SipMask++ in bf16: 3 requests at 544x544 and a batch of 8
    twice (fast NMS, rescoring), launches counted (bf16 K1 and K5, no f32
    variant); then the batch with the kernels, with the plain versions and
    in f32 on the same weights, the backbone's ReLUs and sampling floors
    pinned to one f32 forward's: head outputs and detections (scores and
    mask scores) kernels vs plain within the SipMask++ bf16 bounds, bf16 vs
    f32 logged (the calibrated random backbone amplifies rounding, as in
    phase 22)."""
    from sipmask_tpu_torch.utils.demo_inputs import calibrate_frozen_bn
    return bf16_serving(
        dev, name, smi, "bf16 SipMask++", PP_CONFIG,
        pp_batch_images(3 + PP_BATCH, SEED), PP_BATCH,
        "sipmask++ bf16 serving",
        prepare=lambda det, images: calibrate_frozen_bn(det.model.backbone,
                                                        images),
        f32_tol=None, pin=True, head_tol=BF16_PP_HEAD_TOL,
        match_min=BF16_PP_MATCH_MIN)


def phase_bf16_pp_train(dev, name, smi):
    """Phase 25: SipMask++ in bf16: TRAIN_STEPS SGD steps at 576x576,
    batch 8, max_pos 256, loss_iou, after calibrate_frozen_bn of the
    random R101; launches counted (bf16 K5 and K5c among them); then the
    first step with the kernels, with the plain versions and in f32, the
    backbone's ReLUs and sampling floors pinned to one f32 forward's in
    all three: losses and gradients, kernels vs plain, within the
    SipMask++ bf16 bounds."""
    from sipmask_tpu_torch.utils.demo_inputs import train_batch_for
    dcn = ([f"backbone.layer2.{b}" for b in (0, 3)]
           + [f"backbone.layer3.{b}" for b in range(0, 23, 3)]
           + ["backbone.layer4.0"])
    return bf16_train(
        dev, name, smi, "bf16 SipMask++", PP_CONFIG,
        "sipmask++ bf16 training",
        lambda cfg: train_batch_for(cfg, SEED, dev),
        [f"{b}.conv2.conv_offset.weight" for b in dcn]
        + ["bbox_head.mask_scoring.weight"],
        calibrate=True, pin=True, loss_tol=BF16_PP_LOSS_TOL,
        loss_tols=BF16_PP_LOSS_TOLS, grad_tol=BF16_PP_GRAD_TOL,
        grad_median_tol=BF16_PP_GRAD_MEDIAN_TOL)


def phase_bf16_vis_train(dev, name, smi):
    """Phase 26b: SipMask-VIS in bf16: TRAIN_STEPS SGD steps at 384x640,
    batch 4, current and reference frames, launches counted; then the
    first step with the kernels and with the plain versions: losses within
    BF16_VIS_LOSS_TOL, gradients within phase 21's bound."""
    return bf16_train(
        dev, name, smi, "bf16 VIS", VIS_CONFIG, "vis bf16 training",
        lambda cfg: vis_batch(cfg, dev),
        ("bbox_head.track_convs.0.conv.weight",
         "bbox_head.sipmask_track.weight"),
        loss_tol=BF16_VIS_LOSS_TOL)


def last_presets(dev, name, smi, timed):
    """Phases 27-29: ResNeXt-101 32x4d and HRNet-W32 with HRFPN served and
    trained as the flagship (phases 4-8, HRNet's first step with each K1,
    K2, K4a and K4b call held against its plain version and then those
    calls timed at its shapes), then in bf16 (phases 20-21); the benchmark
    fork trained (with its dedup's counts) and served. ``timed(label, fn,
    *args)`` runs a phase. Returns {path: launches}."""
    paths = {}
    for label, preset in (("27", X101_CONFIG), ("28", HR_CONFIG)):
        p = "x101" if preset == X101_CONFIG else "hrnet"
        paths[f"{p} serving"] = timed(
            f"{label}a", phase_serving, dev, name, smi, preset,
            f"{p} serving", True)
        record = {} if p == "hrnet" else None
        paths[f"{p} training"] = timed(
            f"{label}b", phase_train, dev, name, smi, preset,
            f"{p} training", ("deform_im2col", "deform_conv_backward",
                              "gn_relu_forward", "gn_relu_backward")
            if p == "hrnet" else (), record, True)
        if record:
            timed(f"{label}c", time_recorded, record, "hrnet training")
        rng = np.random.RandomState(SEED)
        imgs = [(rng.rand(*IMAGE_HW, 3) * 255).astype(np.uint8)
                for _ in range(3 + BATCH)]
        paths[f"{p} bf16 serving"] = timed(
            f"{label}d", bf16_serving, dev, name, smi, f"bf16 {p}", preset,
            imgs, BATCH, f"{p} bf16 serving", None, BF16_F32_TOL, False,
            BF16_HEAD_TOL, BF16_HR_MATCH_MIN if p == "hrnet"
            else BF16_MATCH_MIN, ("deform_im2col", "gn_relu_forward"))
        paths[f"{p} bf16 training"] = timed(
            f"{label}e", phase_bf16_preset_train, dev, name, smi, p, preset)
    # boxes of 10 strides a side: a neighbour's box, a stride away,
    # overlaps it by more than 0.9 and the dedup drops positives (at
    # bump_weights' 2 strides the overlap is ~0.6 and it keeps them all)
    paths["fork training"] = timed("29a", phase_train, dev, name, smi,
                                   FORK_CONFIG, "fork training", (), None,
                                   True, 10.0)
    paths["fork serving"] = timed("29b", phase_serving, dev, name, smi,
                                  FORK_CONFIG, "fork serving", True)
    return paths


def check_jpeg_set(image_dir, file_names):
    """Every file of a synthetic set is a JPEG file, named .jpg."""
    for fn in file_names:
        with open(os.path.join(image_dir, fn), "rb") as f:
            head = f.read(3)
        if not fn.endswith(".jpg") or head != b"\xff\xd8\xff":
            raise AssertionError(f"{fn}: not a JPEG file ({head!r})")


def cpu_model():
    """``lscpu``'s model name of the host, with its vendor, family and
    model numbers and ``/proc/cpuinfo``'s model name (lscpu may give
    "unknown" in a virtual machine)."""
    out = subprocess.run(["lscpu"], capture_output=True, text=True,
                         timeout=60).stdout
    fields = {}
    for ln in out.splitlines():
        key, _, value = ln.partition(":")
        fields.setdefault(key.strip(), value.strip())
    try:
        with open("/proc/cpuinfo") as f:
            names = [ln.split(":", 1)[1].strip() for ln in f
                     if ln.startswith("model name")]
    except OSError:
        names = []
    return (f"lscpu model name {fields.get('Model name', '(none)')!r} "
            f"(vendor {fields.get('Vendor ID', '?')}, family "
            f"{fields.get('CPU family', '?')}, model "
            f"{fields.get('Model', '?')}, {fields.get('CPU(s)', '?')} CPUs); "
            f"/proc/cpuinfo model name "
            f"{names[0] if names else '(none)'!r}")


def median_ms(fn, runs=20):
    fn()
    ts = []
    for _ in range(runs):
        t0 = time.perf_counter()
        fn()
        ts.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(ts))


def phase_jpeg(smi):
    """Phase 31: the JPEG codec (``native/jpeg.cpp``, host C++) against
    the digests cv2 gave for the fixtures of ``tests/data/jpeg`` (the
    pixels of ``cv2.imread``) and for seeded images (the bytes of
    ``cv2.imencode``); a mismatch fails the run. Then the median ms of 20
    decodes and 20 encodes of a 640x480 quality-95 4:2:0 image."""
    import hashlib
    from sipmask_tpu_torch import native
    from sipmask_tpu_torch.data import image_io
    from sipmask_tpu_torch.native import jpeg
    root = Path(__file__).resolve().parent
    path = jpeg.library_path()
    if path.parent != root / "build" / "native" or \
            path.name != native.library_name(jpeg.SRC) or \
            jpeg.SRC != root / "sipmask_tpu_torch" / "native" / "jpeg.cpp":
        raise AssertionError(f"{path} is not this checkout's build of "
                             "sipmask_tpu_torch/native/jpeg.cpp")
    fixtures = root / "tests" / "data" / "jpeg"
    with open(fixtures / "digests.json") as f:
        digests = json.load(f)
    for fname, want in sorted(digests["decoded"].items()):
        img = image_io.imread(str(fixtures / fname))
        got = hashlib.sha256(img.tobytes()).hexdigest()
        if list(img.shape) != want["shape"] or got != want["sha256"]:
            raise AssertionError(f"JPEG decode of {fname}: shape "
                                 f"{img.shape}, sha256 {got}; cv2.imread "
                                 f"gave {want}")
    for e in digests["encoded"]:
        h, w = e["shape"]
        img = np.random.RandomState(e["seed"]).randint(0, 256, (h, w, 3),
                                                       np.uint8)
        got = hashlib.sha256(image_io.imencode_jpeg(
            img, e["quality"])).hexdigest()
        if got != e["sha256"]:
            raise AssertionError(f"JPEG encode of {e}: sha256 {got}")
    log(f"JPEG codec: {len(digests['decoded'])} fixtures decode to "
        f"cv2.imread's pixels and {len(digests['encoded'])} seeded images "
        f"encode to cv2.imencode's bytes (sha256 equal)")
    # a 640x480 image with a photograph's mix of smooth areas and noise
    rng = np.random.RandomState(SEED)
    yy, xx = np.mgrid[:480, :640]
    img = (np.stack([(xx * 7 + yy * 3) % 256, (xx * 2 + yy * 11 + 40) % 256,
                     ((xx - yy) * 5) % 256], -1)
           + rng.randint(0, 40, (480, 640, 3))).clip(0, 255).astype(np.uint8)
    data = image_io.imencode_jpeg(img, 95)
    if not np.array_equal(image_io.imdecode(data).shape, (480, 640, 3)):
        raise AssertionError("640x480 decode shape")
    dec = median_ms(lambda: image_io.imdecode(data))
    enc = median_ms(lambda: image_io.imencode_jpeg(img, 95))
    log(f"JPEG 640x480 q95 4:2:0 ({len(data)} bytes): decode "
        f"{dec:.3f} ms, encode {enc:.3f} ms (median of 20, one thread); "
        f"host CPU: {cpu_model()}; card: {smi}")
    return dec, enc


def build_kernels():
    """Phase 2: one nvcc per source of KERNELS and g++ for the mask codec
    (``native/maskops.cpp``) and the JPEG codec (``native/jpeg.cpp``), all
    started together; logs each build's seconds and ptxas's register and
    spill lines."""
    from sipmask_tpu_torch import native as codec
    from sipmask_tpu_torch.native import jpeg
    from sipmask_tpu_torch.ops import native
    t0 = time.perf_counter()
    failed = []

    def build(src):
        try:
            if src == "maskops":
                codec.load()
            elif src == "jpeg":
                jpeg.load()
            else:
                native.load(src)
        except Exception as exc:   # reported and raised below
            failed.append((src, exc))
    threads = [threading.Thread(target=build, args=(src,)) for src in
               sorted({src[:-3] for src, _ in KERNELS.values()}
                      | {"maskops", "jpeg"})]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if failed:
        raise RuntimeError(f"kernel builds failed: {failed}")
    log(f"built kernels and the codecs in {time.perf_counter() - t0:.1f} s; "
        f"the mask codec: g++ {codec.BUILD_LOG['seconds']} s, "
        f"{codec.library_path()}; the JPEG codec: g++ "
        f"{jpeg.BUILD_LOG['seconds']} s, {jpeg.library_path()}")
    for kname, (secs, ptxas) in native.BUILD_LOG.items():
        lines = [ln for ln in ptxas.splitlines() if "registers" in ln
                 or "spill" in ln]
        log(f"  {kname}: nvcc {secs:.1f} s; " + " | ".join(
            ln.strip() for ln in lines))


def set_backend_flags():
    """Plain f32 (TF32 off), bf16 products summed in f32 (as the JAX
    package's preferred_element_type=float32 asks), cuDNN's benchmark mode
    (fixed shapes)."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    # serving shapes are fixed: let cuDNN time its algorithms once per shape
    # (its untimed pick at batch 4, f32, is an FFT path about 8x slower)
    torch.backends.cudnn.benchmark = True
    log(f"torch {torch.__version__} cuda {torch.version.cuda}; "
        f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
        f"cuda.matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
        f"cuda.matmul.allow_bf16_reduced_precision_reduction="
        f"{torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction}"
        f" cudnn.benchmark={torch.backends.cudnn.benchmark}")


def main():
    t_start = time.perf_counter()
    # ---- 1. device
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device "
                         "(torch.cuda.is_available() is False)")
    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True
    ).stdout.strip().splitlines()[0]
    log(smi)
    set_backend_flags()
    seconds = {}

    def timed(label, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        seconds[label] = time.perf_counter() - t0
        log(f"phase {label}: {seconds[label]:.1f} s")
        return out

    def kernel_phase(label, fn):
        e, t, x = timed(label, fn, dev)
        errs.update(e)
        times.update(t)
        extra.update(x)

    # ---- 2. build: one nvcc per source, all at once
    timed("2", build_kernels)

    # ---- 31. the JPEG codec against cv2's digests, and its host ms
    timed("31", phase_jpeg, smi)

    # ---- 3. kernels against their plain versions
    errs, times, extra = {}, {}, {}
    kernel_phase("3", phase_kernels)

    # ---- 4 and 5. the serving path, with the kernels and then without
    paths = {"hi-acc serving": timed("4-5", phase_serving, dev, name, smi)}

    # ---- 6. the training kernels against their plain versions
    kernel_phase("6", phase_train_kernels)

    # ---- 7 and 8. the train step, with the kernels and then without
    paths["hi-acc training"] = timed("7-8", phase_train, dev, name, smi)

    # ---- 9. SipMask++'s kernels against their plain versions
    kernel_phase("9", phase_pp_kernels)

    # ---- 10 and 11. SipMask++ serving and training
    paths["sipmask++ serving"] = timed("10", phase_pp_serving, dev, name,
                                       smi)
    paths["sipmask++ training"] = timed("11", phase_pp_train, dev, name,
                                        smi)

    # ---- 12 and 13. the train and test drivers on a synthetic COCO set,
    # written under build/ (gitignored) and removed after
    work = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        "smoke_drivers")
    shutil.rmtree(work, ignore_errors=True)
    try:
        paths["hi-acc train driver"], drv = timed(
            "12", phase_train_driver, dev, name, smi, work)
        paths["hi-acc test driver"], results13 = timed(
            "13", phase_test_driver, dev, name, smi, drv["ann"],
            drv["images"], drv["last"])

        # ---- 14 and 15. the real-time preset: serving, then training
        # through the driver on phase 12's set
        paths["rt serving"] = timed("14", phase_rt_serving, dev, name, smi)
        paths["rt train driver"] = timed(
            "15", phase_rt_train_driver, dev, name, smi, work, drv["ann"],
            drv["images"])

        # ---- 16 and 17. SipMask-VIS: tracking a video, training pairs
        paths["vis serving"] = timed("16", phase_vis_serving, dev, name, smi)
        paths["vis training"] = timed("17", phase_vis_train, dev, name, smi)

        # ---- 18. the VIS train and test drivers on a synthetic
        # YouTube-VIS set
        paths["vis train driver"], vis = timed(
            "18a", phase_vis_train_driver, dev, name, smi, work)
        paths["vis test driver"] = timed(
            "18b", phase_vis_test_driver, dev, name, smi, vis["ann"],
            vis["images"], vis["last"])

        # ---- 30. the test path: the codec, the device paste against the
        # host path, evaluate_coco with proposal_fast, soft-NMS serving
        paths["hi-acc soft-nms serving"] = timed(
            "30", phase_test_path, dev, name, smi, drv["ann"],
            drv["images"], drv["last"], results13)
    finally:
        shutil.rmtree(work, ignore_errors=True)

    # ---- 19. the bf16 kernels against their plain bf16 versions
    kernel_phase("19", phase_bf16_kernels)

    # ---- 20-22. compute_dtype="bfloat16": flagship serving and training,
    # real-time serving
    paths["hi-acc bf16 serving"] = timed("20", phase_bf16_serving, dev, name,
                                         smi)
    paths["hi-acc bf16 training"] = timed("21", phase_bf16_train, dev, name,
                                          smi)
    paths["rt bf16 serving"] = timed("22", phase_bf16_rt_serving, dev, name,
                                     smi)

    # ---- 23-26. SipMask++ and SipMask-VIS in bf16: the bf16 K5 and K5c,
    # SipMask++ serving and training, VIS tracking and training
    kernel_phase("23", phase_bf16_pp_kernels)
    paths["sipmask++ bf16 serving"] = timed("24", phase_bf16_pp_serving, dev,
                                            name, smi)
    paths["sipmask++ bf16 training"] = timed("25", phase_bf16_pp_train, dev,
                                             name, smi)
    paths["vis bf16 serving"] = timed("26a", phase_vis_serving, dev, name,
                                      smi, True)
    paths["vis bf16 training"] = timed("26b", phase_bf16_vis_train, dev,
                                       name, smi)
    # ---- 27-29. ResNeXt-101 32x4d, HRNet-W32 with HRFPN, and the
    # SipMask-benchmark fork's loss
    paths.update(last_presets(dev, name, smi, timed))
    log("seconds by phase: " + ", ".join(f"{k} {v:.1f}"
                                         for k, v in seconds.items())
        + f"; total {time.perf_counter() - t_start:.1f} s")

    kernels = [{"name": k, "route": "cuda",
                "source": f"sipmask_tpu_torch/csrc/{src}",
                "replaces": replaces,
                "launches": sum(p[k] for p in paths.values()),
                "launches_by_path": {path: p[k] for path, p in paths.items()},
                "max_abs_err": errs[k], "ms": times[k][0],
                "plain_ms": times[k][1], "bound_ms": extra[k][0][0],
                "bound_by": extra[k][0][1], "library_ms": extra[k][1]}
               for k, (src, replaces) in KERNELS.items()]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
