#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port (``sipmask_tpu_torch``) on one
NVIDIA GPU:

    python3 chip_smoke.py

It drives the high-accuracy serving path, ``sipmask_r50_fpn_gn_1x`` at full
width with random weights from a seed, through the port's entry points:

1. finds the card (no CUDA is an error), prints ``nvidia-smi``'s name and
   power limit and the backend flags it sets (TF32 off: plain f32; cuDNN
   benchmark mode on, as for fixed serving shapes);
2. builds the kernels from ``sipmask_tpu_torch/csrc`` with nvcc;
3. holds each kernel against its plain PyTorch version at the slice's
   shapes, and times both at the batch-4 shapes;
4. answers 3 requests of one 800x1333 image through ``init_detector`` /
   ``inference_detector`` and runs one batch of 4 at 800x1344 twice through
   ``Detector.infer``, counting kernel launches;
5. runs the batch again with the plain versions and compares.

Any failure raises (non-zero exit, no result). The second-to-last line is a
JSON object of the kernels; the last is the device line.
"""

import contextlib
import json
import subprocess
import sys
import time

import numpy as np
import torch

SEED = 0
CONFIG = "sipmask_r50_fpn_gn_1x"
IMAGE_HW = (800, 1333)   # at the test scale: padded to 800x1344, no resize
BATCH = 4
LEVELS = [(100, 168), (50, 84), (25, 42), (13, 21), (7, 11)]  # 800x1344
CHANNELS, DEFORM_GROUPS, GN_GROUPS = 256, 4, 32
K1_TOL = 1e-5     # abs: the same four f32 products, FMA-fused in the kernel
K4_TOL = 1e-4     # abs: f32 sums over up to 134400 elements, reordered
HEAD_TOL = 1e-3   # relative to max |x|: the above through up to 9 layers
MATCH_MIN = 0.98  # share of detections the plain run must reproduce
REPLACES = {
    "deform_im2col": "sipmask_tpu/ops/pallas/deform_gather.py:465",
    "gn_relu": "sipmask_tpu/ops/pallas/group_norm.py:124",
}


def log(*args):
    print(*args, flush=True)


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
    times = {}
    for name, (kernel, plain) in runs.items():
        p1, k1, k2, p2 = (cuda_ms(plain), cuda_ms(kernel), cuda_ms(kernel),
                          cuda_ms(plain))
        times[name] = ((k1 + k2) / 2, (p1 + p2) / 2)
        log(f"time {name} bs{BATCH} all 5 levels: kernel {k1:.4f} / "
            f"{k2:.4f} ms, plain {p1:.4f} / {p2:.4f} ms")
    return {"deform_im2col": k1_err, "gn_relu": k4_err}, times


def bump_weights(model, gen):
    """Random non-zero conv_offset weights (a zero-init deformable conv is
    a plain 3x3 conv) and cls/reg bias bumps (at the focal prior every score
    is ~0.01, under score_thr, and no detection reaches NMS)."""
    head = model.bbox_head
    with torch.no_grad():
        w = head.feat_align.conv_offset.weight
        w.copy_(torch.randn(w.shape, generator=gen).to(w.device) * 0.5)
        head.fcos_cls.bias.fill_(-2.5)
        head.fcos_reg.bias.fill_(2.0)


@contextlib.contextmanager
def plain_kernels():
    """Swap the kernel wrappers for their plain versions at the call sites'
    module attributes."""
    from sipmask_tpu_torch.ops import deform_sample, gn_relu
    saved = deform_sample.deform_im2col, gn_relu.gn_relu
    deform_sample.deform_im2col = deform_sample.deform_im2col_plain
    gn_relu.gn_relu = gn_relu.gn_relu_plain
    try:
        yield
    finally:
        deform_sample.deform_im2col, gn_relu.gn_relu = saved


def run_batch(det, batch, capture):
    images, shapes, scales = batch
    capture.clear()
    out = det.infer(images, shapes, scales)
    torch.cuda.synchronize()
    return dict(capture), out


def check_finite(name, t):
    if not bool(torch.isfinite(t).all()):
        raise AssertionError(f"{name} has non-finite values")


def matched_share(a, b, i):
    """Share of run a's detections of image i that run b also has: same
    label, boxes within 0.01 px, scores within 1e-4."""
    va, vb = a["valid"][i], b["valid"][i]
    la, lb = a["labels"][i][va], b["labels"][i][vb]
    ba, bb = a["boxes"][i][va], b["boxes"][i][vb]
    sa, sb = a["scores"][i][va], b["scores"][i][vb]
    if len(la) == 0:
        return 1.0
    same = ((la[:, None] == lb[None]) &
            ((ba[:, None] - bb[None]).abs().amax(-1) <= 0.01) &
            ((sa[:, None] - sb[None]).abs() <= 1e-4))
    return float(same.any(1).float().mean())


def phase_serving(dev, name, smi):
    """Phases 4 and 5: the serving path with the kernels, then the same
    batch with the plain versions."""
    from sipmask_tpu_torch.apis.inference import (inference_detector,
                                                  init_detector, preprocess)
    from sipmask_tpu_torch.ops import deform_sample, gn_relu

    # ---- 4. the serving path
    gen = torch.Generator().manual_seed(SEED)
    det = init_detector(CONFIG, dev, seed=SEED)
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

    deform_sample.deform_im2col.launches = 0
    gn_relu.gn_relu.launches = 0
    for i in range(3):
        t0 = time.perf_counter()
        res = inference_detector(det, imgs[i])
        ms = (time.perf_counter() - t0) * 1e3
        n = len(res["labels"])
        log(f"request {i}: {IMAGE_HW} image -> {n} detections, masks "
            f"{res['masks'].shape}, {ms:.1f} ms wall on {name} ({smi})")
        if n == 0 or not np.isfinite(res["boxes"]).all():
            raise AssertionError(f"request {i}: no valid or finite result")
        if res["masks"].shape != (n, *IMAGE_HW):
            raise AssertionError(f"request {i}: masks {res['masks'].shape}")
    for _ in range(2):   # the first run is the first at the batch shapes
        t0 = time.perf_counter()
        head_k, dec_k = run_batch(det, batch, capture)
        ms = (time.perf_counter() - t0) * 1e3
        log(f"batch of {tuple(images.shape)} through Detector.infer: "
            f"{ms:.1f} ms wall on {name} ({smi})")
    launches = {"deform_im2col": deform_sample.deform_im2col.launches,
                "gn_relu": gn_relu.gn_relu.launches}
    log(f"kernel launches over the 3 requests and 2 batches: {launches}")
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel of the path never ran: {launches}")
    valid = dec_k["valid"].sum(1).tolist()
    log(f"valid detections per image of the batch: {valid}")
    if min(valid) <= 0:
        raise AssertionError("an image of the batch has no detection")
    for key, val in head_k.items():
        for j, t in enumerate(val if isinstance(val, list) else [val]):
            check_finite(f"{key}[{j}]", t)
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
    if (deform_sample.deform_im2col.launches != launches["deform_im2col"]
            or gn_relu.gn_relu.launches != launches["gn_relu"]):
        raise AssertionError("the plain run launched a kernel")
    worst = 0.0
    for key, val in head_k.items():
        vals = val if isinstance(val, list) else [val]
        pvals = head_p[key] if isinstance(val, list) else [head_p[key]]
        for a, b in zip(vals, pvals):
            worst = max(worst, errors(a, b)[1])
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

    return launches


def main():
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
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    # serving shapes are fixed: let cuDNN time its algorithms once per shape
    # (its untimed pick at batch 4, f32, is an FFT path about 8x slower)
    torch.backends.cudnn.benchmark = True
    log(f"torch {torch.__version__} cuda {torch.version.cuda}; "
        f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
        f"cuda.matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn.benchmark={torch.backends.cudnn.benchmark}")

    # ---- 2. build
    from sipmask_tpu_torch.ops import deform_sample, gn_relu, native
    t0 = time.perf_counter()
    deform_sample._lib()
    gn_relu._lib()
    build_s = time.perf_counter() - t0
    log(f"built kernels in {build_s:.1f} s")
    for kname, (secs, ptxas) in native.BUILD_LOG.items():
        lines = [ln for ln in ptxas.splitlines() if "registers" in ln
                 or "spill" in ln]
        log(f"  {kname}: nvcc {secs:.1f} s; " + " | ".join(
            ln.strip() for ln in lines))

    # ---- 3. kernels against their plain versions
    errs, times = phase_kernels(dev)

    # ---- 4 and 5. the serving path, with the kernels and then without
    launches = phase_serving(dev, name, smi)

    kernels = [{"name": k, "route": "cuda",
                "source": f"sipmask_tpu_torch/csrc/{k}.cu",
                "replaces": REPLACES[k], "launches": launches[k],
                "max_abs_err": errs[k], "ms": times[k][0],
                "plain_ms": times[k][1]} for k in REPLACES]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
