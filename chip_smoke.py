#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port (``sipmask_tpu_torch``) on one
NVIDIA GPU:

    python3 chip_smoke.py

It drives ``sipmask_r50_fpn_gn_1x`` at full width with random weights from a
seed through the port's entry points, serving and then training:

1. finds the card (no CUDA is an error), prints ``nvidia-smi``'s name and
   power limit and the backend flags it sets (TF32 off: plain f32; cuDNN
   benchmark mode on, as for fixed shapes);
2. builds the kernels from ``sipmask_tpu_torch/csrc`` with nvcc, one nvcc
   per source, all at once;
3. holds the serving kernels (K1, K4a) against their plain PyTorch versions
   at the slice's shapes, and times both at the batch-4 shapes;
4. answers 3 requests of one 800x1333 image through ``init_detector`` /
   ``inference_detector`` and runs one batch of 4 at 800x1344 twice through
   ``Detector.infer``, counting kernel launches;
5. runs the batch again with the plain versions and compares;
6. holds the training kernels (K2, K3a, K3b, K4b) against their plain
   versions at the train step's shapes, and times both at batch 4;
7. runs 3 SGD steps at 800x1344, batch 4, through ``create_train_state`` /
   ``make_train_step``, counting kernel launches, and checks the losses,
   the frozen stages and the gradients;
8. runs the first step again from the same weights with the plain versions
   and compares losses and gradients.

Any failure raises (non-zero exit, no result). The second-to-last line is a
JSON object of the kernels, with each kernel's launches in the train steps
of phase 7; the last is the device line.
"""

import contextlib
import json
import subprocess
import sys
import threading
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
# relative to each output's max |value|: K2's SIMT GEMMs sum 256 or B*P
# products in another order than cuBLAS and its dX atomics add in run-to-run
# order; K3 sums 32-term dots over up to 268800 pixels in another order than
# the plain matmuls; K4b sums up to 16800 elements per channel, reordered
TRAIN_KERNEL_TOL = 1e-5
LOSS_TOL = 1e-4   # relative: forward values differ by the kernels' rounding
# relative to each tensor's max |g|: the kernels' rounding through the
# backward of ~70 layers, and cuDNN's algorithm picks in the two runs
GRAD_TOL = 1e-3
MASK_HW, MAX_POS, MAX_GTS, TRAIN_STEPS = (400, 672), 512, 64, 3
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
}


def log(*args):
    print(*args, flush=True)


def wrappers():
    """The kernel wrappers by name; each carries its launch count."""
    from sipmask_tpu_torch.ops import deform_conv, deform_sample, gn_relu
    from sipmask_tpu_torch.ops import mask_loss
    return {"deform_im2col": deform_sample.deform_im2col,
            "deform_conv_backward": deform_conv.deform_conv_backward,
            "mask_bce_forward": mask_loss.mask_bce_forward,
            "mask_bce_backward": mask_loss.mask_bce_backward,
            "gn_relu": gn_relu.gn_relu,
            "gn_relu_backward": gn_relu.gn_relu_backward}


def reset_launches():
    for fn in wrappers().values():
        fn.launches = 0


def read_launches():
    return {k: fn.launches for k, fn in wrappers().items()}


def turns(name, plain, kernel, iters=20):
    """Mean CUDA-event ms of kernel and plain, in the order plain, kernel,
    kernel, plain (means of the two turns each)."""
    p1, k1, k2, p2 = (cuda_ms(plain, iters), cuda_ms(kernel, iters),
                      cuda_ms(kernel, iters), cuda_ms(plain, iters))
    log(f"time {name} bs{BATCH}: kernel {k1:.4f} / {k2:.4f} ms, plain "
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
    times = {name: turns(name + " all 5 levels", plain, kernel)
             for name, (kernel, plain) in runs.items()}
    return {"deform_im2col": k1_err, "gn_relu": k4_err}, times


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
    times["deform_conv_backward"] = turns(
        "K2 deform_conv_backward all 5 levels",
        lambda: [torch.autograd.grad(out, leaves, dy.reshape(out.shape),
                                     retain_graph=True)
                 for *_, dy, _c, leaves, out in k2_in],
        lambda: [deform_conv.deform_conv_backward(
            x, off, cols, w2, dy, (3, 3), 1, 1, 1, g)
            for x, off, w2, dy, cols, _, _o in k2_in], iters=10)
    del k2_in
    args, grad = k3_inputs(BATCH, gen, dev)

    def k3a_plain():
        with torch.no_grad():
            return mask_loss.mask_bce_loss_plain(*args)
    times["mask_bce_forward"] = turns(
        f"K3a mask_bce_forward {MASK_HW} K={MAX_POS}", k3a_plain,
        lambda: mask_loss.mask_bce_forward(*args), iters=5)
    leaves = [t.detach().requires_grad_(True) for t in args[:2]]
    pre_p = mask_loss.mask_bce_loss_plain(*leaves, *args[2:])
    times["mask_bce_backward"] = turns(
        f"K3b mask_bce_backward {MASK_HW} K={MAX_POS}",
        lambda: torch.autograd.grad(pre_p, leaves, grad, retain_graph=True),
        lambda: mask_loss.mask_bce_backward(*args, grad), iters=5)
    del args, grad, leaves, pre_p
    k4_in = []
    for h, w in LEVELS:
        x = torch.randn((BATCH, CHANNELS, h, w), generator=gen).to(dev)
        dy = torch.randn((BATCH, CHANNELS, h, w), generator=gen).to(dev)
        wt = torch.ones(CHANNELS, device=dev)
        bs = torch.zeros(CHANNELS, device=dev)
        _, stats = gn_relu.gn_relu_forward(x, wt, bs, GN_GROUPS)
        k4_in.append((x, wt, bs, stats, dy))
    times["gn_relu_backward"] = turns(
        "K4b gn_relu_backward all 5 levels",
        lambda: [gn_relu.gn_relu_backward_plain(*a, GN_GROUPS, True)
                 for a in k4_in],
        lambda: [gn_relu.gn_relu_backward(*a, GN_GROUPS, True)
                 for a in k4_in])
    del k4_in
    torch.cuda.empty_cache()
    return errs, times


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


def phase_train(dev, name, smi):
    """Phases 7 and 8: TRAIN_STEPS SGD steps with the kernels, then the
    first step again from the same weights with the plain versions."""
    from sipmask_tpu_torch.config import get_config
    from sipmask_tpu_torch.train import create_train_state, make_train_step
    from sipmask_tpu_torch.utils.demo_inputs import bump_weights, train_batch

    cfg = get_config(CONFIG)
    if (cfg.train.max_pos, cfg.data.max_gts, cfg.train.imgs_per_device) != (
            MAX_POS, MAX_GTS, BATCH):
        raise AssertionError("the preset's max_pos, max_gts or batch moved")
    # ---- 7. the train step
    state = create_train_state(cfg, dev, seed=SEED)
    bump_weights(state.model, torch.Generator().manual_seed(SEED))
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
        vals, _ = run_step(step, batch, f"train step {i}", name, smi)
        losses.append(vals)
        if i == 0:
            first_grads = {n: p.grad.detach().clone()
                           for n, p in params.items() if p.requires_grad}
        peaks.append(torch.cuda.max_memory_allocated() / 2 ** 30)
        torch.cuda.reset_peak_memory_stats()
    launches = read_launches()
    log(f"kernel launches over the {TRAIN_STEPS} train steps: {launches}")
    log("peak device memory per train step (torch.cuda.max_memory_allocated;"
        " step 0 holds cuDNN's algorithm search): " + ", ".join(
            f"{p:.2f} GiB" for p in peaks))
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel of the train path never ran: "
                             f"{launches}")
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
    log("train checks passed: finite losses, loss_mask > 0, frozen stages "
        "unchanged, finite gradients everywhere")
    del state, step, params
    torch.cuda.empty_cache()

    # ---- 8. the first step again with the plain versions
    state = create_train_state(cfg, dev, state_dict=init)
    step = make_train_step(state, cfg)
    with plain_kernels():
        vals, _ = run_step(step, batch, "plain train step 0", name, smi)
    if read_launches() != launches:
        raise AssertionError("the plain train step launched a kernel")
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
    call sites' module attributes: the deformable conv (K1 + K2), GroupNorm
    (K4a + K4b) and the mask loss (K3a + K3b)."""
    from sipmask_tpu_torch.ops import deform_conv, gn_relu, mask_loss
    saved = (deform_conv.deform_conv2d, gn_relu.gn_relu,
             mask_loss.mask_bce_loss)
    deform_conv.deform_conv2d = deform_conv.deform_conv2d_plain
    gn_relu.gn_relu = gn_relu.gn_relu_plain
    mask_loss.mask_bce_loss = mask_loss.mask_bce_loss_plain
    try:
        yield
    finally:
        (deform_conv.deform_conv2d, gn_relu.gn_relu,
         mask_loss.mask_bce_loss) = saved


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
    from sipmask_tpu_torch.utils.demo_inputs import bump_weights

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

    reset_launches()
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
    launches = read_launches()
    log(f"kernel launches over the 3 requests and 2 batches: {launches}")
    if min(launches["deform_im2col"], launches["gn_relu"]) <= 0:
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
    if read_launches() != launches:
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

    # ---- 2. build: one nvcc per source, all at once
    from sipmask_tpu_torch.ops import native
    t0 = time.perf_counter()
    failed = []

    def build(src):
        try:
            native.load(src)
        except Exception as exc:   # reported and raised below
            failed.append((src, exc))
    threads = [threading.Thread(target=build, args=(src,)) for src in
               sorted({src[:-3] for src, _ in KERNELS.values()})]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if failed:
        raise RuntimeError(f"kernel builds failed: {failed}")
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
    phase_serving(dev, name, smi)

    # ---- 6. the training kernels against their plain versions
    train_errs, train_times = phase_train_kernels(dev)
    errs.update(train_errs)
    times.update(train_times)

    # ---- 7 and 8. the train step, with the kernels and then without
    launches = phase_train(dev, name, smi)

    kernels = [{"name": k, "route": "cuda",
                "source": f"sipmask_tpu_torch/csrc/{src}",
                "replaces": replaces, "launches": launches[k],
                "max_abs_err": errs[k], "ms": times[k][0],
                "plain_ms": times[k][1]}
               for k, (src, replaces) in KERNELS.items()]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
