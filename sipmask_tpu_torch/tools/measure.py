"""Times of the port on one CUDA card, the numbers behind ``PERF.md``:

    python -m sipmask_tpu_torch.tools.measure serve k4a k4b train
    python -m sipmask_tpu_torch.tools.measure k1 --dtype float32 bfloat16
    python -m sipmask_tpu_torch.tools.measure --config \
        sipmaskpp_r101_fpn_ssd_6x serve k5c train
    python -m sipmask_tpu_torch.tools.measure serve train \
        --dtype float32 bfloat16
    python -m sipmask_tpu_torch.tools.measure --config sipmask_vis_r50 \
        video train --dtype float32 bfloat16

from the root of the checkout, with any of the nine modes, in the order
given:

- ``serve``: wall ms of single requests (800x1333; 544x544 for the
  fixed-size presets) through ``inference_detector`` and of batches of
  ``imgs_per_device`` (4; 8) through ``Detector.infer``, each ending in a
  synchronise, then a ``torch.profiler`` trace of two batches: kernel time
  by owner (and the copy kernels' share of it) and the device's idle
  share;
- ``k1``: the deformable im2col (K1, ``deform_im2col``) over FeatureAlign's
  five levels at batch 4 (256 channels, 4 deformable groups; offsets ~2
  px, a third of the pixels +-300 px out), in each ``--dtype`` (bf16 x and
  cols, f32 offsets): CUDA-event ms of the sweep, the host's enqueue time
  of a sweep (and of a call), and the device time of its kernels in a
  ``torch.profiler`` trace, by level and kernel, with the device kernels a
  call;
- ``k4a``: the GroupNorm+ReLU forward (K4a) over one GN site of each of the
  five levels at batch 4, as in serving (no gradient), in each ``--dtype``:
  CUDA-event ms of the sweep, the host's enqueue time of a sweep (and of a
  call), and the device time of its
  kernels in a ``torch.profiler`` trace, also by level; first through
  ``gn_relu`` (the model's entry point), then through the bare launcher
  ``gn_relu_forward`` with and without the saved statistics;
- ``k4b``: the GroupNorm+ReLU backward (K4b, ``gn_relu_backward``) over one
  GN site of each of the five levels at batch 4, in each ``--dtype``:
  CUDA-event ms of the sweep, the host's enqueue time of a sweep (and of
  one call), and the device time and count of its kernels in a
  ``torch.profiler`` trace, also by level and kernel, so that its device
  time and its host time can be read apart;
- ``k5c``: the row-sampling backward (K5c, ``deform_rows_backward``) over
  the SipMask++ train step's three DCN convs (one of each R101 stage at
  576x576, batch 8: offsets ~2 px, a third of the pixels +-300 px out), in
  each ``--dtype`` (bf16 rows and cotangents, f32 positions): CUDA-event
  ms of the sweep, the host's enqueue time of a sweep, and the device time
  of its kernels in a ``torch.profiler`` trace, by kernel and by conv,
  with the device kernels a call (the zeroing of dx included);
- ``k5``: the row sampling (K5, ``deform_rows``) over the same convs, the
  same way;
- ``forward``: one image at batch 1: wall ms of a request, of
  ``Detector.infer`` and of the model's forward, the host's enqueue time
  of a forward, its device time and kernel count, and its ops by host
  time (where a batch of 1 spends its time);
- ``video`` (a tracking preset, SipMask-VIS): an in-memory video of 8
  frames of 720x1280 (``chip_smoke.py`` phase 16's four moving shapes)
  through ``run_video_inference``
  at batch 1 a frame, tracked twice: ms a frame by section (``model`` with
  the decode and the embeddings, ``track``, ``paste`` with the RLEs),
  median over the frames of the second pass, with its peak memory; then a
  ``torch.profiler`` trace of a third pass: kernel time a frame by owner
  and the device's idle share;
- ``train``: warm train steps at the preset's training shapes (800x1344,
  batch 4; 576x576, batch 8; VIS: 384x640, batch 4, with reference
  frames) (median), their sections (forward, loss, backward, optimizer),
  the peak memory, and a ``torch.profiler`` trace of two steps: kernel
  time by owner (and the copy kernels' share of it) and the device's idle
  share of the wall.

``--config`` names the preset, ``sipmask_r50_fpn_gn_1x`` by default; full
width, random weights from seed 0, bumped as ``chip_smoke.py`` bumps them
(and, for a norm-free head, frozen BN calibrated on the batch); TF32 off,
bf16 products summed in f32 (no reduced-precision reductions) and cuDNN's
benchmark mode on. ``--dtype`` gives the model's ``compute_dtype`` for
``serve``, ``forward``, ``video`` and ``train``, and the element type of
``k1``, ``k4a``, ``k4b``, ``k5`` and ``k5c``, float32 by default; with several,
each mode runs once for each, in the order given (give it after the
modes). Each profile also gives the share of
the layout transposes around cuDNN's channels-last kernels (kernel names
holding ``nchwToNhwc``, ``nhwcToNchw`` or ``transpose``). The first line
is the card's name and power limit.
"""

from __future__ import annotations

import argparse
import re
import statistics
import subprocess
import time

import numpy as np
import torch

CONFIG = "sipmask_r50_fpn_gn_1x"
SEED = 0
BATCH = 4   # k4a: the hi-acc serving batch
LEVELS = [(100, 168), (50, 84), (25, 42), (13, 21), (7, 11)]  # 800x1344
# k5, k5c: SipMask++'s DCN conv2 of each R101 stage at 576x576, (Cg, h, w)
PP_DCN_TRAIN = [(128, 72, 72), (256, 36, 36), (512, 18, 18)]
PP_BATCH = 8
# video: chip_smoke.py phase 16's video, 8 frames of 720x1280
VIDEO_FRAMES, VIDEO_HW = 8, (720, 1280)


def log(*args):
    print(*args, flush=True)


def wall_ms(fn):
    """Host-clock ms of fn(), from a synchronised start to a synchronise."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def report(name, ms):
    log(f"{name}: median {statistics.median(ms):.2f} ms, min {min(ms):.2f}, "
        f"max {max(ms):.2f} over {len(ms)}: "
        + ", ".join(f"{m:.2f}" for m in ms))


def kernel_events(prof):
    from torch.autograd import DeviceType
    return [e for e in prof.events() if e.device_type == DeviceType.CUDA
            and "spin_kernel" not in e.name]


def profile_kernels(fn, iters):
    """Device-kernel events of iters calls of fn() in one ``torch.profiler``
    session, after a marker kernel: the first kernel of a session can go
    unrecorded in the card's sandbox."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return kernel_events(prof)


def prepare(model, cfg, images, training=False):
    """Seed-0 weights that detect, as ``chip_smoke.py`` makes them."""
    from ..utils.demo_inputs import bump_weights, calibrate_frozen_bn
    bump_weights(model, torch.Generator().manual_seed(SEED), training)
    if cfg.model.head.norm is None:
        calibrate_frozen_bn(model.backbone, images)


def preset(config, dtype):
    """The preset ``config`` with ``model.compute_dtype`` = ``dtype``."""
    from ..config import _r, get_config
    return _r(get_config(config), "model", compute_dtype=dtype)


def serve(dev, reps, config, dtype="float32"):
    from torch.profiler import ProfilerActivity, profile

    from ..apis.inference import inference_detector, init_detector, preprocess

    det = init_detector(preset(config, dtype), dev, seed=SEED)
    log(f"serve {config}, compute_dtype {dtype}")
    batch = det.cfg.train.imgs_per_device
    d = det.cfg.data
    image_hw = d.fixed_size or (min(d.img_scale), max(d.img_scale))
    rng = np.random.RandomState(SEED)
    imgs = [(rng.rand(*image_hw, 3) * 255).astype(np.uint8)
            for _ in range(batch)]
    prepped = [preprocess(im, det.cfg) for im in imgs]
    images = torch.stack([torch.from_numpy(p[0]).permute(2, 0, 1)
                          for p in prepped]).to(dev)
    shapes = torch.from_numpy(np.stack([p[1] for p in prepped]))
    scales = torch.from_numpy(np.stack([p[2] for p in prepped]))
    prepare(det.model, det.cfg, images)
    for im in imgs[:2]:   # cuDNN times its algorithms at the first shape
        inference_detector(det, im)
    report(f"request (bs 1, {image_hw}, inference_detector)",
           [wall_ms(lambda: inference_detector(det, imgs[i % batch]))
            for i in range(reps)])
    for _ in range(2):
        det.infer(images, shapes, scales)
    torch.cuda.reset_peak_memory_stats()
    report(f"batch of {batch} (Detector.infer)",
           [wall_ms(lambda: det.infer(images, shapes, scales))
            for _ in range(reps)])
    log(f"peak memory of the batches: "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall = wall_ms(lambda: [det.infer(images, shapes, scales)
                                for _ in range(2)])
    owners(prof, wall, "batch")


def forward(dev, reps, config, dtype="float32"):
    """One image (batch 1): wall ms of a request, of ``Detector.infer`` and
    of the model's forward, the host's enqueue time of a forward, and one
    forward's device time and kernels, with its ops by host time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from ..apis.inference import inference_detector, init_detector, preprocess

    det = init_detector(preset(config, dtype), dev, seed=SEED)
    d = det.cfg.data
    image_hw = d.fixed_size or (min(d.img_scale), max(d.img_scale))
    img = (np.random.RandomState(SEED).rand(*image_hw, 3) * 255).astype(
        np.uint8)
    im, shape, scale = preprocess(img, det.cfg)
    x = torch.from_numpy(im).permute(2, 0, 1)[None].contiguous().to(dev)
    shapes, scales = torch.from_numpy(shape[None]), torch.from_numpy(
        scale[None])
    prepare(det.model, det.cfg, x)
    for _ in range(3):   # cuDNN times its algorithms at the first shape
        inference_detector(det, img)
    with torch.no_grad():
        fwd = [wall_ms(lambda: det.model(x)) for _ in range(reps)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        det.model(x)
        enqueue = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
    log(f"forward {config}, compute_dtype {dtype}, bs 1 {image_hw}")
    report("request (inference_detector)",
           [wall_ms(lambda: inference_detector(det, img))
            for _ in range(reps)])
    report("Detector.infer", [wall_ms(lambda: det.infer(x, shapes, scales))
                              for _ in range(reps)])
    report("model forward", fwd)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with torch.no_grad():
            det.model(x)
        torch.cuda.synchronize()
    kern = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    log(f"one forward: host enqueue {enqueue:.2f} ms, device "
        f"{sum(e.device_time for e in kern) / 1e3:.2f} ms in {len(kern)} "
        f"kernels")
    ops = sorted((k for k in prof.key_averages()
                  if k.key.startswith(("aten::", "cudnn"))),
                 key=lambda k: -k.self_cpu_time_total)[:8]
    log("  ops by host time: " + "; ".join(
        f"{k.key} x{k.count} {k.self_cpu_time_total / 1e3:.2f} ms"
        for k in ops))


def k4a(dev, dtype="float32", iters=20):
    from ..ops import gn_relu

    gen = torch.Generator().manual_seed(SEED)
    xs = [torch.randn((BATCH, 256, h, w), generator=gen).to(dev).to(
        getattr(torch, dtype)) for h, w in LEVELS]
    wt = torch.ones(256, device=dev)
    bs = torch.zeros(256, device=dev)
    ways = {
        "gn_relu (no gradient, no statistics kept)":
            lambda x: gn_relu.gn_relu(x, wt, bs, 32),
        "gn_relu_forward, keep_stats=False":
            lambda x: gn_relu.gn_relu_forward(x, wt, bs, 32,
                                              keep_stats=False),
        "gn_relu_forward, keep_stats=True":
            lambda x: gn_relu.gn_relu_forward(x, wt, bs, 32),
    }
    sweeps = {name: (lambda fn=fn: [fn(x) for x in xs])
              for name, fn in ways.items()}
    timed = {name: [] for name in ways}
    with torch.no_grad():
        # every way twice, in the order A B C C B A, before the first
        # profiler session, so that no trace runs ahead of a timing
        for name in list(ways) + list(ways)[::-1]:
            timed[name].append(event_and_host_ms(sweeps[name], iters))
        for name, sweep in sweeps.items():
            device = sum(e.device_time for e in profile_kernels(sweep, iters)
                         ) / 1e3 / iters
            (e1, h1), (e2, h2) = timed[name]
            log(f"K4a {dtype} {name}, 5 levels bs{BATCH}, ms per sweep: "
                f"CUDA events {e1:.4f} / {e2:.4f}, host enqueue {h1:.4f} / "
                f"{h2:.4f} ({(h1 + h2) / 2 / len(LEVELS) * 1e3:.1f} us a "
                f"call), kernels {device:.4f}")
        by_call(profile_kernels(sweeps[name], iters), iters,
                [f"{h}x{w}" for h, w in LEVELS])


def k1(dev, dtype="float32", iters=20):
    from ..ops import deform_sample

    gen = torch.Generator().manual_seed(SEED)
    args = []
    for h, w in LEVELS:
        x = torch.randn((BATCH, 256, h, w), generator=gen).to(dev)
        off = torch.randn((BATCH, 72, h, w), generator=gen) * 2.0
        off.view(BATCH, 72, h * w)[:, :, : (h * w) // 3] *= 150.0
        args.append((x.to(getattr(torch, dtype)), off.to(dev)))

    def sweep():
        return [deform_sample.deform_im2col(x, off, (3, 3), 1, 1, 1, 4)
                for x, off in args]
    with torch.no_grad():
        (e1, h1), (e2, h2) = (event_and_host_ms(sweep, iters)
                              for _ in range(2))
        kern = profile_kernels(sweep, iters)
    calls = iters * len(LEVELS)
    log(f"K1 {dtype} deform_im2col, 5 levels bs{BATCH}, ms per sweep: CUDA "
        f"events {e1:.4f} / {e2:.4f}, host enqueue {h1:.4f} / {h2:.4f} "
        f"({(h1 + h2) / 2 / len(LEVELS) * 1e3:.1f} us a call), kernels "
        f"{sum(e.device_time for e in kern) / 1e3 / iters:.4f} "
        f"({len(kern) / calls:g} device kernels a call)")
    by_call(kern, iters, [f"{h}x{w}" for h, w in LEVELS])


def k4b(dev, dtype="float32", iters=20):
    from ..ops import gn_relu

    gen = torch.Generator().manual_seed(SEED)
    wt = torch.ones(256, device=dev)
    bs = torch.zeros(256, device=dev)
    elem = getattr(torch, dtype)
    args = []
    for h, w in LEVELS:
        x = torch.randn((BATCH, 256, h, w), generator=gen).to(dev).to(elem)
        dy = torch.randn((BATCH, 256, h, w), generator=gen).to(dev).to(elem)
        _, stats = gn_relu.gn_relu_forward(x, wt, bs, 32)
        args.append((x, wt, bs, stats, dy))

    def sweep():
        return [gn_relu.gn_relu_backward(*a, 32, True) for a in args]
    (e1, h1), (e2, h2) = (event_and_host_ms(sweep, iters) for _ in range(2))
    kern = profile_kernels(sweep, iters)
    device = sum(e.device_time for e in kern) / 1e3 / iters
    calls = iters * len(LEVELS)
    log(f"K4b {dtype} gn_relu_backward (act), 5 levels bs{BATCH}, ms per "
        f"sweep: CUDA events {e1:.4f} / {e2:.4f}, host enqueue {h1:.4f} / "
        f"{h2:.4f} ({(h1 + h2) / 2 / len(LEVELS) * 1e3:.1f} us a call), "
        f"kernels {device:.4f} ({len(kern) / calls:g} device kernels a "
        f"call)")
    by_call(kern, iters, [f"{h}x{w}" for h, w in LEVELS])


def k5_k5c(dev, dtype, backward, iters=20):
    """``k5`` (``backward`` False) and ``k5c`` in ``dtype``."""
    from ..ops import deform_sample as ds

    gen = torch.Generator().manual_seed(SEED)
    elem = getattr(torch, dtype)
    args = []
    for c, h, w in PP_DCN_TRAIN:
        x = torch.randn((PP_BATCH, h * w, c), generator=gen).to(dev)
        off = torch.randn((PP_BATCH, 18, h, w), generator=gen) * 2.0
        off.view(PP_BATCH, 18, h * w)[:, :, : (h * w) // 3] *= 150.0
        pyx = ds.positions(off.to(dev), 3, 3, 1, 1, 1, 1).contiguous()
        g = torch.randn((PP_BATCH, h * w, 9, c), generator=gen).to(dev)
        args.append((x.to(elem), pyx, g.to(elem), h, w))

    if backward:
        name = "K5c deform_rows_backward"

        def sweep():
            return [ds.deform_rows_backward(*a) for a in args]
    else:
        name = "K5 deform_rows"

        def sweep():
            return [ds.deform_rows(x, pyx, h, w) for x, pyx, _, h, w in args]
    (e1, h1), (e2, h2) = (event_and_host_ms(sweep, iters) for _ in range(2))
    kern = profile_kernels(sweep, iters)
    log(f"{name} {dtype}, 3 DCN convs at 576x576 bs{PP_BATCH}, ms per "
        f"sweep: CUDA events {e1:.4f} / {e2:.4f}, host enqueue "
        f"{h1:.4f} / {h2:.4f}, kernels "
        f"{sum(e.device_time for e in kern) / 1e3 / iters:.4f} "
        f"({len(kern) / (iters * len(args)):g} device kernels a call)")
    by_call(kern, iters, [f"Cg={c} {h}x{w}" for c, h, w in PP_DCN_TRAIN])


def by_call(kern, iters, calls):
    """Log the device ms of each kernel of each call of a sweep, from the
    kernels of ``iters`` sweeps in launch order."""
    kern = sorted(kern, key=lambda e: e.time_range.start)
    per = len(kern) // (iters * len(calls))
    if per * iters * len(calls) != len(kern):
        log(f"  ({len(kern)} kernels are not {iters} sweeps of "
            f"{len(calls)} calls: no split by call)")
        return
    for i, call in enumerate(calls):
        parts = {}
        for s in range(iters):
            for e in kern[(s * len(calls) + i) * per:][:per]:
                parts[e.name] = parts.get(e.name, 0.0) + e.device_time
        log(f"  {call}: " + "; ".join(
            f"{kernel_name(name)} {t / 1e3 / iters:.4f}"
            for name, t in parts.items()))


def kernel_name(name):
    """A device kernel's name without its namespace and arguments."""
    m = re.search(r"([A-Za-z_]\w*)(<[^(]*>)?\(", name)
    return (m.group(1) + (m.group(2) or ""))[:50] if m else name[:50]


def event_and_host_ms(sweep, iters):
    """(CUDA-event ms, host enqueue ms) per sweep() over iters sweeps. The
    queue holds the launches of all iters sweeps, so the host never waits
    for the card inside the loop."""
    for _ in range(3):
        sweep()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(iters):
        sweep()
    end.record()
    host = (time.perf_counter() - t0) * 1e3 / iters
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters, host


# kernel-name fragments of the port's kernels -> their ids
OWNERS = {"deform_im2col": "K1", "deform_bwd": "K2", "fold_partials": "K2",
          "deform_col2im": "K2", "pad_rows": "K2",
          "mask_bce_fwd_tiles": "K3a",
          "mask_bce_fold_tiles": "K3a", "mask_bce_dbasis_tiles": "K3b",
          "mask_bce_dcofs_tiles": "K3b", "mask_bce_fold_dcofs": "K3b",
          "gn_stats": "K4a", "gn_apply": "K4a", "gn_fwd_cluster": "K4a",
          "gn_bwd": "K4b",
          "deform_rows_fwd": "K5", "deform_rows_bwd": "K5c",
          "assemble_masks": "K6"}
CUDNN = ("cudnn", "xmma", "convolve", "winograd", "implicit", "dgrad",
         "wgrad", "gemm")
LAYOUT = ("nchwToNhwc", "nhwcToNchw", "transpose")


def busy_ms(kern):
    """ms during which at least one of the kernel events ``kern`` ran: the
    union of their device intervals. cuDNN runs the kernels of some
    grouped convolutions (ResNeXt's) side by side, so their summed times
    can exceed the wall."""
    total, start, end = 0.0, None, None
    for s, e in sorted((k.time_range.start, k.time_range.end)
                       for k in kern):
        if end is None or s > end:
            total += 0.0 if end is None else end - start
            start, end = s, e
        else:
            end = max(end, e)
    return (total + (0.0 if end is None else end - start)) / 1e3


def owners(prof, wall, unit):
    """Log the device's idle share over the profiled two ``unit``s (from
    the time some kernel ran, :func:`busy_ms`) and the kernel time per
    ``unit`` by owner and by kernel name."""
    kern = kernel_events(prof)
    busy = sum(e.device_time for e in kern) / 1e3
    log(f"profiled 2 x {unit}: wall {wall:.1f} ms, kernel time {busy:.1f} "
        f"ms, device busy {busy_ms(kern):.1f} ms, device idle share "
        f"{1 - busy_ms(kern) / wall:.3f}")
    by_name, by_owner = {}, {}
    for e in kern:
        t, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (t + e.device_time / 2e3, n + 1)
        owner = next((v for k, v in OWNERS.items() if k in e.name), None)
        if owner is None:
            owner = ("cuDNN/cuBLAS convolutions and GEMMs"
                     if any(k in e.name for k in CUDNN)
                     else "other PyTorch kernels")
        o_ms, o_n = by_owner.get(owner, (0.0, 0))
        by_owner[owner] = (o_ms + e.device_time / 2e3, o_n + 1)
    log(f"kernel ms (launches) per {unit} by owner: " + ", ".join(
        f"{k} {ms:.3f} ({n // 2})" for k, (ms, n) in sorted(
            by_owner.items(), key=lambda kv: -kv[1][0])))
    copies = [e for e in kern if "copy" in e.name.lower()]
    log(f"  of which copies (kernel names holding 'copy': permutes made "
        f"contiguous, stacks, casts): "
        f"{sum(e.device_time for e in copies) / 2e3:.3f} ms "
        f"({len(copies) // 2}) per {unit}")
    layout = [e for e in kern if any(k in e.name for k in LAYOUT)
              and not any(k in e.name for k in OWNERS)]
    log(f"  layout transposes (kernel names holding "
        f"{' or '.join(LAYOUT)}): "
        f"{sum(e.device_time for e in layout) / 2e3:.3f} ms "
        f"({len(layout) // 2}) per {unit}, "
        f"{sum(e.device_time for e in layout) / max(busy * 1e3, 1e-9):.3f} "
        f"of the kernel time")
    for name, (ms, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0]
                                )[:20]:
        log(f"  {ms:9.3f} ms/{unit} {n // 2:5d} launches/{unit}  "
            f"{name[:100]}")


def video(dev, reps, config, dtype="float32"):
    """A tracking preset's video: ms a frame by section, peak memory, and
    a profiled pass's kernel time a frame by owner and idle share."""
    from torch.profiler import ProfilerActivity, profile

    from ..apis.inference import init_detector
    from ..apis.test_video import run_video_inference
    from ..utils.demo_inputs import (MemoryVideo, bump_weights,
                                     moving_shapes_video)

    det = init_detector(preset(config, dtype), dev, seed=SEED)
    if not det.cfg.model.head.track:
        raise SystemExit(f"video: {config} does not track")
    log(f"video {config}, compute_dtype {dtype}, {VIDEO_FRAMES} frames "
        f"{VIDEO_HW}")
    bump_weights(det.model, torch.Generator().manual_seed(SEED))
    clip = MemoryVideo(moving_shapes_video(VIDEO_FRAMES, *VIDEO_HW, SEED))
    run_video_inference(det, clip, progress=False)   # cuDNN's search
    torch.cuda.reset_peak_memory_stats()
    timings = {}
    run_video_inference(det, clip, progress=False, timings=timings)
    for section, ms in timings.items():
        report(f"{section} ms a frame", ms)
    log(f"peak memory of the video: "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall = wall_ms(lambda: run_video_inference(det, clip,
                                                   progress=False))
    owners(prof, wall, f"video of {VIDEO_FRAMES} frames")


def train(dev, reps, config, dtype="float32"):
    from torch.profiler import ProfilerActivity, profile

    from ..models.loss import compute_losses
    from ..train import create_train_state, make_train_step
    from ..utils.demo_inputs import train_batch_for, vis_pair_batch

    cfg = preset(config, dtype)
    log(f"train {config}, compute_dtype {dtype}")
    state = create_train_state(cfg, dev, seed=SEED)
    track = cfg.model.head.track
    if track:   # current and reference frames at the preset's bucket
        d = cfg.data
        h, w = (-(-min(d.img_scale) // d.size_divisor) * d.size_divisor,
                -(-max(d.img_scale) // d.size_divisor) * d.size_divisor)
        batch = vis_pair_batch(cfg.train.imgs_per_device, h, w, d.max_gts,
                               cfg.model.head.num_classes, SEED, dev)
    else:
        batch = train_batch_for(cfg, SEED, dev)
    prepare(state.model, cfg, batch["images"], training=True)
    rescore = state.model.rescore if cfg.model.head.rescoring else None
    log(f"train batch {tuple(batch['images'].shape)}")
    step = make_train_step(state, cfg)
    log(f"train step 0 (cuDNN's algorithm search): "
        f"{wall_ms(lambda: step(batch)):.1f} ms")
    for _ in range(2):
        step(batch)
    torch.cuda.reset_peak_memory_stats()
    report(f"train step (bs {cfg.train.imgs_per_device}, warm)",
           [wall_ms(lambda: step(batch)) for _ in range(reps)])
    log(f"peak memory of the warm steps: "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")

    def sections():
        out, t = {}, time.perf_counter
        torch.cuda.synchronize()
        t0 = t()
        heads = state.model(batch["images"],
                            batch["ref_images"] if track else None)
        torch.cuda.synchronize()
        out["forward"] = t() - t0
        t0 = t()
        total = sum(compute_losses(heads, batch, cfg.model.head,
                                   max_pos=cfg.train.max_pos,
                                   rescore_fn=rescore).values())
        torch.cuda.synchronize()
        out["loss"] = t() - t0
        state.optimizer.zero_grad(set_to_none=True)
        t0 = t()
        total.backward()
        torch.cuda.synchronize()
        out["backward"] = t() - t0
        t0 = t()
        state.optimizer.step()
        torch.cuda.synchronize()
        out["optimizer"] = t() - t0
        return out
    secs = [sections() for _ in range(reps)]
    log("sections, median ms: " + ", ".join(
        f"{k} {statistics.median(s[k] for s in secs) * 1e3:.2f}"
        for k in secs[0]))

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall = wall_ms(lambda: [step(batch) for _ in range(2)])
    owners(prof, wall, "step")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("modes", nargs="+",
                    choices=("serve", "forward", "k1", "k4a", "k4b", "k5",
                             "k5c", "video", "train"))
    ap.add_argument("--config", default=CONFIG,
                    help="the preset to measure")
    ap.add_argument("--reps", type=int, default=7,
                    help="timed repetitions of a request, batch or step")
    ap.add_argument("--dtype", nargs="+", default=["float32"],
                    choices=("float32", "bfloat16"),
                    help="compute_dtype of serve, forward, video and "
                         "train, and the element type of k1, k4a, k4b, k5 "
                         "and k5c, each in turn")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("measure: no CUDA device")
    log(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60, check=True).stdout.strip())
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    torch.backends.cudnn.benchmark = True
    dev = torch.device("cuda", 0)
    for mode in args.modes:
        for dtype in args.dtype:
            if mode in ("k1", "k4a", "k4b"):
                {"k1": k1, "k4a": k4a, "k4b": k4b}[mode](dev, dtype)
                continue
            if mode in ("k5", "k5c"):
                k5_k5c(dev, dtype, mode == "k5c")
                continue
            {"serve": serve, "forward": forward, "video": video,
             "train": train}[mode](
                dev, args.reps, args.config, dtype)


if __name__ == "__main__":
    main()
