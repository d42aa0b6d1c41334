"""Batched serving in a closed loop: one caller submits a batch to
``Detector.infer`` (the model, the decode, the masks and, for SipMask++,
the mask scores) and waits for it before it sends the next.

Set-up makes the pool's original images from the seed, runs each through
the program's ``preprocess``, and builds the detector with the
benchmark's weights. The window cycles through the pool. A batch's time
is from the call to the end of its last device operation, read from CUDA
events (the device waits for the host in a closed loop, so an event
recorded at the call marks it). The outputs of three pool batches drawn
from the seed are kept as the timed path produced them, with the head's
outputs of the same calls (a forward hook on the model): the reference's
forward on the same images is held against the head's outputs, and the
reference's decode of the program's head outputs against what the
program decoded.

Traffic file keys: ``kind`` 'serve_closed', ``batch``, ``size`` [H, W]
(the padded input the preprocessing gives), ``pool``, ``original_sizes``
(one batch's list of [h, w]), ``warm``, ``trace`` (batches profiled),
``syncs`` (batches in sync-debug mode), ``instances``.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from .. import compare, flops, harness, inputs, program, roofline
from .. import device as devmod
from ..reference import decode as ref_decode
from ..reference import model as ref_model

SAMPLES = 3


def _pool(r, pcfg, traffic):
    """[(images (B, 3, H, W), img_shapes (B, 2), scale_factors (B, 4))] on
    the device."""
    out = []
    for batch in inputs.serve_originals(traffic, r.seed, r.device):
        prepped = [program.preprocess(img, pcfg) for img in batch]
        images = np.stack([p[0] for p in prepped])
        if tuple(images.shape[1:3]) != tuple(traffic["size"]):
            raise ValueError(f"preprocess gave {images.shape[1:3]}, the "
                             f"traffic says {traffic['size']}")
        out.append(tuple(torch.from_numpy(np.ascontiguousarray(a)).to(
            r.device) for a in (images.transpose(0, 3, 1, 2), np.stack(
                [p[1] for p in prepped]), np.stack([p[2] for p in prepped]))))
    return out


def _reference(cfg, weights, dev):
    net = ref_model.build(cfg["model"], dev)
    net.load_state_dict(weights)
    return net.eval()


def run(r: harness.Run):
    cell, cfg, traffic = r.cell, r.cell.config, r.cell.traffic
    head, test = cfg["model"]["head"], cfg["model"]["test"]
    dev = r.device
    pcfg = program.preset(cfg)
    program.load()
    r.mark("program imported")
    traffic = dict(traffic, pool=r.pool or traffic["pool"])
    pool = _pool(r, pcfg, traffic)
    r.mark("pool")
    weights = inputs.weights_for(cfg, r.seed, dev, True,
                                 torch.cat([p[0] for p in pool]))
    digest = inputs.digest(weights)
    r.mark("weights")
    if r.cuda:       # the peak of the program's run, not of making inputs
        torch.cuda.reset_peak_memory_stats(dev)
    rng = np.random.RandomState((r.seed + 11) % (2 ** 32))
    picked = set(rng.choice(len(pool), min(SAMPLES, len(pool)),
                            replace=False).tolist())
    kept = {}
    notes = []
    info, n, secs, lat_ms = None, 0, 0.0, []
    if r.control:
        net = _reference(cfg, weights, dev)
        del weights
        with torch.no_grad(), harness.tf32(True):
            for p in picked:
                images, shapes, sfs = pool[p]
                out = net(images)
                kept[p] = (out, ref_decode.decode(
                    out, shapes, sfs, head, test,
                    net.bbox_head.rescore if head["rescoring"] else None))
        del net
        info = harness.device_info(r, cell.chips)
        setup, trace = 0.0, None
    else:
        det = program.detector(pcfg, dev, weights)
        del weights
        r.mark("detector")
        seen = {}

        def hook(mod, args, out):
            if seen.get("on"):
                seen["out"] = out
        handle = det.model.register_forward_hook(hook)
        infer = det.infer
        if r.fault == "altered":
            def infer(images, shapes, sfs):
                out = det.infer(images, shapes, sfs)
                out["scores"] = out["scores"] * 1.01
                return out
        elif r.fault is not None:
            raise ValueError(f"no fault {r.fault!r} for serving")

        def serve(i):
            images, shapes, sfs = pool[i % len(pool)]
            return infer(images, shapes, sfs)

        for i in range(traffic["warm"]):
            serve(i)
        r.mark("warm")
        setup = time.perf_counter() - r.t0
        notes.append("set-up (s from start): " + ", ".join(r.marks))
        events = []

        def call(i):
            p = i % len(pool)
            seen["on"] = p in picked
            if r.cuda:
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                e0.record()
            out = serve(i)
            if r.cuda:
                e1.record()
                e1.synchronize()
                events.append((e0, e1))
            if p in picked:
                kept[p] = (seen.pop("out"), out)
            seen["on"] = False

        n, secs = harness.window(r, call, traffic["warm"])
        lat_ms = [a.elapsed_time(b) for a, b in events]
        notes.append(f"window: {n} batches in {secs:.4f} s")
        trace = syncs = None
        if r.trace:
            after = traffic["warm"] + n
            syncs = devmod.count_syncs(lambda i: serve(after + i),
                                       traffic["syncs"])
            trace = devmod.profile(
                lambda i: serve(after + traffic["syncs"] + i),
                traffic["trace"])
        info = harness.device_info(r, cell.chips, trace)
        handle.remove()
        del det, infer, serve, call, hook
    harness.free()

    weights = inputs.weights_for(cfg, r.seed, dev, True,
                                 torch.cat([p[0] for p in pool]))
    if inputs.digest(weights) != digest:
        raise RuntimeError("the weights made again differ from the run's")
    net = _reference(cfg, weights, dev)
    del weights
    worst_h, worst_d = (0.0, ""), (0.0, "")
    with torch.no_grad():
        for p in sorted(kept):
            images, shapes, sfs = pool[p]
            prog_head, prog_dec = kept[p]
            hg = compare.head_gap(prog_head, net(images))
            ref_dec = ref_decode.decode(
                prog_head, shapes, sfs, head, test,
                net.bbox_head.rescore if head["rescoring"] else None)
            dg = compare.decode_gap(prog_dec, ref_dec)
            worst_h = max(worst_h, hg, key=lambda t: t[0])
            worst_d = max(worst_d, dg, key=lambda t: t[0])
            notes.append(f"pool batch {p}: head gap {hg[0]:.4g} "
                         f"({hg[1]}), decode gap {dg[0]:.4g} ({dg[1]}), "
                         f"{int(ref_dec['valid'].sum())} detections")
    del net
    values = {"head_gap": worst_h[0], "decode_gap": worst_d[0]}
    notes.append("readings " + ", ".join(f"{k} {v!r}"
                                         for k, v in values.items()))
    checks, ok = harness.checks(cell.limits["checks"], values)
    result = {"correct": bool(ok and kept),
              "attempted": n, "failed": 0}
    if r.trace and not r.control:
        fl, calls = flops.count(cfg, traffic, training=False)
        t = harness.Trace(
            "serve", cell.chips, n, secs, fl,
            roofline.PEAK_FLOP_PER_S[cfg["compute_dtype"]], trace,
            roofline.least(calls, training=False), syncs)
        result["metrics"] = harness.per_layer(r, t)
        result["breakdown"] = {"device_ops": trace.device_ops(),
                               "idle_gaps": trace.idle_gaps()}
        notes.append(f"model FLOPs a batch {fl:.6g}; profiled stretch: "
                     f"{trace.units} batches, {len(trace.kernels)} device "
                     f"operations, marker seen: {not trace.dropped}; most "
                     f"launched a unit: {trace.most_launched()}; "
                     f"syncs a batch {syncs}")
    else:
        p95 = float(np.percentile(lat_ms, 95)) if lat_ms else 0.0
        result["metrics"] = {
            "serve_img_s": {"value": n * traffic["batch"] * cell.chips
                            / secs if secs else 0.0, "unit": "images/s"},
            "batch_p95_ms": {"value": p95, "unit": "ms"},
            "setup_s": {"value": setup, "unit": "s"}}
        if lat_ms:
            notes.append(f"batch ms: median {float(np.median(lat_ms)):.4f}, "
                         f"p95 {p95:.4f}, {len(lat_ms)} batches")
    result["device"] = info
    result["readings"] = values
    result["checks"] = checks
    return result, notes


