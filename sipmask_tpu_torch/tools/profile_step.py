"""Per-op device profile of a train step or an inference batch (the JAX
package's ``tools/profile_step.py``, with ``torch.profiler`` in place of
the JAX trace):

    python -m sipmask_tpu_torch.tools.profile_step sipmask_r50_fpn_gn_1x \\
        --mode train --dtype float32 --steps 3 --top 30 --json-out p.json

A batch of ``--batch`` seeded demo images (train: with 8-16 gts each) at
the preset's shape (train: ``train_size``, else ``fixed_size``, else the
keep-ratio scale padded to the stride, 800x1344 for the hi-acc presets;
infer: ``fixed_size`` or that padded scale), random weights from seed 0
that detect (``utils/demo_inputs.bump_weights``); two warm runs, then
``--steps`` under the profiler. It prints the device time a step (the
union of the kernels' intervals), the wall a step and the device's idle
share, then the top ``--top`` device kernels aggregated by name: ms a
step, share of the device time, calls a step, and then each of the
program's spans (``utils/trace.py``: ``sipmask.step.*``,
``sipmask.infer.*``, ``sipmask.K*``) with its host ms and calls a step.
On the CPU the ops' own CPU time takes the kernels' place. TF32 off; bf16
products summed in f32; cuDNN's heuristics pick the convolutions'
algorithms, as every entry point of the port leaves them (its benchmark
mode, which none sets, times other algorithms).
"""

from __future__ import annotations

import argparse
import collections
import json
import time


def default_shape(cfg, mode):
    d = cfg.data
    if mode == "train" and d.train_size is not None:
        return tuple(d.train_size)
    if d.fixed_size is not None:
        return tuple(d.fixed_size)
    div = d.size_divisor
    return (-(-min(d.img_scale) // div) * div,
            -(-max(d.img_scale) // div) * div)


def main(argv=None):
    ap = argparse.ArgumentParser(description="Profile a step.")
    ap.add_argument("config", nargs="?", default="sipmask_r50_fpn_gn_1x")
    ap.add_argument("--mode", default="train", choices=["train", "infer"])
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--shape", type=int, nargs=2, default=None)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--dtype", default="bfloat16",
                    choices=["bfloat16", "float32"],
                    help="the model's compute_dtype")
    ap.add_argument("--top", type=int, default=40)
    ap.add_argument("--json-out", default=None)
    ap.add_argument("--cfg-options", nargs="+", default=None,
                    help="dotted config overrides (see tools/train.py)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from ..config import _r, apply_overrides, get_config
    from ..utils.demo_inputs import bump_weights
    from ..utils.precision import no_tf32
    from .measure import busy_ms, kernel_events

    no_tf32()
    cuda = args.device.startswith("cuda")
    if cuda:
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction \
            = False
    cfg = _r(apply_overrides(get_config(args.config), args.cfg_options),
             "model", compute_dtype=args.dtype)
    h, w = args.shape or default_shape(cfg, args.mode)
    b, dev = args.batch, torch.device(args.device)
    gen = torch.Generator().manual_seed(0)

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)
    if args.mode == "infer":
        from ..apis.inference import init_detector
        det = init_detector(cfg, dev)
        bump_weights(det.model, gen)
        images = torch.from_numpy(np.random.RandomState(0).randn(
            b, 3, h, w).astype(np.float32) * 20).to(dev)
        shapes = torch.tensor([[float(h), float(w)]]).repeat(b, 1)
        sf = torch.ones((b, 4))

        def run():
            d = det.infer(images, shapes, sf)
            d["masks"] = d["masks"] > cfg.model.test.mask_thr
            sync()
    else:
        from ..train import create_train_state, make_train_step
        from ..utils.demo_inputs import train_batch
        state = create_train_state(cfg, dev, seed=0)
        bump_weights(state.model, gen, training=True)
        batch = train_batch(b, h, w, cfg.data.max_gts, 0, dev)
        step = make_train_step(state, cfg)

        def run():
            step(batch)
            sync()
    run()
    run()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    t0 = time.perf_counter()
    with profile(activities=acts) as prof:
        for _ in range(args.steps):
            run()
    wall = (time.perf_counter() - t0) * 1e3 / args.steps
    n = args.steps
    agg, calls = collections.Counter(), collections.Counter()
    if cuda:
        kern = kernel_events(prof)
        for e in kern:
            agg[e.name] += e.time_range.end - e.time_range.start
            calls[e.name] += 1
        total = busy_ms(kern) / n
    else:
        for e in prof.key_averages():
            agg[e.key] += e.self_cpu_time_total
            calls[e.key] += e.count
        total = sum(agg.values()) / 1e3 / n
    rows = [dict(op=k, ms=round(us / 1e3 / n, 4),
                 share=round(us / 1e3 / n / max(total, 1e-12), 4),
                 calls=calls[k] // n) for k, us in agg.most_common()]
    kind = "device kernels" if cuda else "CPU ops (own time)"
    print(f"# profile: {args.config} {args.mode} {args.dtype} bs{b} {h}x{w} "
          f"({n} steps on {args.device}; {kind} {total:.3f} ms/step, wall "
          f"{wall:.3f} ms/step, idle share {max(1 - total / wall, 0):.3f})")
    print(f"## top {args.top} {kind} (ms a step | share | calls a step)")
    for r in rows[:args.top]:
        print(f"{r['ms']:9.3f} ms  {r['share']:6.3f}  x{r['calls']:<5d} "
              f"{r['op']}")
    rest = sum(r["ms"] for r in rows[args.top:])
    print(f"{rest:9.3f} ms          (+{max(len(rows) - args.top, 0)} more)")
    span_us, span_calls = collections.Counter(), collections.Counter()
    for e in prof.events():
        if e.name.startswith("sipmask."):
            span_us[e.name] += e.time_range.end - e.time_range.start
            span_calls[e.name] += 1
    spans = [dict(span=k, host_ms=round(us / 1e3 / n, 4),
                  calls=span_calls[k] / n) for k, us in sorted(span_us.items())]
    print("## spans (host ms a step | calls a step)")
    for r in spans:
        print(f"{r['host_ms']:9.3f} ms  x{r['calls']:<7g} {r['span']}")
    out = dict(config=args.config, mode=args.mode, batch=b, dtype=args.dtype,
               hw=[h, w], device=args.device, steps=n,
               device_ms=round(total, 4), wall_ms=round(wall, 4), ops=rows,
               spans=spans)
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(out, f, indent=1)
        print(f"wrote {args.json_out}")
    return out


if __name__ == "__main__":
    main()
