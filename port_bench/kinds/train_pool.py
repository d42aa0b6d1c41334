"""Training over a pool of batches: set-up builds the program's train state
(``create_train_state`` with the benchmark's weights) and its step
(``make_train_step``), drives it through its first three steps on the
pool's first three batches, reading the losses, the first gradient (from
the optimizer's momentum after one step) and each leaf's change after
three; then it warms up and the window runs the same step over the
pool's batches in turn. Every ``cycle`` steps the harness gives the model
its first weights again and clears the optimizer's state and step count,
so that each step of the window is one of the first ``cycle`` steps from
the weights the check starts from: training from random weights drifts,
and a drifting model changes the work a step does. Once the window has closed and the
program's state is freed, the reference makes the same three steps from
the same weights and batches.

Traffic file keys: ``kind`` 'train_pool', ``batch``, ``size`` [H, W],
``pool`` (distinct batches), ``cycle`` (steps between restarts from the
first weights), ``warm`` (steps after the three), ``trace`` (steps
profiled), ``instances`` (see ``inputs.py``).
"""

from __future__ import annotations

import time

import torch

from .. import compare, flops, harness, inputs, program, roofline
from .. import device as devmod
from ..reference import model as ref_model
from ..reference import train as ref_train

READ_STEPS = 3


def _program_readings(step, state, batches):
    """Losses of the first steps, each leaf's first gradient as the
    optimizer holds it after one step, and each leaf's change after the
    steps."""
    trained = {n: p for n, p in state.model.named_parameters()
               if p.requires_grad}
    start = {n: p.detach().clone() for n, p in trained.items()}
    decay = {id(p): g["weight_decay"] for g in state.optimizer.param_groups
             for p in g["params"]}
    losses, grads = [], None
    for i, b in enumerate(batches):
        metrics = step(b)
        losses.append(float(metrics["loss_total"]))
        if i == 0:
            parts = {k: float(v) for k, v in metrics.items()
                     if k != "loss_total"}
            grads = {}
            for n, p in trained.items():
                buf = state.optimizer.state.get(p, {}).get("momentum_buffer")
                grads[n] = (torch.zeros_like(p) if buf is None
                            else buf - decay[id(p)] * start[n])
            grads = compare.norms(grads)
    change = compare.norms({n: p.detach() - start[n]
                            for n, p in trained.items()})
    return losses, grads, change, parts


def _reference_readings(run, weights, batches, tf32=False):
    cfg = run.cell.config
    net = ref_model.build(cfg["model"], run.device)
    net.load_state_dict(weights)
    with harness.tf32(tf32):
        losses, grads, change, parts = ref_train.run_steps(net, batches,
                                                           cfg)
    grads, change = compare.norms(grads), compare.norms(change)
    del net
    return losses, grads, change, parts


def _images(pool):
    """Every image of the pool: SipMask++'s frozen BN is fitted to them
    all (fitted to one batch, the random R101 scales other batches'
    features far off, and their first step's class loss reads 1e2-3e3)."""
    return torch.cat([b["images"] for b in pool])


def _faulty(step, state, fault):
    """The step with a fault planted (for the checks' own tests): 'unchanged'
    returns the state as it found it, 'half_batch' trains on half the batch,
    its losses the mean over that half."""
    if fault is None:
        return step
    if fault == "half_batch":
        def half(batch):
            b = batch["images"].shape[0] // 2
            return step({k: v[:b] for k, v in batch.items()})
        return half
    if fault == "unchanged":
        def unchanged(batch):
            keep = {k: v.detach().clone()
                    for k, v in state.model.state_dict().items()}
            out = step(batch)
            state.model.load_state_dict(keep)
            state.optimizer.state.clear()
            return out
        return unchanged
    raise ValueError(f"no fault {fault!r} for training")


def run(r: harness.Run):
    cell, cfg, traffic = r.cell, r.cell.config, r.cell.traffic
    dev = r.device
    pool = inputs.train_pool(dict(traffic, pool=r.pool or traffic["pool"]),
                             cfg, r.seed, dev)
    r.mark("pool")
    weights = inputs.weights_for(cfg, r.seed, dev, False, _images(pool))
    digest = inputs.digest(weights)
    r.mark("weights")
    if r.cuda:       # the peak of the program's run, not of making inputs
        torch.cuda.reset_peak_memory_stats(dev)
    first = pool[:READ_STEPS]
    notes = []
    if r.control:
        prog = _reference_readings(r, weights, first, tf32=True)
        del weights
        n, secs, failed, trace = 0, 0.0, 0, None
        setup = 0.0
    else:
        pcfg = program.preset(cfg)
        program.load()
        r.mark("program imported")
        state, step = program.train_state(pcfg, dev, weights)
        del weights
        step = _faulty(step, state, r.fault)
        r.mark("train state")
        live = list(state.model.state_dict().values())
        initial = [v.detach().clone() for v in live]

        def restart():
            torch._foreach_copy_(live, initial)
            state.optimizer.state.clear()
            state.step = 0

        prog = _program_readings(step, state, first)
        r.mark("first steps")
        bad = torch.zeros((), dtype=torch.int64, device=dev)
        top = torch.zeros((), device=dev)

        def call(i):
            """Step i after the first ones, on the pool's next batch; the
            first weights again at the start of each cycle."""
            if i % traffic["cycle"] == 0:
                restart()
            m = step(pool[(READ_STEPS + i) % len(pool)])
            bad.add_((~torch.isfinite(m["loss_total"])).long())
            torch.maximum(top, m["loss_total"].detach(), out=top)

        for i in range(traffic["warm"]):
            call(i)
        r.mark("warm")
        setup = time.perf_counter() - r.t0
        notes.append("set-up (s from start): " + ", ".join(r.marks))
        bad.zero_()
        n, secs = harness.window(r, call, traffic["warm"])
        failed = int(bad)
        notes.append(f"window: {n} steps in {secs:.4f} s, largest loss "
                     f"{float(top):.6g}")
        trace = None
        if r.trace:
            trace = devmod.profile(
                lambda i: call(traffic["warm"] + n + i), traffic["trace"])
        info = harness.device_info(r, cell.chips, trace)
        del state, step, call, live, initial, restart
    if r.control:
        info = harness.device_info(r, cell.chips)
    harness.free()

    # the reference, from the same weights made again
    weights = inputs.weights_for(cfg, r.seed, dev, False, _images(pool))
    if inputs.digest(weights) != digest:
        raise RuntimeError("the weights made again differ from the run's")
    ref = _reference_readings(r, weights, first)
    del weights
    leaves = compare.counted(ref[1])
    g_gap, g_leaf = compare.norm_gap(prog[1], ref[1], leaves)
    c_gap, c_leaf = compare.norm_gap(prog[2], ref[2], leaves)
    values = {"loss_gap": compare.loss_gap(prog[0], ref[0]),
              "loss1_gap": compare.loss_gap(prog[0][:1], ref[0][:1]),
              "grad_gap": g_gap,
              "grad_median_gap": compare.median_gap(prog[1], ref[1], leaves),
              "change_gap": c_gap,
              "change_median_gap": compare.median_gap(prog[2], ref[2],
                                                      leaves)}
    notes.append("readings " + ", ".join(f"{k} {v!r}"
                                         for k, v in values.items()))
    notes.append(f"losses program {prog[0]} reference {ref[0]}")
    notes.append("first step's losses: " + ", ".join(
        f"{k} {prog[3][k]!r} / {ref[3][k]!r}" for k in ref[3]))
    own = sorted(((abs(prog[2][n] - ref[2][n]) / max(ref[2][n], 1e-30), n)
                  for n in leaves), reverse=True)[:5]
    notes.append("largest change gaps, over each leaf's own change: "
                 + ", ".join(f"{n} {g:.3g}" for g, n in own))
    notes.append(f"worst leaves: gradient {g_leaf}, change {c_leaf}; "
                 f"{len(leaves)} of {len(ref[1])} leaves compared; left "
                 f"out: {sorted(set(ref[1]) - set(leaves))}")
    checks, ok = harness.checks(cell.limits["checks"], values)
    result = {"correct": bool(ok and failed == 0), "attempted": n,
              "failed": failed}
    images = n * traffic["batch"] * cell.chips
    if r.trace and not r.control:
        fl, calls = flops.count(cfg, traffic, training=True)
        t = harness.Trace(
            "train", cell.chips, n, secs, fl,
            roofline.PEAK_FLOP_PER_S[cfg["compute_dtype"]], trace,
            roofline.least(calls, training=True))
        result["metrics"] = harness.per_layer(r, t)
        result["device"] = info
        result["breakdown"] = {"device_ops": trace.device_ops(),
                               "idle_gaps": trace.idle_gaps()}
        notes.append(f"model FLOPs a step {fl:.6g}; profiled stretch: "
                     f"{trace.units} steps, {len(trace.kernels)} device "
                     f"operations, marker seen: {not trace.dropped}; most "
                     f"launched a unit: {trace.most_launched()}")
    else:
        result["metrics"] = {
            "train_img_s": {"value": images / secs if secs else 0.0,
                            "unit": "images/s"},
            "setup_s": {"value": setup, "unit": "s"}}
        result["device"] = info
    result["readings"] = values
    result["checks"] = checks
    return result, notes


