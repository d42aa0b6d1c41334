"""What every kind of traffic shares: the run's settings, the measured
window, the traced stretch and its per-layer metrics, and the result
line."""

from __future__ import annotations

import contextlib
import gc
import math
import sys
import time
from dataclasses import dataclass, field
from typing import Optional

import torch

from . import device as devmod
from . import spec


@dataclass
class Run:
    cell: spec.Cell
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    t0: float                       # the process's start (perf_counter)
    control: Optional[str] = None   # 'tf32': the reference in TF32 in the
                                    # program's place
    fault: Optional[str] = None     # a fault planted in the timed path
    pool: Optional[int] = None      # a smaller pool (the CPU tests)
    marks: list = field(default_factory=list)

    def mark(self, label: str):
        """Note the seconds since the process started (set-up's parts)."""
        self.sync()
        self.marks.append(f"{label} {time.perf_counter() - self.t0:.3f}")

    @property
    def cuda(self):
        return self.device.type == "cuda"

    def sync(self):
        if self.cuda:
            torch.cuda.synchronize(self.device)


def window(run: Run, call, first: int):
    """Call ``call(i)`` for i = first, first + 1, ... until ``run.seconds``
    have passed on the host's clock, then wait for the device. The host
    runs at most two calls ahead of the device. Returns (calls, seconds
    from the first call to the end of the last)."""
    pending, n = [], 0
    run.sync()
    t = time.perf_counter()
    while True:
        call(first + n)
        n += 1
        if run.cuda:
            ev = torch.cuda.Event()
            ev.record()
            pending.append(ev)
            if len(pending) > 2:
                pending.pop(0).synchronize()
        if time.perf_counter() - t >= run.seconds:
            break
    run.sync()
    return n, time.perf_counter() - t


@contextlib.contextmanager
def tf32(on: bool):
    """TF32 products in cuDNN's convolutions and CUDA's matrix products on
    or off inside the block (the control's lower precision)."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def free():
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


@dataclass
class Trace:
    """What a per-layer metric reads (``port_bench/metrics/*.py``)."""
    path: str                  # 'train' or 'serve'
    chips: int
    window_units: int          # steps or batches of the timed window
    window_s: float
    flops_per_unit: float      # model FLOPs of a step or a batch
    peak_flop_per_s: float     # of one chip in the configuration's dtype
    stretch: devmod.Stretch    # the profiled stretch
    least_s: dict              # {kernel id: least seconds a unit}
    syncs_per_unit: Optional[float] = None


def per_layer(run: Run, trace: Trace):
    """{metric: {value, unit}} of the cell's per-layer metrics that found
    something to read."""
    out = {}
    for m in run.cell.per_layer:
        v = spec.metric_reader(m["name"], run.cell.pkg)(trace)
        if v is not None:
            out[m["name"]] = {"value": v, "unit": m["unit"]}
    return out


def device_info(run: Run, chips: int, stretch=None):
    if not run.cuda:
        info = {"platform": "cpu", "kind": "cpu", "count": chips,
                "memory_peak_bytes": 0}
    else:
        name, limit = devmod.card()
        info = {"platform": "gpu", "kind": name, "count": chips,
                "memory_peak_bytes": int(torch.cuda.max_memory_allocated()),
                "power_limit": limit}
    if stretch is not None:
        info["busy_s"] = stretch.busy_s()
        info["window_s"] = stretch.wall_s
    return info


def checks(limits: dict, values: dict):
    """{name: {value, limit}} of the values that the cell's limits name,
    and whether each is within its limit (a NaN never is)."""
    missing = set(limits) - set(values)
    if missing:
        raise KeyError(f"limits on numbers the run does not read: {missing}")
    out = {k: {"value": values[k], "limit": lim} for k, lim in limits.items()}
    ok = all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
             for c in out.values())
    return out, ok


def emit(result: dict, notes: list):
    """The notes and then each compared number beside its limit as the last
    lines of standard error; the result as the last line of standard
    output, its ``checks`` last."""
    for line in notes:
        print(line, file=sys.stderr)
    for k, c in result["checks"].items():
        print(f"check {k}: {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    import json
    print(json.dumps(result), flush=True)
