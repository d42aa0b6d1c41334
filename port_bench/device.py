"""What the benchmark reads from the card: its name and power limit, the
peak memory, and a profiled stretch of the timed call (the kernels that
ran, their owners, the device's busy time, the largest device operations
and the longest idle gaps with what the host was doing in them).

``OWNERS`` maps fragments of the program's kernel names to the kernels
K1-K6 (a copy of the program's owner table, frozen here with the
benchmark); ``busy_s`` is the union of the device intervals.
"""

from __future__ import annotations

import subprocess
import time
from dataclasses import dataclass, field

import torch

OWNERS = {"deform_im2col": "K1", "deform_bwd": "K2", "fold_partials": "K2",
          "deform_col2im": "K2", "pad_rows": "K2",
          "mask_bce_fwd_tiles": "K3a", "mask_bce_fold_tiles": "K3a",
          "mask_bce_dbasis_tiles": "K3b", "mask_bce_dcofs_tiles": "K3b",
          "mask_bce_fold_dcofs": "K3b",
          "gn_stats": "K4a", "gn_apply": "K4a", "gn_fwd_cluster": "K4a",
          "gn_bwd": "K4b",
          "deform_rows_fwd": "K5", "deform_rows_bwd": "K5c",
          "assemble_masks": "K6"}
MARKER = "spin_kernel"      # torch.cuda._sleep's kernel


def owner(name: str):
    return next((v for k, v in OWNERS.items() if k in name), None)


def card():
    """(name, power limit as nvidia-smi prints it, or None)."""
    name = torch.cuda.get_device_name(0)
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20).stdout.strip().splitlines()
        return name, out[0].strip() if out else None
    except (OSError, subprocess.SubprocessError):
        return name, None


def busy_s(intervals):
    """Seconds in which at least one of the (start_us, end_us) intervals
    ran: their union."""
    total, start, end = 0.0, None, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += 0.0 if end is None else end - start
            start, end = s, e
        else:
            end = max(end, e)
    return (total + (0.0 if end is None else end - start)) / 1e6


@dataclass
class Stretch:
    """A profiled stretch of ``units`` calls."""
    units: int
    wall_s: float
    kernels: list = field(default_factory=list)   # (name, start_us, end_us)
    host: list = field(default_factory=list)      # (name, start_us, end_us)
    dropped: bool = False     # the marker was not seen

    def busy_s(self):
        return busy_s([(s, e) for _, s, e in self.kernels])

    def device_ops(self, n=10):
        by = {}
        for name, s, e in self.kernels:
            by[name] = by.get(name, 0.0) + (e - s) / 1e6
        return sorted(([k, v] for k, v in by.items()),
                      key=lambda kv: -kv[1])[:n]

    def most_launched(self, n=8):
        """The kernels launched most often in the stretch, with their
        counts a unit."""
        by = {}
        for name, _, _ in self.kernels:
            by[name] = by.get(name, 0) + 1
        return [[k[:80], v / self.units] for k, v in
                sorted(by.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n=10):
        """The longest gaps between device operations, each named by the
        innermost host operation that spans the gap's middle."""
        ev = sorted((s, e) for _, s, e in self.kernels)
        gaps, end = [], None
        for s, e in ev:
            if end is not None and s > end:
                gaps.append((s - end, end, s))
            end = e if end is None else max(end, e)
        out = []
        for d, a, b in sorted(gaps, reverse=True)[:n]:
            mid = (a + b) / 2
            span = [h for h in self.host if h[1] <= mid <= h[2]]
            label = min(span, key=lambda h: h[2] - h[1])[0] if span else "?"
            out.append([label, d / 1e6])
        return out


def profile(call, units: int) -> Stretch:
    """Run ``call(i)`` for i < ``units`` under ``torch.profiler``, after a
    marker kernel (the card's profiler can drop the first kernels of a
    session), and keep the device operations after the marker."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as prof_ctx

    torch.cuda.synchronize()
    with prof_ctx(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(units):
            call(i)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.events()
    dev = sorted(((e.name, e.time_range.start, e.time_range.end)
                  for e in events if e.device_type == DeviceType.CUDA),
                 key=lambda k: k[1])
    marks = [e for e in dev if MARKER in e[0]]
    after = marks[-1][2] if marks else None
    kern = [k for k in dev if MARKER not in k[0]
            and (after is None or k[1] >= after)]
    host = [(e.name, e.time_range.start, e.time_range.end) for e in events
            if e.device_type == DeviceType.CPU
            and (after is None or e.time_range.end >= after)]
    return Stretch(units, wall, kern, host, dropped=not marks)


def count_syncs(call, units: int) -> float:
    """Synchronising CUDA calls a call, counted by PyTorch's sync debug
    mode over ``units`` calls (each one warns)."""
    import warnings
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            for i in range(units):
                call(i)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return sum("synchroniz" in str(w.message) for w in seen) / units
