"""The program's spans in a profiled stretch: the stage of a step or a batch
that enqueued each device operation, and the stage that held the host
while the device idled.

The program opens host-only profiler ranges named ``sipmask.*`` around its
stages and its kernels' wrappers, on the host's clock. This module is the
benchmark's own reader of them, so that a change to the program cannot
move the yardstick:

- device operations: the stretch's device events (``Stretch.kernels``),
  less the ranges that PyTorch projects onto the device from
  ``record_function`` (a device event named as a host event is, such as
  ``Optimizer.step#SGD.step``), sorted by start;
- enqueues: the host calls that put work on the device (``ENQUEUES``),
  sorted by start;
- the two lists are paired by position; where the device list is the
  shorter (the card's profiler can lose a session's first kernels) from
  the end. Any other mismatch, in the counts or in the kinds of a pair (a
  copy, a fill, a kernel), leaves the stretch unpaired: every reading is
  then None;
- a device operation is put down to the ``sipmask.`` spans whose host
  interval holds its enqueue's start; each idle gap between device
  operations (after their union) to the spans that hold the gap's middle
  (the rule of ``Stretch.idle_gaps``), put on the host's clock through the
  operation that ends the gap: the device idles because that operation
  is not enqueued yet, so its gap ends at its enqueue, and the middle lies
  half the gap before.

Only host times are compared with host times, and device times with
device times: on an H100 (torch 2.11, CUDA 12.8) the profiler's device
clock drifted against its host clock within one stretch, by up to 4.7 ms
in half a second (copies and fills, each paired with its own call,
started that long before it), so a device time cannot be set against a
host span directly.

Times are Kineto's microseconds; readings are ms a unit of the stretch.
"""

from __future__ import annotations

from .device import busy_s

PREFIX = "sipmask."
KERNEL_SPANS = frozenset(f"sipmask.{k}" for k in (
    "K1", "K2", "K3a", "K3b", "K4a", "K4b", "K5", "K5c", "K6"))
# the host calls whose device work the stretch records, as the card's
# traces of the three cells name them: launches through the runtime and the
# driver, copies and fills
ENQUEUES = frozenset({"cudaLaunchKernel", "cudaLaunchKernelExC",
                      "cuLaunchKernel", "cudaMemcpyAsync", "cudaMemsetAsync"})


def _kind(name):
    """'copy', 'fill' or 'kernel': of a device event or of its enqueue."""
    return ("copy" if "Memcpy" in name else "fill" if "Memset" in name
            else "kernel")


def device_ops(stretch):
    """[(start, end, name)] of the device operations, sorted by start."""
    projected = {name for name, _, _ in stretch.host}
    return sorted((s, e, name) for name, s, e in stretch.kernels
                  if name not in projected)


def enqueues(stretch):
    """[(start, name)] of the enqueueing host calls, sorted."""
    return sorted((s, name) for name, s, _ in stretch.host
                  if name in ENQUEUES)


def pair(stretch):
    """[(enqueue start, (op start, op end))], or None where the stretch does
    not pair."""
    ops, enq = device_ops(stretch), enqueues(stretch)
    if not ops or len(enq) < len(ops):
        return None
    enq = enq[len(enq) - len(ops):]
    if any(_kind(q) != _kind(o) for (_, q), (_, _, o) in zip(enq, ops)):
        return None
    return [(q, (s, e)) for (q, _), (s, e, _) in zip(enq, ops)]


def _holding(times, stretch):
    """For each of the sorted ``times``, the names of the ``sipmask.``
    spans whose interval holds it."""
    bounds = sorted([(s, 0, name) for name, s, _ in stretch.host
                     if name.startswith(PREFIX)]
                    + [(e, 2, name) for name, _, e in stretch.host
                       if name.startswith(PREFIX)])
    active, i, out = {}, 0, []
    for t in times:
        while i < len(bounds) and bounds[i][:2] < (t, 1):
            _, kind, name = bounds[i]
            active[name] = active.get(name, 0) + (1 if kind == 0 else -1)
            i += 1
        out.append(frozenset(n for n, c in active.items() if c > 0))
    return out


def _spanned(stretch, names):
    return any(name in names for name, _, _ in stretch.host)


def device_ms(stretch, names):
    """Device ms a unit of the operations enqueued inside any span of
    ``names``: the union of their intervals (kernels launched as
    programmatic dependents overlap); None where the stretch has no such
    span or does not pair."""
    names = frozenset(names)
    pairs = pair(stretch) if _spanned(stretch, names) else None
    if pairs is None:
        return None
    held = _holding([q for q, _ in pairs], stretch)
    return busy_s([op for (_, op), h in zip(pairs, held) if h & names]
                  ) * 1e3 / stretch.units


def idle_ms(stretch, names):
    """Idle device ms a unit in the gaps between device operations whose
    middle, on the host's clock, lies inside any span of ``names``; None
    where the stretch has no such span or does not pair."""
    names = frozenset(names)
    pairs = pair(stretch) if _spanned(stretch, names) else None
    if pairs is None:
        return None
    gaps, end = [], None        # (the middle on the host's clock, length)
    for q, (s, e) in pairs:
        if end is not None and s > end:
            gaps.append((q - (s - end) / 2, s - end))
        end = e if end is None else max(end, e)
    gaps.sort()
    held = _holding([t for t, _ in gaps], stretch)
    us = sum(d for (_, d), h in zip(gaps, held) if h & names)
    return us / 1e3 / stretch.units
