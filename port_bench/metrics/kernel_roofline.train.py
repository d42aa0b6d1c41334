"""The program's kernels K1-K6 in a training step: the least time the card
could take for their calls (``roofline.py``) over the device time their
kernels took in the profiled stretch (%). Only kernels seen in the
stretch count, on both sides."""

from port_bench.device import owner


def read(t):
    if t.path != "train":
        return None
    took = {}
    for name, s, e in t.stretch.kernels:
        k = owner(name)
        if k is not None:
            took[k] = took.get(k, 0.0) + (e - s) / 1e6
    ks = [k for k in took if t.least_s.get(k)]
    if not ks:
        return None
    return 100.0 * sum(t.least_s[k] for k in ks) * t.stretch.units / sum(
        took[k] for k in ks)
