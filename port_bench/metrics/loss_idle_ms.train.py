"""Idle device ms a training step while the program's host is inside its
span ``sipmask.step.loss``: the gaps between device operations whose
middle the span holds, read by ``port_bench/spans.py`` from the profiled
stretch."""

from port_bench import spans


def read(t):
    if t.path != "train":
        return None
    return spans.idle_ms(t.stretch, {"sipmask.step.loss"})
