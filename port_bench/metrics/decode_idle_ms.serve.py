"""Idle device ms a served batch while the program's host is inside its
span ``sipmask.infer.decode``: the gaps between device operations whose
middle the span holds, read by ``port_bench/spans.py`` from the profiled
stretch."""

from port_bench import spans


def read(t):
    if t.path != "serve":
        return None
    return spans.idle_ms(t.stretch, {"sipmask.infer.decode"})
