"""Device ms a training step spends on the operations that the program
enqueued inside the spans of its kernels' wrappers (``sipmask.K1`` ...
``sipmask.K6``: the kernels and their glue), read by
``port_bench/spans.py`` from the profiled stretch."""

from port_bench import spans


def read(t):
    if t.path != "train":
        return None
    return spans.device_ms(t.stretch, spans.KERNEL_SPANS)
