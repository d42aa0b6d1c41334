"""Device ms a training step spends on the operations that the program
enqueued inside its span ``sipmask.step.loss`` (``compute_losses`` with
SipMask++'s rescoring, and their sum), read by ``port_bench/spans.py``
from the profiled stretch."""

from port_bench import spans


def read(t):
    if t.path != "train":
        return None
    return spans.device_ms(t.stretch, {"sipmask.step.loss"})
