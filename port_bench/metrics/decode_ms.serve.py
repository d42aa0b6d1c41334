"""Device ms a served batch spends on the operations that the program
enqueued inside its span ``sipmask.infer.decode`` (``decode_batch``: top-k,
NMS, masks, rescoring), read by ``port_bench/spans.py`` from the profiled
stretch."""

from port_bench import spans


def read(t):
    if t.path != "serve":
        return None
    return spans.device_ms(t.stretch, {"sipmask.infer.decode"})
