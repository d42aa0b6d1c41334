"""Device operations a served batch launches, in the profiled stretch
(after the marker kernel)."""


def read(t):
    if t.path != "serve" or not t.stretch.kernels:
        return None
    return len(t.stretch.kernels) / t.stretch.units
