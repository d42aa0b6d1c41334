"""Device operations a training step launches, in the profiled stretch
(after the marker kernel)."""


def read(t):
    if t.path != "train" or not t.stretch.kernels:
        return None
    return len(t.stretch.kernels) / t.stretch.units
