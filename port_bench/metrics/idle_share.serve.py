"""The share of the profiled stretch of served batches in which no
operation ran on the device (%): 1 - the union of the device intervals
over the stretch's wall time."""


def read(t):
    if t.path != "serve" or not t.stretch.wall_s or not t.stretch.kernels:
        return None
    return 100.0 * (1.0 - t.stretch.busy_s() / t.stretch.wall_s)
