"""Synchronising CUDA calls a served batch, counted in PyTorch's sync
debug mode on batches outside the timed window and the profiled
stretch."""


def read(t):
    if t.path != "serve" or t.syncs_per_unit is None:
        return None
    return t.syncs_per_unit
