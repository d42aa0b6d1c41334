"""The training step's model FLOPs over the timed window's time, as a
share of the chips' peak in the configuration's dtype (%)."""


def read(t):
    if t.path != "train" or not t.window_s or not t.flops_per_unit:
        return None
    return 100.0 * t.flops_per_unit * t.window_units / t.window_s / (
        t.chips * t.peak_flop_per_s)
