"""The benchmark's frozen reference against the program on the CPU, at the
published widths on small images: through the harness's own runs, whose
checks compare the program's first steps (losses, first gradients, the
change after three steps) or its served head outputs and decoded
detections with the reference."""

from __future__ import annotations

import pytest

from port_bench.reference import decode, loss, model, ops, train  # noqa
from port_bench.tests import tiny


# (loss, first gradient, change) gaps at most. SipMask++'s calibrated
# random R101 moves a deformable block's sampling positions across pixel
# borders on rounding, where the gradient of its offsets jumps: its first
# step's loss agrees to ~1e-7, but its offset convs' gradients and their
# change over three steps differ far more than the flagship's leaves.
BOUNDS = {"flagship.train": (1e-5, 1e-3, 1e-2),
          "sipmaskpp.train": (5e-3, 5e-2, 0.5)}


@pytest.mark.parametrize("name,seed", [("flagship.train", 20240101),
                                       ("sipmaskpp.train", 5)])
def test_training_matches(name, seed):
    result, notes = tiny.run(name, seed)
    got = result["readings"]
    for key, bound in zip(("loss_gap", "grad_gap", "change_gap"),
                          BOUNDS[name]):
        assert got[key] < bound, (key, notes)
    assert result["failed"] == 0


def test_serving_matches():
    result, notes = tiny.run("sipmaskpp.serve")
    got = result["readings"]
    # the calibrated random R101 amplifies the rounding of its convs
    assert got["head_gap"] < 1e-2, notes
    assert got["decode_gap"] < 1e-5, notes
