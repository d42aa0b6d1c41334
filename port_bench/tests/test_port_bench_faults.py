"""Each fault that a cell can have, planted in the timed path under the
rest of a run (the CPU stands in for the chip), makes ``correct`` false
at the cell's limits."""

from __future__ import annotations

import pytest

from port_bench.tests import tiny


@pytest.mark.parametrize("fault", ["unchanged", "half_batch"])
@pytest.mark.parametrize("name", ["flagship.train", "sipmaskpp.train"])
def test_training_faults(name, fault):
    result, notes = tiny.run(name, 5, fault=fault)
    assert result["correct"] is False, (result["checks"], notes)


def test_an_altered_answer():
    result, notes = tiny.run("sipmaskpp.serve", fault="altered")
    assert result["correct"] is False, (result["checks"], notes)


def test_a_sound_serving_run_is_correct():
    """(The training cells' limits are set for their own sizes; at the
    small size their sound runs are held by the reference's test.)"""
    result, notes = tiny.run("sipmaskpp.serve", 5)
    assert result["correct"] is True, (result["checks"], notes)
