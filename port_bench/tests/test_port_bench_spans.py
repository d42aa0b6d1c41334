"""``spans.py`` on hand-made stretches: the pairing of enqueues with device
operations, the attribution of device time and idle gaps to the program's
spans, and the readers of the metrics that use them."""

from __future__ import annotations

import json
from pathlib import Path

import pytest

from port_bench import harness, spans, spec
from port_bench.device import Stretch

ROOT = Path(__file__).resolve().parents[2]
SPAN_METRICS = [m for m in json.loads(
    (ROOT / "BENCHMARK.json").read_text())["per_layer"]
    if m["source"] == "program_span"]

# One step of a known timeline (us, the host's clock). The host enqueues
# five operations: two in the forward (the second, through the driver,
# inside K1), a copy in the loss, one in the backward (inside K2, whose
# span autograd's thread opens), one in the update, where torch.optim's
# record_function range is also projected onto the device. The device
# idles 162 us in the loss, 70 in the backward (the gap's middle, 295,
# after the loss span's end) and 80 in the update.
HOST = [
    ("sipmask.step.forward", 0, 100),
    ("cudaLaunchKernel", 10, 12),
    ("sipmask.K1", 20, 40),
    ("cuLaunchKernel", 25, 27),
    ("sipmask.step.loss", 100, 290),
    ("cudaMemcpyAsync", 250, 252),
    ("sipmask.step.backward", 292, 400),
    ("sipmask.K2", 310, 340),
    ("cudaLaunchKernel", 330, 332),
    ("sipmask.step.update", 400, 500),
    ("Optimizer.step#SGD.step", 410, 490),
    ("cudaLaunchKernel", 460, 462),
]


def _kernels(shift=0.0):
    """The device's events on a clock ``shift`` us off the host's."""
    return [(n, s + shift, e + shift) for n, s, e in [
        ("k_fwd", 20, 60),
        ("k_K1", 60, 90),
        ("Memcpy DtoD (Device -> Device)", 252, 262),
        ("k_K2", 332, 382),
        ("Optimizer.step#SGD.step", 415, 495),
        ("k_sgd", 462, 472),
    ]]


KERNELS = _kernels()


def _stretch(kernels=KERNELS, host=HOST, units=1):
    return Stretch(units, 1.0, list(kernels), list(host))


def test_projected_ranges_are_left_out():
    st = _stretch()
    assert [o[:2] for o in spans.device_ops(st)] == [
        (20, 60), (60, 90), (252, 262), (332, 382), (462, 472)]
    assert [q for q, _ in spans.enqueues(st)] == [10, 25, 250, 330, 460]
    assert [q for q, _ in spans.pair(st)] == [10, 25, 250, 330, 460]


@pytest.mark.parametrize("kernels, host, first", [
    # the profiler lost the first two device operations: pair from the end
    (KERNELS[2:], HOST, 250),
    # an enqueue before the stretch's first operation (the marker's launch)
    (KERNELS, [("cudaLaunchKernel", 1, 3)] + HOST, 10),
])
def test_a_shorter_device_list_pairs_from_the_end(kernels, host, first):
    pairs = spans.pair(_stretch(kernels, host))
    assert pairs[0][0] == first and pairs[-1] == (460, (462, 472))
    assert len(pairs) == len(spans.device_ops(_stretch(kernels, host)))


@pytest.mark.parametrize("kernels, host", [
    # more device operations than enqueues
    (KERNELS + [("k_extra", 600, 610)], HOST),
    # a kernel paired with a copy's call
    (KERNELS[:2] + [("k_not_a_copy", 252, 262)] + KERNELS[3:], HOST),
    # no device operation
    ([], HOST),
])
def test_any_other_mismatch_leaves_every_reading_none(kernels, host):
    st = _stretch(kernels, host)
    assert spans.pair(st) is None
    assert spans.device_ms(st, {"sipmask.step.forward"}) is None
    assert spans.idle_ms(st, {"sipmask.step.forward"}) is None


@pytest.mark.parametrize("names, device_ms, idle_ms", [
    ({"sipmask.step.forward"}, 0.070, 0.0),
    ({"sipmask.step.loss"}, 0.010, 0.162),
    ({"sipmask.step.backward"}, 0.050, 0.070),
    ({"sipmask.step.update"}, 0.010, 0.080),
    (spans.KERNEL_SPANS, 0.080, 0.0),
    ({"sipmask.K1"}, 0.030, 0.0),
])
@pytest.mark.parametrize("shift", [0.0, -4700.0, 1300.0])
def test_stage_and_idle_attribution_of_a_known_timeline(names, device_ms,
                                                          idle_ms, shift):
    """The readings are the same whatever the device clock's offset from
    the host's."""
    for units in (1, 2):
        st = _stretch(_kernels(shift), units=units)
        assert spans.device_ms(st, names) == pytest.approx(device_ms / units)
        assert spans.idle_ms(st, names) == pytest.approx(idle_ms / units)


def test_a_program_without_the_span_reads_none():
    host = [h for h in HOST if not h[0].startswith("sipmask.")]
    st = _stretch(host=host)
    assert spans.pair(st) is not None
    assert spans.device_ms(st, {"sipmask.step.loss"}) is None
    assert spans.idle_ms(st, {"sipmask.step.loss"}) is None
    assert spans.device_ms(st, spans.KERNEL_SPANS) is None


def _trace(path, stretch):
    return harness.Trace(path, 1, 10, 1.0, 1e12, 67e12, stretch, {})


SERVE_HOST = [("sipmask.infer.forward", 0, 100),
              ("cudaLaunchKernel", 10, 12),
              ("sipmask.K5", 30, 50),
              ("cudaLaunchKernel", 35, 37),
              ("sipmask.infer.decode", 100, 200),
              ("sipmask.K6", 150, 170),
              ("cudaLaunchKernel", 160, 162)]
SERVE_KERNELS = [("conv", 20, 40), ("k_K5", 40, 80), ("k_K6", 170, 190)]


@pytest.mark.parametrize("m", SPAN_METRICS, ids=lambda m: m["name"])
def test_every_span_metric_reads_only_its_own_path(m):
    read = spec.metric_reader(m["name"])
    path = m["name"].rsplit(".", 1)[1]
    other = "serve" if path == "train" else "train"
    st = (_stretch() if path == "train"
          else _stretch(SERVE_KERNELS, SERVE_HOST))
    assert read(_trace(other, st)) is None
    got = read(_trace(path, st))
    assert got is not None and got >= 0
    assert m["workloads"] and all(w.endswith("." + path)
                                  for w in m["workloads"])


@pytest.mark.parametrize("name, want", [
    ("decode_ms.serve", 0.020 / 10),
    ("kernels_ms.serve", 0.060 / 10),
    ("forward_idle_ms.serve", 0.0),
    ("decode_idle_ms.serve", 0.090 / 10),   # gap 80-170, ended at 160
])
def test_serve_metrics_of_a_known_batch(name, want):
    st = Stretch(10, 1.0, SERVE_KERNELS, SERVE_HOST)
    assert spec.metric_reader(name)(_trace("serve", st)) == pytest.approx(
        want)
