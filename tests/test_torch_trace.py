"""The port's spans (``sipmask_tpu_torch/utils/trace.py``): host-only
profiler ranges, never user annotations (which PyTorch projects onto the
device timeline), nested as the train step, ``Detector.infer`` and the
kernels' wrappers open them; and the ``timings`` dicts the test drivers
fill through them."""

from __future__ import annotations

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from sipmask_tpu_torch.utils.trace import span, spanned

STAGES = ["sipmask.step.forward", "sipmask.step.loss",
          "sipmask.step.backward", "sipmask.step.update"]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _spans(prof):
    """[(name, start, end)] of the profile's ``sipmask.`` events, sorted by
    start; every one a CPU range that is no user annotation."""
    out = []
    for e in prof.events():
        if e.name.startswith("sipmask."):
            assert not e.is_user_annotation, e.name
            assert e.device_type == torch.autograd.DeviceType.CPU, e.name
            out.append((e.name, e.time_range.start, e.time_range.end))
    return sorted(out, key=lambda s: s[1])


def _inside(inner, outer):
    return outer[1] <= inner[1] and inner[2] <= outer[2]


def test_span_is_a_host_range_that_nests_and_record_function_is_not():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with span("sipmask.outer"):
            with span("sipmask.inner"):
                torch.ones(3).add_(1)
        with torch.profiler.record_function("annotated"):
            pass
    got = {e.name: e for e in prof.events()}
    assert got["sipmask.inner"].cpu_parent.name == "sipmask.outer"
    assert got["sipmask.outer"].cpu_parent is None
    assert not got["sipmask.outer"].is_user_annotation
    assert not got["sipmask.inner"].is_user_annotation
    # what a span avoids: record_function's range is a user annotation
    assert any(e.is_user_annotation for e in prof.events())
    s = _spans(prof)
    assert [n for n, _, _ in s] == ["sipmask.outer", "sipmask.inner"]
    assert _inside(s[1], s[0])


def test_timed_span_appends_host_ms_under_the_last_part_of_its_name():
    timings = {}
    for _ in range(2):
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            with span("sipmask.video.track", timings, torch.device("cpu")):
                torch.ones(3).add_(1)
    assert list(timings) == ["track"] and len(timings["track"]) == 2
    assert all(ms >= 0 for ms in timings["track"])
    assert [n for n, _, _ in _spans(prof)] == ["sipmask.video.track"]
    with span("sipmask.test.encode", timings):      # no device: no sync
        pass
    assert len(timings["encode"]) == 1


def test_spanned_keeps_the_function_and_its_attributes():
    @spanned("sipmask.probe")
    def f(a, b=2):
        """doc"""
        f.calls += 1
        return a + b
    f.calls = 0
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert f(1, b=3) == 4
    assert f.calls == 1 and f.__doc__ == "doc" and f.__name__ == "f"
    assert [n for n, _, _ in _spans(prof)] == ["sipmask.probe"]


# ---------------------------------------------------------------- the kernels


def _k_inputs():
    """One tiny CPU call of each kernel's public wrapper (its plain route)."""
    from sipmask_tpu_torch.ops import (deform_conv, deform_sample, gn_relu,
                                       mask_assembly, mask_loss)
    g = torch.Generator().manual_seed(0)

    def r(*shape):
        return torch.randn(*shape, generator=g)
    x, off = r(1, 4, 6, 6), r(1, 18, 6, 6)
    cols = deform_sample.deform_im2col(x, off)
    w2 = r(5, 36)
    xr, pyx = r(2, 36, 4), torch.rand(2, 9, 5, 2, generator=g) * 5
    basis, cofs = r(1, 8, 16, 16), r(1, 3, 32)
    boxes = torch.tensor([[[1.0, 1.0, 9.0, 12.0], [0.0, 2.0, 15.0, 7.0],
                           [4.0, 4.0, 8.0, 8.0]]])
    gt_masks = (torch.rand(1, 2, 16, 16, generator=g) > 0.5).to(torch.uint8)
    gt_idx = torch.tensor([[0, 1, 0]])
    valid = torch.tensor([[True, True, False]])
    gx, gw, gb = r(2, 64, 3, 3), r(64), r(64)
    _, stats = gn_relu.gn_relu_forward(gx, gw, gb, 32)
    return {
        "K1": lambda: deform_sample.deform_im2col(x, off),
        "K2": lambda: deform_conv.deform_conv_backward(
            x, off, cols, w2, r(1, 5, 6, 6)),
        "K3a": lambda: mask_loss.mask_bce_forward(basis, cofs, boxes,
                                                  gt_masks, gt_idx, valid),
        "K3b": lambda: mask_loss.mask_bce_backward(
            basis, cofs, boxes, gt_masks, gt_idx, valid, r(1, 3)),
        "K4a": lambda: gn_relu.gn_relu_forward(gx, gw, gb, 32),
        "K4b": lambda: gn_relu.gn_relu_backward(gx, gw, gb, stats,
                                                r(2, 64, 3, 3), 32, True),
        "K5": lambda: deform_sample.deform_rows(xr, pyx, 6, 6),
        "K5c": lambda: deform_sample.deform_rows_backward(
            xr, pyx, r(2, 5, 9, 4), 6, 6),
        "K6": lambda: mask_assembly.assemble_masks(
            basis.permute(0, 2, 3, 1), cofs, boxes),
    }


@pytest.mark.parametrize("kernel", ["K1", "K2", "K3a", "K3b", "K4a", "K4b",
                                    "K5", "K5c", "K6"])
def test_each_kernel_wrapper_call_is_one_span(kernel):
    call = _k_inputs()[kernel]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        call()
    assert [n for n, _, _ in _spans(prof)] == [f"sipmask.{kernel}"]


# ------------------------------------------------- the train step and serving

def _cfg(preset):
    from sipmask_tpu_torch.config import get_config
    return get_config(preset)


# the presets' widths at a small image (SipMask++'s rescoring wants masks of
# 127 pixels or more)
SIZES = {"sipmask_r50_fpn_gn_1x": 128, "sipmaskpp_r101_fpn_ssd_6x": 256}
# the kernels each preset's stages reach on the CPU, by stage
TRAIN_K = {"sipmask_r50_fpn_gn_1x": {"sipmask.K4a": "sipmask.step.forward",
                                     "sipmask.K4b": "sipmask.step.backward"},
           "sipmaskpp_r101_fpn_ssd_6x": {"sipmask.K6": "sipmask.step.loss"}}


@pytest.mark.parametrize("preset", sorted(SIZES))
def test_train_step_opens_its_four_stages_in_order(preset):
    from sipmask_tpu_torch.train import create_train_state, make_train_step
    from sipmask_tpu_torch.utils.demo_inputs import train_batch
    cfg = _cfg(preset)
    state = create_train_state(cfg, "cpu", seed=0)
    step = make_train_step(state, cfg)
    size = SIZES[preset]
    batch = train_batch(1, size, size, cfg.data.max_gts, 0,
                        torch.device("cpu"))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        metrics = step(batch)
    assert torch.isfinite(metrics["loss_total"])
    s = _spans(prof)
    stages = [t for t in s if t[0] in STAGES]
    assert [n for n, _, _ in stages] == STAGES
    for a, b in zip(stages, stages[1:]):
        assert a[2] <= b[1]
    assert {n for n, _, _ in s} == set(STAGES) | set(TRAIN_K[preset])
    by = {n: t for n, t in zip(STAGES, stages)}
    for t in s:
        if t[0] not in STAGES:
            assert _inside(t, by[TRAIN_K[preset][t[0]]]), t[0]


@pytest.mark.parametrize("preset", sorted(SIZES))
def test_infer_opens_forward_then_decode(preset):
    from sipmask_tpu_torch.apis.inference import init_detector
    from sipmask_tpu_torch.utils.demo_inputs import bump_weights
    cfg = _cfg(preset)
    det = init_detector(cfg, "cpu")
    bump_weights(det.model, torch.Generator().manual_seed(0))
    size = SIZES[preset]
    images = torch.from_numpy(np.random.RandomState(0).randn(
        1, 3, size, size).astype(np.float32) * 20)
    shapes = torch.tensor([[float(size), float(size)]])
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        det.infer(images, shapes, torch.ones((1, 4)))
    s = _spans(prof)
    fwd, dec = (next(t for t in s if t[0] == n)
                for n in ("sipmask.infer.forward", "sipmask.infer.decode"))
    assert fwd[2] <= dec[1]
    assert [n for n, _, _ in s].count("sipmask.infer.forward") == 1
    assert [n for n, _, _ in s].count("sipmask.infer.decode") == 1
    ks = [t for t in s if t[0].startswith("sipmask.K")]
    assert [t[0] for t in ks if _inside(t, dec)] == ["sipmask.K6"]
    assert all(_inside(t, fwd) for t in ks if t[0] != "sipmask.K6")
