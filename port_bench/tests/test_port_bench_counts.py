"""``flops.py`` and ``roofline.py`` against counts by hand."""

from __future__ import annotations

import pytest
import torch
import torch.nn.functional as F

from port_bench import flops, roofline, spec


def test_one_conv():
    x = torch.empty((2, 64, 50, 84), device="meta")
    w = torch.empty((256, 64, 3, 3), device="meta")
    got = flops.counted(lambda: F.conv2d(x, w, padding=1))
    assert got == 2 * 2 * 256 * 64 * 9 * 50 * 84


def test_one_conv_forward_and_backward():
    x = torch.empty((2, 64, 50, 84), device="meta", requires_grad=True)
    w = torch.empty((256, 64, 3, 3), device="meta", requires_grad=True)
    got = flops.counted(lambda: F.conv2d(x, w, padding=1).sum().backward())
    assert got == 3 * 2 * 2 * 256 * 64 * 9 * 50 * 84


def test_one_k4a_call():
    shape = (4, 256, 100, 168)
    n = 4 * 256 * 100 * 168
    got = roofline.least([("gn", {"x": shape})], training=False)
    by_bytes = (8 * n + 8 * 256) / 3.35e12
    by_ops = 8 * n / 67e12
    assert got == {"K4a": pytest.approx(max(by_bytes, by_ops))}
    got = roofline.least([("gn", {"x": shape})], training=True)
    assert got["K4b"] == pytest.approx(max(12 * n / 3.35e12, 10 * n / 67e12))


def test_the_flagship_step_has_every_kernel():
    c = spec.load_cell("flagship.train")
    fl, calls = flops.count(c.config, c.traffic, training=True)
    least = roofline.least(calls, training=True)
    assert set(least) == {"K1", "K2", "K3a", "K3b", "K4a", "K4b"}
    # 8 GroupNorms a level (3 + 4 tower convs and FeatureAlign) x 5 levels
    assert sum(name == "gn" for name, _ in calls) == 40
    assert 4e12 < fl < 7e12
