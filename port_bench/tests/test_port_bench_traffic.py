"""The traffic is fixed by the seed, has COCO's instance mean and area
split, and the seed changes what is drawn but not how much."""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from port_bench import inputs, spec

TRAFFIC = json.loads((spec.PKG / "traffic" / "coco_train_b4_800x1344.json")
                     .read_text())
INST = TRAFFIC["instances"]


@pytest.mark.parametrize("n", [64, 128, 16])
def test_instance_counts_have_cocos_mean(n):
    c = inputs.count_set(n, INST["mean"], INST["cap"])
    assert c.sum() == round(INST["mean"] * n)
    assert c.min() >= 1 and c.max() <= INST["cap"]
    assert np.median(c) < c.mean()          # heavy-tailed: a long right tail


def test_areas_follow_cocos_split():
    n = 465          # 64 images x 7.27
    a = inputs.area_set(n, INST["area_split"], INST["area_bounds"])
    small = (a < 32 ** 2).mean()
    medium = ((a >= 32 ** 2) & (a < 96 ** 2)).mean()
    large = (a >= 96 ** 2).mean()
    w = np.asarray(INST["area_split"]) / sum(INST["area_split"])
    assert abs(small - w[0]) < 2 / n and abs(medium - w[1]) < 2 / n
    assert abs(large - w[2]) < 2 / n


def _tiny():
    c = spec.load_cell("flagship.train")
    return c.config, dict(c.traffic, batch=2, size=[64, 96], pool=3)


def test_the_seed_fixes_the_batches():
    cfg, tr = _tiny()
    a = inputs.train_pool(tr, cfg, 2 ** 31 + 5, "cpu")
    b = inputs.train_pool(tr, cfg, 2 ** 31 + 5, "cpu")
    c = inputs.train_pool(tr, cfg, 2 ** 31 + 6, "cpu")
    for x, y in zip(a, b):
        for k in x:
            assert torch.equal(x[k], y[k])
    assert not torch.equal(a[0]["images"], c[0]["images"])
    # another seed: the same instance counts, in another order
    count = [sorted(int((p["gt_labels"][i] > 0).sum()) for p in pool
                    for i in range(2)) for pool in (a, c)]
    assert count[0] == count[1]


def test_the_seed_fixes_the_weights():
    cfg, tr = _tiny()
    w1 = inputs.make_weights(cfg, 7, "cpu", False)
    w2 = inputs.make_weights(cfg, 7, "cpu", False)
    assert inputs.digest(w1) == inputs.digest(w2)
    assert inputs.digest(inputs.make_weights(cfg, 8, "cpu", False)) != \
        inputs.digest(w1)


def test_serving_originals():
    c = spec.load_cell("sipmaskpp.serve")
    tr = dict(c.traffic, pool=2)
    imgs = inputs.serve_originals(tr, 99, "cpu")
    assert len(imgs) == 2 and len(imgs[0]) == tr["batch"]
    for batch in imgs:
        assert sorted(im.shape[:2] for im in batch) == sorted(
            tuple(s) for s in tr["original_sizes"])
        assert all(im.dtype == np.uint8 for im in batch)
    again = inputs.serve_originals(tr, 99, "cpu")
    assert all(np.array_equal(x, y) for x, y in zip(imgs[0], again[0]))
