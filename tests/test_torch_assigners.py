"""The port's MaxIoU assigner, random sampler (sipmask_tpu_torch/core/
assigners.py) and the losses outside the training paths (bounded IoU, BCE
on probabilities, summed MSE) against the JAX package's, on the CPU.

The assignments are equal, padded gts, ties and the low-quality overrides
included. ``random_sample``'s picks are equal when the port is given JAX's
priorities (``jax.random``'s bits cannot be drawn in torch); drawn from a
``torch.Generator`` they keep the caps, are valid and disjoint. The losses
agree within 1e-6 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sipmask_tpu.core import assigners as jassign
from sipmask_tpu.core import losses as jlosses
from sipmask_tpu_torch.core import assigners, losses

T = torch.from_numpy


def _boxes(seed=0):
    """Gts (5 slots: gt 3 duplicates gt 1, gt 4 is a tiny box, the last
    slot padded) and boxes around them: jittered copies, exact copies (IoU
    ties between gts 1 and 3), far boxes and boxes of middling overlap."""
    rng = np.random.RandomState(seed)
    gts = np.array([[10, 10, 50, 60], [70, 20, 120, 90], [30, 80, 90, 130],
                    [70, 20, 120, 90], [140, 140, 142, 141],
                    [0, 0, 0, 0]], np.float32)
    valid = np.array([1, 1, 1, 1, 1, 0], bool)
    jit = gts[rng.randint(0, 4, 40)] + rng.randn(40, 4).astype(
        np.float32) * 8
    far = rng.uniform(200, 300, (10, 2)).astype(np.float32)
    far = np.concatenate([far, far + 20], 1)
    mid = gts[:3] + np.array([12, 0, 12, 0], np.float32)
    boxes = np.concatenate([jit, gts[:4], far, mid, gts[4:5] + 30])
    boxes[:, 2:] = np.maximum(boxes[:, 2:], boxes[:, :2] + 1)
    labels = np.array([3, 7, 2, 5, 1, 9], np.int32)
    return boxes.astype(np.float32), gts, labels, valid


ASSIGN_CASES = {"default": dict(),
                "strict": dict(pos_iou_thr=0.7, neg_iou_thr=0.3,
                               min_pos_iou=0.3),
                "no_low_quality": dict(match_low_quality=False)}


@pytest.mark.parametrize("case", list(ASSIGN_CASES))
@pytest.mark.parametrize("padded", [False, True])
def test_max_iou_assign_equals_jax(case, padded):
    boxes, gts, labels, valid = _boxes()
    if padded:
        valid = np.zeros_like(valid)
    kw = ASSIGN_CASES[case]
    want = jassign.max_iou_assign(jnp.asarray(boxes), jnp.asarray(gts),
                                  jnp.asarray(labels), jnp.asarray(valid),
                                  **kw)
    got = assigners.max_iou_assign(T(boxes), T(gts), T(labels), T(valid),
                                   **kw)
    np.testing.assert_array_equal(got.gt_inds.numpy(),
                                  np.asarray(want.gt_inds))
    np.testing.assert_array_equal(got.labels.numpy(),
                                  np.asarray(want.labels))
    np.testing.assert_allclose(got.max_overlaps.numpy(),
                               np.asarray(want.max_overlaps), rtol=1e-6,
                               atol=1e-7)
    assert got.gt_inds.dtype == got.labels.dtype == torch.int32
    inds = got.gt_inds.numpy()
    if padded:
        assert (inds == -1).all()
    else:
        assert (inds == 0).any() and (inds == -1).any()
        # the copy of gt 1 (box 41) ties gts 1 and 3 (IoU 1): the box
        # takes the first, the low-quality pass the last
        assert inds[41] == (4 if kw.get("match_low_quality", True) else 2)


def test_random_sample_equals_jax_given_its_priorities():
    boxes, gts, labels, valid = _boxes(1)
    want_a = jassign.max_iou_assign(jnp.asarray(boxes), jnp.asarray(gts),
                                    jnp.asarray(labels), jnp.asarray(valid))
    got_a = assigners.max_iou_assign(T(boxes), T(gts), T(labels), T(valid))
    n = boxes.shape[0]
    for key, num, frac in ((0, 16, 0.5), (3, 40, 0.25), (5, 200, 0.5)):
        k = jax.random.PRNGKey(key)
        want = jassign.random_sample(want_a, k, num=num, pos_fraction=frac)
        kp, kn = jax.random.split(k)
        prio = [T(np.asarray(jax.random.uniform(kk, (n,)))) for kk in (kp,
                                                                      kn)]
        got = assigners.sample_by_priority(got_a, *prio, num=num,
                                           pos_fraction=frac)
        for f in got._fields:
            np.testing.assert_array_equal(getattr(got, f).numpy(),
                                          np.asarray(getattr(want, f)),
                                          err_msg=f"{key} {f}")


def test_random_sample_from_a_generator_keeps_caps_and_disjoint_sets():
    boxes, gts, labels, valid = _boxes(2)
    a = assigners.max_iou_assign(T(boxes), T(gts), T(labels), T(valid))
    inds = a.gt_inds.numpy()
    n_pos, n_neg = int((inds > 0).sum()), int((inds == 0).sum())
    gen = torch.Generator().manual_seed(0)
    draws = []
    for num, frac in ((8, 0.5), (64, 0.25), (256, 0.5)):
        s = assigners.random_sample(a, gen, num=num, pos_fraction=frac)
        cap, n = int(num * frac), len(inds)
        # as in JAX, a cap above the box count gives a slot a box
        assert s.pos_inds.shape == (min(cap, n),)
        assert s.neg_inds.shape == (min(num - cap, n),)
        assert int(s.pos_valid.sum()) == min(cap, n_pos)
        assert int(s.neg_valid.sum()) == min(num - cap, n_neg)
        pos = s.pos_inds.numpy()[s.pos_valid.numpy()]
        neg = s.neg_inds.numpy()[s.neg_valid.numpy()]
        assert (inds[pos] > 0).all() and (inds[neg] == 0).all()
        assert len(set(pos)) == len(pos) and len(set(neg)) == len(neg)
        assert not set(pos) & set(neg)
        assert (s.pos_inds.numpy()[~s.pos_valid.numpy()] == -1).all()
        assert (s.neg_inds.numpy()[~s.neg_valid.numpy()] == -1).all()
        draws.append(neg)
    # a draw below the count available picks a subset that moves
    s2 = assigners.random_sample(a, gen, num=8, pos_fraction=0.5)
    assert not np.array_equal(np.sort(draws[0]),
                              np.sort(s2.neg_inds.numpy()))


def test_losses_match_jax():
    rng = np.random.RandomState(3)
    t = rng.uniform(0, 80, (50, 4)).astype(np.float32)
    t[:, 2:] += t[:, :2] + 2
    p = (t + rng.randn(50, 4) * 6).astype(np.float32)
    p[:3] = t[:3]                                  # exact: zero deltas
    w = rng.rand(50).astype(np.float32)
    for kw in ({}, {"weight": w, "avg_factor": 7.0}):
        want = jlosses.bounded_iou_loss(
            jnp.asarray(p), jnp.asarray(t),
            **{k: (jnp.asarray(v) if k == "weight" else v)
               for k, v in kw.items()})
        got = losses.bounded_iou_loss(
            T(p), T(t), **{k: (T(v) if k == "weight" else v)
                           for k, v in kw.items()})
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    probs = rng.rand(64).astype(np.float32)
    probs[:4] = [0.0, 1.0, 1e-30, 1 - 1e-8]         # the -100 clamps
    targets = rng.rand(64).astype(np.float32)
    targets[:4] = [1.0, 0.0, 1.0, 0.0]
    want = np.asarray(jlosses.binary_cross_entropy(jnp.asarray(probs),
                                                   jnp.asarray(targets)))
    got = losses.binary_cross_entropy(T(probs), T(targets)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert got[0] == got[1] == 100.0
    a, b = rng.randn(2, 30).astype(np.float32)
    for wt in (None, w[:30]):
        want = jlosses.mse_sum(jnp.asarray(a), jnp.asarray(b),
                               None if wt is None else jnp.asarray(wt))
        got = losses.mse_sum(T(a), T(b), None if wt is None else T(wt))
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
