"""The port's soft-NMS (sipmask_tpu_torch/ops/nms.py) against the JAX
package's and the reference's soft_nms_cpu kernel (transcribed in numpy by
``reference_loader.soft_nms_cpu_oracle``): ``soft_nms`` and the soft path
of ``multiclass_nms_idx``, linear and gaussian, on seeded scenes."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reference_loader import soft_nms_cpu_oracle
from sipmask_tpu.ops import nms as j_nms
from sipmask_tpu_torch.ops import nms


def _dets(seed, n=60):
    """The JAX package's soft-NMS parity scene: (n, 5) boxes and scores."""
    r = np.random.RandomState(seed)
    x1 = r.uniform(0, 80, n).astype(np.float32)
    y1 = r.uniform(0, 80, n).astype(np.float32)
    wb = r.uniform(5, 40, n).astype(np.float32)
    hb = r.uniform(5, 40, n).astype(np.float32)
    scores = r.uniform(0.05, 1.0, n).astype(np.float32)
    return np.stack([x1, y1, x1 + wb, y1 + hb, scores], 1)


def _scene(seed, n, c, hot=4):
    """Boxes in 12 tight clusters of similar sizes, so that picks decay
    their neighbours (IoU mostly above 0.5), scores of ``hot`` classes in
    [0.2, 1] and of the others below 0.12, and score factors: the top of
    the decayed candidates competes with the undecayed ones, over several
    waves."""
    r = np.random.RandomState(seed)
    centers = r.uniform(40, 300, (12, 2)).astype(np.float32)
    k = r.randint(0, 12, n)
    cx = centers[k, 0] + r.normal(0, 4, n).astype(np.float32)
    cy = centers[k, 1] + r.normal(0, 4, n).astype(np.float32)
    wb = r.uniform(40, 50, n).astype(np.float32)
    hb = r.uniform(40, 50, n).astype(np.float32)
    boxes = np.stack([cx - wb / 2, cy - hb / 2, cx + wb / 2, cy + hb / 2], 1)
    scores = r.uniform(0, 1, (n, c)).astype(np.float32) ** 2 * 0.12
    cols = r.choice(c, hot, replace=False)
    scores[:, cols] = r.uniform(0.2, 1, (n, hot)).astype(np.float32)
    factors = r.uniform(0.3, 1.0, n).astype(np.float32)
    return boxes, scores, factors


def _check_same(got, want, rtol=1e-6):
    """idxs, labels and valid equal; scores within ``rtol``."""
    want = {k: np.asarray(v) for k, v in want.items()}
    v = want["valid"]
    assert v.sum() > 0
    np.testing.assert_array_equal(got["valid"].numpy(), v)
    np.testing.assert_array_equal(got["idxs"].numpy(), want["idxs"])
    np.testing.assert_array_equal(got["labels"].numpy(), want["labels"])
    np.testing.assert_allclose(got["scores"].numpy(), want["scores"],
                               rtol=rtol, atol=0)
    np.testing.assert_array_equal(got["boxes"].numpy(), want["boxes"])


@pytest.mark.parametrize("method", ["linear", "gaussian"])
def test_soft_nms_matches_jax_and_the_cpu_kernel(method):
    """Every pick, index and decayed score as JAX's ``soft_nms``; the pick
    order and scores as the reference kernel's for as many picks as both
    make (JAX's own parity test's bounds)."""
    for seed in range(4):
        dets = _dets(seed)
        got = nms.soft_nms(torch.from_numpy(dets[:, :4]),
                           torch.from_numpy(dets[:, 4]), iou_thr=0.3,
                           max_out=len(dets), method=method)
        want = j_nms.soft_nms(jnp.asarray(dets[:, :4]),
                              jnp.asarray(dets[:, 4]), iou_thr=0.3,
                              max_out=len(dets), method=method)
        keep, ks, valid = (t.numpy() for t in got)
        np.testing.assert_array_equal(valid, np.asarray(want[2]))
        np.testing.assert_array_equal(keep, np.asarray(want[0]))
        np.testing.assert_allclose(ks[valid], np.asarray(want[1])[valid],
                                   rtol=1e-6, atol=0)
        oracle, inds = soft_nms_cpu_oracle(dets, iou_thr=0.3, method=method)
        m = min(int(valid.sum()), len(inds))
        assert m > 5
        np.testing.assert_array_equal(keep[:m], inds[:m])
        np.testing.assert_allclose(ks[:m], oracle[:m, 4], rtol=2e-5,
                                   atol=1e-6)


def test_soft_nms_within_classes_matches_jax():
    """``class_ids``: a pick decays only the boxes of its own class."""
    dets = _dets(7, 80)
    cls = np.random.RandomState(7).randint(0, 3, 80)
    got = nms.soft_nms(torch.from_numpy(dets[:, :4]),
                       torch.from_numpy(dets[:, 4]), iou_thr=0.3, max_out=50,
                       class_ids=torch.from_numpy(cls))
    want = j_nms.soft_nms(jnp.asarray(dets[:, :4]), jnp.asarray(dets[:, 4]),
                          iou_thr=0.3, max_out=50,
                          class_ids=jnp.asarray(cls))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                               rtol=1e-6, atol=0)


@pytest.mark.parametrize("method", ["linear", "gaussian"])
def test_multiclass_soft_nms_matches_jax(method):
    """N = 1000, C = 80, with score factors: the uncapped wave-batched
    per-class soft-NMS keeps JAX's detections (idxs and labels equal,
    scores within 1e-6 relative), decayed ones among them."""
    boxes, scores, factors = _scene(3, 1000, 80)
    args = dict(score_thr=0.05, iou_thr=0.5, max_per_img=100,
                nms_type="soft_nms", soft_method=method)
    got = nms.multiclass_nms_idx(torch.from_numpy(boxes),
                                 torch.from_numpy(scores),
                                 score_factors=torch.from_numpy(factors),
                                 **args)
    want = j_nms.multiclass_nms_idx(jnp.asarray(boxes), jnp.asarray(scores),
                                    score_factors=jnp.asarray(factors),
                                    **args)
    assert int(got["valid"].sum()) == 100
    idx, lab = got["idxs"].numpy(), got["labels"].numpy()
    assert (got["scores"].numpy() < scores[idx, lab] * factors[idx]).any()
    _check_same(got, want)


@pytest.mark.parametrize("method", ["linear", "gaussian"])
def test_multiclass_soft_nms_matches_the_cpu_kernel_per_class(method):
    """The reference's composition by hand: per class, the raw-score
    threshold, the score factors, soft_nms_cpu; all classes' picks sorted
    by decayed score, the top max_per_img. Same (row, class) set, scores
    to JAX's own parity bounds."""
    n_cls, score_thr, max_out = 5, 0.05, 60
    boxes, scores, factors = _scene(11, 300, n_cls, hot=3)
    want = []
    for ci in range(n_cls):
        sel = np.nonzero(scores[:, ci] > score_thr)[0]
        dets = np.concatenate([boxes[sel], (scores[sel, ci] * factors[sel])
                               [:, None]], 1)
        out, inds = soft_nms_cpu_oracle(dets, iou_thr=0.5, method=method)
        want += [(out[k, 4], sel[int(inds[k])], ci) for k in range(len(out))]
    want = sorted(want, key=lambda w: -w[0])[:max_out]
    got = nms.multiclass_nms_idx(
        torch.from_numpy(boxes), torch.from_numpy(scores), score_thr, 0.5,
        max_out, score_factors=torch.from_numpy(factors),
        nms_type="soft_nms", soft_method=method)
    v = got["valid"].numpy()
    assert v.sum() == len(want) > 30
    np.testing.assert_allclose(got["scores"].numpy()[v],
                               [w[0] for w in want], rtol=3e-5, atol=1e-6)
    assert set(zip(got["idxs"].numpy()[v].tolist(),
                   got["labels"].numpy()[v].tolist())) == \
        {(int(w[1]), w[2]) for w in want}


def test_multiclass_soft_nms_ties_go_to_the_lower_index():
    """Scores on a coarse grid tie within and across classes, and boxes
    repeat: the picks and the global order follow JAX's lower-index-first
    rule (its top_k and argmax)."""
    r = np.random.RandomState(4)
    n, c = 200, 6
    base = _scene(4, n // 4, c)[0].round()
    boxes = np.concatenate([base] * 4)          # each box four times
    scores = (r.randint(1, 8, (n, c)) / 8).astype(np.float32)
    for method in ("linear", "gaussian"):
        args = dict(score_thr=0.1, iou_thr=0.5, max_per_img=100,
                    nms_type="soft_nms", soft_method=method)
        got = nms.multiclass_nms_idx(torch.from_numpy(boxes),
                                     torch.from_numpy(scores), **args)
        want = j_nms.multiclass_nms_idx(jnp.asarray(boxes),
                                        jnp.asarray(scores), **args)
        _check_same(got, want)


def test_multiclass_nms_idx_refuses_an_unknown_nms_type():
    boxes, scores, _ = _scene(0, 20, 3, hot=1)
    with pytest.raises(ValueError, match="nms_type"):
        nms.multiclass_nms_idx(torch.from_numpy(boxes),
                               torch.from_numpy(scores), 0.05, 0.5, 10,
                               nms_type="matrix_nms")
