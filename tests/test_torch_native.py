"""The port's C++ mask codec (sipmask_tpu_torch/native) against the JAX
package's C++ library (sipmask_tpu.native) and numpy codec
(sipmask_tpu.eval.rle), and against the port's own plain versions
(eval/rle.py, eval/maskops.py's ``*_plain``): counts byte for byte, areas,
IoUs (crowd included), intersections and greedy matches exactly; and where
the library is built."""

import hashlib
import shutil

import numpy as np
import pytest

from sipmask_tpu import native as j_native
from sipmask_tpu.eval import rle as j_rle
from sipmask_tpu_torch import native
from sipmask_tpu_torch.eval import maskops, rle

SHAPES = [(1, 1), (7, 13), (480, 640)]


def _masks(h, w, seed, n=4):
    """Empty, full, noise and blobs (rectangles) of one shape, uint8."""
    rng = np.random.RandomState(seed)
    out = [np.zeros((h, w), np.uint8), np.ones((h, w), np.uint8),
           (rng.rand(h, w) > 0.5).astype(np.uint8)]
    for _ in range(n):
        m = np.zeros((h, w), np.uint8)
        for _ in range(3):
            y0, x0 = rng.randint(0, h), rng.randint(0, w)
            m[y0:y0 + rng.randint(1, h + 1), x0:x0 + rng.randint(1, w + 1)] = 1
        out.append(m)
    return np.stack(out)


@pytest.mark.parametrize("hw", SHAPES, ids=["1x1", "7x13", "480x640"])
def test_counts_are_byte_identical(hw):
    masks = _masks(*hw, seed=hw[1])
    got = native.encode_masks(masks)
    assert got == [native.encode_mask(m) for m in masks]
    assert native.encode_masks(masks.astype(bool)) == got
    for m, g in zip(masks, got):
        assert g == j_native.encode_mask(m) == j_rle.encode_mask(m) == \
            rle.encode_mask(m)
        np.testing.assert_array_equal(native.decode_mask(g), m)
        area = native.rle_area(g)
        assert area == j_native.rle_area(g) == rle.rle_area(g) == m.sum()
        # counts as str and as a list of runs decode the same
        runs = rle.decode_counts(g["counts"])
        for counts in (g["counts"].decode(), runs.tolist()):
            np.testing.assert_array_equal(
                native.decode_mask({"size": list(hw), "counts": counts}), m)


@pytest.mark.parametrize("hw", SHAPES + [(5, 3), (33, 17)],
                         ids=["1x1", "7x13", "480x640", "5x3", "33x17"])
def test_the_column_major_encoder_gives_the_same_bytes(hw):
    """``encode_masks_t`` on the masks' transposes (its 8-byte steps, the
    tails of sizes that are no multiple of 8, runs that start and end
    inside a step, any non-zero byte as a one) gives ``encode_masks``'s
    bytes."""
    masks = _masks(*hw, seed=3 + hw[0])
    want = native.encode_masks(masks)
    assert want == [j_native.encode_mask(m) for m in masks]
    rng = np.random.RandomState(hw[1])
    for m in (masks, masks.astype(bool),
              masks * rng.randint(1, 256, masks.shape).astype(np.uint8)):
        got = native.encode_masks_t(np.ascontiguousarray(
            np.swapaxes(m, 1, 2)))
        assert got == want
    assert native.encode_masks_t(np.zeros((0, 4, 3), np.uint8)) == []


@pytest.mark.parametrize("hw", SHAPES, ids=["1x1", "7x13", "480x640"])
def test_ious_intersections_and_crowd_are_exact(hw):
    dts = [native.encode_mask(m) for m in _masks(*hw, seed=1)]
    gts = [native.encode_mask(m) for m in _masks(*hw, seed=2, n=2)]
    crowd = np.arange(len(gts)) % 2 == 1
    got = native.iou_matrix(dts, gts, crowd)
    want = j_native.iou_matrix(dts, gts, crowd)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, maskops.iou_matrix_plain(dts, gts,
                                                                crowd))
    np.testing.assert_array_equal(native.iou_matrix(dts, gts),
                                  j_native.iou_matrix(dts, gts))
    inter = native.inter_matrix(dts, gts)
    np.testing.assert_array_equal(inter, j_native.inter_matrix(dts, gts))
    np.testing.assert_array_equal(inter, maskops.inter_matrix_plain(dts, gts))
    # a crowd gt divides by the detection's area alone
    d_area = np.asarray([native.rle_area(r) for r in dts], np.float64)
    np.testing.assert_array_equal(
        got[:, crowd], np.where(d_area[:, None] > 0,
                                inter[:, crowd] / np.maximum(d_area[:, None],
                                                             1), 0.0))


def test_empty_inputs():
    one = [native.encode_mask(np.ones((3, 4), np.uint8))]
    for fn in (native.iou_matrix, native.inter_matrix):
        assert fn([], one).shape == (0, 1)
        assert fn(one, []).shape == (1, 0)
    assert native.encode_masks(np.zeros((0, 5, 6), np.uint8)) == []
    dtm, dt_ig = native.greedy_match(np.zeros((3, 0)), np.array([0.5]),
                                     np.zeros(0), np.zeros(0))
    assert dtm.shape == dt_ig.shape == (1, 3) and not dtm.any()


@pytest.mark.parametrize("seed", range(3))
def test_greedy_match_is_exact(seed):
    """COCOeval's matching over the ten thresholds, gts sorted ignore-last,
    crowd gts matchable again: C++ as the JAX package's and as Python
    loops."""
    from sipmask_tpu_torch.eval.coco_eval import IOU_THRS
    rng = np.random.RandomState(seed)
    n_dt, n_gt = 30, 12
    ious = rng.rand(n_dt, n_gt) * (rng.rand(n_dt, n_gt) > 0.4)
    ious[:, :3] = np.round(ious[:, :3], 1)       # ties at the thresholds
    gt_ig = np.sort(rng.rand(n_gt) > 0.7).astype(np.uint8)
    crowd = (rng.rand(n_gt) > 0.8).astype(np.uint8)
    got = native.greedy_match(ious, IOU_THRS, gt_ig, crowd)
    for want in (j_native.greedy_match(ious, IOU_THRS, gt_ig, crowd),
                 maskops.greedy_match_plain(ious, IOU_THRS, gt_ig, crowd)):
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    assert got[0].any() and got[1].any()


def test_the_library_is_the_ports_own_build():
    """Loaded from build/native/maskops-<hash of the source and flags>.so
    beside the package, built from sipmask_tpu_torch/native/maskops.cpp and
    not the JAX package's library; the public eval functions are its."""
    path = native.library_path()
    digest = hashlib.sha1(native.SRC.read_bytes()
                          + " ".join(native.CXX_FLAGS).encode()).hexdigest()
    assert path.parent == native.SRC.parents[2] / "build" / "native"
    assert path.name == f"maskops-{digest[:12]}.so"
    assert native.SRC.parent.name == "native" and \
        native.SRC.parents[1].name == "sipmask_tpu_torch"
    assert native.available()
    assert maskops.iou_matrix is native.iou_matrix
    assert maskops.greedy_match is native.greedy_match
    assert maskops.encode_masks is native.encode_masks
    assert maskops.encode_masks_t is native.encode_masks_t


def test_a_changed_source_builds_under_a_new_hash(tmp_path):
    src = tmp_path / "maskops.cpp"
    shutil.copy(native.SRC, src)
    same = native.build(src, tmp_path / "out")
    assert same.name == native.library_path().name
    src.write_bytes(src.read_bytes() + b"\n// another build\n")
    other = native.build(src, tmp_path / "out")
    assert other.name != same.name and other.exists() and same.exists()
    assert native.build(src, tmp_path / "out") == other   # cached
    src.write_text("this is not C++")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.build(src, tmp_path / "out")
