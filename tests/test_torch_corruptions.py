"""The port's corruption suite (``sipmask_tpu_torch/data/corruptions.py``
and the cv2 routines of ``data/imgops.py`` it runs on) against the JAX
package's ``sipmask_tpu/data/corruptions.py``, which runs cv2: every
corruption at every severity on a 37x53 and a 64x96 BGR image, byte for
byte, except where cv2's float code takes an order or a scalar tail the
port does not reproduce (``FLOAT_ROUTES``, each with its bound); and each
cv2 routine on its own."""

import cv2
import numpy as np
import pytest

from sipmask_tpu.data import corruptions as J
from sipmask_tpu_torch.data import corruptions as P
from sipmask_tpu_torch.data import imgops

NAMES = sorted(J.CORRUPTIONS) + sorted(J.EXTRA_CORRUPTIONS)
SHAPES = [(37, 53, 3), (64, 96, 3)]
# cv2's float routes: motion_blur's float warpAffine of its line kernel
# (the last w % 16 pixels of a row, which cv2's vectors do not cover) and
# its filter2D; frost's INTER_CUBIC. A level apart on at most this share of
# an image's bytes (1 byte of 5883 at 37x53 seen).
FLOAT_ROUTES = {"motion_blur": 1e-3, "frost": 1e-3}


def _image(shape):
    return np.random.RandomState(shape[0] * 7 + shape[1]).randint(
        0, 256, shape).astype(np.uint8)


def test_the_port_has_the_jax_packages_corruptions():
    assert sorted(P.CORRUPTIONS) == sorted(J.CORRUPTIONS)
    assert sorted(P.EXTRA_CORRUPTIONS) == sorted(J.EXTRA_CORRUPTIONS)


@pytest.mark.parametrize("shape", SHAPES, ids=["37x53", "64x96"])
@pytest.mark.parametrize("name", NAMES)
def test_corrupt_matches_the_jax_package(name, shape):
    img = _image(shape)
    for severity in range(1, 6):
        want = J.corrupt(img, name, severity)
        got = P.corrupt(img, name, severity)
        assert got.dtype == np.uint8 and got.shape == img.shape
        diff = np.abs(got.astype(np.int16) - want)
        if name not in FLOAT_ROUTES:
            assert diff.max() == 0, (name, severity, int((diff > 0).sum()))
            continue
        assert diff.max() <= 1, (name, severity)
        assert (diff > 0).mean() <= FLOAT_ROUTES[name], (name, severity)


def test_unknown_corruption_names_it():
    with pytest.raises(KeyError, match="no_such_thing"):
        P.corrupt(_image(SHAPES[0]), "no_such_thing", 1)


@pytest.mark.parametrize("sigma", [0.7, 0.9, 1.1, 1.5, 2, 3, 4, 6])
def test_gaussian_blur_u8_is_cv2s(sigma):
    img = _image((41, 67, 3))
    np.testing.assert_array_equal(imgops.gaussian_blur_u8(img, sigma),
                                  cv2.GaussianBlur(img, (0, 0), sigma))


@pytest.mark.parametrize("sigma", [0.296, 0.512, 0.8, 2, 3, 4])
def test_gaussian_blur_f32_is_cv2s(sigma):
    """Kernels of 3, 5, 7 and more taps (cv2's two small filters and its
    general one), at widths whose rows end in cv2's scalar code: bit for
    bit, but for at most 2 values an image in the last columns, each
    within an ulp of 1 (the inputs' scale) of cv2's (seen: 2 of 1961 at
    37x53 with 7 taps)."""
    rng = np.random.RandomState(7)
    for h, w in [(37, 53), (30, 61), (40, 64), (33, 45)]:
        x = rng.rand(h, w).astype(np.float32) * 2 - 1
        got = imgops.gaussian_blur_f32(x, sigma)
        want = cv2.GaussianBlur(x, (0, 0), sigma)
        apart = np.argwhere(got != want)
        assert len(apart) <= 2 and (apart[:, 1] >= w - 8).all(), apart
        assert np.abs(got - want).max() <= np.spacing(np.float32(1))


def test_hsv_u8_is_cv2s_over_every_colour():
    """BGR -> HSV on random pixels, HSV -> BGR on every (h, s, v) with h
    below 180 (every fifth v), in rows of 40: 32 pixels in cv2's vector
    blocks, 8 in its scalar tail."""
    img = _image((64, 80, 3))
    np.testing.assert_array_equal(imgops.bgr_to_hsv_u8(img),
                                  cv2.cvtColor(img, cv2.COLOR_BGR2HSV))
    h, s, v = np.meshgrid(np.arange(180), np.arange(256), np.arange(0, 256, 5),
                          indexing="ij")
    hsv = np.stack([h, s, v], -1).reshape(-1, 40, 3).astype(np.uint8)
    np.testing.assert_array_equal(imgops.hsv_to_bgr_u8(hsv),
                                  cv2.cvtColor(hsv, cv2.COLOR_HSV2BGR))


def test_remap_area_and_circle_are_cv2s():
    rng = np.random.RandomState(2)
    img = _image((48, 64, 3))
    mx = (np.arange(64)[None] + rng.randn(48, 64) * 3).astype(np.float32)
    my = (np.arange(48)[:, None] + rng.randn(48, 64) * 3).astype(np.float32)
    np.testing.assert_array_equal(
        imgops.remap_linear_u8(img, mx, my),
        cv2.remap(img, mx, my, cv2.INTER_LINEAR,
                  borderMode=cv2.BORDER_REFLECT))
    for oh, ow in [(28, 38), (24, 32), (12, 16), (19, 25)]:
        np.testing.assert_array_equal(
            imgops.resize_area_u8(img, oh, ow),
            cv2.resize(img, (ow, oh), interpolation=cv2.INTER_AREA))
    for r in (3, 4, 6, 8, 10):
        want = np.zeros((2 * r + 1,) * 2, np.float32)
        cv2.circle(want, (r, r), r, 1.0, -1)
        got = imgops.fill_circle(np.zeros_like(want), (r, r), r, 1.0)
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("size", [17, 21])
def test_warp_affine_f32_is_cv2s_on_whole_vectors(size):
    """motion_blur's rotated line kernels of 17 and 21 pixels (no row tail
    past cv2's 16-wide vectors), value for value."""
    k = np.zeros((size, size), np.float32)
    k[size // 2, :] = 1.0 / size
    c = (size / 2 - 0.5, size / 2 - 0.5)
    m = cv2.getRotationMatrix2D(c, 45, 1.0)
    np.testing.assert_array_equal(imgops.rotation_matrix_2d(c, 45, 1.0), m)
    np.testing.assert_array_equal(imgops.warp_affine_f32(k, m, (size, size)),
                                  cv2.warpAffine(k, m, (size, size)))
