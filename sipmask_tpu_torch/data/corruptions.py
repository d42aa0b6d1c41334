"""The image corruption suite of the robustness benchmark, the port of
``sipmask_tpu/data/corruptions.py`` without cv2: the 15 corruptions of the
benchmarking-corruptions protocol (Hendrycks & Dietterich 2019) and 3
extras, each at severity 1..5, on uint8 BGR (H, W, 3) images.

The numpy arithmetic is the JAX package's line for line (its content-hash
seed, its float32 / float64 mix, its truncating casts); the cv2 calls are
``imgops``'s equivalents, bit for bit where cv2 computes in integers.
Two float cv2 routes (``frost``'s ``INTER_CUBIC`` and ``motion_blur``'s
``warpAffine`` and ``filter2D``) agree to float rounding, which a
truncation to uint8 may turn into a level on a few pixels; the float
``GaussianBlur`` of ``snow`` and ``elastic_transform`` is cv2's, bit for
bit. ``jpeg_compression`` goes through the
port's JPEG codec (cv2's bytes). ``fog`` resizes bilinearly: the JAX
package passes ``cv2.INTER_CUBIC`` as ``cv2.resize``'s third positional
argument, which is ``dst``, so cv2 takes its default, INTER_LINEAR.
"""

from __future__ import annotations

import numpy as np

from . import image_io
from .imgops import (bgr_to_hsv_u8, filter2d_u8, fill_circle,
                     gaussian_blur_f32, gaussian_blur_u8, hsv_to_bgr_u8,
                     remap_linear_u8, resize_area_u8, resize_bilinear_f32,
                     resize_bilinear_u8, resize_cubic_f32, resize_nearest,
                     rotation_matrix_2d, warp_affine_f32)


def _rng(img):
    # deterministic per-image noise: seed from a cheap content hash
    return np.random.RandomState(int(img[::17, ::23].sum()) % (2 ** 31))


def _as_float(img):
    return img.astype(np.float32) / 255.0


def _to_uint8(x):
    return np.clip(x * 255.0, 0, 255).astype(np.uint8)


# --------------------------------------------------------------- noise
def gaussian_noise(img, severity):
    c = [0.08, 0.12, 0.18, 0.26, 0.38][severity - 1]
    x = _as_float(img)
    return _to_uint8(x + _rng(img).normal(size=x.shape) * c)


def shot_noise(img, severity):
    c = [60, 25, 12, 5, 3][severity - 1]
    x = _as_float(img)
    return _to_uint8(_rng(img).poisson(x * c) / float(c))


def impulse_noise(img, severity):
    c = [0.03, 0.06, 0.09, 0.17, 0.27][severity - 1]
    rng = _rng(img)
    x = _as_float(img).copy()
    m = rng.rand(*x.shape[:2])
    x[m < c / 2] = 0.0
    x[m > 1 - c / 2] = 1.0
    return _to_uint8(x)


def speckle_noise(img, severity):
    c = [0.15, 0.2, 0.35, 0.45, 0.6][severity - 1]
    x = _as_float(img)
    return _to_uint8(x + x * _rng(img).normal(size=x.shape) * c)


# ---------------------------------------------------------------- blur
def gaussian_blur(img, severity):
    c = [1, 2, 3, 4, 6][severity - 1]
    return gaussian_blur_u8(img, c)


def defocus_blur(img, severity):
    radius = [3, 4, 6, 8, 10][severity - 1]
    k = np.zeros((2 * radius + 1, 2 * radius + 1), np.float32)
    fill_circle(k, (radius, radius), radius, 1.0)
    k /= k.sum()
    return filter2d_u8(img, k)


def motion_blur(img, severity):
    size = [9, 13, 17, 21, 25][severity - 1]
    k = np.zeros((size, size), np.float32)
    k[size // 2, :] = 1.0 / size
    m = rotation_matrix_2d((size / 2 - 0.5, size / 2 - 0.5), 45, 1.0)
    k = warp_affine_f32(k, m, (size, size))
    k /= max(k.sum(), 1e-8)
    return filter2d_u8(img, k)


def zoom_blur(img, severity):
    zooms = {1: 1.06, 2: 1.11, 3: 1.16, 4: 1.21, 5: 1.26}[severity]
    h, w = img.shape[:2]
    acc = _as_float(img).copy()
    n = 1
    for z in np.arange(1.01, zooms, 0.01):
        zh, zw = int(np.ceil(h * z)), int(np.ceil(w * z))
        zoomed = resize_bilinear_u8(img, zh, zw)
        top, left = (zh - h) // 2, (zw - w) // 2
        acc += _as_float(zoomed[top:top + h, left:left + w])
        n += 1
    return _to_uint8(acc / n)


def glass_blur(img, severity):
    sigma, max_d, iters = [(0.7, 1, 1), (0.9, 2, 1), (1.0, 2, 2),
                           (1.1, 3, 2), (1.5, 4, 2)][severity - 1]
    x = gaussian_blur_u8(img, sigma)
    h, w = x.shape[:2]
    rng = _rng(img)
    for _ in range(iters):
        dx = rng.randint(-max_d, max_d + 1, (h, w))
        dy = rng.randint(-max_d, max_d + 1, (h, w))
        yy = np.clip(np.arange(h)[:, None] + dy, 0, h - 1)
        xx = np.clip(np.arange(w)[None, :] + dx, 0, w - 1)
        x = x[yy, xx]
    return gaussian_blur_u8(x, sigma)


# ------------------------------------------------------------- weather
def snow(img, severity):
    amt, blur_sig, bright = [(0.05, 2, 0.9), (0.1, 2, 0.85),
                             (0.17, 3, 0.8), (0.25, 3, 0.75),
                             (0.35, 4, 0.7)][severity - 1]
    rng = _rng(img)
    h, w = img.shape[:2]
    layer = (rng.rand(h, w) < amt).astype(np.float32)
    layer = gaussian_blur_f32(layer, blur_sig)
    layer = np.clip(layer * 3.0, 0, 1)[..., None]
    x = _as_float(img) * bright
    return _to_uint8(x * (1 - layer) + layer)


def frost(img, severity):
    # procedural frost: thresholded low-frequency noise crystals
    amt = [0.25, 0.32, 0.4, 0.45, 0.55][severity - 1]
    rng = _rng(img)
    h, w = img.shape[:2]
    n = rng.rand(h // 4 + 1, w // 4 + 1).astype(np.float32)
    n = resize_cubic_f32(n, h, w)
    crystals = np.clip((n - (1 - amt)) / amt, 0, 1)[..., None]
    x = _as_float(img)
    return _to_uint8(x * (1 - 0.6 * crystals) + 0.85 * crystals)


def fog(img, severity):
    amt, decay = [(1.5, 2.0), (2.0, 2.0), (2.5, 1.7),
                  (2.5, 1.5), (3.0, 1.4)][severity - 1]
    rng = _rng(img)
    h, w = img.shape[:2]
    # plasma-like fractal fog via multi-octave smoothed noise
    layer = np.zeros((h, w), np.float32)
    for octv in range(4):
        s = 2 ** (octv + 3)
        n = rng.rand(h // s + 2, w // s + 2).astype(np.float32)
        layer += resize_bilinear_f32(n, h, w) / (decay ** octv)
    layer = (layer - layer.min()) / max(layer.max() - layer.min(), 1e-6)
    x = _as_float(img)
    mx = x.max()
    x = x + amt * 0.3 * layer[..., None]
    return _to_uint8(x * mx / max(x.max(), 1e-6))


def brightness(img, severity):
    c = [0.1, 0.2, 0.3, 0.4, 0.5][severity - 1]
    hsv = bgr_to_hsv_u8(img).astype(np.float32)
    hsv[..., 2] = np.clip(hsv[..., 2] + c * 255, 0, 255)
    return hsv_to_bgr_u8(hsv.astype(np.uint8))


def contrast(img, severity):
    c = [0.4, 0.3, 0.2, 0.1, 0.05][severity - 1]
    x = _as_float(img)
    means = x.mean((0, 1), keepdims=True)
    return _to_uint8((x - means) * c + means)


# -------------------------------------------------------------- digital
def elastic_transform(img, severity):
    alpha, sigma = [(2, 0.8), (3, 0.7), (4, 0.6),
                    (5, 0.5), (6, 0.4)][severity - 1]
    rng = _rng(img)
    h, w = img.shape[:2]
    scale = min(h, w) * 0.01
    dx = gaussian_blur_f32((rng.rand(h, w).astype(np.float32) * 2 - 1),
                           sigma * scale) * alpha * scale
    dy = gaussian_blur_f32((rng.rand(h, w).astype(np.float32) * 2 - 1),
                           sigma * scale) * alpha * scale
    mx = (np.arange(w)[None, :] + dx).astype(np.float32)
    my = (np.arange(h)[:, None] + dy).astype(np.float32)
    return remap_linear_u8(img, mx, my)


def pixelate(img, severity):
    c = [0.6, 0.5, 0.4, 0.3, 0.25][severity - 1]
    h, w = img.shape[:2]
    small = resize_area_u8(img, max(int(h * c), 1), max(int(w * c), 1))
    return resize_nearest(small, h, w)


def jpeg_compression(img, severity):
    q = [25, 18, 15, 10, 7][severity - 1]
    return image_io.imdecode(image_io.imencode_jpeg(img, q))


def saturate(img, severity):
    c, shift = [(0.3, 0), (0.1, 0), (2.0, 0), (5.0, 0.1),
                (20.0, 0.2)][severity - 1]
    hsv = bgr_to_hsv_u8(img).astype(np.float32)
    hsv[..., 1] = np.clip(hsv[..., 1] * c + shift * 255, 0, 255)
    return hsv_to_bgr_u8(hsv.astype(np.uint8))


# the benchmark's canonical 15 + 3 extras (the reference test_robustness.py
# 'benchmark'/'all' corruption sets)
CORRUPTIONS = {
    "gaussian_noise": gaussian_noise,
    "shot_noise": shot_noise,
    "impulse_noise": impulse_noise,
    "defocus_blur": defocus_blur,
    "glass_blur": glass_blur,
    "motion_blur": motion_blur,
    "zoom_blur": zoom_blur,
    "snow": snow,
    "frost": frost,
    "fog": fog,
    "brightness": brightness,
    "contrast": contrast,
    "elastic_transform": elastic_transform,
    "pixelate": pixelate,
    "jpeg_compression": jpeg_compression,
}
EXTRA_CORRUPTIONS = {
    "speckle_noise": speckle_noise,
    "gaussian_blur": gaussian_blur,
    "saturate": saturate,
}


def corrupt(img: np.ndarray, name: str, severity: int) -> np.ndarray:
    """Apply corruption ``name`` at ``severity`` (1..5) to a BGR uint8
    image."""
    assert 1 <= severity <= 5, severity
    fn = CORRUPTIONS.get(name) or EXTRA_CORRUPTIONS.get(name)
    if fn is None:
        raise KeyError(f"unknown corruption {name!r}; known: "
                       f"{sorted(CORRUPTIONS) + sorted(EXTRA_CORRUPTIONS)}")
    out = fn(img, severity)
    assert out.shape == img.shape and out.dtype == np.uint8
    return out
