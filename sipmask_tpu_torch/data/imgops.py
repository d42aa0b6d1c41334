"""Image operations of the data pipeline in numpy, each giving OpenCV's
numbers: the port reads no cv2, and its batches must equal the JAX
package's, which resizes and rasterizes with cv2.

- ``resize_bilinear_u8``: ``cv2.resize(img, (w, h), INTER_LINEAR)`` on uint8
  images, bit for bit: cv2's 11-bit fixed-point coefficients and the
  rounding of its vectorised vertical pass, in int32.
- ``resize_bilinear_f32``: the same on float32 (cv2's float path), with
  cv2's ``fx`` / ``fy`` form for the mask paste.
- ``resize_nearest``: ``INTER_NEAREST``.
- ``downsample2x_mask``: an exact 2x bilinear reduction followed by > 0.5,
  which cv2 runs as INTER_AREA, the 2x2 mean.
- ``fill_polygons``: ``cv2.fillPoly(mask, pts, 1)`` with integer points: the
  scanline fill of cv2's edge table plus every edge drawn as an 8-connected
  line.
- ``bgr_to_hsv_f32`` / ``hsv_to_bgr_f32``: ``cv2.cvtColor`` between BGR and
  HSV on float32 images (H in degrees, S unclipped, V in the input's
  scale), bit for bit.

The corruption suite (``corruptions.py``) takes these, each named after
the cv2 call it stands for:

- ``gaussian_blur_u8``: ``cv2.GaussianBlur(img, (0, 0), sigma)`` on uint8,
  bit for bit: cv2's 8.8 fixed-point kernel (its error-diffusion rounding),
  a horizontal pass into 8.8 sums, a vertical one into 16.16, reflect-101
  borders.
- ``gaussian_blur_f32``: the same on float32 images, bit for bit at the
  corruptions' sizes: cv2's float kernel, its separable passes as its
  vector code (fused multiply-adds) and its scalar row tails compute them.
- ``filter2d_u8``: ``cv2.filter2D(img, -1, kernel)`` with a float kernel:
  a correlation in float64 with reflect-101 borders, rounded.
- ``fill_circle``: ``cv2.circle(img, center, radius, color, -1)``.
- ``rotation_matrix_2d`` and ``warp_affine_f32``: ``cv2.getRotationMatrix2D``
  and ``cv2.warpAffine`` (bilinear, zero border) on float32, cv2's vector
  arithmetic (its rows' scalar tails may lie an ulp away).
- ``resize_cubic_f32``: ``INTER_CUBIC`` on float32 (cv2's A = -0.75
  weights in float32, edge pixels repeated).
- ``resize_area_u8``: ``INTER_AREA`` downscaling of uint8 images: cv2's
  integer path at whole scales and its float area weights otherwise.
- ``bgr_to_hsv_u8`` / ``hsv_to_bgr_u8``: ``cv2.cvtColor`` between BGR and
  HSV (H in [0, 180)) on uint8, bit for bit: the fixed-point division
  tables one way, float sectors the other.
- ``remap_linear_u8``: ``cv2.remap(img, mx, my, INTER_LINEAR,
  borderMode=BORDER_REFLECT)`` with float32 maps: cv2's float blends,
  rounded.

Every function works on whole rows or whole edges at once; none loops over
pixels.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

_COEF_BITS = 11
_COEF_SCALE = 1 << _COEF_BITS
_XY_SHIFT = 16


def _linear_map(src: int, dst: int, scale: float, clamp: bool,
                fixed: bool) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """cv2's bilinear source map along one axis: (s0, s1, f) with s0, s1
    the two source indices and f (float32) the weight of s1. ``scale`` is
    cv2's src/dst ratio (the inverse of its fx). The fixed-point (uint8)
    path rounds the source coordinate to float32 before it takes the
    fraction; the float path takes the fraction in float64 and rounds that.
    Columns (``clamp``) take cv2's edge rule: outside the source, the weight
    moves to the edge pixel; rows keep f and clamp only the indices."""
    v = (np.arange(dst, dtype=np.float64) + 0.5) * scale - 0.5
    if fixed:
        v = v.astype(np.float32)
    s = np.floor(v)
    f = (v - s).astype(np.float32)
    s = s.astype(np.int64)
    if clamp:
        lo, hi = s < 0, s >= src - 1
        f[lo | hi] = 0
        s[lo] = 0
        s[hi] = src - 1
    return np.clip(s, 0, src - 1), np.clip(s + 1, 0, src - 1), f


def _fixed(f: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """cv2's 11-bit coefficients: each weight rounded on its own, half to
    even, in float32."""
    one = np.float32(_COEF_SCALE)
    return (np.rint((np.float32(1) - f) * one).astype(np.int32),
            np.rint(f * one).astype(np.int32))


def _scales(src_h, src_w, out_h, out_w, fx=None, fy=None):
    """cv2's src/dst ratios in float64: 1 / (dst / src), or 1 / fx where fx
    is given (a float32 fx is taken at its exact value, as cv2 takes it)."""
    sx = 1.0 / (float(fx) if fx is not None else out_w / src_w)
    sy = 1.0 / (float(fy) if fy is not None else out_h / src_h)
    return sy, sx


def resize_bilinear_u8(img: np.ndarray, out_h: int, out_w: int
                       ) -> np.ndarray:
    """``cv2.resize(img, (out_w, out_h), interpolation=INTER_LINEAR)`` for
    a uint8 (h, w) or (h, w, c) image, bit for bit. (At an exact 2x
    reduction cv2 takes its INTER_AREA path, (sum of 2x2 + 2) >> 2; the
    fixed-point map gives the same numbers there.)"""
    if img.dtype != np.uint8:
        raise TypeError(f"resize_bilinear_u8 takes uint8, not {img.dtype}")
    h, w = img.shape[:2]
    if (out_h, out_w) == (h, w):
        return img.copy()
    sy, sx = _scales(h, w, out_h, out_w)
    x0, x1, fxs = _linear_map(w, out_w, sx, clamp=True, fixed=True)
    y0, y1, fys = _linear_map(h, out_h, sy, clamp=False, fixed=True)
    a0, a1 = _fixed(fxs)
    b0, b1 = _fixed(fys)
    rows = np.unique(np.concatenate([y0, y1]))
    src = img[rows].astype(np.int32)
    ext = (slice(None),) + (None,) * (img.ndim - 2)
    horiz = src[:, x0] * a0[ext] + src[:, x1] * a1[ext]
    where = np.searchsorted(rows, np.stack([y0, y1]))
    r0, r1 = horiz[where[0]] >> 4, horiz[where[1]] >> 4
    ext = (slice(None), None) + (None,) * (img.ndim - 2)
    out = (((b0[ext] * r0) >> 16) + ((b1[ext] * r1) >> 16) + 2) >> 2
    return np.clip(out, 0, 255).astype(np.uint8)


def bilinear_f32_map(src_h, src_w, out_h, out_w, fx=None, fy=None):
    """cv2's float bilinear map: ((y0, y1, wy), (x0, x1, wx)) with float32
    weights of the second index; ``fx`` / ``fy`` as ``cv2.resize(src,
    None, fx, fy)`` takes them (the map from 1/fx, the caller's size from
    ``round(w * fx)``). ``apis/inference.paste_masks`` applies it on the
    device."""
    sy, sx = _scales(src_h, src_w, out_h, out_w, fx, fy)
    return (_linear_map(src_h, out_h, sy, clamp=False, fixed=False),
            _linear_map(src_w, out_w, sx, clamp=True, fixed=False))


def scaled_size(h: int, w: int, fx: float, fy: float) -> Tuple[int, int]:
    """cv2's output size for ``fx`` / ``fy``: each side rounded, half to
    even (``saturate_cast<int>`` of a double)."""
    return int(np.rint(h * float(fy))), int(np.rint(w * float(fx)))


def resize_bilinear_f32(x: np.ndarray, out_h: Optional[int] = None,
                        out_w: Optional[int] = None, fx=None, fy=None,
                        axes: Tuple[int, int] = (0, 1)) -> np.ndarray:
    """``cv2.resize(x, (out_w, out_h), interpolation=INTER_LINEAR)`` on
    float32, or ``cv2.resize(x, None, fx=fx, fy=fy)`` when fx and fy are
    given (then the size is ``scaled_size``). ``axes`` are the (h, w) axes:
    (0, 1) for cv2's (h, w[, c]) images, (1, 2) for a stack of masks
    (n, h, w). Agrees with cv2 to float rounding (cv2 may fuse the
    multiply-adds)."""
    ay, ax = axes
    h, w = x.shape[ay], x.shape[ax]
    if fx is not None:
        out_h, out_w = scaled_size(h, w, fx, fy)
    x = np.asarray(x, np.float32)
    if (out_h, out_w) == (h, w):
        return x.copy()
    (y0, y1, wy), (x0, x1, wx) = bilinear_f32_map(h, w, out_h, out_w, fx, fy)

    def bcast(v, axis):
        shape = [1] * x.ndim
        shape[axis] = -1
        return v.reshape(shape)
    horiz = (np.take(x, x0, ax) * bcast(np.float32(1) - wx, ax)
             + np.take(x, x1, ax) * bcast(wx, ax))
    return (np.take(horiz, y0, ay) * bcast(np.float32(1) - wy, ay)
            + np.take(horiz, y1, ay) * bcast(wy, ay))


def _nearest_map(src: int, dst: int) -> np.ndarray:
    """cv2's INTER_NEAREST source index along one axis:
    ``min(floor(d * (1 / (dst / src))), src - 1)``."""
    scale = 1.0 / (dst / src)
    return np.minimum(np.floor(np.arange(dst) * scale).astype(np.int64),
                      src - 1)


def resize_nearest(x: np.ndarray, out_h: int, out_w: int,
                   axes: Tuple[int, int] = (0, 1)) -> np.ndarray:
    """``cv2.resize(x, (out_w, out_h), interpolation=INTER_NEAREST)``;
    ``axes`` as in :func:`resize_bilinear_f32`."""
    ay, ax = axes
    rows = _nearest_map(x.shape[ay], out_h)
    cols = _nearest_map(x.shape[ax], out_w)
    return np.take(np.take(x, rows, ay), cols, ax)


def downsample2x_mask(masks: np.ndarray) -> np.ndarray:
    """(n, H, W) integer masks with H, W even -> (n, H/2, W/2) uint8:
    ``cv2.resize(m, (W/2, H/2), INTER_LINEAR) > 0.5`` on each mask, which
    cv2 computes as the 2x2 mean (its INTER_AREA path), so a pixel is set
    where its 2x2 block sums to more than 2."""
    acc = np.add(masks[:, 0::2, 0::2], masks[:, 0::2, 1::2],
                 dtype=np.int32)
    acc += masks[:, 1::2, 0::2]
    acc += masks[:, 1::2, 1::2]
    return (acc > 2).astype(np.uint8)


# ------------------------------------------------------------- fillPoly

def _clip_line(w: int, h: int, p1: List[int], p2: List[int]) -> bool:
    """cv2's ``clipLine`` on (w, h): moves p1 / p2 (lists [x, y]) onto the
    image rectangle in place; False when the segment misses it. The
    products go through doubles and truncate, as cv2's do."""
    right, bottom = w - 1, h - 1

    def code(x, y):
        return (x < 0) + (x > right) * 2 + (y < 0) * 4 + (y > bottom) * 8
    c1, c2 = code(*p1), code(*p2)
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        x1, y1 = p1
        x2, y2 = p2
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            x1 += int(float(a - y1) * (x2 - x1) / (y2 - y1))
            y1 = a
            c1 = (x1 < 0) + (x1 > right) * 2
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            x2 += int(float(a - y2) * (x2 - x1) / (y2 - y1))
            y2 = a
            c2 = (x2 < 0) + (x2 > right) * 2
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                y1 += int(float(a - x1) * (y2 - y1) / (x2 - x1))
                x1 = a
                c1 = 0
            if c2:
                a = 0 if c2 == 1 else right
                y2 += int(float(a - x2) * (y2 - y1) / (x2 - x1))
                x2 = a
                c2 = 0
        p1[:] = [x1, y1]
        p2[:] = [x2, y2]
    return (c1 | c2) == 0


def _outside(w, h, *pts):
    return any(not (0 <= x < w and 0 <= y < h) for x, y in pts)


def _line_pixels(w: int, h: int, p1, p2):
    """The pixels of cv2's 8-connected ``Line`` from p1 to p2 (its
    ``LineIterator``, left to right, clipped to the image): (ys, xs), or
    None when the segment misses the image."""
    p1, p2 = [int(p1[0]), int(p1[1])], [int(p2[0]), int(p2[1])]
    if _outside(w, h, p1, p2) and not _clip_line(w, h, p1, p2):
        return None
    if p2[0] < p1[0]:
        p1, p2 = p2, p1
    dx, dy = p2[0] - p1[0], p2[1] - p1[1]
    sy = -1 if dy < 0 else 1
    dy = abs(dy)
    k = np.arange(max(dx, dy) + 1, dtype=np.int64)
    # Bresenham's minor offset after k major steps: ceil(k * minor / major
    # - 1/2), in integers
    if dy > dx:   # y is the major axis; x moves right
        minor = -((dy - 2 * k * dx) // (2 * dy))
        return p1[1] + sy * k, p1[0] + minor
    minor = -((dx - 2 * k * dy) // (2 * max(dx, 1)))
    return p1[1] + sy * minor, p1[0] + k


def fill_polygons(polys: Sequence[np.ndarray], h: int, w: int
                  ) -> np.ndarray:
    """``cv2.fillPoly(mask, polys, 1)`` on a zero (h, w) uint8 mask, with
    ``polys`` a list of (n, 2) integer (x, y) arrays and cv2's defaults
    (8-connected lines, no shift).

    cv2 collects the edges of all the polygons into one table, 16.16 fixed
    point, each stepped by a slope truncated toward zero: an edge with an
    end outside the image is clipped to it (``clipLine``) and takes the
    clipped ends' x's; it takes their rows too unless the clipped ends
    share one, and then keeps its own. Its start x is that line extended
    back to its own first row. Each row y fills, between the sorted
    crossings taken in pairs (even-odd), the pixels x with
    ceil(x_left) <= x <= floor(x_right). Every edge is also drawn as an
    8-connected line, so boundary pixels are set."""
    mask = np.zeros((h, w), np.uint8)
    edges = []   # (y0, y1, x at y0 in 16.16, x step a row in 16.16)
    for poly in polys:
        pts = np.asarray(poly, np.int64).reshape(-1, 2)
        for i in range(len(pts)):
            x0, y0 = int(pts[i - 1][0]), int(pts[i - 1][1])
            x1, y1 = int(pts[i][0]), int(pts[i][1])
            line = _line_pixels(w, h, (x0, y0), (x1, y1))
            if line is not None:
                mask[line[0], line[1]] = 1
            if y0 == y1:
                continue
            c0, c1 = [x0, y0], [x1, y1]
            if _outside(w, h, c0, c1):
                t0, t1 = [x0, y0], [x1, y1]
                _clip_line(w, h, t0, t1)
                # the clipped x's, and the clipped rows unless they meet
                c0, c1 = ((t0, t1) if t0[1] != t1[1]
                          else ([t0[0], y0], [t1[0], y1]))
            num, den = (c1[0] - c0[0]) << _XY_SHIFT, c1[1] - c0[1]
            dx = abs(num) // abs(den) * (1 if (num < 0) == (den < 0) else -1)
            if y0 > y1:
                x0, y0, y1, c0 = x1, y1, y0, c1
            edges.append((y0, y1, (c0[0] << _XY_SHIFT) + (y0 - c0[1]) * dx,
                          dx))
    if len(edges) < 2:
        return mask
    e = np.asarray(edges, np.int64)
    ends = e[:, 2] + (e[:, 1] - e[:, 0]) * e[:, 3]
    if (e[:, 1].max() < 0 or e[:, 0].min() >= h
            or max(e[:, 2].max(), ends.max()) < 0
            or min(e[:, 2].min(), ends.min()) >= (w << _XY_SHIFT)):
        return mask
    # every edge crosses rows y0 <= y < y1, at x0 + (y - y0) * dx
    n_rows = np.maximum(np.minimum(e[:, 1], h) - e[:, 0], 0)
    idx = np.repeat(np.arange(len(e)), n_rows)
    step = np.arange(len(idx)) - np.repeat(np.cumsum(n_rows) - n_rows,
                                           n_rows)
    ys = e[idx, 0] + step
    xs = e[idx, 2] + step * e[idx, 3]
    order = np.lexsort((xs, ys))
    ys, xs = ys[order], xs[order]
    # each row holds an even count of crossings: pair them in x order
    one = 1 << _XY_SHIFT
    yl = ys[0::2]
    xl = (xs[0::2] + one - 1) >> _XY_SHIFT
    xr = xs[1::2] >> _XY_SHIFT
    keep = (yl >= 0) & (xl < w) & (xr >= 0) & (xl <= xr)
    yl, xl, xr = yl[keep], np.maximum(xl[keep], 0), np.minimum(xr[keep],
                                                                w - 1)
    runs = np.zeros((h, w + 1), np.int32)
    np.add.at(runs, (yl, xl), 1)
    np.add.at(runs, (yl, xr + 1), -1)
    mask |= (np.cumsum(runs[:, :w], 1) > 0).astype(np.uint8)
    return mask


# ------------------------------------------------------ float BGR <-> HSV

_FLT_EPSILON = np.float32(np.finfo(np.float32).eps)
# Floats per vector in cv2's BGR2HSV row loop. The vector width, and with
# it each row's scalar tail, is the one that opencv-python 5.0.0 (baseline
# SSE3, dispatch up to AVX512_SKX) took on an x86-64 host with AVX-512; a
# cv2 build or CPU that dispatches 4 or 16 lanes rounds the tails otherwise.
_HSV_LANES = 8
# (b, g, r) entries of HSV2BGR's table (v, v(1-s), v(1-sh), v(1-s(1-h)))
# for each of the six hue sectors
_HSV_SECTORS = np.array([[1, 3, 0], [1, 0, 2], [3, 0, 1], [0, 2, 1],
                         [0, 1, 3], [2, 1, 0]])


def _fma(a, b, c):
    """a * b + c for float32 a, b with one rounding, as a fused
    multiply-add gives it (the product is exact in float64)."""
    return (a.astype(np.float64) * b + c).astype(np.float32)


def bgr_to_hsv_f32(img: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(img, cv2.COLOR_BGR2HSV)`` on a float32 (h, w, 3)
    image: H in [0, 360], S = (max - min) / (|max| + FLT_EPSILON), V = max.
    cv2 converts a row in vectors of 8 (the hue as a fused multiply-add
    with 60 / (diff + eps) in float32) and the last ``w % 8`` pixels of
    each row in scalar code (60 / (diff + eps) in double, the red sector's
    hue without the fused add, then wrapped by + 360 if negative). Bit
    for bit with that cv2 build and dispatch only (see ``_HSV_LANES``)."""
    b, g, r = (img[..., i] for i in range(3))
    v = np.maximum(np.maximum(r, g), b)
    diff = v - np.minimum(np.minimum(r, g), b)
    s = diff / (np.abs(v) + _FLT_EPSILON)
    r_max, g_max = r == v, g == v
    num = np.where(r_max, g - b, np.where(g_max, b - r, r - g))
    base = np.where(r_max, np.where(g < b, 360, 0),
                    np.where(g_max, 120, 240)).astype(np.float32)
    h = _fma(num, np.float32(60) / (diff + _FLT_EPSILON), base)
    tail = slice(img.shape[1] - img.shape[1] % _HSV_LANES, None)
    rev = (60.0 / (diff[:, tail] + _FLT_EPSILON).astype(np.float64)
           ).astype(np.float32)
    n = num[:, tail]
    ht = np.where(r_max[:, tail], n * rev, _fma(n, rev, base[:, tail]))
    h[:, tail] = np.where(ht < 0, ht + np.float32(360), ht)
    return np.stack([h, s, v], -1)


def hsv_to_bgr_f32(img: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(img, cv2.COLOR_HSV2BGR)`` on a float32 (h, w, 3)
    image with H in [0, 360] (S and V any value): the sector is
    trunc(H * 6/360) mod 6, the fraction h what is left, and the table
    ``v(1 - s h)``, ``v(1 - s (1 - h))`` takes fused multiply-adds."""
    one = np.float32(1)
    hue = img[..., 0] * (np.float32(6) / np.float32(360))
    s, v = img[..., 1], img[..., 2]
    pre = np.trunc(hue)
    frac = hue - pre
    sector = (pre - np.trunc(pre * (one / np.float32(6))) * np.float32(6)
              ).astype(np.int64)
    tab = np.stack([v, v * (one - s), v * _fma(-s, frac, one),
                    v * _fma(-s, one - frac, one)])
    pick = _HSV_SECTORS[sector]
    return np.stack([np.take_along_axis(tab, pick[None, ..., c], 0)[0]
                     for c in range(3)], -1)


# ------------------------------------------------------ borders, rounding

def border_index(p: np.ndarray, n: int, reflect_101: bool = True
                 ) -> np.ndarray:
    """cv2's ``borderInterpolate`` for indices ``p`` into a length ``n``:
    BORDER_REFLECT_101 (gfedcb|abcdefgh|gfedcba) or BORDER_REFLECT
    (fedcba|abcdefgh|hgfedcb), repeated as far as ``p`` reaches."""
    p = np.asarray(p, np.int64)
    if n == 1:
        return np.zeros_like(p)
    if reflect_101:
        period = 2 * (n - 1)
        p = np.mod(p, period)
        return np.where(p >= n, period - p, p)
    period = 2 * n
    p = np.mod(p, period)
    return np.where(p >= n, period - 1 - p, p)


def _padded(img: np.ndarray, ry: int, rx: int) -> np.ndarray:
    """``img`` with ``ry`` rows and ``rx`` columns of reflect-101 border on
    each side."""
    h, w = img.shape[:2]
    return img[border_index(np.arange(-ry, h + ry), h)][
        :, border_index(np.arange(-rx, w + rx), w)]


def _round_u8(x: np.ndarray) -> np.ndarray:
    """cv2's ``saturate_cast<uchar>`` of a float: round half to even, then
    clip."""
    return np.clip(np.rint(x), 0, 255).astype(np.uint8)


# ------------------------------------------------------------- Gaussian

def gaussian_ksize(sigma: float, uint8: bool) -> int:
    """cv2's kernel size for ``ksize=(0, 0)``: round(sigma * 3 * 2 + 1) | 1
    on uint8 images, round(sigma * 4 * 2 + 1) | 1 on float ones."""
    return int(np.rint(sigma * (3 if uint8 else 4) * 2 + 1)) | 1


def gaussian_kernel(n: int, sigma: float) -> np.ndarray:
    """cv2's ``getGaussianKernel(n, sigma)`` in float64 (its bit-exact
    form: the outer taps exp(-x^2 / (8 sigma^2)) at x = 1 - n, 3 - n, ...,
    normalised by their sum, the centre one minus the others)."""
    scale = -0.125 / (sigma * sigma)
    half = (n - 1) // 2
    vals = [np.exp(float(x * x) * scale) for x in range(1 - n, -1, 2)]
    total = 0.0
    for v in vals:
        total += v
    total = total * 2 + 1.0
    mul = 1.0 / total
    k = np.zeros(n)
    acc = 0.0
    for i, v in enumerate(vals):
        k[i] = k[n - 1 - i] = v * mul
        acc += v * mul
    k[half] = 1.0 - acc * 2
    return k


def _gaussian_kernel_u8(n: int, sigma: float) -> np.ndarray:
    """cv2's 8.8 fixed-point taps of the uint8 blur: the outer taps rounded
    with their errors carried inward (error diffusion), the centre 256
    minus the rest."""
    k = gaussian_kernel(n, sigma)
    out = np.zeros(n, np.int64)
    err = 0.0
    for i in range(n // 2):
        adj = k[i] * 256.0 + err
        v = int(np.rint(adj))
        err = adj - v
        out[i] = out[n - 1 - i] = v
    out[n // 2] = 256 - 2 * out[:n // 2].sum()
    return out


def gaussian_blur_u8(img: np.ndarray, sigma: float) -> np.ndarray:
    """``cv2.GaussianBlur(img, (0, 0), sigma)`` on a uint8 (h, w[, c])
    image, bit for bit: 8.8 taps, the horizontal sums kept in 8.8, the
    vertical ones in 16.16, rounded by (v + 2^15) >> 16."""
    n = gaussian_ksize(sigma, True)
    if n == 1:
        return img.copy()
    k, r = _gaussian_kernel_u8(n, sigma), n // 2
    h, w = img.shape[:2]
    x = _padded(img, r, r).astype(np.int64)
    hz = sum(k[j] * x[:, j:j + w] for j in range(n))
    v = sum(k[j] * hz[j:j + h] for j in range(n))
    return np.clip((v + (1 << 15)) >> 16, 0, 255).astype(np.uint8)


def _smooth_f32(x: np.ndarray, k: np.ndarray, out_len: int,
                first: bool) -> Tuple[np.ndarray, np.ndarray]:
    """One separable pass of cv2's float filter along axis 1 of the padded
    ``x``: (its vector code's result, its scalar code's), where a
    symmetric tap pair x[c - j] + x[c + j] is added first and the vector
    code fuses each multiply-add. The row pass sums tap by tap from the
    first (3 taps: the pair, then the centre; 5 taps: the inner pair, the
    centre, the outer pair), the column pass from the centre out."""
    n = len(k)
    r = n // 2

    def tap(j):
        return x[:, j:j + out_len]

    def pair(j):
        return tap(r - j) + tap(r + j)
    if first and n == 3:
        return (_fma(tap(1), k[1], pair(1) * k[0]),
                pair(1) * k[0] + tap(1) * k[1])
    if first and n == 5:
        vec = _fma(tap(2), k[2], pair(1) * k[1])
        return (_fma(pair(2), k[0], vec),
                tap(2) * k[2] + pair(1) * k[1] + pair(2) * k[0])
    if first:
        vec, tail = tap(0) * k[0], tap(0) * k[0]
        for j in range(1, n):
            vec = _fma(tap(j), k[j], vec)
            tail = tail + tap(j) * k[j]
        return vec, tail
    vec, tail = tap(r) * k[r], tap(r) * k[r]
    for j in range(1, r + 1):
        vec = _fma(pair(j), k[r + j], vec)
        tail = tail + pair(j) * k[r + j]
    return vec, (vec if n == 3 else tail)


def gaussian_blur_f32(img: np.ndarray, sigma: float) -> np.ndarray:
    """``cv2.GaussianBlur(img, (0, 0), sigma)`` on a float32 (h, w) image,
    bit for bit: cv2's float kernel (:func:`gaussian_kernel` in float32),
    reflect-101 borders, the passes of :func:`_smooth_f32`; the last
    ``w % 4`` pixels of each row of the row pass and the last ``w % 8`` of
    the column pass take cv2's scalar code (opencv-python 5.0 on x86-64).
    With 7 or more taps a value of those last columns may still lie an ulp
    away (2 of 1961 seen)."""
    n = gaussian_ksize(sigma, False)
    img = np.asarray(img, np.float32)
    if n == 1:
        return img.copy()
    k, r = gaussian_kernel(n, sigma).astype(np.float32), n // 2
    h, w = img.shape
    vec, tail = _smooth_f32(_padded(img, 0, r), k, w, True)
    rows = np.concatenate([vec[:, :w - w % 4], tail[:, w - w % 4:]], 1)
    vec, tail = _smooth_f32(rows[border_index(np.arange(-r, h + r), h)].T,
                            k, h, False)
    return np.ascontiguousarray(
        np.concatenate([vec[:w - w % 8], tail[w - w % 8:]]).T)


# ------------------------------------------------------------ filter2D

def filter2d_u8(img: np.ndarray, kernel: np.ndarray) -> np.ndarray:
    """``cv2.filter2D(img, -1, kernel)`` for a uint8 (h, w[, c]) image and
    an odd float kernel (anchor at its centre): the correlation summed in
    float64 over the kernel's non-zero taps, reflect-101 borders, rounded
    half to even and saturated."""
    kh, kw = kernel.shape
    ry, rx = kh // 2, kw // 2
    h, w = img.shape[:2]
    x = _padded(img, ry, rx).astype(np.float64)
    acc = np.zeros(img.shape, np.float64)
    for i, j in zip(*np.nonzero(kernel)):
        acc += float(kernel[i, j]) * x[i:i + h, j:j + w]
    return _round_u8(acc)


# ----------------------------------------------------- circle, warpAffine

def fill_circle(img: np.ndarray, center: Tuple[int, int], radius: int,
                color) -> np.ndarray:
    """``cv2.circle(img, center, radius, color, -1)`` (8-connected, no
    shift) in place: cv2's midpoint circle, each step filling four
    horizontal spans. The circle must lie inside the image."""
    cx, cy = center
    h, w = img.shape[:2]
    if not (radius <= cx < w - radius and radius <= cy < h - radius):
        raise ValueError("fill_circle: the circle must lie inside the image")
    err, dx, dy, plus, minus = 0, radius, 0, 1, 2 * radius - 1
    while dx >= dy:
        for y, half in ((cy - dy, dx), (cy + dy, dx), (cy - dx, dy),
                        (cy + dx, dy)):
            img[y, cx - half:cx + half + 1] = color
        dy += 1
        err += plus
        plus += 2
        mask = int(err <= 0) - 1
        err -= minus & mask
        dx += mask
        minus -= mask & 2
    return img


def rotation_matrix_2d(center: Tuple[float, float], angle: float,
                       scale: float) -> np.ndarray:
    """``cv2.getRotationMatrix2D(center, angle, scale)``: a (2, 3) float64
    matrix, the angle in degrees, counter-clockwise."""
    a = angle * np.pi / 180
    alpha, beta = np.cos(a) * scale, np.sin(a) * scale
    cx, cy = center
    return np.array([[alpha, beta, (1 - alpha) * cx - beta * cy],
                     [-beta, alpha, beta * cx + (1 - alpha) * cy]])


def _invert_affine(m: np.ndarray) -> np.ndarray:
    """cv2's ``invertAffineTransform`` in float64."""
    d = m[0, 0] * m[1, 1] - m[0, 1] * m[1, 0]
    d = 1.0 / d if d != 0 else 0.0
    a11, a22 = m[1, 1] * d, m[0, 0] * d
    a12, a21 = -m[0, 1] * d, -m[1, 0] * d
    return np.array([[a11, a12, -a11 * m[0, 2] - a12 * m[1, 2]],
                     [a21, a22, -a21 * m[0, 2] - a22 * m[1, 2]]])


def warp_affine_f32(img: np.ndarray, m: np.ndarray,
                    size: Tuple[int, int]) -> np.ndarray:
    """``cv2.warpAffine(img, m, size)`` for a float32 (h, w) image, as
    opencv-python 5.0's vector kernel computes it: the inverse of ``m`` in
    float32, each row's source point m01 y + m02 in float32, then
    x m00 + that as a fused multiply-add; the four neighbours (zero
    outside) blended along x and then along y, each blend a fused
    multiply-add v0 + a (v1 - v0). cv2 computes the last ``w % 16``
    pixels of a row otherwise, so those may lie an ulp or two away."""
    ow, oh = size
    im = _invert_affine(np.asarray(m, np.float64)).astype(np.float32)
    img = np.asarray(img, np.float32)
    h, w = img.shape
    ys, xs = np.meshgrid(np.arange(oh, dtype=np.float32),
                         np.arange(ow, dtype=np.float32), indexing="ij")
    sx = _fma(xs, im[0, 0], im[0, 1] * ys + im[0, 2])
    sy = _fma(xs, im[1, 0], im[1, 1] * ys + im[1, 2])
    x0, y0 = np.floor(sx), np.floor(sy)
    a, b = sx - x0, sy - y0
    x0, y0 = x0.astype(np.int64), y0.astype(np.int64)

    def at(yy, xx):
        inside = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
        return np.where(inside, img[np.clip(yy, 0, h - 1),
                                    np.clip(xx, 0, w - 1)], np.float32(0))

    def blend(t, v0, v1):
        return _fma(t, v1 - v0, v0)
    top = blend(a, at(y0, x0), at(y0, x0 + 1))
    bottom = blend(a, at(y0 + 1, x0), at(y0 + 1, x0 + 1))
    return blend(b, top, bottom)


# --------------------------------------------------------- cubic, area

def _cubic_weights(f: np.ndarray) -> np.ndarray:
    """cv2's ``interpolateCubic`` (A = -0.75) in float32: (n, 4)."""
    a = np.float32(-0.75)
    one = np.float32(1)
    x1 = f + one
    c0 = ((a * x1 - np.float32(5) * a) * x1 + np.float32(8) * a) * x1 \
        - np.float32(4) * a
    c1 = ((a + np.float32(2)) * f - (a + np.float32(3))) * f * f + one
    g = one - f
    c2 = ((a + np.float32(2)) * g - (a + np.float32(3))) * g * g + one
    return np.stack([c0, c1, c2, one - c0 - c1 - c2], -1)


def _cubic_map(src: int, dst: int):
    """Source indices (dst, 4), clamped to the image, and weights (dst, 4)
    of cv2's cubic resize along one axis."""
    scale = src / dst
    f = ((np.arange(dst) + 0.5) * scale - 0.5).astype(np.float32)
    s = np.floor(f)
    f = f - s
    idx = s.astype(np.int64)[:, None] + np.arange(-1, 3)[None]
    return np.clip(idx, 0, src - 1), _cubic_weights(f)


def resize_cubic_f32(x: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """``cv2.resize(x, (out_w, out_h), interpolation=INTER_CUBIC)`` on a
    float32 (h, w) image: cv2's weights and edge rule, the four taps of
    each pass summed left to right in float32 (cv2 may fuse the
    multiply-adds, so a value may lie an ulp away)."""
    x = np.asarray(x, np.float32)
    h, w = x.shape
    xi, xw = _cubic_map(w, out_w)
    yi, yw = _cubic_map(h, out_h)
    horiz = x[:, xi[:, 0]] * xw[:, 0]
    for j in range(1, 4):
        horiz = horiz + x[:, xi[:, j]] * xw[:, j]
    out = horiz[yi[:, 0]] * yw[:, 0, None]
    for j in range(1, 4):
        out = out + horiz[yi[:, j]] * yw[:, j, None]
    return out


def _area_tab(src: int, dst: int, scale: float):
    """cv2's ``computeResizeAreaTab``: (dst index, src index, weight) of
    every source pixel a destination pixel covers, in cv2's order."""
    tab = []
    for d in range(dst):
        f1 = d * scale
        f2 = f1 + scale
        cell = min(scale, src - f1)
        s1, s2 = int(np.ceil(f1)), int(np.floor(f2))
        s2 = min(s2, src - 1)
        s1 = min(s1, s2)
        if s1 - f1 > 1e-3:
            tab.append((d, s1 - 1, np.float32((s1 - f1) / cell)))
        for s in range(s1, s2):
            tab.append((d, s, np.float32(1.0 / cell)))
        if f2 - s2 > 1e-3:
            tab.append((d, s2, np.float32(min(min(f2 - s2, 1.0), cell)
                                          / cell)))
    return tab


def resize_area_u8(img: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """``cv2.resize(img, (out_w, out_h), interpolation=INTER_AREA)`` for a
    uint8 (h, w[, c]) image no larger than the source. At whole scales
    cv2's integer path: each block's sum, (sum + 2) >> 2 for 2x2 blocks,
    else rounded sum * (1 / area) in float32; otherwise its area weights
    in float32, each row's weighted sum in the table's order and the rows'
    likewise."""
    h, w = img.shape[:2]
    if (out_h, out_w) == (h, w):
        return img.copy()
    sx, sy = 1.0 / (out_w / w), 1.0 / (out_h / h)
    ix, iy = int(np.rint(sx)), int(np.rint(sy))
    if abs(sx - ix) < np.finfo(np.float64).eps and \
            abs(sy - iy) < np.finfo(np.float64).eps:
        blocks = img[:out_h * iy, :out_w * ix].astype(np.int64).reshape(
            (out_h, iy, out_w, ix) + img.shape[2:]).sum((1, 3))
        if ix == iy == 2:
            return ((blocks + 2) >> 2).astype(np.uint8)
        return _round_u8(blocks.astype(np.float32)
                         * (np.float32(1) / np.float32(ix * iy)))
    x = img.astype(np.float32)

    def along(x, tab, n_out, axis):
        out = np.zeros((n_out,) + tuple(np.delete(x.shape, axis)),
                       np.float32)
        moved = np.moveaxis(x, axis, 0)
        seen = np.zeros(n_out, bool)
        for d, s, a in tab:
            term = moved[s] * a
            out[d] = out[d] + term if seen[d] else term
            seen[d] = True
        return np.moveaxis(out, 0, axis)
    horiz = along(x, _area_tab(w, out_w, sx), out_w, 1)
    return _round_u8(along(horiz, _area_tab(h, out_h, sy), out_h, 0))


# ------------------------------------------------------ uint8 BGR <-> HSV

_HSV_SHIFT = 12


def _hsv_tables():
    i = np.arange(1, 256, dtype=np.float64)
    sdiv = np.concatenate([[0], np.rint((255 << _HSV_SHIFT) / i)])
    hdiv = np.concatenate([[0], np.rint((180 << _HSV_SHIFT) / (6.0 * i))])
    return sdiv.astype(np.int64), hdiv.astype(np.int64)


def bgr_to_hsv_u8(img: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(img, cv2.COLOR_BGR2HSV)`` on uint8 (H in [0, 180)),
    bit for bit: cv2's 12-bit division tables."""
    sdiv, hdiv = _hsv_tables()
    b, g, r = (img[..., i].astype(np.int64) for i in range(3))
    v = np.maximum(np.maximum(b, g), r)
    diff = v - np.minimum(np.minimum(b, g), r)
    half = 1 << (_HSV_SHIFT - 1)
    s = (diff * sdiv[v] + half) >> _HSV_SHIFT
    h = np.where(v == r, g - b, np.where(v == g, b - r + 2 * diff,
                                         r - g + 4 * diff))
    h = (h * hdiv[diff] + half) >> _HSV_SHIFT
    h = np.where(h < 0, h + 180, h)
    return np.stack([h, s, v], -1).astype(np.uint8)


# Pixels a block of cv2's vector HSV2BGR row loop on uint8 takes (blocks
# of 64, then of 32, the same arithmetic), as opencv-python 5.0.0
# dispatched it on the x86-64 host its bytes were checked on; the last
# ``w % 32`` pixels of each row take its scalar code.
_HSV_U8_BLOCK = 32


def hsv_to_bgr_u8(img: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(img, cv2.COLOR_HSV2BGR)`` on uint8 (H in [0, 180)):
    S and V scaled by 1/255 in float32, cv2's float sectors with
    hscale = 6/180, v(1 - s h) and v(1 - s (1 - h)) as fused
    multiply-adds, each channel from value * 255: truncated in cv2's
    vector blocks (``_HSV_U8_BLOCK`` pixels), rounded in the rest of a
    row."""
    one = np.float32(1)
    hue = img[..., 0].astype(np.float32) * (np.float32(6) / np.float32(180))
    s = img[..., 1].astype(np.float32) * (one / np.float32(255))
    v = img[..., 2].astype(np.float32) * (one / np.float32(255))
    sector = np.floor(hue)     # hue < 6: cv2's fmod and trunc agree
    frac = hue - sector
    pick = _HSV_SECTORS[sector.astype(np.int64)]

    def channels(tab):
        return np.stack([np.take_along_axis(tab, pick[None, ..., c], 0)[0]
                         for c in range(3)], -1) * np.float32(255)
    vals = channels(np.stack([v, v * (one - s), v * _fma(-s, frac, one),
                              v * _fma(-s, one - frac, one)]))
    tail = np.where((s == 0)[..., None], (v * np.float32(255))[..., None],
                    vals)
    out = np.trunc(vals)
    cut = img.shape[1] - img.shape[1] % _HSV_U8_BLOCK
    out[:, cut:] = np.rint(tail[:, cut:])
    return np.clip(out, 0, 255).astype(np.uint8)


# --------------------------------------------------------------- remap

def remap_linear_u8(img: np.ndarray, map_x: np.ndarray,
                    map_y: np.ndarray) -> np.ndarray:
    """``cv2.remap(img, map_x, map_y, INTER_LINEAR,
    borderMode=BORDER_REFLECT)`` for a uint8 (h, w[, c]) image and float32
    maps, as opencv-python 5.0 computes it: the four neighbours of each
    map point (reflected at the border) in float32, blended along x and
    then along y, each blend a fused multiply-add v0 + a (v1 - v0), then
    rounded."""
    h, w = img.shape[:2]
    map_x = np.asarray(map_x, np.float32)
    map_y = np.asarray(map_y, np.float32)
    x0, y0 = np.floor(map_x), np.floor(map_y)
    ext = (Ellipsis,) + (None,) * (img.ndim - 2)
    a, b = (map_x - x0)[ext], (map_y - y0)[ext]
    x0, y0 = x0.astype(np.int64), y0.astype(np.int64)

    def at(yy, xx):
        return img[border_index(yy, h, reflect_101=False),
                   border_index(xx, w, reflect_101=False)].astype(np.float32)

    def blend(t, v0, v1):
        return _fma(t, v1 - v0, v0)
    top = blend(a, at(y0, x0), at(y0, x0 + 1))
    bottom = blend(a, at(y0 + 1, x0), at(y0 + 1, x0 + 1))
    return _round_u8(blend(b, top, bottom))
