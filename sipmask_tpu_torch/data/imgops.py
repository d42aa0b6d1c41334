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
