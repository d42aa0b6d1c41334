"""FCOS point generation, the port of ``sipmask_tpu/core/points.py``."""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch


def all_points(featmap_sizes: Sequence[Tuple[int, int]],
               strides: Sequence[int],
               regress_ranges: Sequence[Tuple[float, float]] = None,
               device=None):
    """Concatenated per-level points, strides and regress ranges.

    Per level the points are the pixel centres ``(x, y) * stride +
    stride // 2`` in row-major (h, w) order. Returns (points (P, 2) [x, y],
    strides (P,), ranges (P, 2) or None), f32, P = sum(h*w).
    """
    pts, strs, rngs = [], [], []
    for i, ((h, w), s) in enumerate(zip(featmap_sizes, strides)):
        xs = np.arange(0, w * s, s, dtype=np.float32) + s // 2
        ys = np.arange(0, h * s, s, dtype=np.float32) + s // 2
        x, y = np.meshgrid(xs, ys)
        pts.append(np.stack([x.reshape(-1), y.reshape(-1)], -1))
        strs.append(np.full((h * w,), s, dtype=np.float32))
        if regress_ranges is not None:
            rngs.append(np.tile(np.asarray(regress_ranges[i], np.float32),
                                (h * w, 1)))
    points = torch.from_numpy(np.concatenate(pts, 0)).to(device)
    strides_t = torch.from_numpy(np.concatenate(strs, 0)).to(device)
    ranges = (torch.from_numpy(np.concatenate(rngs, 0)).to(device)
              if regress_ranges is not None else None)
    return points, strides_t, ranges
