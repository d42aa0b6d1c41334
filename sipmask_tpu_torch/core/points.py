"""FCOS point generation, the port of ``sipmask_tpu/core/points.py``."""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch


def all_points(featmap_sizes: Sequence[Tuple[int, int]],
               strides: Sequence[int], device=None):
    """Concatenated per-level points, (P, 2) [x, y] f32, P = sum(h*w).

    Per level the points are the pixel centres ``(x, y) * stride +
    stride // 2`` in row-major (h, w) order.
    """
    pts = []
    for (h, w), s in zip(featmap_sizes, strides):
        xs = np.arange(0, w * s, s, dtype=np.float32) + s // 2
        ys = np.arange(0, h * s, s, dtype=np.float32) + s // 2
        x, y = np.meshgrid(xs, ys)
        pts.append(np.stack([x.reshape(-1), y.reshape(-1)], -1))
    return torch.from_numpy(np.concatenate(pts, 0)).to(device)
