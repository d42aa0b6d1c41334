"""Deformable convolution v1 (forward), the port of
``sipmask_tpu/ops/deform_conv.py:deform_conv2d``.

The sampling runs in K1 (:func:`.deform_sample.deform_im2col`); the tap
contraction is one ``torch.matmul``, as the JAX package leaves its own
contraction (``deform_conv.py:104-107``) to XLA outside the Pallas kernel.
"""

from __future__ import annotations

import torch

from . import deform_sample


def deform_conv2d(x, offsets, weight, *, stride: int = 1, padding: int = 1,
                  dilation: int = 1, deform_groups: int = 1):
    """Deformable conv, NCHW.

    Args:
      x: (B, C, H, W) f32.
      offsets: (B, G*K*2, Ho, Wo) in the CUDA layout ([dy, dx] per tap,
        group-major), K = kh*kw.
      weight: (O, C, kh, kw) OIHW.
    Returns:
      (B, O, Ho, Wo).
    """
    b, c, h, w = x.shape
    o, wc, kh, kw = weight.shape
    if wc != c:
        raise ValueError(f"weight takes {wc} channels, x has {c}")
    g, k = deform_groups, kh * kw
    cols = deform_sample.deform_im2col(x, offsets, (kh, kw), stride, padding,
                                       dilation, g)      # (B, G*K*Cg, P)
    # (O, C, kh, kw) -> (O, G*K*Cg) in the row order of cols
    w2 = weight.reshape(o, g, c // g, k).permute(0, 1, 3, 2).reshape(o, -1)
    out = torch.matmul(w2, cols)                          # (B, O, P)
    return out.reshape(b, o, *offsets.shape[2:])
