"""BFP, the Balanced Feature Pyramid neck of Libra R-CNN (NCHW), the port of
``sipmask_tpu/models/bfp.py``: gather every level to the refine level's
resolution (max pooling from finer levels, pixel repetition from coarser
ones), average, refine (``None``, a biased 3x3 conv + ReLU, or the
embedded-gaussian NonLocal2D with reduction 1 and no scale), and add the
result back to every level, resized the other way. It wraps an existing
pyramid; no SipMask preset uses it.

As in the JAX package the resizes are exact only where the levels' sizes
are in exact power-of-2 ratios; other pyramids raise ``ValueError``.
Names follow mmdet's ``BFP``: ``refine.conv.*`` for ``conv``,
``refine.{g,theta,phi,conv_out}.conv.*`` for ``non_local``. ``dtype`` is
the compute dtype (``layers.conv2d``).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .layers import ConvModule, repeat2d


class NonLocal2D(nn.Module):
    """The embedded-gaussian non-local block: 1x1 ``g``/``theta``/``phi``
    convs to ``in_channels // reduction``, softmax over the pairwise
    products (divided by sqrt(inter) when ``use_scale``), and a 1x1
    ``conv_out`` back on a residual path."""

    def __init__(self, in_channels: int, reduction: int = 2,
                 use_scale: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        inter = in_channels // reduction
        self.use_scale = use_scale
        for name, cin, cout in (("g", in_channels, inter),
                                ("theta", in_channels, inter),
                                ("phi", in_channels, inter),
                                ("conv_out", inter, in_channels)):
            setattr(self, name, ConvModule(cin, cout, 1, act=False,
                                           dtype=dtype))

    def forward(self, x):
        b, _, h, w = x.shape
        g = self.g(x).flatten(2)                       # (B, inter, HW)
        theta = self.theta(x).flatten(2)
        phi = self.phi(x).flatten(2)
        pw = theta.transpose(1, 2) @ phi               # (B, HW, HW)
        if self.use_scale:
            pw = pw / torch.tensor(float(g.shape[1]), dtype=pw.dtype).sqrt()
        pw = pw.softmax(-1)
        y = (pw @ g.transpose(1, 2)).transpose(1, 2)   # (B, inter, HW)
        return x + self.conv_out(y.reshape(b, -1, h, w))


def _check_levels(feats: Sequence[torch.Tensor]) -> None:
    """Raise ``ValueError`` unless level i's size is level 0's / 2**i: the
    max pools and pixel repetitions of the gather and the scatter give the
    refine level's size only then."""
    sizes = [tuple(f.shape[-2:]) for f in feats]
    h0, w0 = sizes[0]
    if any((h << i, w << i) != (h0, w0) for i, (h, w) in enumerate(sizes)):
        raise ValueError(f"BFP needs levels whose sizes halve level by "
                         f"level; got {sizes}")


class BFP(nn.Module):
    def __init__(self, out_channels: int = 256, refine_level: int = 2,
                 refine_type: Optional[str] = "conv",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.refine_level, self.refine_type = refine_level, refine_type
        if refine_type == "conv":
            self.refine = ConvModule(out_channels, out_channels, 3,
                                     dtype=dtype)
        elif refine_type == "non_local":
            self.refine = NonLocal2D(out_channels, reduction=1,
                                     use_scale=False, dtype=dtype)
        elif refine_type is not None:
            raise ValueError(f"refine_type {refine_type!r}")

    def forward(self, feats):
        _check_levels(feats)
        lvl = self.refine_level
        gathered = []
        for i, f in enumerate(feats):
            if i < lvl:
                gathered.append(F.max_pool2d(f, 2 ** (lvl - i)))
            elif i > lvl:
                gathered.append(repeat2d(f, 2 ** (i - lvl)))
            else:
                gathered.append(f)
        bsf = sum(gathered) / len(feats)
        if self.refine_type is not None:
            bsf = self.refine(bsf)
        outs = []
        for i, f in enumerate(feats):
            if i < lvl:
                r = repeat2d(bsf, 2 ** (lvl - i))
            elif i > lvl:
                r = F.max_pool2d(bsf, 2 ** (i - lvl))
            else:
                r = bsf
            outs.append(f + r)
        return tuple(outs)
