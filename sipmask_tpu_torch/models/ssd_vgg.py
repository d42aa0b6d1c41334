"""SSD-VGG16 backbone (NCHW), the port of ``sipmask_tpu/models/ssd_vgg.py``:
VGG-16 through conv5 with ceil-mode 2x2 stage pools, pool5 as a 3x3
stride-1 pool, the dilated fc6 and the 1x1 fc7, the extra layers of the
``S`` pattern, and the learnable L2Norm on conv4_3 (eps outside the sqrt).
Outputs (L2Norm(conv4_3), fc7, then every odd extra layer): 6 levels at
input size 300, 7 at 512. No SipMask preset uses it; it completes the
reference's backbone surface.

Names follow mmdet's ``SSDVGG`` ``state_dict``: ``features.{i}`` (the VGG
Sequential: a conv and its ReLU per layer, a pool after each of the first
four stages, pool5 at 30, fc6 at 31 and fc7 at 33), ``extra.{i}`` and
``l2_norm.weight``. ``dtype`` is the compute dtype (``layers.conv2d``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .layers import conv

VGG16_STAGES = ((2, 64), (2, 128), (3, 256), (3, 512), (3, 512))

# 'S' marks a stride-2 3x3 conv to the NEXT listed width
EXTRA_SETTING = {
    300: (256, "S", 512, 128, "S", 256, 128, 256, 128, 256),
    512: (256, "S", 512, 128, "S", 256, 128, "S", 256, 128, "S", 256, 128),
}


def ceil_max_pool_2x2(x):
    """MaxPool2d(2, 2, ceil_mode=True): an odd extent keeps a last window
    of one row or column (the JAX package's -inf pad)."""
    return F.max_pool2d(x, 2, 2, ceil_mode=True)


class L2Norm(nn.Module):
    """Per-channel learnable L2 normalization: x / (||x||_2 + eps) * weight
    over the channels, the norm taken in f32 (in x's dtype where that is
    wider) and the result cast back to x's dtype."""

    def __init__(self, channels: int, scale: float = 20.0,
                 eps: float = 1e-10):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.full((channels,), float(scale)))

    def forward(self, x):
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        norm = xf.pow(2).sum(1, keepdim=True).sqrt() + self.eps
        return (xf / norm * self.weight.to(xf.dtype)[:, None, None]).to(
            x.dtype)


class SSDVGG(nn.Module):
    """Returns (conv4_3 L2-normed, fc7, the extras at every odd layer)."""

    def __init__(self, input_size: int = 300,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        layers, cin = [], 3
        for si, (n_convs, ch) in enumerate(VGG16_STAGES):
            for _ in range(n_convs):
                layers += [nn.Conv2d(cin, ch, 3, padding=1), nn.ReLU()]
                cin = ch
            if si == 3:   # conv4_3's ReLU: its output is the first level
                self.tap = len(layers) - 1
            # the stage pools are ceil_max_pool_2x2; pool5 is 3x3 stride 1
            layers.append(nn.MaxPool2d(2, 2, ceil_mode=True) if si < 4
                          else nn.MaxPool2d(3, 1, 1))
        layers += [nn.Conv2d(cin, 1024, 3, padding=6, dilation=6), nn.ReLU(),
                   nn.Conv2d(1024, 1024, 1), nn.ReLU()]
        self.features = nn.Sequential(*layers)
        setting = EXTRA_SETTING[input_size]
        extra, cin, skip = [], 1024, False
        for i, v in enumerate(setting):
            if skip:
                skip = False
                continue
            k = (1, 3)[len(extra) % 2]
            if v == "S":
                extra.append(nn.Conv2d(cin, setting[i + 1], k, 2, 1))
                cin, skip = setting[i + 1], True
            else:
                extra.append(nn.Conv2d(cin, v, k))
                cin = v
        if input_size == 512:
            extra.append(nn.Conv2d(cin, 256, 4, padding=1))
        self.extra = nn.Sequential(*extra)
        self.l2_norm = L2Norm(512)

    def forward(self, x):
        outs = []
        for i, m in enumerate(self.features):
            if isinstance(m, nn.Conv2d):
                x = conv(x, m, self.dtype)
            elif isinstance(m, nn.ReLU):
                x = torch.relu(x)
            else:
                x = m(x)
            if i == self.tap:
                outs.append(self.l2_norm(x))
        outs.append(x)
        for i, m in enumerate(self.extra):
            x = torch.relu(conv(x, m, self.dtype))
            if i % 2 == 1:
                outs.append(x)
        return tuple(outs)
