"""Feature Pyramid Network P3..P7 (NCHW), the port of
``sipmask_tpu/models/fpn.py`` in SipMask's configuration: laterals on C3..C5,
a nearest top-down path, P6 from P5's output and P7 from relu(P6)."""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from .layers import ConvModule, resize_nearest


class FPN(nn.Module):
    def __init__(self, in_channels: Sequence[int] = (256, 512, 1024, 2048),
                 out_channels: int = 256, start_level: int = 1,
                 num_outs: int = 5):
        super().__init__()
        self.start_level, self.num_outs = start_level, num_outs
        used = in_channels[start_level:]
        self.lateral_convs = nn.ModuleList(
            ConvModule(c, out_channels, 1, act=False) for c in used)
        self.fpn_convs = nn.ModuleList(
            ConvModule(out_channels, out_channels, 3,
                       stride=1 if i < len(used) else 2, act=False)
            for i in range(num_outs))

    def forward(self, inputs):
        used = inputs[self.start_level:]
        n = len(used)
        laterals = [conv(x) for conv, x in zip(self.lateral_convs, used)]
        for i in range(n - 1, 0, -1):
            h, w = laterals[i - 1].shape[2:]
            laterals[i - 1] = laterals[i - 1] + resize_nearest(laterals[i], h,
                                                               w)
        outs = [self.fpn_convs[i](laterals[i]) for i in range(n)]
        src = outs[-1]
        for i in range(n, self.num_outs):
            if i > n:
                src = torch.relu(src)
            src = self.fpn_convs[i](src)
            outs.append(src)
        return tuple(outs)
