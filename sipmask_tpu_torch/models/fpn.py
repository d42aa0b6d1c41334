"""Feature Pyramid Network P3..P7 (NCHW), the port of
``sipmask_tpu/models/fpn.py``: laterals on the inputs from ``start_level``,
a nearest top-down path, then (``add_extra_convs``) stride-2 3x3 convs for
the levels beyond the inputs, from the last output (SipMask's setting) or
the last input (``extra_convs_on_inputs``), each but the first after a ReLU
when ``relu_before_extra_convs``; in the compute dtype ``dtype``
(``layers.conv2d``). Without ``add_extra_convs`` it returns one level an
input, as the JAX package does."""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from .layers import ConvModule, resize_nearest


class FPN(nn.Module):
    def __init__(self, in_channels: Sequence[int] = (256, 512, 1024, 2048),
                 out_channels: int = 256, start_level: int = 1,
                 num_outs: int = 5, add_extra_convs: bool = True,
                 extra_convs_on_inputs: bool = False,
                 relu_before_extra_convs: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.start_level = start_level
        self.on_inputs = extra_convs_on_inputs
        self.relu_before_extra = relu_before_extra_convs
        used = in_channels[start_level:]
        n_out = num_outs if add_extra_convs else len(used)
        self.lateral_convs = nn.ModuleList(
            ConvModule(c, out_channels, 1, act=False, dtype=dtype)
            for c in used)
        self.fpn_convs = nn.ModuleList(
            ConvModule(in_channels[-1] if i == len(used) and
                       extra_convs_on_inputs else out_channels,
                       out_channels, 3, stride=1 if i < len(used) else 2,
                       act=False, dtype=dtype)
            for i in range(n_out))

    def forward(self, inputs):
        used = inputs[self.start_level:]
        n = len(used)
        laterals = [conv(x) for conv, x in zip(self.lateral_convs, used)]
        for i in range(n - 1, 0, -1):
            h, w = laterals[i - 1].shape[2:]
            laterals[i - 1] = laterals[i - 1] + resize_nearest(laterals[i], h,
                                                               w)
        outs = [self.fpn_convs[i](laterals[i]) for i in range(n)]
        src = inputs[-1] if self.on_inputs else outs[-1]
        for i in range(n, len(self.fpn_convs)):
            if i > n and self.relu_before_extra:
                src = torch.relu(src)
            src = self.fpn_convs[i](src)
            outs.append(src)
        return tuple(outs)
