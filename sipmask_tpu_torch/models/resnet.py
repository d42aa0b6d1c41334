"""Caffe-style ResNet-50/101 backbone (NCHW), the port of
``sipmask_tpu/models/resnet.py`` without the DCN stages and ResNeXt groups.

Caffe style: a block's stride sits on its first 1x1 conv. Every BatchNorm is
frozen and folded into the conv before it; the stem and the first
``frozen_stages`` stages are frozen too. Names follow mmdet's ResNet
(``conv1``, ``bn1``, ``layer{s}.{b}.conv{1,2,3}``, ``downsample.{0,1}``).
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .layers import FrozenBatchNorm2d, conv_folded_bn

STAGE_BLOCKS = {50: (3, 4, 6, 3), 101: (3, 4, 23, 3)}


class Bottleneck(nn.Module):
    def __init__(self, in_channels: int, planes: int, stride: int = 1,
                 downsample: bool = False):
        super().__init__()
        self.conv1 = nn.Conv2d(in_channels, planes, 1, stride, bias=False)
        self.bn1 = FrozenBatchNorm2d(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, 1, 1, bias=False)
        self.bn2 = FrozenBatchNorm2d(planes)
        self.conv3 = nn.Conv2d(planes, planes * 4, 1, bias=False)
        self.bn3 = FrozenBatchNorm2d(planes * 4)
        self.downsample = (nn.Sequential(
            nn.Conv2d(in_channels, planes * 4, 1, stride, bias=False),
            FrozenBatchNorm2d(planes * 4)) if downsample else None)

    def forward(self, x):
        out = torch.relu(conv_folded_bn(x, self.conv1, self.bn1))
        out = torch.relu(conv_folded_bn(out, self.conv2, self.bn2))
        out = conv_folded_bn(out, self.conv3, self.bn3)
        identity = (x if self.downsample is None else
                    conv_folded_bn(x, self.downsample[0], self.downsample[1]))
        return torch.relu(out + identity)


class ResNet(nn.Module):
    def __init__(self, depth: int = 50,
                 out_indices: Tuple[int, ...] = (0, 1, 2, 3),
                 frozen_stages: int = 1):
        super().__init__()
        self.out_indices = out_indices
        self.frozen_stages = frozen_stages
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = FrozenBatchNorm2d(64)
        in_ch = 64
        for stage, n_blocks in enumerate(STAGE_BLOCKS[depth]):
            planes = 64 * 2 ** stage
            blocks = []
            for b in range(n_blocks):
                blocks.append(Bottleneck(
                    in_ch, planes, stride=(1 if stage == 0 or b else 2),
                    downsample=b == 0))
                in_ch = planes * 4
            self.add_module(f"layer{stage + 1}", nn.Sequential(*blocks))
        # frozen_stages (mmdet's _freeze_stages): the stem and the first
        # frozen_stages stages take no gradient and no update
        frozen = [self.conv1] + [getattr(self, f"layer{i}")
                                 for i in range(1, frozen_stages + 1)]
        for m in frozen:
            m.requires_grad_(False)

    def forward(self, x):
        """x: (B, 3, H, W) normalized BGR. Returns the out_indices of
        C2..C5."""
        x = torch.relu(conv_folded_bn(x, self.conv1, self.bn1))
        x = F.max_pool2d(x, 3, 2, 1)
        if self.frozen_stages >= 1:
            x = x.detach()
        outs = []
        for stage in range(4):
            x = getattr(self, f"layer{stage + 1}")(x)
            if stage + 1 <= self.frozen_stages:
                x = x.detach()
            if stage in self.out_indices:
                outs.append(x)
        return tuple(outs)
