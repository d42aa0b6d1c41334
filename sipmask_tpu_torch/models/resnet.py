"""Caffe-style ResNet-50/101 backbone (NCHW) with optional DCN stages, the
port of ``sipmask_tpu/models/resnet.py`` without the ResNeXt groups.

Caffe style: a block's stride sits on its first 1x1 conv. Every BatchNorm is
frozen and folded into the conv before it; the stem and the first
``frozen_stages`` stages are frozen too. A stage with DCN (SipMask++) puts a
``DeformConvPack`` in place of conv2 of every third block (b % 3 == 0), as
the SipMask fork of mmdet does: R101 has 2 + 8 + 1 of them in stages 2-4.
Names follow mmdet's ResNet (``conv1``, ``bn1``, ``layer{s}.{b}.conv{1,2,3}``,
``downsample.{0,1}``; a DCN conv2 has ``weight`` and
``conv_offset.{weight,bias}``).
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import deform_conv as dc_ops
from .layers import FrozenBatchNorm2d, conv_folded_bn

STAGE_BLOCKS = {50: (3, 4, 6, 3), 101: (3, 4, 23, 3)}


class DeformConvPack(nn.Module):
    """3x3 deformable conv v1 whose offsets come from its own zero-init 3x3
    conv (with bias) on the input (mmdet's DeformConvPack): the sampled
    route, ``deform_conv.deform_conv2d_rows``. Its weight stays unfolded;
    the block applies the frozen BN after it."""

    def __init__(self, in_channels: int, out_channels: int,
                 deform_groups: int = 1, stride: int = 1):
        super().__init__()
        self.stride, self.deform_groups = stride, deform_groups
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels,
                                               3, 3))
        self.conv_offset = nn.Conv2d(in_channels, deform_groups * 18, 3,
                                     stride, 1, bias=True)

    def forward(self, x):
        return dc_ops.deform_conv2d_rows(
            x, self.conv_offset(x), self.weight, stride=self.stride,
            padding=1, deform_groups=self.deform_groups)


class Bottleneck(nn.Module):
    def __init__(self, in_channels: int, planes: int, stride: int = 1,
                 downsample: bool = False, with_dcn: bool = False,
                 dcn_deform_groups: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(in_channels, planes, 1, stride, bias=False)
        self.bn1 = FrozenBatchNorm2d(planes)
        self.conv2 = (DeformConvPack(planes, planes, dcn_deform_groups)
                      if with_dcn else
                      nn.Conv2d(planes, planes, 3, 1, 1, bias=False))
        self.bn2 = FrozenBatchNorm2d(planes)
        self.conv3 = nn.Conv2d(planes, planes * 4, 1, bias=False)
        self.bn3 = FrozenBatchNorm2d(planes * 4)
        self.downsample = (nn.Sequential(
            nn.Conv2d(in_channels, planes * 4, 1, stride, bias=False),
            FrozenBatchNorm2d(planes * 4)) if downsample else None)

    def forward(self, x):
        out = torch.relu(conv_folded_bn(x, self.conv1, self.bn1))
        if isinstance(self.conv2, DeformConvPack):
            scale, bias = self.bn2.affine()
            out = self.conv2(out) * scale[:, None, None] + bias[:, None, None]
            out = torch.relu(out)
        else:
            out = torch.relu(conv_folded_bn(out, self.conv2, self.bn2))
        out = conv_folded_bn(out, self.conv3, self.bn3)
        identity = (x if self.downsample is None else
                    conv_folded_bn(x, self.downsample[0], self.downsample[1]))
        return torch.relu(out + identity)


class ResNet(nn.Module):
    def __init__(self, depth: int = 50,
                 out_indices: Tuple[int, ...] = (0, 1, 2, 3),
                 frozen_stages: int = 1,
                 stage_with_dcn: Tuple[bool, ...] = (False,) * 4,
                 dcn_deform_groups: int = 1):
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
                    downsample=b == 0,
                    with_dcn=stage_with_dcn[stage] and b % 3 == 0,
                    dcn_deform_groups=dcn_deform_groups))
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
