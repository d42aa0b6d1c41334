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

``dtype`` is the compute dtype (``layers.conv2d``): the stem casts the f32
images to it, and every conv, ReLU, pool and residual sum after runs in it.
A DCN conv2 in bf16 follows the JAX package's ``DeformConvPack``
(``sipmask_tpu/models/resnet.py:38-52``): its offset conv runs in bf16 and
its offsets are upcast to f32, the sampling and the contraction take the
bf16 input and return bf16, and its frozen BN is applied in bf16.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import deform_conv as dc_ops
from .layers import FrozenBatchNorm2d, conv, conv_folded_bn

STAGE_BLOCKS = {50: (3, 4, 6, 3), 101: (3, 4, 23, 3)}


class DeformConvPack(nn.Module):
    """3x3 deformable conv v1 whose offsets come from its own zero-init 3x3
    conv (with bias) on the input (mmdet's DeformConvPack): the sampled
    route, ``deform_conv.deform_conv2d_rows``. Its weight stays unfolded;
    the block applies the frozen BN after it. ``dtype``: the compute dtype
    of the offset conv and of the result (``forward`` takes another, as
    ``calibrate_frozen_bn`` runs the f32 graph); the offsets are f32."""

    def __init__(self, in_channels: int, out_channels: int,
                 deform_groups: int = 1, stride: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.stride, self.deform_groups = stride, deform_groups
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels,
                                               3, 3))
        self.conv_offset = nn.Conv2d(in_channels, deform_groups * 18, 3,
                                     stride, 1, bias=True)

    def forward(self, x, dtype=None):
        dt = self.dtype if dtype is None else dtype
        offsets = conv(x, self.conv_offset, dt)
        if dt == torch.bfloat16:
            x, offsets = x.to(dt), offsets.float()
        return dc_ops.deform_conv2d_rows(
            x, offsets, self.weight, stride=self.stride, padding=1,
            deform_groups=self.deform_groups)


class Bottleneck(nn.Module):
    def __init__(self, in_channels: int, planes: int, stride: int = 1,
                 downsample: bool = False, with_dcn: bool = False,
                 dcn_deform_groups: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.conv1 = nn.Conv2d(in_channels, planes, 1, stride, bias=False)
        self.bn1 = FrozenBatchNorm2d(planes)
        self.conv2 = (DeformConvPack(planes, planes, dcn_deform_groups,
                                     dtype=dtype)
                      if with_dcn else
                      nn.Conv2d(planes, planes, 3, 1, 1, bias=False))
        self.bn2 = FrozenBatchNorm2d(planes)
        self.conv3 = nn.Conv2d(planes, planes * 4, 1, bias=False)
        self.bn3 = FrozenBatchNorm2d(planes * 4)
        self.downsample = (nn.Sequential(
            nn.Conv2d(in_channels, planes * 4, 1, stride, bias=False),
            FrozenBatchNorm2d(planes * 4)) if downsample else None)

    def forward(self, x):
        dt = self.dtype
        out = torch.relu(conv_folded_bn(x, self.conv1, self.bn1, dt))
        if isinstance(self.conv2, DeformConvPack):
            out = self.conv2(out)
            scale, bias = (t.to(out.dtype)[:, None, None]
                           for t in self.bn2.affine())
            out = torch.relu(out * scale + bias)
        else:
            out = torch.relu(conv_folded_bn(out, self.conv2, self.bn2, dt))
        out = conv_folded_bn(out, self.conv3, self.bn3, dt)
        identity = (x if self.downsample is None else
                    conv_folded_bn(x, self.downsample[0], self.downsample[1],
                                   dt))
        return torch.relu(out + identity)


class ResNet(nn.Module):
    def __init__(self, depth: int = 50,
                 out_indices: Tuple[int, ...] = (0, 1, 2, 3),
                 frozen_stages: int = 1,
                 stage_with_dcn: Tuple[bool, ...] = (False,) * 4,
                 dcn_deform_groups: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
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
                    dcn_deform_groups=dcn_deform_groups, dtype=dtype))
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
        x = torch.relu(conv_folded_bn(x, self.conv1, self.bn1, self.dtype))
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
