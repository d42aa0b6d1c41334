"""HRNetV2 backbone and HRFPN neck (NCHW), the port of
``sipmask_tpu/models/hrnet.py``.

HRNet: a stem of two stride-2 3x3 convs, stage 1's four Bottlenecks at 64
planes, then stages 2-4 of parallel branches at strides 4/8/16/32 whose
modules end in an exchange (fuse) unit. HRFPN upsamples every branch to
1/4, concatenates them, reduces with a 1x1 conv and average-pools the
result into five levels at strides 8-128, each through a 3x3 conv.

The frozen BNs are applied as the JAX package applies them: *unfolded*
(``FrozenBatchNorm2d.forward``) after the stem, transition, BasicBlock and
fuse convs, and *folded* into the convs of stage 1's Bottlenecks
(``resnet.Bottleneck``). ``dtype`` is the compute dtype
(``layers.conv2d``): every conv takes and returns it, and the BNs, sums,
resizes and pools run on tensors of it.

Names follow mmdet's ``HRNet`` and ``HRFPN`` ``state_dict``s, so a
reference checkpoint loads by name: ``conv1``/``bn1``/``conv2``/``bn2`` (the
stem), ``layer1.{b}``, ``transition{s-1}.{i}.{0,1}`` (a branch whose width
changes) or ``.{i}.0.{0,1}`` (a new branch), ``stage{s}.{m}.branches.{i}.{b}``
and ``stage{s}.{m}.fuse_layers.{i}.{j}.{0,1}`` (upsampling) or
``.{i}.{j}.{k}.{0,1}`` (the k-th conv of a downsampling chain);
``neck.reduction_conv.conv`` and ``neck.fpn_convs.{i}.conv``.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .layers import ConvModule, FrozenBatchNorm2d, conv, repeat2d, \
    resize_bilinear
from .resnet import Bottleneck

HRNET_WIDTHS = {18: (18, 36, 72, 144), 32: (32, 64, 128, 256),
                48: (48, 96, 192, 384)}
# (num_modules, num_blocks) of stages 2..4, the standard HRNet recipe
STAGE_SPEC = ((1, 4), (4, 4), (3, 4))


def _conv_bn(cin: int, cout: int, k: int, stride: int = 1) -> nn.Sequential:
    """A bias-free conv and its frozen BN (``.0``, ``.1``)."""
    return nn.Sequential(nn.Conv2d(cin, cout, k, stride, k // 2, bias=False),
                         FrozenBatchNorm2d(cout))


def _apply(seq: nn.Sequential, x, dtype):
    """``seq``'s conv in ``dtype``, then its BN unfolded."""
    return seq[1](conv(x, seq[0], dtype))


class BasicBlock(nn.Module):
    """Two 3x3 convs with unfolded BN and the identity shortcut (a branch's
    input always has the branch's width in HRNet)."""

    def __init__(self, channels: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.conv1 = nn.Conv2d(channels, channels, 3, 1, 1, bias=False)
        self.bn1 = FrozenBatchNorm2d(channels)
        self.conv2 = nn.Conv2d(channels, channels, 3, 1, 1, bias=False)
        self.bn2 = FrozenBatchNorm2d(channels)

    def forward(self, x):
        out = torch.relu(self.bn1(conv(x, self.conv1, self.dtype)))
        out = self.bn2(conv(out, self.conv2, self.dtype))
        return torch.relu(out + x)


class HRModule(nn.Module):
    """``num_blocks`` BasicBlocks a branch, then the exchange unit: branch i
    receives every other branch j, upsampled (1x1 conv, BN, nearest
    repetition by 2**(j-i)) or downsampled (i-j stride-2 3x3 convs, each
    with BN and all but the last with a ReLU), added in order of j; one ReLU
    after the sum."""

    def __init__(self, widths: Sequence[int], num_blocks: int = 4,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        n = len(widths)
        self.branches = nn.ModuleList(
            nn.Sequential(*(BasicBlock(w, dtype) for _ in range(num_blocks)))
            for w in widths)
        self.fuse_layers = nn.ModuleList()
        for i in range(n):
            row = []
            for j in range(n):
                if j > i:
                    row.append(_conv_bn(widths[j], widths[i], 1))
                elif j < i:
                    row.append(nn.Sequential(*(
                        _conv_bn(widths[j],
                                 widths[i] if s == i - j - 1 else widths[j],
                                 3, 2)
                        for s in range(i - j))))
                else:
                    row.append(None)
            self.fuse_layers.append(nn.ModuleList(row))

    def forward(self, xs):
        dt = self.dtype
        xs = [branch(x) for branch, x in zip(self.branches, xs)]
        outs = []
        for i, row in enumerate(self.fuse_layers):
            acc = xs[i]
            for j, layer in enumerate(row):
                if j == i:
                    continue
                if j > i:
                    y = repeat2d(_apply(layer, xs[j], dt), 2 ** (j - i))
                else:
                    y = xs[j]
                    for s, step in enumerate(layer):
                        y = _apply(step, y, dt)
                        if s < i - j - 1:
                            y = torch.relu(y)
                acc = acc + y
            outs.append(torch.relu(acc))
        return outs


class HRNet(nn.Module):
    """HighResolutionNet (HRNetV2); returns the four branch maps at strides
    4/8/16/32.

    ``frozen_stages`` >= 1 freezes stage 1's Bottlenecks (``layer1``) as the
    JAX package's optimizer labels them (``backbone/layer1_*``); the stem
    trains, and the gradient flows through stage 1 into it."""

    def __init__(self, width: int = 32, frozen_stages: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        widths = HRNET_WIDTHS[width]
        self.conv1 = nn.Conv2d(3, 64, 3, 2, 1, bias=False)
        self.bn1 = FrozenBatchNorm2d(64)
        self.conv2 = nn.Conv2d(64, 64, 3, 2, 1, bias=False)
        self.bn2 = FrozenBatchNorm2d(64)
        self.layer1 = nn.Sequential(*(
            Bottleneck(64 if b == 0 else 256, 64, downsample=b == 0,
                       dtype=dtype) for b in range(4)))
        prev = [256]
        for stage, (n_modules, n_blocks) in enumerate(STAGE_SPEC, start=2):
            ws = widths[:stage]
            trans = []
            for i, w in enumerate(ws):
                if i < len(prev):
                    trans.append(_conv_bn(prev[i], w, 3)
                                 if prev[i] != w else None)
                else:   # a new branch from the lowest-resolution one
                    trans.append(nn.Sequential(_conv_bn(prev[-1], w, 3, 2)))
            self.add_module(f"transition{stage - 1}", nn.ModuleList(trans))
            self.add_module(f"stage{stage}", nn.ModuleList(
                HRModule(ws, n_blocks, dtype) for _ in range(n_modules)))
            prev = list(ws)
        if frozen_stages >= 1:
            self.layer1.requires_grad_(False)

    def forward(self, x):
        """x: (B, 3, H, W) normalized BGR, H and W multiples of 32."""
        dt = self.dtype
        x = torch.relu(self.bn1(conv(x, self.conv1, dt)))
        x = torch.relu(self.bn2(conv(x, self.conv2, dt)))
        xs = [self.layer1(x)]
        for stage in range(2, 2 + len(STAGE_SPEC)):
            new = []
            for i, t in enumerate(getattr(self, f"transition{stage - 1}")):
                if i < len(xs):
                    new.append(xs[i] if t is None
                               else torch.relu(_apply(t, xs[i], dt)))
                else:
                    new.append(torch.relu(_apply(t[0], xs[-1], dt)))
            xs = new
            for module in getattr(self, f"stage{stage}"):
                xs = module(xs)
        return tuple(xs)


class HRFPN(nn.Module):
    """HRFPN: every branch bilinearly upsampled to the first's size
    (half-pixel centres), concatenated, a 1x1 ``reduction_conv`` with bias,
    then level i average-pooled with window = stride = 2**(i+1) (floor
    sizes; the window clamped to the map for tiny inputs) and a 3x3 conv
    with bias, no ReLU: strides 8..128 on HRNet's stride-4 base."""

    def __init__(self, in_channels: Sequence[int], out_channels: int = 256,
                 num_outs: int = 5, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.reduction_conv = ConvModule(sum(in_channels), out_channels, 1,
                                         act=False, dtype=dtype)
        self.fpn_convs = nn.ModuleList(
            ConvModule(out_channels, out_channels, 3, act=False, dtype=dtype)
            for _ in range(num_outs))

    def forward(self, feats) -> Tuple[torch.Tensor, ...]:
        h, w = feats[0].shape[2:]
        x = self.reduction_conv(torch.cat(
            [feats[0]] + [resize_bilinear(f, h, w) for f in feats[1:]], 1))
        outs = []
        for i, fpn_conv in enumerate(self.fpn_convs):
            k = 2 ** (i + 1)
            kh, kw = min(k, h), min(k, w)
            outs.append(fpn_conv(F.avg_pool2d(x, (kh, kw), (kh, kw))))
        return tuple(outs)
