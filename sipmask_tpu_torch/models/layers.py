"""Shared building blocks (NCHW), the port of ``sipmask_tpu/models/layers.py``.

Module attribute names follow the reference's mmdet ``state_dict`` names
(``conv``, ``gn``, ``bn1`` with ``running_mean``/``running_var``, ``scale``).

The compute dtype (``ModelConfig.compute_dtype``) follows flax's
``nn.Conv(dtype=...)`` as the JAX package uses it: parameters stay f32, each
conv casts its input and its (folded) kernel to the compute dtype and
returns it, and a conv's bias is cast and added after the conv
(:func:`conv2d`). GroupNorm keeps f32 statistics and returns its input's
dtype; ``Scale`` multiplies in its input's dtype. In f32 nothing is cast
and the graph is the f32 one.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import gn_relu as gn_ops


class FrozenBatchNorm2d(nn.Module):
    """BatchNorm with frozen statistics and affine, kept as buffers (the
    reference backbone's ``BN(requires_grad=False)`` + ``norm_eval``)."""

    def __init__(self, num_features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.register_buffer("weight", torch.ones(num_features))
        self.register_buffer("bias", torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def affine(self):
        """Folded (scale, bias): y = x*scale + bias."""
        scale = self.weight * torch.rsqrt(self.running_var + self.eps)
        return scale, self.bias - self.running_mean * scale


def conv2d(x, weight, bias, dtype, stride=1, padding=0, dilation=1,
           groups=1):
    """flax's ``nn.Conv(dtype=dtype)``. In bf16: x and the weight cast to
    bf16, the conv in bf16, then the bias cast to bf16 and added, as in
    JAX: the conv's sum is rounded to bf16 and the sum with the bias
    rounded again. On the CPU PyTorch's bf16 conv rounds before its bias
    too (the two forms give the same bits there); cuDNN's fused bias rounds
    once, so the card would round elsewhere than JAX. In f32 it is
    ``F.conv2d`` on the tensors as they are (a model cast to float64 runs in
    float64)."""
    if dtype != torch.bfloat16:
        return F.conv2d(x, weight, bias, stride, padding, dilation, groups)
    y = F.conv2d(x.to(dtype), weight.to(dtype), None, stride, padding,
                 dilation, groups)
    return y if bias is None else y + bias.to(dtype)[:, None, None]


def conv(x, m: nn.Conv2d, dtype=torch.float32):
    """``m`` applied as :func:`conv2d` in ``dtype``."""
    return conv2d(x, m.weight, m.bias, dtype, m.stride, m.padding,
                  m.dilation, m.groups)


def conv_folded_bn(x, conv: nn.Conv2d, bn: FrozenBatchNorm2d,
                   dtype=torch.float32):
    """``bn(conv(x))`` with the frozen-BN scale folded into the conv weight
    (``layers.ConvFoldedBN``): one conv, no pass over the activation. The
    fold is f32, then cast to ``dtype`` with x; the bias is added as
    :func:`conv2d` adds it."""
    scale, bias = bn.affine()
    return conv2d(x, conv.weight * scale[:, None, None, None], bias, dtype,
                  conv.stride, conv.padding, conv.dilation, conv.groups)


class Scale(nn.Module):
    """Learnable scalar multiplier (mmdet/ops/scale.py)."""

    def __init__(self, init_value: float = 1.0):
        super().__init__()
        self.scale = nn.Parameter(torch.tensor(float(init_value)))

    def forward(self, x):
        return x * self.scale.to(x.dtype)


class GroupNorm32(nn.Module):
    """GroupNorm(num_groups) with the ReLU fused when ``act`` (kernel K4 on
    CUDA, its plain version on the CPU): f32 statistics, the result in x's
    dtype."""

    def __init__(self, channels: int, num_groups: int = 32,
                 eps: float = 1e-5, act: bool = False):
        super().__init__()
        self.num_groups, self.eps, self.act = num_groups, eps, act
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x):
        return gn_ops.gn_relu(x, self.weight, self.bias, self.num_groups,
                              self.eps, self.act)


class ConvModule(nn.Module):
    """conv -> (GroupNorm32) -> (ReLU), mmdet's ConvModule: the conv has a
    bias only when there is no norm; padding defaults to 'same'."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 3, stride: int = 1,
                 norm: Optional[str] = None, act: bool = True,
                 padding: Optional[int] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.conv = nn.Conv2d(
            in_channels, out_channels, kernel_size, stride,
            kernel_size // 2 if padding is None else padding,
            bias=norm is None)
        self.gn = (GroupNorm32(out_channels, 32, 1e-5, act)
                   if norm == "gn" else None)
        self.act = act

    def forward(self, x):
        x = conv(x, self.conv, self.dtype)
        if self.gn is not None:
            return self.gn(x)       # the ReLU rides the norm
        return torch.relu(x) if self.act else x


def resize_bilinear(x, out_h: int, out_w: int):
    """Bilinear resize, half-pixel centres, in x's dtype. For upsampling
    this equals the JAX package's ``jax.image.resize(..., 'bilinear')``
    (in bf16 up to rounding: JAX rounds after each axis, F.interpolate
    once)."""
    return F.interpolate(x, size=(out_h, out_w), mode="bilinear",
                         align_corners=False)


def resize_nearest(x, out_h: int, out_w: int):
    """Nearest resize as mmdet's FPN does it, in x's dtype; at integer
    upsampling factors it equals the JAX package's
    ``jax.image.resize(..., 'nearest')``."""
    return F.interpolate(x, size=(out_h, out_w), mode="nearest")
