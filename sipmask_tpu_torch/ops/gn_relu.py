"""GroupNorm (+ ReLU) forward: kernel K4 and its plain version.

Counterpart of ``sipmask_tpu/ops/pallas/group_norm.py:fused_gn_relu`` (its
forward, ``_fwd_impl``) and of ``sipmask_tpu/models/layers.py:
group_norm_nhwc`` + relu. On a CUDA tensor :func:`gn_relu` launches
``csrc/gn_relu.cu``; on a CPU tensor it runs :func:`gn_relu_plain`.

Layout: x and the result (B, C, H, W), f32; weight and bias (C,).
"""

from __future__ import annotations

import ctypes

import torch

from . import native


def _check(x, weight, bias, groups):
    if x.dim() != 4:
        raise ValueError(f"x must be NCHW, got {tuple(x.shape)}")
    c = x.shape[1]
    if c % groups:
        raise ValueError(f"{c} channels do not split into {groups} groups")
    if tuple(weight.shape) != (c,) or tuple(bias.shape) != (c,):
        raise ValueError(f"weight {tuple(weight.shape)} and bias "
                         f"{tuple(bias.shape)} must be ({c},)")
    if not x.dtype == weight.dtype == bias.dtype == torch.float32:
        raise TypeError(f"float32 only, got {x.dtype}, {weight.dtype}, "
                        f"{bias.dtype}")
    if not x.device == weight.device == bias.device:
        raise ValueError("x, weight and bias must share a device")


def gn_relu_plain(x, weight, bias, groups: int = 32, eps: float = 1e-5,
                  act: bool = True):
    """Plain PyTorch K4: the single-pass-variance GroupNorm of
    ``layers._gn_fwd_impl``, then a ReLU when ``act``."""
    _check(x, weight, bias, groups)
    b, c, h, w = x.shape
    cg = c // groups
    xf = x.float()
    s1 = xf.sum((2, 3))                  # (B, C)
    s2 = (xf * xf).sum((2, 3))
    n = float(h * w * cg)
    mean = s1.reshape(b, groups, cg).sum(-1) / n          # (B, G)
    var = s2.reshape(b, groups, cg).sum(-1) / n - mean * mean
    rstd = torch.rsqrt(var + eps)
    g_sc = weight.float().reshape(groups, cg)
    g_bi = bias.float().reshape(groups, cg)
    sc = (rstd[:, :, None] * g_sc).reshape(b, c)
    bi = (g_bi - (mean * rstd)[:, :, None] * g_sc).reshape(b, c)
    y = xf * sc[:, :, None, None] + bi[:, :, None, None]
    return torch.relu(y) if act else y


def _lib():
    lib = native.load("gn_relu")
    if lib.gn_relu_f32.argtypes is None:
        lib.gn_relu_num_partials.restype = ctypes.c_int
        lib.gn_relu_num_partials.argtypes = [ctypes.c_longlong]
        lib.gn_relu_f32.restype = ctypes.c_int
        lib.gn_relu_f32.argtypes = (
            [ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_int,
                                     ctypes.c_longlong, ctypes.c_int,
                                     ctypes.c_float, ctypes.c_int,
                                     ctypes.c_void_p])
    return lib


def gn_relu(x, weight, bias, groups: int = 32, eps: float = 1e-5,
            act: bool = True):
    """GroupNorm(groups) with a per-channel affine, then ReLU when ``act``.

    CPU tensors take :func:`gn_relu_plain`; CUDA tensors launch the K4
    kernels (contiguous f32 only) and raise on anything they do not take.
    """
    if x.device.type == "cpu":
        return gn_relu_plain(x, weight, bias, groups, eps, act)
    if x.device.type != "cuda":
        raise ValueError(f"no K4 kernel for device {x.device}")
    _check(x, weight, bias, groups)
    if not (x.is_contiguous() and weight.is_contiguous()
            and bias.is_contiguous()):
        raise ValueError("x, weight and bias must be contiguous")
    b, c, h, w = x.shape
    if b * groups > 65535:
        raise ValueError(f"grid too large for B*G={b * groups}")
    y = torch.empty_like(x)
    if y.numel() == 0:
        return y
    lib = _lib()
    parts = lib.gn_relu_num_partials(c // groups * h * w)
    partial = torch.empty((b * groups * parts * 2,), device=x.device,
                          dtype=torch.float32)
    with torch.cuda.device(x.device):
        code = lib.gn_relu_f32(
            x.data_ptr(), weight.data_ptr(), bias.data_ptr(),
            partial.data_ptr(), y.data_ptr(), b, c, h * w, groups, eps,
            int(act), native.stream_ptr(x.device))
    native.check_launch(lib, "gn_relu", code)
    gn_relu.launches += 1
    return y


gn_relu.launches = 0
