"""Deformable convolution v1, the port of
``sipmask_tpu/ops/deform_conv.py:deform_conv2d``, with kernel K2 (its
backward) and the plain version.

On CUDA tensors :func:`deform_conv2d` is a ``torch.autograd.Function``: the
forward samples with K1 (:func:`.deform_sample.deform_im2col`) and contracts
the taps with one ``torch.matmul``, as the JAX package leaves its own
contraction (``deform_conv.py:104-107``) to XLA outside the Pallas kernel;
it saves ``cols``, as the JAX code saves ``sampT``. The backward is K2
(:func:`deform_conv_backward`, ``csrc/deform_col2im.cu``), which computes
every product of the TPU kernel itself: the two GEMMs, the col2im and the
position gradients. On CPU tensors it is :func:`deform_conv2d_plain`,
autograd through ``deform_im2col_plain``.

Layouts (NCHW, f32): x (B, C, H, W); offsets (B, G*K*2, Ho, Wo) in the CUDA
layout ([dy, dx] per tap, group-major), K = kh*kw; weight (O, C, kh, kw);
w2 (O, G*K*Cg), the weight in the row order of ``cols``.
"""

from __future__ import annotations

import ctypes

import torch

from . import deform_sample, native


def _w2(weight, deform_groups: int):
    """(O, C, kh, kw) -> (O, G*K*Cg) in the row order of cols."""
    o, c, kh, kw = weight.shape
    g = deform_groups
    return weight.reshape(o, g, c // g, kh * kw).permute(0, 1, 3, 2).reshape(
        o, -1)


def _check_weight(x, weight):
    if weight.dim() != 4 or weight.shape[1] != x.shape[1]:
        raise ValueError(f"weight {tuple(weight.shape)} does not take "
                         f"{x.shape[1]} channels")


def deform_conv2d_plain(x, offsets, weight, *, stride: int = 1,
                        padding: int = 1, dilation: int = 1,
                        deform_groups: int = 1):
    """Plain PyTorch deformable conv: :func:`deform_im2col_plain` and one
    ``torch.matmul``, differentiable by autograd."""
    _check_weight(x, weight)
    kh, kw = weight.shape[2:]
    cols = deform_sample.deform_im2col_plain(x, offsets, (kh, kw), stride,
                                             padding, dilation, deform_groups)
    out = torch.matmul(_w2(weight, deform_groups), cols)   # (B, O, P)
    return out.reshape(x.shape[0], weight.shape[0], *offsets.shape[2:])


def deform_conv_backward_plain(x, offsets, w2, dy, kernel_size=(3, 3),
                               stride: int = 1, padding: int = 1,
                               dilation: int = 1, deform_groups: int = 1):
    """Plain PyTorch K2: (dx, d offsets, d w2) of ``w2 @ cols`` with the
    cotangent dy (B, O, Ho, Wo), by autograd through
    :func:`deform_im2col_plain`."""
    with torch.enable_grad():
        xs, off, w = (t.detach().requires_grad_(True)
                      for t in (x, offsets, w2))
        cols = deform_sample.deform_im2col_plain(
            xs, off, kernel_size, stride, padding, dilation, deform_groups)
        out = torch.matmul(w, cols)
        return torch.autograd.grad(out, (xs, off, w),
                                   dy.reshape(out.shape))


def _lib():
    lib = native.load("deform_col2im")
    fn = lib.deform_conv_bwd_f32
    if fn.argtypes is None:
        lib.deform_conv_bwd_partial_floats.restype = ctypes.c_longlong
        lib.deform_conv_bwd_partial_floats.argtypes = [ctypes.c_int] * 4
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 13 + [
            ctypes.c_void_p]
    return lib


def deform_conv_backward(x, offsets, cols, w2, dy, kernel_size=(3, 3),
                         stride: int = 1, padding: int = 1,
                         dilation: int = 1, deform_groups: int = 1):
    """K2: (dx, d offsets, d w2) of ``out = w2 @ cols`` (B, O, P) with
    ``cols = deform_im2col(x, offsets)``, for the cotangent dy
    (B, O, Ho, Wo). CPU tensors take :func:`deform_conv_backward_plain`;
    CUDA tensors launch the kernels (contiguous f32 only) and raise on
    anything they do not take."""
    if x.device.type == "cpu":
        return deform_conv_backward_plain(x, offsets, w2, dy, kernel_size,
                                          stride, padding, dilation,
                                          deform_groups)
    if x.device.type != "cuda":
        raise ValueError(f"no K2 kernel for device {x.device}")
    kh, kw = kernel_size
    b, c, h, w, g, k, ho, wo = deform_sample._check(
        x, offsets, kh, kw, stride, padding, dilation, deform_groups)
    o, kc, p = w2.shape[0], g * k * (c // g), ho * wo
    if (tuple(w2.shape) != (o, kc) or tuple(cols.shape) != (b, kc, p)
            or dy.numel() != b * o * p):
        raise ValueError(f"w2 {tuple(w2.shape)}, cols {tuple(cols.shape)}, "
                         f"dy {tuple(dy.shape)} do not fit x "
                         f"{tuple(x.shape)} and offsets "
                         f"{tuple(offsets.shape)}")
    ts = (x, offsets, cols, w2, dy)
    if any(t.dtype != torch.float32 for t in ts):
        raise TypeError("float32 only")
    if any(t.device != x.device for t in ts):
        raise ValueError("all inputs must be on one device")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("x, offsets, cols, w2 and dy must be contiguous")
    if b * g > 65535 or k > 65535:
        raise ValueError(f"grid too large for B*G={b * g}, K={k}")
    lib = _lib()
    dcols = torch.empty_like(cols)
    partial = torch.empty((lib.deform_conv_bwd_partial_floats(b, o, kc, p),),
                          device=x.device, dtype=torch.float32)
    dx = torch.zeros_like(x)
    doffsets = torch.empty_like(offsets)
    dw2 = torch.empty_like(w2)
    if p == 0 or b == 0:
        return dx, doffsets, dw2.zero_()
    with torch.cuda.device(x.device):
        code = lib.deform_conv_bwd_f32(
            x.data_ptr(), offsets.data_ptr(), cols.data_ptr(), w2.data_ptr(),
            dy.data_ptr(), dcols.data_ptr(), partial.data_ptr(),
            dx.data_ptr(), doffsets.data_ptr(), dw2.data_ptr(), b, c, h, w, g,
            ho, wo, kh, kw, stride, padding, dilation, o,
            native.stream_ptr(x.device))
    native.check_launch(lib, "deform_col2im", code)
    deform_conv_backward.launches += 1
    return dx, doffsets, dw2


deform_conv_backward.launches = 0


class _DeformConv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, offsets, w2, kernel_size, stride, padding, dilation,
                deform_groups):
        cols = deform_sample.deform_im2col(x, offsets, kernel_size, stride,
                                           padding, dilation, deform_groups)
        ctx.save_for_backward(x, offsets, cols, w2)
        ctx.conf = (kernel_size, stride, padding, dilation, deform_groups)
        return torch.matmul(w2, cols)                       # (B, O, P)

    @staticmethod
    def backward(ctx, dout):
        x, offsets, cols, w2 = ctx.saved_tensors
        dx, doffsets, dw2 = deform_conv_backward(
            x, offsets, cols, w2, dout.contiguous(), *ctx.conf)
        return dx, doffsets, dw2, None, None, None, None, None


def deform_conv2d(x, offsets, weight, *, stride: int = 1, padding: int = 1,
                  dilation: int = 1, deform_groups: int = 1):
    """Deformable conv, NCHW, differentiable in x, offsets and weight.

    Args:
      x: (B, C, H, W) f32.
      offsets: (B, G*K*2, Ho, Wo) in the CUDA layout ([dy, dx] per tap,
        group-major), K = kh*kw.
      weight: (O, C, kh, kw) OIHW.
    Returns:
      (B, O, Ho, Wo).
    """
    if x.device.type == "cpu":
        return deform_conv2d_plain(x, offsets, weight, stride=stride,
                                   padding=padding, dilation=dilation,
                                   deform_groups=deform_groups)
    _check_weight(x, weight)
    kh, kw = weight.shape[2:]
    out = _DeformConv.apply(x.contiguous(), offsets.contiguous(),
                            _w2(weight, deform_groups).contiguous(), (kh, kw),
                            stride, padding, dilation, deform_groups)
    return out.reshape(x.shape[0], weight.shape[0], *offsets.shape[2:])
