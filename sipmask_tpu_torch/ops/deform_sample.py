"""Deformable bilinear sampling as an im2col: kernel K1 and its plain version.

Counterpart of ``sipmask_tpu/ops/pallas/deform_gather.py``'s kc-major
forward (``sample_bilinear_rows_t`` and the TPU kernels behind it) together
with the position math of ``sipmask_tpu/ops/deform_conv.py:_sample_positions``.
On a CUDA tensor :func:`deform_im2col` launches ``csrc/deform_im2col.cu``; on
a CPU tensor it runs :func:`deform_im2col_plain`. Forward only: the backward
is kernel K2 in ``deform_conv.py``.

Layouts (NCHW, f32):
  x        (B, C, H, W); deformable group g owns channels g*Cg .. (g+1)*Cg-1.
  offsets  (B, G*K*2, Ho, Wo) in the CUDA layout: channel g*2K + 2*(i*kw+j)
           holds dy and the next one dx, for tap (i, j) of group g.
  cols     (B, G*K*Cg, Ho*Wo); row g*K*Cg + (i*kw+j)*Cg + c.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from . import native


def out_size(h: int, w: int, kh: int, kw: int, stride: int, padding: int,
             dilation: int) -> Tuple[int, int]:
    ho = (h + 2 * padding - dilation * (kh - 1) - 1) // stride + 1
    wo = (w + 2 * padding - dilation * (kw - 1) - 1) // stride + 1
    return ho, wo


def _check(x, offsets, kh, kw, stride, padding, dilation, deform_groups):
    if x.dim() != 4 or offsets.dim() != 4:
        raise ValueError(f"x and offsets must be NCHW, got {tuple(x.shape)} "
                         f"and {tuple(offsets.shape)}")
    b, c, h, w = x.shape
    g, k = deform_groups, kh * kw
    if c % g:
        raise ValueError(f"{c} channels do not split into {g} groups")
    ho, wo = out_size(h, w, kh, kw, stride, padding, dilation)
    if tuple(offsets.shape) != (b, g * k * 2, ho, wo):
        raise ValueError(f"offsets {tuple(offsets.shape)} != "
                         f"{(b, g * k * 2, ho, wo)}")
    if x.dtype != torch.float32 or offsets.dtype != torch.float32:
        raise TypeError(f"float32 only, got {x.dtype} and {offsets.dtype}")
    if x.device != offsets.device:
        raise ValueError(f"x on {x.device}, offsets on {offsets.device}")
    return b, c, h, w, g, k, ho, wo


def sample_positions(offsets, kh: int, kw: int, stride: int, padding: int,
                     dilation: int, deform_groups: int):
    """Absolute sampling positions: (py, px), each (B, G, K, Ho*Wo) f32.

    p = (ho*stride - pad + i*dilation + dy, wo*stride - pad + j*dilation + dx).
    """
    b, _, ho, wo = offsets.shape
    g, k = deform_groups, kh * kw
    off = offsets.float().reshape(b, g, k, 2, ho * wo)
    dev = offsets.device
    base_y = (torch.arange(ho, device=dev) * stride - padding).float()
    base_x = (torch.arange(wo, device=dev) * stride - padding).float()
    tap_y = (torch.arange(kh, device=dev) * dilation).float()
    tap_x = (torch.arange(kw, device=dev) * dilation).float()
    ty = tap_y[:, None].expand(kh, kw).reshape(k)
    tx = tap_x[None, :].expand(kh, kw).reshape(k)
    by = (base_y[None, :, None] + ty[:, None, None]).expand(k, ho, wo)
    bx = (base_x[None, None, :] + tx[:, None, None]).expand(k, ho, wo)
    py = by.reshape(k, ho * wo) + off[:, :, :, 0]
    px = bx.reshape(k, ho * wo) + off[:, :, :, 1]
    return py, px


def deform_im2col_plain(x, offsets, kernel_size=(3, 3), stride: int = 1,
                        padding: int = 1, dilation: int = 1,
                        deform_groups: int = 1):
    """Plain PyTorch K1: four gathers, each corner zero outside the map.

    Same arithmetic, in the same order, as ``deform_gather.sample_ref``.
    """
    kh, kw = kernel_size
    b, c, h, w, g, k, ho, wo = _check(x, offsets, kh, kw, stride, padding,
                                      dilation, deform_groups)
    cg, p = c // g, ho * wo
    py, px = sample_positions(offsets, kh, kw, stride, padding, dilation, g)
    y0, x0 = torch.floor(py), torch.floor(px)
    xg = x.reshape(b, g, cg, h * w)
    out = 0.0
    for dy in (0, 1):
        for dx in (0, 1):
            yy, xx = y0 + dy, x0 + dx
            wgt = ((py - y0 if dy else 1.0 - (py - y0)) *
                   (px - x0 if dx else 1.0 - (px - x0)))
            inb = (yy >= 0) & (yy <= h - 1) & (xx >= 0) & (xx <= w - 1)
            qi = (yy.clamp(0, h - 1) * w + xx.clamp(0, w - 1)).long()
            v = torch.gather(xg, 3, qi.reshape(b, g, 1, k * p)
                             .expand(b, g, cg, k * p))
            out = out + v.reshape(b, g, cg, k, p) * (
                wgt * inb).reshape(b, g, 1, k, p)
    return out.permute(0, 1, 3, 2, 4).reshape(b, g * k * cg, p)


def _lib():
    lib = native.load("deform_im2col")
    fn = lib.deform_im2col_f32
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 12 + [
            ctypes.c_void_p]
    return lib


def deform_im2col(x, offsets, kernel_size=(3, 3), stride: int = 1,
                  padding: int = 1, dilation: int = 1,
                  deform_groups: int = 1):
    """Deformable im2col: (x, offsets) -> cols, layouts in the module note.

    CPU tensors take :func:`deform_im2col_plain`; CUDA tensors launch the
    K1 kernel (contiguous f32 only) and raise on anything it does not take.
    The kernel records no gradient, so on CUDA it also raises when one is
    wanted: the deformable convolution differentiates through
    ``deform_conv.deform_conv2d``, whose backward is kernel K2.
    """
    if x.device.type == "cpu":
        return deform_im2col_plain(x, offsets, kernel_size, stride, padding,
                                   dilation, deform_groups)
    if x.device.type != "cuda":
        raise ValueError(f"no K1 kernel for device {x.device}")
    if torch.is_grad_enabled() and (x.requires_grad or
                                    offsets.requires_grad):
        raise RuntimeError("deform_im2col records no gradient on CUDA: "
                           "differentiate through deform_conv.deform_conv2d")
    kh, kw = kernel_size
    b, c, h, w, g, k, ho, wo = _check(x, offsets, kh, kw, stride, padding,
                                      dilation, deform_groups)
    if not (x.is_contiguous() and offsets.is_contiguous()):
        raise ValueError("x and offsets must be contiguous")
    cg = c // g
    if b * g > 65535 or k * -(-cg // 16) > 65535:  # 16: kChanChunk
        raise ValueError(f"grid too large for B*G={b * g}, K={k}, Cg={cg}")
    cols = torch.empty((b, g * k * cg, ho * wo), device=x.device,
                       dtype=torch.float32)
    if cols.numel() == 0:
        return cols
    lib = _lib()
    with torch.cuda.device(x.device):
        code = lib.deform_im2col_f32(
            x.data_ptr(), offsets.data_ptr(), cols.data_ptr(), b, c, h, w, g,
            ho, wo, kh, kw, stride, padding, dilation,
            native.stream_ptr(x.device))
    native.check_launch(lib, "deform_im2col", code)
    deform_im2col.launches += 1
    return cols


deform_im2col.launches = 0
