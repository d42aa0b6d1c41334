"""Deformable bilinear sampling: kernels K1 (im2col, kc-major) and K5 (rows,
p-major) with K5's backward K5c, and their plain versions.

K1 is the counterpart of ``sipmask_tpu/ops/pallas/deform_gather.py``'s
kc-major forward (``sample_bilinear_rows_t`` and the TPU kernels behind it)
together with the position math of
``sipmask_tpu/ops/deform_conv.py:_sample_positions``. On a CUDA tensor
:func:`deform_im2col` launches ``csrc/deform_im2col.cu``; on a CPU tensor it
runs :func:`deform_im2col_plain`. Forward only: its backward is kernel K2 in
``deform_conv.py``.

K5 is the counterpart of ``deform_gather.sample_bilinear_rows``: the same
sampling emitted p-major, (N, P, K, Cg) with N = B*G, from channels-last
feature rows, so the (K*Cg) row of each output pixel feeds one matmul. One
kernel, ``csrc/deform_rows.cu``, replaces the TPU's separable and banded
forward kernels (``_sample_pallas_sep``, ``_sample_pallas``) and its dense
tiers; its backward :func:`deform_rows_backward` replaces
``_sample_pallas_bwd`` (K5c). :func:`deform_rows_plain` is ``sample_ref``.

Layouts (f32):
  K1: x        (B, C, H, W); deformable group g owns channels g*Cg .. (g+1)*Cg-1.
      offsets  (B, G*K*2, Ho, Wo) in the CUDA layout: channel g*2K + 2*(i*kw+j)
               holds dy and the next one dx, for tap (i, j) of group g.
      cols     (B, G*K*Cg, Ho*Wo); row g*K*Cg + (i*kw+j)*Cg + c.
  K5: x_rows   (N, H*W, Cg) channels-last rows, N = B*G (b-major).
      pyx      (N, K, P, 2) absolute (py, px) per tap and output pixel.
      sampled  (N, P, K, Cg).
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from . import native

_FLOATS = (torch.float32, torch.float64)


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
    if x.dtype not in _FLOATS or offsets.dtype != x.dtype:
        raise TypeError(f"float32 or float64 (the plain versions; the "
                        f"kernels take float32), got {x.dtype} and "
                        f"{offsets.dtype}")
    if x.device != offsets.device:
        raise ValueError(f"x on {x.device}, offsets on {offsets.device}")
    return b, c, h, w, g, k, ho, wo


def sample_positions(offsets, kh: int, kw: int, stride: int, padding: int,
                     dilation: int, deform_groups: int):
    """Absolute sampling positions: (py, px), each (B, G, K, Ho*Wo), in the
    offsets' float type.

    p = (ho*stride - pad + i*dilation + dy, wo*stride - pad + j*dilation + dx).
    """
    b, _, ho, wo = offsets.shape
    g, k = deform_groups, kh * kw
    off = offsets.reshape(b, g, k, 2, ho * wo)
    dev, dt = offsets.device, offsets.dtype
    base_y = (torch.arange(ho, device=dev) * stride - padding).to(dt)
    base_x = (torch.arange(wo, device=dev) * stride - padding).to(dt)
    tap_y = (torch.arange(kh, device=dev) * dilation).to(dt)
    tap_x = (torch.arange(kw, device=dev) * dilation).to(dt)
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
    if x.dtype != torch.float32:
        raise TypeError(f"the K1 kernel takes float32, got {x.dtype}")
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


# ------------------------------------------------- K5: p-major row sampling

def positions(offsets, kh: int, kw: int, stride: int, padding: int,
              dilation: int, deform_groups: int):
    """Offsets in the CUDA layout (B, G*K*2, Ho, Wo) -> ``pyx``
    (B*G, K, Ho*Wo, 2), as ``deform_conv._sample_positions`` builds it."""
    b = offsets.shape[0]
    py, px = sample_positions(offsets, kh, kw, stride, padding, dilation,
                              deform_groups)
    g, k, p = py.shape[1:]
    return torch.stack([py, px], -1).reshape(b * g, k, p, 2)


def _check_rows(x_rows, pyx, h: int, w: int):
    if x_rows.dim() != 3 or pyx.dim() != 4 or pyx.shape[-1] != 2:
        raise ValueError(f"x_rows must be (N, Q, Cg) and pyx (N, K, P, 2), "
                         f"got {tuple(x_rows.shape)} and {tuple(pyx.shape)}")
    n, q, cg = x_rows.shape
    if q != h * w or pyx.shape[0] != n:
        raise ValueError(f"x_rows {tuple(x_rows.shape)} and pyx "
                         f"{tuple(pyx.shape)} do not fit a {h}x{w} map")
    if x_rows.dtype not in _FLOATS or pyx.dtype != x_rows.dtype:
        raise TypeError(f"float32 or float64 (the plain versions; the "
                        f"kernels take float32), got {x_rows.dtype} and "
                        f"{pyx.dtype}")
    if x_rows.device != pyx.device:
        raise ValueError(f"x_rows on {x_rows.device}, pyx on {pyx.device}")
    return n, cg, pyx.shape[1], pyx.shape[2]


def deform_rows_plain(x_rows, pyx, h: int, w: int):
    """Plain PyTorch K5: ``deform_gather.sample_ref``, four gathers, each
    corner zero outside the map; differentiable by autograd (``floor`` has
    no gradient, which gives the one-sided position derivative).
    Returns (N, P, K, Cg), contiguous."""
    n, cg, k, p = _check_rows(x_rows, pyx, h, w)
    py, px = pyx[..., 0], pyx[..., 1]                       # (N, K, P)
    y0, x0 = torch.floor(py), torch.floor(px)
    out = 0.0
    for dy in (0, 1):
        for dx in (0, 1):
            yy, xx = y0 + dy, x0 + dx
            wgt = ((py - y0 if dy else 1.0 - (py - y0)) *
                   (px - x0 if dx else 1.0 - (px - x0)))
            inb = (yy >= 0) & (yy <= h - 1) & (xx >= 0) & (xx <= w - 1)
            qi = (yy.clamp(0, h - 1) * w + xx.clamp(0, w - 1)).long()
            v = torch.gather(x_rows, 1, qi.reshape(n, k * p, 1)
                             .expand(n, k * p, cg))
            out = out + v.reshape(n, k, p, cg) * (wgt * inb)[..., None]
    return out.permute(0, 2, 1, 3).contiguous()


def deform_rows_backward_plain(x_rows, pyx, dsampled, h: int, w: int):
    """Plain PyTorch K5c: (dx_rows, dpyx) of :func:`deform_rows_plain` for
    the cotangent ``dsampled`` (N, P, K, Cg), by autograd."""
    with torch.enable_grad():
        xs, pp = (t.detach().requires_grad_(True) for t in (x_rows, pyx))
        out = deform_rows_plain(xs, pp, h, w)
        return torch.autograd.grad(out, (xs, pp), dsampled)


def _rows_lib():
    lib = native.load("deform_rows")
    if lib.deform_rows_fwd_f32.argtypes is None:
        for fn, n_ptr in ((lib.deform_rows_fwd_f32, 3),
                          (lib.deform_rows_bwd_f32, 5)):
            fn.restype = ctypes.c_int
            fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * 7 + [
                ctypes.c_void_p]
    return lib


def _rows_launch_args(x_rows, pyx, tensors):
    """Checks of the CUDA path; returns the vec4 flag."""
    if x_rows.device.type != "cuda":
        raise ValueError(f"no K5 kernel for device {x_rows.device}")
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError("the K5 kernels take float32")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("x_rows, pyx and dsampled must be contiguous")
    cg = x_rows.shape[2]
    return int(cg % 4 == 0 and all(t.data_ptr() % 16 == 0 for t in tensors))


def deform_rows(x_rows, pyx, h: int, w: int):
    """K5: bilinear sampling of ``x_rows`` (N, h*w, Cg) at ``pyx``
    (N, K, P, 2) -> (N, P, K, Cg), the layout of
    ``deform_gather.sample_bilinear_rows``.

    CPU tensors take :func:`deform_rows_plain`; CUDA tensors launch
    ``csrc/deform_rows.cu`` (contiguous f32 only) and raise on anything it
    does not take. The kernel records no gradient, so on CUDA it also raises
    when one is wanted: differentiate through
    ``deform_conv.deform_conv2d_rows``, whose backward is K5c.
    """
    if x_rows.device.type == "cpu":
        return deform_rows_plain(x_rows, pyx, h, w)
    n, cg, k, p = _check_rows(x_rows, pyx, h, w)
    if torch.is_grad_enabled() and (x_rows.requires_grad or
                                    pyx.requires_grad):
        raise RuntimeError("deform_rows records no gradient on CUDA: "
                           "differentiate through "
                           "deform_conv.deform_conv2d_rows")
    vec4 = _rows_launch_args(x_rows, pyx, (x_rows, pyx))
    out = torch.empty((n, p, k, cg), device=x_rows.device,
                      dtype=torch.float32)
    if out.numel() == 0:
        return out
    lib = _rows_lib()
    with torch.cuda.device(x_rows.device):
        code = lib.deform_rows_fwd_f32(
            x_rows.data_ptr(), pyx.data_ptr(), out.data_ptr(), n, h, w, cg,
            k, p, vec4, native.stream_ptr(x_rows.device))
    native.check_launch(lib, "deform_rows", code)
    deform_rows.launches += 1
    return out


deform_rows.launches = 0


def deform_rows_backward(x_rows, pyx, dsampled, h: int, w: int):
    """K5c: (dx_rows (N, h*w, Cg), dpyx (N, K, P, 2)) of :func:`deform_rows`
    for the cotangent ``dsampled`` (N, P, K, Cg). The position derivative is
    the one-sided floor rule of ``deform_gather._dtent``. CPU tensors take
    :func:`deform_rows_backward_plain`; CUDA tensors zero dx and launch the
    kernel: dpyx gives the same bits on every call, dx's sums change order
    (atomics)."""
    if x_rows.device.type == "cpu":
        return deform_rows_backward_plain(x_rows, pyx, dsampled, h, w)
    n, cg, k, p = _check_rows(x_rows, pyx, h, w)
    if tuple(dsampled.shape) != (n, p, k, cg) or \
            dsampled.device != x_rows.device:
        raise ValueError(f"dsampled {tuple(dsampled.shape)} on "
                         f"{dsampled.device} does not fit {(n, p, k, cg)} "
                         f"on {x_rows.device}")
    vec4 = _rows_launch_args(x_rows, pyx, (x_rows, pyx, dsampled))
    dx = torch.zeros_like(x_rows)
    dpyx = torch.empty_like(pyx)
    if dsampled.numel() == 0:
        return dx, dpyx.zero_()
    lib = _rows_lib()
    with native.device_guard(x_rows.device):
        code = lib.deform_rows_bwd_f32(
            x_rows.data_ptr(), pyx.data_ptr(), dsampled.data_ptr(),
            dx.data_ptr(), dpyx.data_ptr(), n, h, w, cg, k, p, vec4,
            native.stream_ptr(x_rows.device))
    native.check_launch(lib, "deform_rows", code)
    deform_rows_backward.launches += 1
    return dx, dpyx


deform_rows_backward.launches = 0
