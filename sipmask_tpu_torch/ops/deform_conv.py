"""Deformable convolution v1/v2, the port of
``sipmask_tpu/ops/deform_conv.py:deform_conv2d``, on two routes.

**The im2col route** (:func:`deform_conv2d`, FeatureAlign): on CUDA tensors a
``torch.autograd.Function`` whose forward samples with K1
(:func:`.deform_sample.deform_im2col`) and contracts the taps with one
``torch.matmul``, as the JAX package leaves its own contraction
(``deform_conv.py:104-107``) to XLA outside the Pallas kernel; it saves
``cols``, as the JAX code saves ``sampT``. The backward is K2
(:func:`deform_conv_backward`, ``csrc/deform_col2im.cu``), which computes
every product of the TPU kernel itself: the two GEMMs (on the tensor cores
in 3xTF32, f32-accurate; :func:`tf32_split_matmul_plain` states the
split), the col2im and the position gradients. On CPU tensors it is
:func:`deform_conv2d_plain`, autograd through ``deform_im2col_plain``.

**The sampled route** (:func:`deform_conv2d_rows`, the SipMask++ backbone's
``DeformConvPack``, and :func:`modulated_deform_conv2d`): the JAX package's
``sample_bilinear_rows`` path (``deform_conv.py:193-215``). On CUDA a
``torch.autograd.Function``: the forward samples with K5
(:func:`.deform_sample.deform_rows`, p-major rows) and contracts with one
``torch.matmul`` (B*P, K*C) x (K*C, O); the backward forms dsampled = dy*W^T
and dW = sampled^T*dy with ``torch.matmul``, as the JAX package does outside
any Pallas kernel on this route, then K5c
(:func:`.deform_sample.deform_rows_backward`) for dX and d offsets. A DCNv2
modulation mask multiplies the sampled taps outside the kernel, as in JAX
(``deform_conv.py:200-202``). x arrives NCHW and the route wants
channels-last rows, so each call permutes x once (a read and a write of x,
a ninth of the sampled tensor it produces) and permutes the (B, P, O)
product back to NCHW.

Routing is by module, not by a TPU budget: FeatureAlign takes the im2col
route and ``DeformConvPack`` the sampled route. In the JAX package the
backbone's layer2 DCN (Cg = O = 128) fits the fused core's VMEM budget and
takes the kc-major route (``deform_conv.py:139-146``), while layer3 and
layer4 take the sampled one; the port runs all three on the sampled route:
the same function, summed in another order.

Layouts (NCHW, f32): x (B, C, H, W); offsets (B, G*K*2, Ho, Wo) in the CUDA
layout ([dy, dx] per tap, group-major), K = kh*kw; mask (B, G*K, Ho, Wo);
weight (O, C, kh, kw); w2 (O, G*K*Cg), the weight in the row order of
``cols``.
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


def tf32_round_plain(a):
    """f32 -> the nearest TF32 value, ties away from zero, as
    ``cvt.rna.tf32.f32`` rounds: add half a TF32 unit (0x1000) to the f32
    bits and clear the 13 low mantissa bits."""
    bits = a.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def tf32_split_matmul_plain(a, b):
    """a @ b in 3xTF32, K2's GEMM arithmetic: each f32 operand is split into
    big = tf32(x) and small = tf32(x - big), and small·big + big·small is
    accumulated before big·big, in f32. Every product of two TF32 values is
    exact in f32, so only the dropped small·small and the f32 sums differ
    from an f32 product. Used by the CPU tests to pin the split."""
    a_big, b_big = tf32_round_plain(a), tf32_round_plain(b)
    a_small, b_small = tf32_round_plain(a - a_big), tf32_round_plain(b - b_big)
    return (a_small @ b_big + a_big @ b_small) + a_big @ b_big


def _lib():
    lib = native.load("deform_col2im")
    fn = lib.deform_conv_bwd_f32
    if fn.argtypes is None:
        lib.deform_conv_bwd_partial_floats.restype = ctypes.c_longlong
        lib.deform_conv_bwd_partial_floats.argtypes = [ctypes.c_int] * 4
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 13 + [
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
    if b * g > 65535 or -(-p // 128) > 65535:
        raise ValueError(f"grid too large for B*G={b * g}, P={p}")
    lib = _lib()
    # scratch: x and dX as channels-last rows, dcols p-major per group,
    # the dW2 partials
    x_rows, dx_rows = torch.empty_like(x), torch.empty_like(x)
    dcols = torch.empty((b * g, p, k * (c // g)), device=x.device,
                        dtype=torch.float32)
    partial = torch.empty((lib.deform_conv_bwd_partial_floats(b, o, kc, p),),
                          device=x.device, dtype=torch.float32)
    dx = torch.empty_like(x)
    doffsets = torch.empty_like(offsets)
    dw2 = torch.empty_like(w2)
    if p == 0 or b == 0:
        return dx.zero_(), doffsets, dw2.zero_()
    with native.device_guard(x.device):
        code = lib.deform_conv_bwd_f32(
            x.data_ptr(), offsets.data_ptr(), cols.data_ptr(), w2.data_ptr(),
            dy.data_ptr(), x_rows.data_ptr(), dcols.data_ptr(),
            partial.data_ptr(), dx_rows.data_ptr(), dx.data_ptr(),
            doffsets.data_ptr(), dw2.data_ptr(), b, c, h, w, g, ho, wo, kh,
            kw, stride, padding, dilation, o, native.stream_ptr(x.device))
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


# ------------------------------------------------------- the sampled route

def _rows_inputs(x, offsets, weight, stride, padding, dilation,
                 deform_groups, mask):
    """NCHW inputs -> (x_rows (B*G, H*W, Cg), pyx (B*G, K, P, 2),
    w2g (G, K*Cg, O), mask (B, G, P, K) or None), differentiable."""
    _check_weight(x, weight)
    o, c, kh, kw = weight.shape
    b, _, h, w = x.shape
    g, k = deform_groups, kh * kw
    deform_sample._check(x, offsets, kh, kw, stride, padding, dilation, g)
    cg = c // g
    x_rows = x.permute(0, 2, 3, 1).reshape(b, h * w, g, cg)
    x_rows = x_rows.permute(0, 2, 1, 3).reshape(b * g, h * w, cg)
    pyx = deform_sample.positions(offsets, kh, kw, stride, padding,
                                  dilation, g)
    w2g = weight.reshape(o, g, cg, k).permute(1, 3, 2, 0).reshape(
        g, k * cg, o)
    m = None
    if mask is not None:
        p = pyx.shape[2]
        if tuple(mask.shape) != (b, g * k, *offsets.shape[2:]):
            raise ValueError(f"mask {tuple(mask.shape)} != "
                             f"{(b, g * k, *offsets.shape[2:])}")
        m = mask.float().reshape(b, g, k, p).permute(0, 1, 3, 2)
    return x_rows.contiguous(), pyx.contiguous(), w2g.contiguous(), m


def _contract(sampled, w2g, b: int):
    """sampled (B*G, P, K, Cg) . w2g (G, K*Cg, O) -> (B, P, O)."""
    g, kc, o = w2g.shape
    p = sampled.shape[1]
    out = torch.matmul(sampled.reshape(b, g, p, kc), w2g)   # (B, G, P, O)
    return out[:, 0] if g == 1 else out.sum(1)


def _modulate(sampled, m):
    """sampled (B*G, P, K, Cg) times the per-tap mask (B, G, P, K)."""
    n, p, k, cg = sampled.shape
    return (sampled.reshape(m.shape + (cg,)) * m[..., None]).reshape(
        n, p, k, cg)


def _to_nchw(out, b: int, ho: int, wo: int):
    return out.permute(0, 2, 1).reshape(b, out.shape[2], ho, wo)


def deform_conv2d_rows_plain(x, offsets, weight, *, stride: int = 1,
                             padding: int = 1, dilation: int = 1,
                             deform_groups: int = 1, mask=None):
    """Plain PyTorch sampled route: :func:`deform_rows_plain`, the optional
    modulation and one ``torch.matmul``, differentiable by autograd."""
    x_rows, pyx, w2g, m = _rows_inputs(x, offsets, weight, stride, padding,
                                       dilation, deform_groups, mask)
    h, w = x.shape[2:]
    s = deform_sample.deform_rows_plain(x_rows, pyx, h, w)
    if m is not None:
        s = _modulate(s, m)
    return _to_nchw(_contract(s, w2g, x.shape[0]), x.shape[0],
                    *offsets.shape[2:])


class _DeformConvRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x_rows, pyx, w2g, m, h, w, b):
        s = deform_sample.deform_rows(x_rows, pyx, h, w)   # (N, P, K, Cg)
        sm = _modulate(s, m) if m is not None else s
        ctx.save_for_backward(x_rows, pyx, w2g, sm, m,
                              s if m is not None else None)
        ctx.conf = (h, w, b)
        return _contract(sm, w2g, b)                        # (B, P, O)

    @staticmethod
    def backward(ctx, dout):
        x_rows, pyx, w2g, sm, m, s = ctx.saved_tensors
        h, w, b = ctx.conf
        g, kc, o = w2g.shape
        n, p, k, cg = sm.shape
        dout = dout.contiguous()
        # dsampled = dy . W^T and dW = sampled^T . dy, one matmul each
        dsm = torch.matmul(dout[:, None], w2g.transpose(1, 2))  # (B,G,P,KC)
        smg = sm.reshape(b, g, p, kc)
        dy = dout.reshape(b * p, o)
        dw2g = torch.stack([smg[:, j].reshape(b * p, kc).t() @ dy
                            for j in range(g)])                 # (G, KC, O)
        dsm = dsm.reshape(n, p, k, cg)
        dm = None
        if m is not None:
            dm = (dsm * s).sum(-1).reshape(m.shape)
            dsm = _modulate(dsm, m)
        dx_rows, dpyx = deform_sample.deform_rows_backward(
            x_rows, pyx, dsm.contiguous(), h, w)
        return dx_rows, dpyx, dw2g, dm, None, None, None


def deform_conv2d_rows(x, offsets, weight, *, stride: int = 1,
                       padding: int = 1, dilation: int = 1,
                       deform_groups: int = 1, mask=None):
    """Deformable conv on the sampled route, NCHW, differentiable in x,
    offsets, weight (and mask).

    Args:
      x: (B, C, H, W) f32.
      offsets: (B, G*K*2, Ho, Wo) in the CUDA layout, K = kh*kw.
      weight: (O, C, kh, kw) OIHW.
      mask: optional (B, G*K, Ho, Wo) modulation (sigmoid already applied),
        making this DCNv2.
    Returns:
      (B, O, Ho, Wo).
    """
    if x.device.type == "cpu":
        return deform_conv2d_rows_plain(
            x, offsets, weight, stride=stride, padding=padding,
            dilation=dilation, deform_groups=deform_groups, mask=mask)
    x_rows, pyx, w2g, m = _rows_inputs(x, offsets, weight, stride, padding,
                                       dilation, deform_groups, mask)
    h, w = x.shape[2:]
    out = _DeformConvRows.apply(x_rows, pyx, w2g, m, h, w, x.shape[0])
    return _to_nchw(out, x.shape[0], *offsets.shape[2:])


def modulated_deform_conv2d(x, offsets, mask, weight, **kw):
    """DCNv2 (the JAX package's ``modulated_deform_conv2d``): ``mask`` is the
    (B, G*K, Ho, Wo) post-sigmoid modulation; the sampled route."""
    return deform_conv2d_rows(x, offsets, weight, mask=mask, **kw)
