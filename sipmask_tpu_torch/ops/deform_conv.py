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
in 3xTF32, f32-accurate, :func:`tf32_split_matmul_plain` states the split;
in bf16 on wgmma fed by TMA, :func:`col2im_schedule` mirrors the plan),
the col2im and the position gradients. On CPU tensors it is
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

**bf16** (the JAX package's ``compute_dtype="bfloat16"``): x bf16,
offsets f32. On the im2col route (FeatureAlign) the weight is bf16 too:
K1 gives bf16 cols, the tap contraction is a bf16 ``torch.matmul`` with
f32 sums rounded to bf16 (JAX's ``preferred_element_type=jnp.float32``
then ``astype``, ``deform_conv.py:98-108``; the callers turn off cuBLAS's
reduced-precision bf16 reductions), and K2 takes bf16 operands: dsampled
rounded to bf16, dW in f32, dX summed in f32 and rounded once, d offsets
in f32 (:func:`deform_conv_backward_plain` states that arithmetic). On the
sampled route (``DeformConvPack``: one deform group, no modulation mask;
others raise in bf16) the weight stays an f32 parameter and is cast to the
samples' bf16, as JAX casts it (``w2.astype(sampled.dtype)``,
``deform_conv.py:210``): K5 gives bf16 samples, the contraction is a bf16
``torch.matmul`` summed in f32 and rounded once, and so are its two
backward products, dsampled and dW; dW reaches the f32 weight through the
cast, rounded to bf16 as JAX's does (its weight cotangent passes the same
``astype``); K5c gives a bf16 dX and f32 d offsets.

Layouts (NCHW, f32): x (B, C, H, W); offsets (B, G*K*2, Ho, Wo) in the CUDA
layout ([dy, dx] per tap, group-major), K = kh*kw; mask (B, G*K, Ho, Wo);
weight (O, C, kh, kw); w2 (O, G*K*Cg), the weight in the row order of
``cols``.
"""

from __future__ import annotations

import ctypes

import torch

from ..utils.trace import spanned
from . import custom, deform_sample, native


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
    :func:`deform_im2col_plain`.

    bf16 x, w2 and dy (f32 offsets) take the kernel's arithmetic, as
    ``deform_gather._bwd_conv_kernel`` rounds: dsampled = W^T·dy summed in
    f32 and rounded to bf16, then dX and d offsets by autograd in f32
    through the f32 sampling of x with that cotangent, dX rounded once to
    bf16; d w2 = sum_b dy_b·cols_b^T in f32 (f32, unrounded) with cols the
    bf16 sampled values."""
    if x.dtype == torch.bfloat16:
        b, o = dy.shape[:2]
        cols = deform_sample.deform_im2col_plain(
            x, offsets, kernel_size, stride, padding, dilation,
            deform_groups).float()
        dyf = dy.reshape(b, o, -1).float()
        dsamp = torch.matmul(w2.float().t(), dyf).to(torch.bfloat16)
        dw2 = torch.matmul(dyf, cols.transpose(1, 2)).sum(0)
        with torch.enable_grad():
            xs, off = (t.detach().float().requires_grad_(True)
                       for t in (x, offsets))
            cols32 = deform_sample.deform_im2col_plain(
                xs, off, kernel_size, stride, padding, dilation,
                deform_groups)
            dx, doff = torch.autograd.grad(cols32, (xs, off), dsamp.float())
        return dx.to(torch.bfloat16), doff, dw2
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


# K2's work split (csrc/deform_col2im.cu), mirrored by col2im_schedule
GEMM_TILE = 128       # mma.sync GEMM tiles (kBM = kBN), wgmma dW2 tiles
DCOLS_TILE_N = 192    # columns of a wgmma dcols block (kDcN), in one group
DW2_CHUNK = 2048      # pixels of a dW2 partial (kSplitK)
WGMMA_DEPTH, MMA_DEPTH = 64, 32   # pixels a stage, wgmma and mma.sync
H100_SMS = 132


def col2im_route(p: int, kc: int, kcg: int, o: int) -> str:
    """How a bf16 K2 call's GEMMs run, as ``route`` in
    ``csrc/deform_col2im.cu`` decides by shape (for 16-byte aligned
    tensors, which the allocator gives): "mma.sync" unless KC % 8 == 0,
    K*Cg is a multiple of 192 (a dcols block in one group) and O <= 256
    (W2's slice in shared memory); then "wgmma" (TMA-fed) where P % 8 == 0
    (16-byte rows), else "padded" (the wgmma GEMMs on copies of dy and
    cols with rows of P rounded up to 8)."""
    if kc % 8 or kcg % DCOLS_TILE_N or o > 256:
        return "mma.sync"
    return "wgmma" if p % 8 == 0 else "padded"


def _cover(rects, shape):
    """Write counts of rectangles ``rects`` (n, 5) int64 rows (z, r0, r1,
    c0, c1), half-open, on the grid cut at every rectangle's edges and at
    the ends of ``shape`` (Z, R, C): returns (counts (Z, cells_r,
    cells_c), row edges, column edges); each cell is wholly inside or
    outside every rectangle."""
    z, r0, r1, c0, c1 = (t.contiguous() for t in rects.unbind(1))
    rows, cols = shape[1], shape[2]
    er = torch.unique(torch.cat([r0, r1, torch.tensor([0, rows])]))
    ec = torch.unique(torch.cat([c0, c1, torch.tensor([0, cols])]))
    i0, i1 = torch.searchsorted(er, r0), torch.searchsorted(er, r1)
    j0, j1 = torch.searchsorted(ec, c0), torch.searchsorted(ec, c1)
    diff = torch.zeros((shape[0], len(er), len(ec)), dtype=torch.int64)
    for i, j, sign in ((i0, j0, 1), (i0, j1, -1), (i1, j0, -1),
                       (i1, j1, 1)):
        diff.index_put_((z, i, j), torch.full_like(z, sign), accumulate=True)
    counts = diff.cumsum(1).cumsum(2)[:, :-1, :-1]
    return counts, er, ec


def col2im_schedule(b: int, g: int, cg: int, k: int, p: int, o: int):
    """K2's bf16 plan in plain PyTorch (for the tests): how
    ``csrc/deform_col2im.cu`` cuts a bf16 call with B = b, G = g, Cg = cg,
    K = k taps, P = p pixels and O = o outputs on an H100 (132 SMs).
    Returns a dict:

    - ``route``: the GEMMs', :func:`col2im_route`; ``padded``, for the
      "padded" route, write counts of the copies of dy and cols (B*O +
      B*KC rows of P rounded up to 8), else None;
    - ``dcols``: write counts of the dcols GEMM's epilogues over (B*G, P,
      K*Cg), on cells (:func:`_cover`: counts, row edges, column edges);
      ``dcols_spans``: each block's columns of KC, [n0, n1);
    - ``partial``: write counts of the dW2 partials (B*splits, O, KC), on
      cells; ``chunks``: each split's pixels (k0, k1) and the first pixel
      of each of its stages;
    - ``scatter``: "half-warp" (Cg % 4 == 0: one (image·group,
      pixel, tap) a half-warp) or "warp" (a warp per (image·group, pixel)
      over its K taps), and ``items``, how many times each (image·group,
      pixel, tap) is taken, (B*G, P, K)."""
    def span(n, size):
        return -(-n // size)
    kcg = k * cg
    kc, n = g * kcg, b * g
    route = col2im_route(p, kc, kcg, o)
    wgmma = route != "mma.sync"
    splits = span(p, DW2_CHUNK)
    padded = None
    if route == "padded":   # a thread per 8 elements (16 bytes) of a row
        p8, rows = span(p, 8) * 8, b * (o + kc)
        i = torch.arange(rows * (p8 // 8))
        first = i % (p8 // 8) * 8
        padded = torch.bincount(
            ((i // (p8 // 8) * p8 + first)[:, None]
             + torch.arange(8)).reshape(-1),
            minlength=rows * p8).reshape(rows, p8)
    rects, spans = [], []
    if wgmma:
        # grid (per_n, KC/192): block (x, y) walks pixel tiles x, x + per_n,
        # ... of 128 over the images; consumer c writes 64 of its rows
        n_tiles, tpi = kc // DCOLS_TILE_N, span(p, 128)
        per_n = max(1, min(b * tpi, H100_SMS // n_tiles))
        for y in range(n_tiles):
            n0 = y * DCOLS_TILE_N
            grp, r0 = n0 // kcg, n0 % kcg
            spans.append((n0, n0 + DCOLS_TILE_N))
            for x in range(per_n):
                tile = torch.arange(x, b * tpi, per_n)
                for c in range(2):
                    m0 = tile % tpi * 128 + 64 * c
                    keep = m0 < p
                    m0 = m0[keep]
                    rects.append(torch.stack([
                        tile[keep] // tpi * g + grp, m0,
                        torch.clamp(m0 + 64, max=p),
                        torch.full_like(m0, r0),
                        torch.full_like(m0, r0 + DCOLS_TILE_N)], 1))
    else:
        # grid (ceil(KC/128), ceil(P/128), B): each column of a block's
        # tile to its group's rows
        for bx in range(span(kc, GEMM_TILE)):
            n0, n1 = bx * GEMM_TILE, min(kc, (bx + 1) * GEMM_TILE)
            spans.append((n0, n1))
            for grp in range(n0 // kcg, span(n1, kcg)):
                c0, c1 = max(n0, grp * kcg), min(n1, (grp + 1) * kcg)
                m0 = torch.arange(span(p, GEMM_TILE)) * GEMM_TILE
                for image in range(b):
                    rects.append(torch.stack([
                        torch.full_like(m0, image * g + grp), m0,
                        torch.clamp(m0 + GEMM_TILE, max=p),
                        torch.full_like(m0, c0 - grp * kcg),
                        torch.full_like(m0, c1 - grp * kcg)], 1))
    dcols = _cover(torch.cat(rects), (n, p, kcg))
    # dW2 partials: z = image * splits + split; tiles of 128 o x 128 n
    tm, tn = span(o, GEMM_TILE), span(kc, GEMM_TILE)
    if wgmma:   # persistent: tile = x, x + grid, ...; o fastest
        tiles = b * splits * tm * tn
        grid = min(tiles, H100_SMS)
        tile = torch.cat([torch.arange(x, tiles, grid) for x in range(grid)])
        mt, nt, z = tile % tm, tile // tm % tn, tile // (tm * tn)
    else:       # grid (tn, tm, B*splits)
        z, mt, nt = torch.meshgrid(torch.arange(b * splits),
                                   torch.arange(tm), torch.arange(tn),
                                   indexing="ij")
        z, mt, nt = z.reshape(-1), mt.reshape(-1), nt.reshape(-1)
    partial = _cover(torch.stack([
        z, mt * GEMM_TILE, torch.clamp((mt + 1) * GEMM_TILE, max=o),
        nt * GEMM_TILE, torch.clamp((nt + 1) * GEMM_TILE, max=kc)], 1),
        (b * splits, o, kc))
    depth = WGMMA_DEPTH if wgmma else MMA_DEPTH
    chunks = []
    for split in range(splits):
        k0 = split * DW2_CHUNK
        k1 = min(p, k0 + DW2_CHUNK)
        chunks.append((k0, k1, list(range(k0, k1, depth))))
    half = cg % 4 == 0
    if half:   # grid ceil(N*P*K / 16): 16 half-warps a block
        item = torch.arange(span(n * p * k, 16) * 16)
        items = torch.bincount(item[item < n * p * k],
                               minlength=n * p * k).reshape(n, p, k)
    else:      # grid ceil(N*P / 8): a warp per (n, p), all K taps
        item = torch.arange(span(n * p, 8) * 8)
        items = torch.bincount(item[item < n * p], minlength=n * p)
        items = items.reshape(n, p, 1).expand(n, p, k)
    return {"route": route, "padded": padded, "dcols": dcols, "dcols_spans": spans, "partial": partial,
            "chunks": chunks, "scatter": "half-warp" if half else "warp",
            "items": items}


def _lib():
    lib = native.load("deform_col2im")
    if lib.deform_conv_bwd_f32.argtypes is None:
        lib.deform_conv_bwd_scratch_floats.restype = ctypes.c_longlong
        lib.deform_conv_bwd_scratch_floats.argtypes = [ctypes.c_int] * 7
        for fn in (lib.deform_conv_bwd_f32, lib.deform_conv_bwd_bf16):
            fn.restype = ctypes.c_int
            fn.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 13 + [
                ctypes.c_void_p]
    return lib


@spanned("sipmask.K2")
def deform_conv_backward(x, offsets, cols, w2, dy, kernel_size=(3, 3),
                         stride: int = 1, padding: int = 1,
                         dilation: int = 1, deform_groups: int = 1):
    """K2: (dx, d offsets, d w2) of ``out = w2 @ cols`` (B, O, P) with
    ``cols = deform_im2col(x, offsets)``, for the cotangent dy
    (B, O, Ho, Wo). CPU tensors take :func:`deform_conv_backward_plain`;
    CUDA tensors launch the kernels (contiguous; f32, or x, cols, w2 and dy
    bf16 with f32 offsets, which gives bf16 dx and f32 d offsets and
    d w2) and raise on anything they do not take. f32 calls count in
    ``launches``, bf16 calls in ``bf16_launches``."""
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
    bf16 = x.dtype == torch.bfloat16
    if offsets.dtype != torch.float32 or any(
            t.dtype != x.dtype for t in (cols, w2, dy)) or x.dtype not in (
                torch.float32, torch.bfloat16):
        raise TypeError(f"x, cols, w2 and dy float32 or bfloat16 and "
                        f"offsets float32, got "
                        f"{[t.dtype for t in ts]}")
    if any(t.device != x.device for t in ts):
        raise ValueError("all inputs must be on one device")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("x, offsets, cols, w2 and dy must be contiguous")
    if b * g > 65535 or -(-p // 128) > 65535:
        raise ValueError(f"grid too large for B*G={b * g}, P={p}")
    lib = _lib()
    # scratch: x and dX as channels-last rows (dX's f32), dcols p-major per
    # group, the dW2 partials (in bf16 with P % 8 != 0 also row-padded
    # copies of dy and cols for TMA)
    x_rows = torch.empty_like(x)
    dx_rows = torch.empty_like(x, dtype=torch.float32)
    dcols = torch.empty((b * g, p, k * (c // g)), device=x.device,
                        dtype=x.dtype)
    partial = torch.empty((lib.deform_conv_bwd_scratch_floats(
        b, o, g, k, c // g, p, bf16),), device=x.device, dtype=torch.float32)
    dx = torch.empty_like(x)
    doffsets = torch.empty_like(offsets)
    dw2 = torch.empty_like(w2, dtype=torch.float32)
    if p == 0 or b == 0:
        return dx.zero_(), doffsets, dw2.zero_()
    launch = lib.deform_conv_bwd_bf16 if bf16 else lib.deform_conv_bwd_f32
    with native.device_guard(x.device):
        code = launch(
            x.data_ptr(), offsets.data_ptr(), cols.data_ptr(), w2.data_ptr(),
            dy.data_ptr(), x_rows.data_ptr(), dcols.data_ptr(),
            partial.data_ptr(), dx_rows.data_ptr(), dx.data_ptr(),
            doffsets.data_ptr(), dw2.data_ptr(), b, c, h, w, g, ho, wo, kh,
            kw, stride, padding, dilation, o, native.stream_ptr(x.device))
    native.check_launch(lib, "deform_col2im", code)
    if bf16:
        deform_conv_backward.bf16_launches += 1
    else:
        deform_conv_backward.launches += 1
    return dx, doffsets, dw2


deform_conv_backward.launches = 0
deform_conv_backward.bf16_launches = 0


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
      x: (B, C, H, W) f32, or bf16 (then the weight is bf16 too and the
        offsets f32, as FeatureAlign casts them in the JAX package).
      offsets: (B, G*K*2, Ho, Wo) in the CUDA layout ([dy, dx] per tap,
        group-major), K = kh*kw.
      weight: (O, C, kh, kw) OIHW.
    Returns:
      (B, O, Ho, Wo) in x's dtype.
    """
    if custom.routed():   # torch.export: the K1 custom op, then the GEMM
        _check_weight(x, weight)
        kh, kw = weight.shape[2:]
        cols = torch.ops.sipmask.deform_im2col(
            x.contiguous(), offsets.contiguous(), kh, kw, stride, padding,
            dilation, deform_groups)
        out = torch.matmul(_w2(weight, deform_groups), cols)
        return out.reshape(x.shape[0], weight.shape[0], *offsets.shape[2:])
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
    if x.dtype == torch.bfloat16:
        if g > 1 or mask is not None:
            raise NotImplementedError(
                "the sampled route in bf16 takes one deform group and no "
                "modulation mask (DCNv1, as DeformConvPack)")
        w2g = w2g.to(torch.bfloat16)   # the cast JAX makes, dW rounds in it
    m = None
    if mask is not None:
        p = pyx.shape[2]
        if tuple(mask.shape) != (b, g * k, *offsets.shape[2:]):
            raise ValueError(f"mask {tuple(mask.shape)} != "
                             f"{(b, g * k, *offsets.shape[2:])}")
        m = mask.float().reshape(b, g, k, p).permute(0, 1, 3, 2)
    return x_rows.contiguous(), pyx.contiguous(), w2g.contiguous(), m


def _contract(sampled, w2g, b: int):
    """sampled (B*G, P, K, Cg) . w2g (G, K*Cg, O) -> (B, P, O), summed in
    f32 at least and rounded once to the operands' dtype."""
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
    modulation and one ``torch.matmul``, differentiable by autograd (in
    bf16 with the arithmetic of the module note: each bf16 product of the
    contraction and its backward is summed in f32 and rounded once)."""
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
        # dsampled = dy . W^T and dW = sampled^T . dy, one matmul each (in
        # bf16: bf16 operands and results, f32 sums)
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
      x: (B, C, H, W) f32, or bf16 (then the offsets f32 and the weight
        f32, cast to bf16 inside, as ``DeformConvPack`` feeds it in the JAX
        package's bf16 graph; one deform group and no mask).
      offsets: (B, G*K*2, Ho, Wo) in the CUDA layout, K = kh*kw.
      weight: (O, C, kh, kw) OIHW.
      mask: optional (B, G*K, Ho, Wo) modulation (sigmoid already applied),
        making this DCNv2.
    Returns:
      (B, O, Ho, Wo) in x's dtype.
    """
    if custom.routed():   # torch.export: the K5 custom op, then the GEMM
        x_rows, pyx, w2g, m = _rows_inputs(x, offsets, weight, stride,
                                           padding, dilation, deform_groups,
                                           mask)
        s = torch.ops.sipmask.deform_rows(x_rows.contiguous(),
                                          pyx.contiguous(), *x.shape[2:])
        if m is not None:
            s = _modulate(s, m)
        return _to_nchw(_contract(s, w2g, x.shape[0]), x.shape[0],
                        *offsets.shape[2:])
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
