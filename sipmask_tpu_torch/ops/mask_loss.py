"""The SP mask loss: kernels K3a (forward) and K3b (backward) and their plain
version.

Counterpart of ``sipmask_tpu/ops/pallas/mask_loss.py:mask_bce_loss_fused``.
:func:`mask_bce_loss` is the differentiable entry point: on CUDA tensors it
is a ``torch.autograd.Function`` whose forward launches K3a
(:func:`mask_bce_forward`) and whose backward launches K3b
(:func:`mask_bce_backward`), both in ``csrc/mask_bce.cu``; on CPU tensors
it is :func:`mask_bce_loss_plain`, autograd through
``crop_split.mask_bce_loss_indexed``.

Layouts: basis (B, NB, H, W) f32 (the head's ``feat_masks``), cofs
(B, K, 4*NB) f32, boxes (B, K, 4) xyxy in mask coordinates, gt_masks
(B, G, H, W) {0, 1}, gt_idx (B, K) int, valid (B, K) bool. The result is
(B, K) f32, 0 where ``valid`` is False. Boxes and gt take no gradient.
"""

from __future__ import annotations

import ctypes

import torch

from . import native
from .crop_split import mask_bce_loss_indexed
from .mask_assembly import _colmix_logits, _quadrant_bounds


def mask_bce_loss_plain(basis, cofs, boxes, gt_masks, gt_idx, valid):
    """Plain PyTorch K3: ``mask_bce_loss_indexed`` per image, through
    autograd, with invalid positives set to 0."""
    pre = torch.stack([
        mask_bce_loss_indexed(basis[i].permute(1, 2, 0), cofs[i],
                              boxes[i].detach(), gt_masks[i], gt_idx[i])
        for i in range(basis.shape[0])])
    return torch.where(valid, pre, torch.zeros_like(pre))


TILE_H, TILE_W = 16, 32   # the K3 kernels' pixel tiles (kTileH, kTileW)


def _clip(f, lo: int, hi: int):
    """f clipped to [lo, hi] as the kernels' clip_floor / clip_ceil do it:
    NaN gives lo."""
    return torch.where(f > lo, torch.where(f >= hi, torch.full_like(f, hi),
                                           f), torch.full_like(f, lo)).long()


def _int_bounds(x1, y1, x2, y2, h: int, w: int):
    """A box's conservative integer bounds in the map, as ``load_box`` in
    ``csrc/mask_bce.cu`` takes them: (c_lo, c_hi, r_lo, r_hi)."""
    return (_clip(torch.floor(x1), 0, w), _clip(torch.ceil(x2), -1, w - 1),
            _clip(torch.floor(y1), 0, h), _clip(torch.ceil(y2), -1, h - 1))


def _span(lo, hi, n: int, size: int):
    """(..., n) bool: the tiles t of ``size`` pixels with
    lo // size <= t <= hi // size."""
    t = torch.arange(n, device=lo.device)
    return ((lo // size)[..., None] <= t) & (t <= (hi // size)[..., None])


def _rect_tiles(some, r0, r1, c0, c1, h: int, w: int):
    """(..., ceil(h/16), ceil(w/32)) bool: the tiles of the integer
    rectangles rows [r0, r1] x cols [c0, c1] where ``some``."""
    return (some[..., None, None] & _span(r0, r1, -(-h // TILE_H), TILE_H)
            [..., :, None] & _span(c0, c1, -(-w // TILE_W), TILE_W)
            [..., None, :])


def tile_hits(boxes, valid, h: int, w: int):
    """K3a's hit predicate, (B, K, ceil(h/16), ceil(w/32)) bool: the 16x32
    pixel tiles whose partial the tile kernel writes and the fold adds
    (``tile_span`` in ``csrc/mask_bce.cu``). A valid box touches the tiles
    of its conservative integer bounds (floor of x1, y1 and ceil of x2, y2,
    clipped to the map); off the map, degenerate and NaN boxes touch none."""
    x1, y1, x2, y2 = boxes.float().unbind(-1)
    c_lo, c_hi, r_lo, r_hi = _int_bounds(x1, y1, x2, y2, h, w)
    some = valid & (c_lo <= c_hi) & (r_lo <= r_hi)
    return _rect_tiles(some, r_lo, r_hi, c_lo, c_hi, h, w)


def quad_tile_hits(boxes, valid, grad, h: int, w: int):
    """K3b's segment predicate, (B, K, 4, ceil(h/16), ceil(w/32)) bool: the
    (quadrant, tile) pairs whose d cofs segment the tile kernel writes and
    the fold adds (``quad_tile_span`` in ``csrc/mask_bce.cu``). Quadrant q
    of a valid box whose cotangent is not 0 touches the tiles of its
    conservative rectangle: the box's integer bounds cut at the floor (below
    or right of the half-split) or the ceil (above or left of it) of the
    split, clipped to the map."""
    x1, y1, x2, y2 = boxes.float().unbind(-1)
    c_lo, c_hi, r_lo, r_hi = _int_bounds(x1, y1, x2, y2, h, w)
    xm = x1 + (x2 - x1 + 0.1) * 0.5
    ym = y1 + (y2 - y1 + 0.1) * 0.5
    rows = ((r_lo, torch.minimum(r_hi, _clip(torch.ceil(ym), -1, h - 1))),
            (torch.maximum(r_lo, _clip(torch.floor(ym), 0, h)), r_hi))
    cols = ((c_lo, torch.minimum(c_hi, _clip(torch.ceil(xm), -1, w - 1))),
            (torch.maximum(c_lo, _clip(torch.floor(xm), 0, w)), c_hi))
    live = valid & (grad != 0) & (c_lo <= c_hi) & (r_lo <= r_hi)
    quads = []
    for q in range(4):          # q = 2*below + right
        (r0, r1), (c0, c1) = rows[q >> 1], cols[q & 1]
        quads.append(_rect_tiles(live & (r0 <= r1) & (c0 <= c1), r0, r1, c0,
                                 c1, h, w))
    return torch.stack(quads, 2)


def mask_bce_forward_tiled_plain(basis, cofs, boxes, gt_masks, gt_idx,
                                 valid):
    """K3a in the kernel's order, in plain PyTorch (for the tests): each
    (positive, 16x32 tile) partial of the stable BCE, then the fold over the
    tiles :func:`tile_hits` marks. A gt index outside [0, G) reads as an
    empty mask. (B, K) f32, 0 where ``valid`` is False."""
    b, nb, h, w, k, g = _check(basis, cofs, boxes, gt_masks, gt_idx, valid)
    th, tw = -(-h // TILE_H), -(-w // TILE_W)
    parts = []
    for i in range(b):
        sel, in_box = _colmix_logits(basis[i].permute(1, 2, 0), cofs[i],
                                     boxes[i])                   # (h, w, K)
        idx = gt_idx[i].long()
        y = gt_masks[i][idx.clamp(0, g - 1)].permute(1, 2, 0).to(sel.dtype)
        y = y * ((idx >= 0) & (idx < g)).to(sel.dtype)
        bce = (sel.clamp(min=0) - sel * y + torch.log1p(torch.exp(
            -sel.abs()))) * in_box.to(sel.dtype)
        bce = torch.nn.functional.pad(
            bce, (0, 0, 0, tw * TILE_W - w, 0, th * TILE_H - h))
        parts.append(bce.reshape(th, TILE_H, tw, TILE_W, k).sum((1, 3))
                     .permute(2, 0, 1))                          # (K, th, tw)
    partial = torch.stack(parts)
    hits = tile_hits(boxes, valid, h, w)
    return torch.where(hits, partial, torch.zeros_like(partial)).sum((2, 3))


def mask_bce_backward_tiled_plain(basis, cofs, boxes, gt_masks, gt_idx,
                                  valid, grad):
    """K3b in the kernels' order, in plain PyTorch (for the tests): with
    d = grad*(sigmoid(s) - y) at each in-box pixel of a valid positive,
    d basis pixel by pixel (each 16x32 tile's pixels on their own), and
    d cofs as a 32-float segment per (positive, quadrant, tile), kept where
    :func:`quad_tile_hits` marks it and folded in tile order. A gt index
    outside [0, G) reads as an empty mask. Returns (d basis (B, NB, H, W),
    d cofs (B, K, 4*NB))."""
    b, nb, h, w, k, g = _check(basis, cofs, boxes, gt_masks, gt_idx, valid)
    th, tw = -(-h // TILE_H), -(-w // TILE_W)
    hits = quad_tile_hits(boxes, valid, grad, h, w)
    pad = torch.nn.functional.pad
    dbasis, dcofs = [], []
    for i in range(b):
        sel, in_box = _colmix_logits(basis[i].permute(1, 2, 0), cofs[i],
                                     boxes[i])                   # (h, w, K)
        _, right, bottom = _quadrant_bounds(boxes[i].float(), h, w)
        idx = gt_idx[i].long()
        y = gt_masks[i][idx.clamp(0, g - 1)].permute(1, 2, 0).to(sel.dtype)
        y = y * ((idx >= 0) & (idx < g)).to(sel.dtype)
        gv = torch.where(valid[i], grad[i].to(sel.dtype), 0.0)
        d = gv * (torch.sigmoid(sel) - y) * in_box.to(sel.dtype)
        dq = d[..., None] * torch.nn.functional.one_hot(
            right.long() + 2 * bottom.long(), 4).to(d.dtype)  # (h, w, K, 4)
        dbasis.append(torch.einsum("hwkq,kqn->nhw", dq,
                                   cofs[i].reshape(k, 4, nb)))
        dqt = pad(dq, (0, 0, 0, 0, 0, tw * TILE_W - w, 0, th * TILE_H - h)
                  ).reshape(th, TILE_H, tw, TILE_W, k, 4)
        bt = pad(basis[i], (0, tw * TILE_W - w, 0, th * TILE_H - h)
                 ).reshape(nb, th, TILE_H, tw, TILE_W)
        seg = torch.einsum("aibjkq,naibj->kqabn", dqt, bt)  # K, 4, th, tw, nb
        seg = torch.where(hits[i][..., None], seg, 0.0).reshape(
            k, 4, th * tw, nb)
        acc = torch.zeros((k, 4, nb), dtype=seg.dtype)
        for t in range(th * tw):
            acc = acc + seg[:, :, t]
        dcofs.append(acc.reshape(k, 4 * nb))
    return torch.stack(dbasis), torch.stack(dcofs)


def _check(basis, cofs, boxes, gt_masks, gt_idx, valid):
    if basis.dim() != 4 or cofs.dim() != 3 or boxes.dim() != 3:
        raise ValueError(f"basis {tuple(basis.shape)}, cofs "
                         f"{tuple(cofs.shape)}, boxes {tuple(boxes.shape)}: "
                         "expected (B, NB, H, W), (B, K, 4*NB), (B, K, 4)")
    b, nb, h, w = basis.shape
    k = cofs.shape[1]
    if (tuple(cofs.shape) != (b, k, 4 * nb) or tuple(boxes.shape) != (b, k, 4)
            or gt_masks.dim() != 4 or tuple(gt_masks.shape[2:]) != (h, w)
            or gt_masks.shape[0] != b or tuple(gt_idx.shape) != (b, k)
            or tuple(valid.shape) != (b, k)):
        raise ValueError(
            f"shapes do not agree: basis {tuple(basis.shape)}, cofs "
            f"{tuple(cofs.shape)}, boxes {tuple(boxes.shape)}, gt_masks "
            f"{tuple(gt_masks.shape)}, gt_idx {tuple(gt_idx.shape)}, valid "
            f"{tuple(valid.shape)}")
    if not basis.dtype == cofs.dtype == boxes.dtype == torch.float32:
        raise TypeError(f"float32 only, got {basis.dtype}, {cofs.dtype}, "
                        f"{boxes.dtype}")
    devs = {t.device for t in (basis, cofs, boxes, gt_masks, gt_idx, valid)}
    if len(devs) != 1:
        raise ValueError(f"inputs on several devices: {devs}")
    return b, nb, h, w, k, gt_masks.shape[1]


def _lib():
    lib = native.load("mask_bce")
    if lib.mask_bce_fwd_f32.argtypes is None:
        lib.mask_bce_num_bases.restype = ctypes.c_int
        lib.mask_bce_num_bases.argtypes = []
        for fn in (lib.mask_bce_fwd_scratch, lib.mask_bce_bwd_scratch):
            fn.restype, fn.argtypes = ctypes.c_int64, [ctypes.c_int] * 4
        lib.mask_bce_fwd_f32.restype = ctypes.c_int
        lib.mask_bce_fwd_f32.argtypes = [ctypes.c_void_p] * 8 + [
            ctypes.c_int] * 5 + [ctypes.c_void_p]
        lib.mask_bce_bwd_f32.restype = ctypes.c_int
        lib.mask_bce_bwd_f32.argtypes = [ctypes.c_void_p] * 10 + [
            ctypes.c_int] * 5 + [ctypes.c_void_p]
    return lib


def _cuda_operands(basis, cofs, boxes, gt_masks, gt_idx, valid):
    """Check what the kernels take; gt, gt_idx and valid in the kernels'
    integer types (uint8, int64, uint8)."""
    if basis.device.type != "cuda":
        raise ValueError(f"no K3 kernel for device {basis.device}")
    dims = _check(basis, cofs, boxes, gt_masks, gt_idx, valid)
    if not all(t.is_contiguous() for t in (basis, cofs, boxes, gt_masks)):
        raise ValueError("basis, cofs, boxes and gt_masks must be contiguous")
    if cofs.data_ptr() % 16:
        raise ValueError("cofs must be 16-byte aligned (the kernels stage "
                         "it as float4)")
    if gt_masks.dtype not in (torch.uint8, torch.bool):
        raise TypeError(f"gt_masks must be uint8 or bool, got "
                        f"{gt_masks.dtype}")
    lib = _lib()
    if dims[1] != lib.mask_bce_num_bases():
        raise ValueError(f"the K3 kernels take {lib.mask_bce_num_bases()} "
                         f"basis masks, got {dims[1]}")
    # d basis runs four blocks a row of tiles
    if dims[0] > 65535 or 4 * -(-dims[2] // TILE_H) > 65535:
        raise ValueError(f"grid too large for B={dims[0]}, H={dims[2]}")
    # views where the caller's types already fit (int64 indices and bool
    # validity, as the loss gives them): no conversion kernel a call
    return (lib, dims, gt_masks.view(torch.uint8),
            gt_idx.to(torch.int64).contiguous(),
            valid.contiguous().view(torch.uint8) if valid.dtype == torch.bool
            else valid.to(torch.uint8).contiguous())


def mask_bce_forward(basis, cofs, boxes, gt_masks, gt_idx, valid):
    """K3a: (B, K) pixel-summed BCE per positive. CPU tensors take
    :func:`mask_bce_loss_plain`; CUDA tensors launch the kernel, which does
    not record a gradient: it raises when one is wanted (differentiate
    through :func:`mask_bce_loss`)."""
    if basis.device.type == "cpu":
        return mask_bce_loss_plain(basis, cofs, boxes, gt_masks, gt_idx,
                                   valid)
    if torch.is_grad_enabled() and (basis.requires_grad or
                                    cofs.requires_grad):
        raise RuntimeError("mask_bce_forward records no gradient on CUDA: "
                           "call mask_bce_loss")
    lib, (b, nb, h, w, k, g), gt, idx, vld = _cuda_operands(
        basis, cofs, boxes, gt_masks, gt_idx, valid)
    pre = torch.empty((b, k), device=basis.device, dtype=torch.float32)
    if pre.numel() == 0:
        return pre
    # one partial per (image, positive, 16x32 pixel tile); the fold reads
    # only those the tile kernel wrote
    partial = torch.empty((lib.mask_bce_fwd_scratch(b, k, h, w),),
                          device=basis.device, dtype=torch.float32)
    with torch.cuda.device(basis.device):
        code = lib.mask_bce_fwd_f32(
            basis.data_ptr(), cofs.data_ptr(), boxes.data_ptr(),
            gt.data_ptr(), idx.data_ptr(), vld.data_ptr(), partial.data_ptr(),
            pre.data_ptr(), b, k, g, h, w, native.stream_ptr(basis.device))
    native.check_launch(lib, "mask_bce", code)
    mask_bce_forward.launches += 1
    return pre


mask_bce_forward.launches = 0


def mask_bce_backward_plain(basis, cofs, boxes, gt_masks, gt_idx, valid,
                            grad):
    """Plain PyTorch K3b: (d basis, d cofs) of ``sum(grad * pre)`` by
    autograd through :func:`mask_bce_loss_plain`."""
    with torch.enable_grad():
        bs = basis.detach().requires_grad_(True)
        cf = cofs.detach().requires_grad_(True)
        pre = mask_bce_loss_plain(bs, cf, boxes, gt_masks, gt_idx, valid)
        return torch.autograd.grad(pre, (bs, cf), grad)


def mask_bce_backward(basis, cofs, boxes, gt_masks, gt_idx, valid, grad):
    """K3b: (d basis (B, NB, H, W), d cofs (B, K, 4*NB)) for the cotangent
    ``grad`` (B, K) of :func:`mask_bce_forward`. CPU tensors take
    :func:`mask_bce_backward_plain`; CUDA tensors launch the kernels."""
    if basis.device.type == "cpu":
        return mask_bce_backward_plain(basis, cofs, boxes, gt_masks, gt_idx,
                                       valid, grad)
    lib, (b, nb, h, w, k, g), gt, idx, vld = _cuda_operands(
        basis, cofs, boxes, gt_masks, gt_idx, valid)
    if tuple(grad.shape) != (b, k) or grad.device != basis.device:
        raise ValueError(f"grad {tuple(grad.shape)} on {grad.device}")
    grad = grad.to(torch.float32).contiguous()
    dbasis = torch.empty_like(basis)
    dcofs = torch.empty_like(cofs)
    if k == 0:
        return dbasis.zero_(), dcofs
    # a 4*NB-float d cofs partial per (image, positive, 16x32 pixel tile);
    # the fold reads only the quadrant segments the tile kernel wrote
    partial = torch.empty((lib.mask_bce_bwd_scratch(b, k, h, w),),
                          device=basis.device, dtype=torch.float32)
    with torch.cuda.device(basis.device):
        code = lib.mask_bce_bwd_f32(
            basis.data_ptr(), cofs.data_ptr(), boxes.data_ptr(),
            gt.data_ptr(), idx.data_ptr(), vld.data_ptr(), grad.data_ptr(),
            partial.data_ptr(), dbasis.data_ptr(), dcofs.data_ptr(), b, k, g,
            h, w, native.stream_ptr(basis.device))
    native.check_launch(lib, "mask_bce", code)
    mask_bce_backward.launches += 1
    return dbasis, dcofs


mask_bce_backward.launches = 0


class _MaskBCE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, basis, cofs, boxes, gt_masks, gt_idx, valid):
        ctx.save_for_backward(basis, cofs, boxes, gt_masks, gt_idx, valid)
        return mask_bce_forward(basis, cofs, boxes, gt_masks, gt_idx, valid)

    @staticmethod
    def backward(ctx, grad):
        dbasis, dcofs = mask_bce_backward(*ctx.saved_tensors, grad)
        return dbasis, dcofs, None, None, None, None


def mask_bce_loss(basis, cofs, boxes, gt_masks, gt_idx, valid):
    """Differentiable SP mask loss, (B, K): kernels on CUDA, the plain
    version on the CPU (layouts in the module note)."""
    if basis.device.type == "cpu":
        return mask_bce_loss_plain(basis, cofs, boxes, gt_masks, gt_idx,
                                   valid)
    return _MaskBCE.apply(basis.contiguous(), cofs.contiguous(),
                          boxes.detach().contiguous(), gt_masks, gt_idx,
                          valid)
