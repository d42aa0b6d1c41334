"""SP mask assembly: kernel K6 and its plain version.

Counterpart of ``sipmask_tpu/ops/pallas/mask_assembly.py:assemble_masks_pallas``
and of the JAX package's XLA colmix form (``ops/crop_split.py``). The JAX
decode keeps the colmix form, because on a TPU the fused kernel lost inside
jit; on the card there is no such fusion to lose, so :func:`assemble_masks`
launches ``csrc/mask_assembly.cu`` on CUDA tensors, for every caller: the
decode of every config and the SipMask++ rescoring loss. On CPU tensors it
runs :func:`assemble_masks_plain`, the colmix form.

CropSplit rules of the reference CUDA kernel: pixel (ph, pw) lies in box n
iff pw >= x1, ph >= y1, pw < x2 and ph < y2 (float compares); its quadrant
is right of the half-split when pw >= x1 + (x2 - x1 + 0.1)/2 and below it
when ph >= y1 + (y2 - y1 + 0.1)/2; coefficient planes are ordered
[top-left, top-right, bottom-left, bottom-right]; outside the box the mask
is 0. Forward only: nothing differentiates through assembly.

Layouts (f32, the JAX kernel's): basis (B, h, w, nb), cofs (B, N, 4*nb),
boxes (B, N, 4) xyxy in mask (stride-2) coordinates; result (B, h, w, N),
which the kernel's wrapper returns as a view of (B, N, h, w) masks.
"""

from __future__ import annotations

import ctypes

import torch

from . import native


def _quadrant_bounds(boxes, h: int, w: int):
    """(in_box, right, bottom), each (h, w, N) bool."""
    pw = torch.arange(w, dtype=boxes.dtype, device=boxes.device)[None, :, None]
    ph = torch.arange(h, dtype=boxes.dtype, device=boxes.device)[:, None, None]
    x1, y1, x2, y2 = boxes[:, 0], boxes[:, 1], boxes[:, 2], boxes[:, 3]
    in_box = (pw >= x1) & (pw < x2) & (ph >= y1) & (ph < y2)
    right = pw >= (x1 + (x2 - x1 + 0.1) / 2)
    bottom = ph >= (y1 + (y2 - y1 + 0.1) / 2)
    return in_box, right, bottom


def _colmix_logits(basis, cofs, boxes):
    """Each pixel's quadrant logit for one image: the coefficients are mixed
    per column (0/1 weights, so exactly a select) before the two basis
    matmuls.

    Returns (sel (h, w, N) f32 logits, in_box (h, w, N) bool).
    """
    h, w, nb = basis.shape
    n = cofs.shape[0]
    in_box, right, bottom = _quadrant_bounds(boxes.float(), h, w)
    r = right[0].to(cofs.dtype)                   # (w, N): same on every row
    c = cofs.reshape(n, 4, nb)
    ctop = (1 - r)[:, :, None] * c[:, 0][None] + r[:, :, None] * c[:, 1][None]
    cbot = (1 - r)[:, :, None] * c[:, 2][None] + r[:, :, None] * c[:, 3][None]
    bt = basis.permute(1, 0, 2)                   # (w, h, nb)
    mtop = torch.matmul(bt, ctop.transpose(1, 2)).permute(1, 0, 2)  # (h,w,N)
    mbot = torch.matmul(bt, cbot.transpose(1, 2)).permute(1, 0, 2)
    bm = bottom.float()                           # (h, 1, N): same per column
    return mtop * (1 - bm) + mbot * bm, in_box


def _check(basis, cofs, boxes):
    if basis.dim() != 4 or cofs.dim() != 3 or boxes.dim() != 3:
        raise ValueError(f"basis (B, h, w, nb), cofs (B, N, 4*nb) and boxes "
                         f"(B, N, 4) expected, got {tuple(basis.shape)}, "
                         f"{tuple(cofs.shape)}, {tuple(boxes.shape)}")
    b, h, w, nb = basis.shape
    n = cofs.shape[1]
    if tuple(cofs.shape) != (b, n, 4 * nb) or tuple(boxes.shape) != (b, n, 4):
        raise ValueError(f"cofs {tuple(cofs.shape)} and boxes "
                         f"{tuple(boxes.shape)} do not fit basis "
                         f"{tuple(basis.shape)}")
    if not basis.device == cofs.device == boxes.device:
        raise ValueError("basis, cofs and boxes must share a device")
    return b, h, w, nb, n


def assemble_masks_plain(basis, cofs, boxes):
    """Plain PyTorch K6: the colmix form of each image, sigmoid, box crop.
    (B, h, w, nb), (B, N, 4*nb), (B, N, 4) -> (B, h, w, N)."""
    _check(basis, cofs, boxes)
    out = []
    for i in range(basis.shape[0]):
        sel, in_box = _colmix_logits(basis[i], cofs[i], boxes[i])
        out.append(torch.sigmoid(sel) * in_box.to(sel.dtype))
    return torch.stack(out)


SEGMENT = 32   # pixels of the flattened h*w plane a K6 warp writes at once


def _ceil_clip(v, n: int, if_nan: int):
    """ceil(v) clipped to [0, n] as ``ceil_clip`` in ``csrc/mask_assembly.cu``
    takes it: NaN gives ``if_nan``."""
    f = torch.ceil(v).clamp(0, n)
    return torch.where(torch.isnan(f), torch.full_like(f, if_nan), f).long()


def pixel_bounds(boxes, h: int, w: int):
    """The exact integer pixel bounds of (..., 4) boxes, as the K6 kernel
    stages them: (first col, last col, first row, last row). Integer col c
    satisfies c >= x1 and c < x2 iff ceil(x1) <= c <= ceil(x2) - 1, so these
    pick the pixels of CropSplit's float rule; empty when first > last."""
    x1, y1, x2, y2 = boxes.float().unbind(-1)
    return (_ceil_clip(x1, w, w), _ceil_clip(x2, w, 0) - 1,
            _ceil_clip(y1, h, h), _ceil_clip(y2, h, 0) - 1)


def segment_hits(boxes, h: int, w: int):
    """K6's warp-uniform cull, (B, N, ceil(h*w/32)) bool: the 32-pixel
    segments of the flattened plane in which the kernel computes box n's
    dots (``segment_hit`` in ``csrc/mask_assembly.cu``); every other segment
    it fills with zeros. A segment may wrap from one row into the next (and
    over several rows where w < 32)."""
    c_lo, c_hi, r_lo, r_hi = (t[..., None] for t in pixel_bounds(boxes, h, w))
    start = torch.arange(0, h * w, SEGMENT, device=boxes.device)
    last = (start + SEGMENT - 1).clamp(max=h * w - 1)
    ra, ca, rb, cb = start // w, start % w, last // w, last % w

    def in_rows(r):
        return (r >= r_lo) & (r <= r_hi)
    one_row = in_rows(ra) & (torch.maximum(ca, c_lo)
                             <= torch.minimum(cb, c_hi))
    wrapped = ((in_rows(ra) & (c_hi >= ca)) | (in_rows(rb) & (c_lo <= cb))
               | (torch.maximum(ra + 1, r_lo) <= torch.minimum(rb - 1, r_hi)))
    some = (c_lo <= c_hi) & (r_lo <= r_hi)
    return some & torch.where(ra == rb, one_row, wrapped)


def _lib():
    lib = native.load("mask_assembly")
    fn = lib.assemble_masks_f32
    if fn.argtypes is None:
        lib.assemble_masks_num_bases.restype = ctypes.c_int
        lib.assemble_masks_num_bases.argtypes = []
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [
            ctypes.c_void_p]
    return lib


def assemble_masks(basis, cofs, boxes):
    """K6: SP mask assembly, (B, h, w, nb), (B, N, 4*nb), (B, N, 4) ->
    (B, h, w, N) sigmoid probabilities, 0 outside the boxes.

    CPU tensors take :func:`assemble_masks_plain` (a contiguous result);
    CUDA tensors launch the kernel (f32, 32 bases) and raise on anything it
    does not take. The kernel reads the basis channel-major, so the
    permuted view of an NCHW basis is read in place, and writes the masks
    detection-major: the result is the (B, h, w, N) view of a contiguous
    (B, N, h, w) tensor, whose ``permute(0, 3, 1, 2).contiguous()`` is that
    tensor, with no copy. With an NCHW basis view, contiguous cofs and f32
    boxes a call is one device kernel.
    """
    if basis.device.type == "cpu":
        return assemble_masks_plain(basis, cofs, boxes)
    if basis.device.type != "cuda":
        raise ValueError(f"no K6 kernel for device {basis.device}")
    b, h, w, nb, n = _check(basis, cofs, boxes)
    if not basis.dtype == cofs.dtype == torch.float32:
        raise TypeError(f"float32 only, got {basis.dtype} and {cofs.dtype}")
    lib = _lib()
    if nb != lib.assemble_masks_num_bases():
        raise ValueError(f"the K6 kernel takes "
                         f"{lib.assemble_masks_num_bases()} basis masks, got "
                         f"{nb}")
    if b > 65535:
        raise ValueError(f"grid too large for B={b}")
    basis_c = basis.detach().permute(0, 3, 1, 2).contiguous()  # (B, nb, h, w)
    cofs_c = cofs.detach().contiguous()
    if cofs_c.data_ptr() % 16:     # staged as float4
        cofs_c = cofs_c.clone()
    boxes_c = boxes.detach().float().contiguous()
    out = torch.empty((b, n, h, w), device=basis.device, dtype=torch.float32)
    if out.numel() == 0:
        return out.permute(0, 2, 3, 1)
    with native.device_guard(basis.device):
        code = lib.assemble_masks_f32(
            basis_c.data_ptr(), cofs_c.data_ptr(), boxes_c.data_ptr(),
            out.data_ptr(), b, h, w, n, native.stream_ptr(basis.device))
    native.check_launch(lib, "mask_assembly", code)
    assemble_masks.launches += 1
    return out.permute(0, 2, 3, 1)


assemble_masks.launches = 0
