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
boxes (B, N, 4) xyxy in mask (stride-2) coordinates; result (B, h, w, N).
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


def quadrant_params(boxes):
    """(B, N, 4) boxes -> (B, 6, N) [x1, y1, x2, y2, rx, by] f32, the split
    points in the f32 expressions of :func:`_quadrant_bounds`."""
    bx = boxes.float()
    x1, y1, x2, y2 = bx[..., 0], bx[..., 1], bx[..., 2], bx[..., 3]
    rx = x1 + (x2 - x1 + 0.1) / 2
    by = y1 + (y2 - y1 + 0.1) / 2
    return torch.stack([x1, y1, x2, y2, rx, by], 1).contiguous()


def _lib():
    lib = native.load("mask_assembly")
    fn = lib.assemble_masks_f32
    if fn.argtypes is None:
        lib.assemble_masks_smem_bytes.restype = ctypes.c_int
        lib.assemble_masks_smem_bytes.argtypes = [ctypes.c_int] * 2
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [
            ctypes.c_void_p]
    return lib


def assemble_masks(basis, cofs, boxes):
    """K6: SP mask assembly, (B, h, w, nb), (B, N, 4*nb), (B, N, 4) ->
    (B, h, w, N) sigmoid probabilities, 0 outside the boxes.

    CPU tensors take :func:`assemble_masks_plain`; CUDA tensors launch the
    kernel (f32; the basis is read channel-major, so the permuted view of
    an NCHW basis is read in place) and raise on anything it does not take.
    """
    if basis.device.type == "cpu":
        return assemble_masks_plain(basis, cofs, boxes)
    if basis.device.type != "cuda":
        raise ValueError(f"no K6 kernel for device {basis.device}")
    b, h, w, nb, n = _check(basis, cofs, boxes)
    if not basis.dtype == cofs.dtype == torch.float32:
        raise TypeError(f"float32 only, got {basis.dtype} and {cofs.dtype}")
    lib = _lib()
    if lib.assemble_masks_smem_bytes(nb, n) > 227 * 1024:
        raise ValueError(f"{n} detections of {nb} bases exceed the kernel's "
                         f"shared memory")
    basis_c = basis.permute(0, 3, 1, 2).contiguous()      # (B, nb, h, w)
    cq = cofs.detach().reshape(b, n, 4, nb).permute(0, 2, 3, 1).contiguous()
    params = quadrant_params(boxes.detach())
    out = torch.empty((b, h, w, n), device=basis.device, dtype=torch.float32)
    if out.numel() == 0:
        return out
    with torch.cuda.device(basis.device):
        code = lib.assemble_masks_f32(
            basis_c.data_ptr(), cq.data_ptr(), params.data_ptr(),
            out.data_ptr(), b, h, w, nb, n, native.stream_ptr(basis.device))
    native.check_launch(lib, "mask_assembly", code)
    assemble_masks.launches += 1
    return out


assemble_masks.launches = 0
