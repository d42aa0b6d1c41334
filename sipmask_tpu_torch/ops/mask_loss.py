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


def mask_bce_loss_plain(basis, cofs, boxes, gt_masks, gt_idx, valid):
    """Plain PyTorch K3: ``mask_bce_loss_indexed`` per image, through
    autograd, with invalid positives set to 0."""
    pre = torch.stack([
        mask_bce_loss_indexed(basis[i].permute(1, 2, 0), cofs[i],
                              boxes[i].detach(), gt_masks[i], gt_idx[i])
        for i in range(basis.shape[0])])
    return torch.where(valid, pre, torch.zeros_like(pre))


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
        for fn in (lib.mask_bce_num_bases, lib.mask_bce_num_slices):
            fn.restype, fn.argtypes = ctypes.c_int, []
        lib.mask_bce_fwd_f32.restype = ctypes.c_int
        lib.mask_bce_fwd_f32.argtypes = [ctypes.c_void_p] * 8 + [
            ctypes.c_int] * 5 + [ctypes.c_void_p]
        lib.mask_bce_bwd_f32.restype = ctypes.c_int
        lib.mask_bce_bwd_f32.argtypes = [ctypes.c_void_p] * 10 + [
            ctypes.c_int] * 5 + [ctypes.c_void_p]
    return lib


def _cuda_operands(basis, cofs, boxes, gt_masks, gt_idx, valid):
    """Check what the kernels take; gt, gt_idx and valid in the kernels'
    integer types."""
    if basis.device.type != "cuda":
        raise ValueError(f"no K3 kernel for device {basis.device}")
    dims = _check(basis, cofs, boxes, gt_masks, gt_idx, valid)
    if not all(t.is_contiguous() for t in (basis, cofs, boxes, gt_masks)):
        raise ValueError("basis, cofs, boxes and gt_masks must be contiguous")
    if gt_masks.dtype not in (torch.uint8, torch.bool):
        raise TypeError(f"gt_masks must be uint8 or bool, got "
                        f"{gt_masks.dtype}")
    lib = _lib()
    if dims[1] != lib.mask_bce_num_bases():
        raise ValueError(f"the K3 kernels take {lib.mask_bce_num_bases()} "
                         f"basis masks, got {dims[1]}")
    if dims[0] > 65535 or dims[4] > 65535:
        raise ValueError(f"grid too large for B={dims[0]}, K={dims[4]}")
    return (lib, dims, gt_masks.view(torch.uint8),
            gt_idx.to(torch.int32).contiguous(),
            valid.to(torch.uint8).contiguous())


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
    partial = torch.empty((b * k * lib.mask_bce_num_slices(),),
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
    partial = torch.empty((b * k * lib.mask_bce_num_slices() * 4 * nb,),
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
