"""The forward kernels a served graph reaches, as ``torch.library`` custom
ops, so that ``torch.export`` can trace a model through them: the ctypes
launches of the wrappers take raw pointers, which a traced (fake) tensor
does not have.

- ``sipmask::deform_im2col`` (K1, f32 and bf16), ``sipmask::gn_relu``
  (K4a, f32 and bf16), ``sipmask::deform_rows`` (K5, SipMask++'s DCN
  stages) and ``sipmask::assemble_masks`` (K6).
- Each op's implementation is the kernel's wrapper: on CUDA tensors its
  launcher (which counts the launch), on CPU tensors the plain version.
  Its ``register_fake`` gives the output's shape, dtype and strides.
- The model goes through the ops only while :func:`routed` is true: while
  ``torch.export`` traces it, or inside :func:`route_through_ops` (which
  ``tools/get_flops.py`` uses so that ``FlopCounterMode`` sees the
  kernels). Eager calls launch the kernels directly: a Python custom op's
  dispatch adds host time to every call, and bf16 serving is bound by the
  host.
- FLOP formulas for ``torch.utils.flop_counter``: K1 and K5 count a
  multiply and an add for each of an output's four bilinear corners, K6 a
  multiply and an add a basis mask for each (pixel, detection), as the
  convolutions count their products.
"""

from __future__ import annotations

import contextlib

import torch
from torch import Tensor

_ROUTED = [0]


def routed() -> bool:
    """True while the model should call the custom ops."""
    return bool(_ROUTED[0]) or torch.compiler.is_exporting()


@contextlib.contextmanager
def route_through_ops():
    """Within this context the model calls the custom ops, also eagerly."""
    _ROUTED[0] += 1
    try:
        yield
    finally:
        _ROUTED[0] -= 1


# ---------------------------------------------------------------- K1

@torch.library.custom_op("sipmask::deform_im2col", mutates_args=())
def deform_im2col(x: Tensor, offsets: Tensor, kh: int, kw: int,
                  stride: int, padding: int, dilation: int,
                  deform_groups: int) -> Tensor:
    from .deform_sample import deform_im2col as launch
    return launch(x, offsets, (kh, kw), stride, padding, dilation,
                  deform_groups)


@deform_im2col.register_fake
def _(x, offsets, kh, kw, stride, padding, dilation, deform_groups):
    b, c = x.shape[:2]
    return x.new_empty((b, c * kh * kw,
                        offsets.shape[2] * offsets.shape[3]))


# ---------------------------------------------------------------- K4a

@torch.library.custom_op("sipmask::gn_relu", mutates_args=())
def gn_relu(x: Tensor, weight: Tensor, bias: Tensor, groups: int,
            eps: float, act: bool) -> Tensor:
    from .gn_relu import gn_relu_forward
    return gn_relu_forward(x, weight, bias, groups, eps, act, False)[0]


@gn_relu.register_fake
def _(x, weight, bias, groups, eps, act):
    return torch.empty_like(x)


# ---------------------------------------------------------------- K5

@torch.library.custom_op("sipmask::deform_rows", mutates_args=())
def deform_rows(x_rows: Tensor, pyx: Tensor, h: int, w: int) -> Tensor:
    from .deform_sample import deform_rows as launch
    return launch(x_rows, pyx, h, w)


@deform_rows.register_fake
def _(x_rows, pyx, h, w):
    n, k, p, _ = pyx.shape
    return x_rows.new_empty((n, p, k, x_rows.shape[2]))


# ---------------------------------------------------------------- K6

@torch.library.custom_op("sipmask::assemble_masks", mutates_args=())
def assemble_masks(basis: Tensor, cofs: Tensor, boxes: Tensor) -> Tensor:
    from .mask_assembly import assemble_masks as launch
    out = launch(basis, cofs, boxes)
    # the kernel's layout on every device: the plain version's is (B, h,
    # w, N)-contiguous
    return out.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)


@assemble_masks.register_fake
def _(basis, cofs, boxes):
    b, h, w, _ = basis.shape
    n = cofs.shape[1]
    # the kernel's masks: the (B, h, w, N) view of (B, N, h, w)
    return basis.new_empty((b, n, h, w), dtype=torch.float32).permute(
        0, 2, 3, 1)


# ------------------------------------------------------ FLOP formulas

def _register_flops():
    from torch.utils.flop_counter import register_flop_formula

    @register_flop_formula(torch.ops.sipmask.deform_im2col)
    def _(x_shape, offsets_shape, kh, kw, *args, out_shape=None, **kw_):
        return 2 * 4 * _numel(out_shape)

    @register_flop_formula(torch.ops.sipmask.deform_rows)
    def _(x_shape, pyx_shape, h, w, *args, out_shape=None, **kw_):
        return 2 * 4 * _numel(out_shape)

    @register_flop_formula(torch.ops.sipmask.assemble_masks)
    def _(basis_shape, cofs_shape, boxes_shape, *args, out_shape=None,
          **kw_):
        return 2 * basis_shape[-1] * _numel(out_shape)


def _numel(shape):
    n = 1
    for s in shape:
        n *= int(s)
    return n


_register_flops()
