"""Op parity of the PyTorch port (sipmask_tpu_torch) with the JAX package.

Inputs come from numpy seeds and go through both, in f32 on the CPU, where
each port wrapper runs its kernel's plain version. The JAX Pallas kernels run
in interpret mode, as tests/test_ops.py runs them.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sipmask_tpu.core import boxes as jboxes
from sipmask_tpu.core.points import all_points as j_all_points
from sipmask_tpu.models.layers import group_norm_nhwc
from sipmask_tpu.ops.crop_split import assemble_masks as j_assemble_masks
from sipmask_tpu.ops.deform_conv import _sample_positions
from sipmask_tpu.ops.deform_conv import deform_conv2d as j_deform_conv2d
from sipmask_tpu.ops.nms import multiclass_nms_idx as j_multiclass_nms_idx
from sipmask_tpu.ops.pallas.deform_gather import (_sample_pallas_sep_t,
                                                  _sample_pallas_t,
                                                  sample_ref)
from sipmask_tpu.ops.pallas.group_norm import fused_gn_relu
from sipmask_tpu.ops.pallas.mask_loss import mask_bce_loss_fused
from sipmask_tpu.core import losses as jlosses
from sipmask_tpu.core.targets import centerness_target as j_centerness
from sipmask_tpu.core.targets import fcos_targets as j_fcos_targets
from sipmask_tpu.ops.crop_split import (
    mask_bce_loss_indexed as j_mask_bce_loss_indexed)
from sipmask_tpu_torch.core import losses as plosses
from sipmask_tpu_torch.core.boxes import (bbox_overlaps, center_size,
                                          distance2bbox)
from sipmask_tpu_torch.core.points import all_points
from sipmask_tpu_torch.core.targets import centerness_target, fcos_targets
from sipmask_tpu_torch.models.layers import resize_bilinear, resize_nearest
from sipmask_tpu_torch.ops import (deform_conv, deform_sample, gn_relu,
                                   mask_loss, native)
from sipmask_tpu_torch.ops.crop_split import (assemble_masks,
                                              mask_bce_loss_indexed)
from sipmask_tpu_torch.ops.deform_conv import deform_conv2d
from sipmask_tpu_torch.ops.nms import multiclass_nms_idx

T = torch.from_numpy


def _nchw(a):
    return T(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2)))


# ------------------------------------------------------------------- K1

def _offsets(rng, b, g, h, w, regime):
    """(B, H, W, G*18) offsets in the CUDA layout. 'moderate': sigma 0.7 px;
    'extreme': thirds of +-300 px, sigma 2 px and integer far-out offsets
    (where a gather that forms the address before the bounds test reads
    out of bounds)."""
    off = rng.randn(b, h, w, g * 18).astype(np.float32)
    if regime == "moderate":
        return off * 0.7
    flat = off.reshape(b, h * w, g * 18)
    p = h * w
    flat[:, :p // 3] *= 300.0
    flat[:, p // 3:2 * p // 3] *= 2.0
    flat[:, 2 * p // 3:] = np.round(flat[:, 2 * p // 3:] * 100.0)
    return flat.reshape(b, h, w, g * 18)


def _k1_case(seed, regime, b=2, g=2, cg=8, h=24, w=20):
    rng = np.random.RandomState(seed)
    x = rng.randn(b, h, w, g * cg).astype(np.float32)
    off = _offsets(rng, b, g, h, w, regime)
    # the JAX kernels' operands, batch-major rows: N = b*G + g
    x_rows = jnp.asarray(x.reshape(b, h * w, g, cg).transpose(0, 2, 1, 3)
                         .reshape(b * g, h * w, cg))
    pyx = _sample_positions(jnp.asarray(off), 3, 3, 1, 1, 1, g)
    return x, off, x_rows, pyx, (b, g, cg, h, w)


@pytest.mark.parametrize("regime", ["moderate", "extreme"])
@pytest.mark.parametrize("ref", ["sep_t", "banded_t", "sample_ref"])
def test_deform_im2col_plain_matches_jax(ref, regime):
    x, off, x_rows, pyx, (b, g, cg, h, w) = _k1_case(0, regime)
    p = h * w
    if ref == "sep_t":
        want = _sample_pallas_sep_t(x_rows, pyx, h, w, interpret=True)
    elif ref == "banded_t":
        want = _sample_pallas_t(x_rows, pyx, h, w, interpret=True)
    else:   # (N, P, K, Cg) -> (N, K*Cg, P)
        want = sample_ref(x_rows, pyx, h, w).transpose(0, 2, 3, 1)
    want = np.asarray(want)[:, :, :p].reshape(b, g * 9 * cg, p)
    got = deform_sample.deform_im2col(_nchw(x), _nchw(off), (3, 3), 1, 1, 1,
                                      g)
    # same f32 arithmetic as sample_ref; the one-hot matmuls of the Pallas
    # kernels sum the same four products in another order
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_deform_im2col_cpu_takes_the_plain_version():
    x, off, *_ = _k1_case(1, "moderate", h=6, w=5)
    before = deform_sample.deform_im2col.launches
    got = deform_sample.deform_im2col(_nchw(x), _nchw(off), (3, 3), 1, 1, 1,
                                      2)
    want = deform_sample.deform_im2col_plain(_nchw(x), _nchw(off), (3, 3),
                                             1, 1, 1, 2)
    assert torch.equal(got, want)
    assert deform_sample.deform_im2col.launches == before


def test_kernel_wrappers_raise_off_cpu_and_cuda():
    """No fallback: a device with no kernel raises, it does not run the
    plain version."""
    x = torch.empty((1, 8, 4, 4), device="meta")
    with pytest.raises(ValueError, match="no K1 kernel"):
        deform_sample.deform_im2col(x, torch.empty((1, 18, 4, 4),
                                                   device="meta"))
    with pytest.raises(ValueError, match="no K4 kernel"):
        gn_relu.gn_relu(x, torch.ones(8, device="meta"),
                        torch.zeros(8, device="meta"), 4)


def test_deform_im2col_rejects_bad_offsets():
    with pytest.raises(ValueError, match="offsets"):
        deform_sample.deform_im2col(torch.zeros(1, 8, 5, 5),
                                    torch.zeros(1, 36, 5, 5), (3, 3), 1, 1,
                                    1, 1)


@pytest.mark.parametrize("stride,dilation,groups,regime", [
    (1, 1, 4, "moderate"),   # FeatureAlign
    (1, 1, 4, "extreme"),
    (2, 1, 1, "moderate"),
    (1, 2, 2, "extreme"),
])
def test_deform_conv2d_matches_jax(stride, dilation, groups, regime):
    rng = np.random.RandomState(3)
    b, c, h, w, o = 2, 16, 13, 11, 12
    x = rng.randn(b, h, w, c).astype(np.float32)
    pad = dilation
    ho = (h + 2 * pad - 2 * dilation - 1) // stride + 1
    wo = (w + 2 * pad - 2 * dilation - 1) // stride + 1
    off = _offsets(rng, b, groups, ho, wo, regime)
    weight = (rng.randn(3, 3, c, o) * 0.1).astype(np.float32)    # HWIO
    want = j_deform_conv2d(jnp.asarray(x), jnp.asarray(off),
                           jnp.asarray(weight), stride=stride, padding=pad,
                           dilation=dilation, deform_groups=groups)
    got = deform_conv2d(_nchw(x), _nchw(off),
                        T(np.ascontiguousarray(weight.transpose(3, 2, 0, 1))),
                        stride=stride, padding=pad, dilation=dilation,
                        deform_groups=groups)
    # f32 contractions over 9*16 products, summed in another order
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(),
                               np.asarray(want), rtol=1e-4, atol=1e-4)


def _deform_grad_case(regime):
    rng = np.random.RandomState(9)
    b, c, h, w, o, g = 2, 16, 11, 13, 8, 4
    x = rng.randn(b, h, w, c).astype(np.float32)
    if regime == "zero":      # conv_offset's initial state
        off = np.zeros((b, h, w, g * 18), np.float32)
    else:
        off = _offsets(rng, b, g, h, w, regime)
    weight = (rng.randn(3, 3, c, o) * 0.1).astype(np.float32)      # HWIO
    dy = rng.randn(b, h, w, o).astype(np.float32)
    return x, off, weight, dy, g


@pytest.mark.parametrize("regime", ["moderate", "zero", "extreme"])
def test_deform_conv2d_gradients_match_jax(regime):
    """The plain version's gradients (autograd through deform_im2col_plain)
    and K2's CPU wrapper against jax.vjp of the JAX deform_conv2d (its CPU
    path: autodiff of sample_ref, the one-sided floor rule)."""
    x, off, weight, dy, g = _deform_grad_case(regime)
    _, vjp = jax.vjp(lambda a, b_, c: j_deform_conv2d(
        a, b_, c, padding=1, deform_groups=g), jnp.asarray(x),
        jnp.asarray(off), jnp.asarray(weight))
    jdx, jdoff, jdw = (np.asarray(t) for t in vjp(jnp.asarray(dy)))
    xt = _nchw(x).requires_grad_(True)
    ot = _nchw(off).requires_grad_(True)
    wt = T(np.ascontiguousarray(weight.transpose(3, 2, 0, 1))
           ).requires_grad_(True)
    out = deform_conv2d(xt, ot, wt, padding=1, deform_groups=g)
    out.backward(_nchw(dy))
    # f32 sums of up to 9*16 products (dx, d offsets) or 2*143 (dw), in
    # another order
    tol = dict(rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(xt.grad.permute(0, 2, 3, 1).numpy(), jdx,
                               **tol)
    np.testing.assert_allclose(ot.grad.permute(0, 2, 3, 1).numpy(), jdoff,
                               **tol)
    np.testing.assert_allclose(wt.grad.permute(2, 3, 1, 0).numpy(), jdw,
                               **tol)
    if regime == "zero":
        assert np.abs(jdoff).max() > 0 and ot.grad.abs().max() > 0
    # K2's wrapper (its plain version on the CPU) gives the same gradients
    w2 = deform_conv._w2(wt.detach(), g).contiguous()
    cols = deform_sample.deform_im2col(xt.detach(), ot.detach(), (3, 3), 1,
                                       1, 1, g)
    dx, doff, dw2 = deform_conv.deform_conv_backward(
        xt.detach(), ot.detach(), cols, w2, _nchw(dy), (3, 3), 1, 1, 1, g)
    np.testing.assert_allclose(dx.numpy(), xt.grad.numpy(), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(doff.numpy(), ot.grad.numpy(), rtol=1e-6,
                               atol=1e-6)
    wt2 = wt.detach().clone().requires_grad_(True)
    deform_conv._w2(wt2, g).backward(dw2)
    np.testing.assert_allclose(wt2.grad.numpy(), wt.grad.numpy(), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("depth", [256, 2048])   # O; a dW2 pixel chunk
def test_tf32_split_matmul_plain_is_f32_accurate(depth):
    """K2's GEMMs on the tensor cores: 3xTF32 (tf32_split_matmul_plain
    states the split) stays within 1e-5 of the f64 product's max at K2's
    contraction depths, as chip_smoke's TRAIN_KERNEL_TOL needs; one TF32
    product (three decimal digits) does not."""
    rng = np.random.RandomState(depth)
    a = T(rng.randn(96, depth).astype(np.float32))
    b = T(rng.randn(depth, 80).astype(np.float32))
    exact = a.double() @ b.double()
    scale = float(exact.abs().max())

    def err(got):
        return float((got.double() - exact).abs().max()) / scale
    rounded = deform_conv.tf32_round_plain(a)
    # every value TF32: 13 low mantissa bits clear, within half a TF32 unit
    assert not (rounded.view(torch.int32) & 0x1FFF).any()
    assert float(((rounded - a) / a).abs().max()) <= 2.0 ** -11
    assert err(deform_conv.tf32_split_matmul_plain(a, b)) <= 1e-5
    assert err(rounded @ deform_conv.tf32_round_plain(b)) > 1e-5


# ------------------------------------------------------------------- K4

@pytest.mark.parametrize("act", [True, False])
@pytest.mark.parametrize("ref", ["fused_gn_relu", "group_norm_nhwc"])
def test_gn_relu_plain_matches_jax(ref, act):
    rng = np.random.RandomState(4)
    b, h, w, c, groups = 2, 9, 7, 256, 32     # odd h*w: ragged tiles
    x = (rng.randn(b, h, w, c) * 3.0 + 1.0).astype(np.float32)
    scale = (rng.rand(c) + 0.5).astype(np.float32)
    bias = (rng.randn(c) * 0.2).astype(np.float32)
    xj, sj, bj = jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias)
    if ref == "fused_gn_relu":
        want = fused_gn_relu(xj, sj, bj, groups, 1e-5, act, True)
    else:
        want = group_norm_nhwc(xj, sj, bj, groups, 1e-5)
        want = jnp.maximum(want, 0) if act else want
    got = gn_relu.gn_relu(_nchw(x), T(scale), T(bias), groups, 1e-5, act)
    # the same single-pass f32 statistics; only summation order differs
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(),
                               np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("b,c,groups", [
    (2, 64, 32),     # Cg 2
    (1, 256, 32),    # the head towers' own: Cg 8
    (2, 512, 32),    # Cg 16
])
@pytest.mark.parametrize("act", [True, False])
def test_gn_relu_backward_matches_jax(act, b, c, groups):
    """gn_relu's CPU backward (gn_relu_backward_plain, whose per-channel
    coefficients follow K4b's order) and autograd through gn_relu_plain
    against the VJP of group_norm_nhwc (+ relu)."""
    rng = np.random.RandomState(10)
    h, w = 9, 7
    x = (rng.randn(b, h, w, c) * 3.0 + 1.0).astype(np.float32)
    scale = (rng.rand(c) + 0.5).astype(np.float32)
    bias = (rng.randn(c) * 0.2).astype(np.float32)
    dy = rng.randn(b, h, w, c).astype(np.float32)

    def f(x_, s_, b_):
        y = group_norm_nhwc(x_, s_, b_, groups, 1e-5)
        return jnp.maximum(y, 0) if act else y
    _, vjp = jax.vjp(f, jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias))
    want = [np.asarray(t) for t in vjp(jnp.asarray(dy))]
    want[0] = want[0].transpose(0, 3, 1, 2)
    for fn in (gn_relu.gn_relu, gn_relu.gn_relu_plain):
        xt = _nchw(x).requires_grad_(True)
        st, bt = T(scale).requires_grad_(True), T(bias).requires_grad_(True)
        y = fn(xt, st, bt, groups, 1e-5, act)
        assert y.grad_fn is not None
        y.backward(_nchw(dy))
        # the same f32 algebra; sums over 63 pixels in another order
        for got, exp in zip((xt.grad, st.grad, bt.grad), want):
            np.testing.assert_allclose(got.numpy(), exp, rtol=1e-4,
                                       atol=1e-5)


def test_gn_relu_plain_masks_by_the_kernels_fma_sign():
    """K4a and K4b gate the ReLU on fmaf(x, sc, bi) > 0. Where x*sc + bi
    rounded twice in f32 is exactly 0 but the exact value is positive (x
    equal to its group's mean, bi = -fl(x*sc)), the plain K4b passes dy on
    as the kernels do, and the plain K4a gives their y: an f64 backward
    with the exact mask, and fmaf's rounding of y."""
    rng = np.random.RandomState(3)
    b, c, groups, h, w = 2, 64, 32, 4, 5
    cg, n = c // groups, float(h * w * c // groups)
    x = rng.randn(b, c, h, w).astype(np.float32)
    dy = rng.randn(b, c, h, w).astype(np.float32)
    weight = np.ones(c, np.float32)
    bias = np.zeros(c, np.float32)
    mean = x[:, ::cg, 0, 0].copy()            # each group's first element
    rstd = np.empty((b, groups), np.float32)
    for i in range(b):
        for g in range(groups):
            while True:   # x0*rstd rounded down in f32: the exact value > 0
                r = np.float32(rng.rand() + 0.5)
                if float(mean[i, g]) * float(r) > float(mean[i, g] * r):
                    break
            rstd[i, g] = r
    stats = np.stack([mean, rstd], -1)
    sc = np.repeat(rstd, cg, 1)[:, :, None, None]
    bi = (0.0 - np.repeat(mean * rstd, cg, 1))[:, :, None, None]
    exact = x.astype(np.float64) * sc + bi
    twice = x * sc + bi                       # f32, two roundings
    ties = (exact > 0) & ~(twice > 0)
    assert ties.sum() == b * groups

    dy_eff = np.where(exact > 0, dy, 0.0).astype(np.float64)
    xd, mean_c = x.astype(np.float64), np.repeat(mean, cg, 1).astype(
        np.float64)
    rstd_c = np.repeat(rstd, cg, 1).astype(np.float64)
    r1, r2 = dy_eff.sum((2, 3)), (dy_eff * xd).sum((2, 3))
    sdx = (r2 - mean_c * r1) * rstd_c
    m1 = np.repeat(r1.reshape(b, groups, cg).sum(-1) / n, cg, 1)
    m2 = np.repeat(sdx.reshape(b, groups, cg).sum(-1) / n, cg, 1)
    a, b2 = rstd_c, -rstd_c * rstd_c * m2
    c2 = rstd_c * (mean_c * rstd_c * m2 - m1)
    want = (a[:, :, None, None] * dy_eff + b2[:, :, None, None] * xd
            + c2[:, :, None, None], sdx.sum(0), r1.sum(0))
    got = gn_relu.gn_relu_backward_plain(T(x), T(weight), T(bias), T(stats),
                                         T(dy), groups, True)
    for g_, w_ in zip(got, want):
        np.testing.assert_allclose(g_.numpy(), w_, rtol=1e-5,
                                   atol=1e-5 * np.abs(w_).max())
    # the forward's y where the mask flips: fmaf's one rounding, not 0
    y = gn_relu._pre_relu(T(x), T(sc[:, :, 0, 0]), T(bi[:, :, 0, 0])).float()
    np.testing.assert_array_equal(y.numpy()[ties],
                                  exact[ties].astype(np.float32))
    assert (y.numpy()[ties] > 0).all()


# ------------------------------------------------------------------- K3

def _mask_case(seed, b=2, k=20, g=5, h=24, w=40):
    """Basis NCHW, coefficients, boxes in mask coordinates (some partly or
    wholly off the map, one degenerate), gt masks, gt indices, validity."""
    rng = np.random.RandomState(seed)
    basis = rng.randn(b, 32, h, w).astype(np.float32)
    cofs = (rng.randn(b, k, 128) * 0.5).astype(np.float32)
    x1 = rng.uniform(-5, w - 4, (b, k))
    y1 = rng.uniform(-5, h - 4, (b, k))
    boxes = np.stack([x1, y1, x1 + rng.uniform(1.5, w, (b, k)),
                      y1 + rng.uniform(1.5, h, (b, k))], -1).astype(
                          np.float32)
    boxes[:, 3] = [6.3, 4.2, 5.1, 9.0]                   # degenerate
    gt = (rng.rand(b, g, h, w) > 0.5).astype(np.uint8)
    gt_idx = rng.randint(0, g, (b, k)).astype(np.int32)
    valid = rng.rand(b, k) > 0.25
    return basis, cofs, boxes, gt, gt_idx, valid


def test_mask_bce_loss_indexed_matches_jax():
    basis, cofs, boxes, gt, gt_idx, _ = _mask_case(11)
    g = np.random.RandomState(12).rand(*gt_idx.shape).astype(np.float32)
    for i in range(basis.shape[0]):
        jb = jnp.asarray(basis[i].transpose(1, 2, 0))
        want, vjp = jax.vjp(lambda bs, cf: j_mask_bce_loss_indexed(
            bs, cf, jnp.asarray(boxes[i]), jnp.asarray(gt[i]),
            jnp.asarray(gt_idx[i])), jb, jnp.asarray(cofs[i]))
        jdb, jdc = vjp(jnp.asarray(g[i]))
        bt = T(basis[i].transpose(1, 2, 0).copy()).requires_grad_(True)
        ct = T(cofs[i]).requires_grad_(True)
        got = mask_bce_loss_indexed(bt, ct, T(boxes[i]), T(gt[i]),
                                    T(gt_idx[i]))
        got.backward(T(g[i]))
        # f32 sums over up to 960 pixels, in another order
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-3)
        np.testing.assert_allclose(bt.grad.numpy(), np.asarray(jdb),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(ct.grad.numpy(), np.asarray(jdc),
                                   rtol=1e-5, atol=1e-4)


def test_mask_loss_wrappers_match_the_fused_kernel():
    """K3's CPU wrappers (the plain version, batched, invalid positives
    zeroed) against the JAX Pallas kernel in interpret mode, values and
    gradients in basis and cofs."""
    basis, cofs, boxes, gt, gt_idx, valid = _mask_case(13)
    g = np.random.RandomState(14).rand(*gt_idx.shape).astype(np.float32)
    jb = jnp.asarray(basis.transpose(0, 2, 3, 1))
    want, vjp = jax.vjp(lambda bs, cf: mask_bce_loss_fused(
        bs, cf, jnp.asarray(boxes), jnp.asarray(gt), jnp.asarray(gt_idx),
        interpret=True, mm_dtype=jnp.float32, valid=jnp.asarray(valid)),
        jb, jnp.asarray(cofs))
    jdb, jdc = vjp(jnp.asarray(g))
    args = (T(basis), T(cofs), T(boxes), T(gt), T(gt_idx), T(valid))
    pre = mask_loss.mask_bce_forward(*args)
    dbasis, dcofs = mask_loss.mask_bce_backward(*args, T(g))
    assert not pre[~args[5]].any()
    np.testing.assert_allclose(pre.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(dbasis.numpy(),
                               np.asarray(jdb).transpose(0, 3, 1, 2),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(dcofs.numpy(), np.asarray(jdc), rtol=1e-5,
                               atol=1e-4)
    bt, ct = args[0].clone().requires_grad_(True), args[1].clone(
    ).requires_grad_(True)
    loss = mask_loss.mask_bce_loss(bt, ct, *args[2:])
    assert loss.grad_fn is not None
    loss.backward(T(g))
    np.testing.assert_allclose(bt.grad.numpy(), dbasis.numpy(), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(ct.grad.numpy(), dcofs.numpy(), rtol=1e-6,
                               atol=1e-6)


def test_mask_bce_tiled_plain_matches_plain_and_the_fused_kernel():
    """K3a's order in plain PyTorch (a partial per positive and 16x32 pixel
    tile, then the fold over the tiles the hit predicate marks) against the
    plain version and the JAX Pallas kernel in interpret mode."""
    basis, cofs, boxes, gt, gt_idx, valid = _mask_case(13, w=72)
    want = mask_bce_loss_fused(
        jnp.asarray(basis.transpose(0, 2, 3, 1)), jnp.asarray(cofs),
        jnp.asarray(boxes), jnp.asarray(gt), jnp.asarray(gt_idx),
        interpret=True, mm_dtype=jnp.float32, valid=jnp.asarray(valid))
    args = (T(basis), T(cofs), T(boxes), T(gt), T(gt_idx), T(valid))
    got = mask_loss.mask_bce_forward_tiled_plain(*args)
    assert not got[~args[5]].any()
    # f32 sums over up to 1728 pixels, in another order
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-3)
    np.testing.assert_allclose(
        got.numpy(), mask_loss.mask_bce_loss_plain(*args).numpy(), rtol=1e-5,
        atol=1e-3)


def _regime_boxes(regime, rng, b, k, h, w):
    """(b, k, 4) boxes: 'random' in and across the map's borders;
    'degenerate' (x2 <= x1, y2 <= y1, or no integer inside); 'off_map'
    (wholly or partly outside); 'nan' (one coordinate NaN); 'tile_edges'
    (corners at and beside multiples of 8, 16 and 32, at x.5, at 0 and at w
    or h); 'split_edges' (half-splits on and just inside tile edges)."""
    x1 = rng.uniform(-5, w, (b, k))
    y1 = rng.uniform(-5, h, (b, k))
    boxes = np.stack([x1, y1, x1 + rng.uniform(0.5, w, (b, k)),
                      y1 + rng.uniform(0.5, h, (b, k))], -1)
    if regime == "degenerate":
        boxes[:, 0::3, 2] = boxes[:, 0::3, 0] - rng.uniform(0, 3, (b, 1))
        boxes[:, 1::3, 3] = boxes[:, 1::3, 1]
        boxes[:, 2::3, 0] = np.floor(boxes[:, 2::3, 0]) + 0.2
        boxes[:, 2::3, 2] = boxes[:, 2::3, 0] + 0.6
    elif regime == "off_map":
        shift = rng.choice([-1.0, 1.0], (b, k, 2)) * rng.uniform(
            0.5, 2.0, (b, k, 2)) * np.array([w, h])
        boxes += np.concatenate([shift, shift], -1)
    elif regime == "nan":
        boxes[np.arange(b)[:, None], np.arange(k)[None],
              rng.randint(0, 4, (b, k))] = np.nan
        boxes[:, ::4] = [2.0, 3.0, 20.0, 11.0]       # some stay finite
    elif regime == "split_edges":
        # half-splits exactly on tile edges and on the last column or row
        # of a tile: x1 + (x2 - x1 + 0.1)/2 rounds to the target in f32
        xm = rng.choice([15.0, 31.0, 32.0, 47.0, 63.0], (b, k))
        ym = rng.choice([7.0, 15.0, 16.0, 31.0], (b, k))
        x1 = np.floor(xm - rng.uniform(1, 30, (b, k)))
        y1 = np.floor(ym - rng.uniform(1, 15, (b, k)))
        boxes = np.stack([x1, y1, 2 * xm - x1 - 0.1, 2 * ym - y1 - 0.1], -1)
    elif regime == "tile_edges":
        xs = [0, 0.5, 7.5, 8, 31, 31.5, 32, 32.5, 63, 63.5, 64, w - 1,
              w - 0.5, w, w + 0.5]
        ys = [0, 0.5, 7, 7.5, 8, 8.5, 15, 15.5, 16, 31, 32, h - 1, h - 0.5,
              h, h + 0.5]
        bx = np.sort(rng.choice(xs, (b, k, 2)), -1)
        by = np.sort(rng.choice(ys, (b, k, 2)), -1)
        boxes = np.stack([bx[..., 0], by[..., 0], bx[..., 1], by[..., 1]],
                         -1)
    return boxes.astype(np.float32)


@pytest.mark.parametrize("regime", ["random", "degenerate", "off_map", "nan",
                                    "tile_edges"])
def test_mask_bce_tiles_hold_every_in_box_pixel(regime):
    """No pixel inside a valid box (CropSplit's float rule) lies in a tile
    that K3a's hit predicate misses, so the fold drops nothing; the tiled
    plain version then equals the plain version."""
    b, k, h, w = 2, 24, 40, 72            # ragged tiles in both directions
    rng = np.random.RandomState(21)
    basis, cofs, _, gt, gt_idx, valid = _mask_case(22, b, k, 5, h, w)
    boxes = T(_regime_boxes(regime, rng, b, k, h, w))
    valid = T(valid)
    hits = mask_loss.tile_hits(boxes, valid, h, w)
    th, tw = mask_loss.TILE_H, mask_loss.TILE_W
    nth, ntw = -(-h // th), -(-w // tw)
    assert hits.shape == (b, k, nth, ntw)
    pw = torch.arange(w, dtype=torch.float32)
    ph = torch.arange(h, dtype=torch.float32)[:, None]
    x1, y1, x2, y2 = (boxes[..., i, None, None] for i in range(4))
    in_box = (pw >= x1) & (pw < x2) & (ph >= y1) & (ph < y2)
    in_box &= valid[..., None, None]
    in_tile = torch.nn.functional.pad(
        in_box, (0, ntw * tw - w, 0, nth * th - h)).reshape(
            b, k, nth, th, ntw, tw).any(5).any(3)
    assert not (in_tile & ~hits).any()
    if regime in ("random", "tile_edges"):
        assert in_tile.any()
    args = (T(basis), T(cofs), boxes, T(gt), T(gt_idx), valid)
    np.testing.assert_allclose(
        mask_loss.mask_bce_forward_tiled_plain(*args).numpy(),
        mask_loss.mask_bce_loss_plain(*args).numpy(), rtol=1e-5, atol=1e-3)


def test_mask_bce_tiled_backward_matches_plain_and_the_fused_kernel():
    """K3b's order in plain PyTorch (d basis per tile pixel; d cofs as a
    segment per positive, quadrant and 16x32 tile, kept where the segment
    predicate marks it and folded in tile order) against the plain version
    and the JAX Pallas kernel's vjp in interpret mode; positives with a
    zero cotangent get exactly zero d cofs."""
    basis, cofs, boxes, gt, gt_idx, valid = _mask_case(13, w=72)
    g = np.random.RandomState(14).rand(*gt_idx.shape).astype(np.float32)
    g[:, ::5] = 0.0
    _, vjp = jax.vjp(lambda bs, cf: mask_bce_loss_fused(
        bs, cf, jnp.asarray(boxes), jnp.asarray(gt), jnp.asarray(gt_idx),
        interpret=True, mm_dtype=jnp.float32, valid=jnp.asarray(valid)),
        jnp.asarray(basis.transpose(0, 2, 3, 1)), jnp.asarray(cofs))
    jdb, jdc = vjp(jnp.asarray(g))
    args = (T(basis), T(cofs), T(boxes), T(gt), T(gt_idx), T(valid), T(g))
    dbasis, dcofs = mask_loss.mask_bce_backward_tiled_plain(*args)
    want_db, want_dc = mask_loss.mask_bce_backward_plain(*args)
    assert not dcofs[T(g) == 0].any() and not dcofs[~args[5]].any()
    # f32 sums over up to 1728 pixels, in another order
    for want in (np.asarray(jdb).transpose(0, 3, 1, 2), want_db.numpy()):
        np.testing.assert_allclose(dbasis.numpy(), want, rtol=1e-5,
                                   atol=1e-5)
    for want in (np.asarray(jdc), want_dc.numpy()):
        np.testing.assert_allclose(dcofs.numpy(), want, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("regime", ["random", "degenerate", "off_map", "nan",
                                    "tile_edges", "split_edges"])
def test_mask_bce_quadrant_tiles_hold_every_in_box_pixel(regime):
    """No pixel of quadrant q inside a valid box (CropSplit's float rule and
    half-split) lies in a tile that K3b's segment predicate misses for q, so
    the d cofs fold drops nothing; the tiled plain backward then equals the
    plain version."""
    b, k, h, w = 2, 24, 40, 72            # ragged tiles in both directions
    rng = np.random.RandomState(23)
    basis, cofs, _, gt, gt_idx, valid = _mask_case(24, b, k, 5, h, w)
    boxes = T(_regime_boxes(regime, rng, b, k, h, w))
    valid = T(valid)
    grad = T(rng.rand(b, k).astype(np.float32))
    grad[:, ::5] = 0.0
    hits = mask_loss.quad_tile_hits(boxes, valid, grad, h, w)
    th, tw = mask_loss.TILE_H, mask_loss.TILE_W
    nth, ntw = -(-h // th), -(-w // tw)
    assert hits.shape == (b, k, 4, nth, ntw)
    assert not (hits & ~mask_loss.tile_hits(boxes, valid, h, w)[:, :, None]
                ).any()
    assert not hits[grad == 0].any()
    pw = torch.arange(w, dtype=torch.float32)
    ph = torch.arange(h, dtype=torch.float32)[:, None]
    x1, y1, x2, y2 = (boxes[..., i, None, None] for i in range(4))
    in_box = (pw >= x1) & (pw < x2) & (ph >= y1) & (ph < y2)
    in_box &= (valid & (grad != 0))[..., None, None]
    quad = ((pw >= x1 + (x2 - x1 + 0.1) / 2).long()
            + 2 * (ph >= y1 + (y2 - y1 + 0.1) / 2).long())
    in_quad = torch.stack([in_box & (quad == q) for q in range(4)], 2)
    in_tile = torch.nn.functional.pad(
        in_quad, (0, ntw * tw - w, 0, nth * th - h)).reshape(
            b, k, 4, nth, th, ntw, tw).any(6).any(4)
    assert not (in_tile & ~hits).any()
    if regime in ("random", "tile_edges", "split_edges"):
        assert in_tile.any()
    args = (T(basis), T(cofs), boxes, T(gt), T(gt_idx), valid, grad)
    got = mask_loss.mask_bce_backward_tiled_plain(*args)
    want = mask_loss.mask_bce_backward_plain(*args)
    np.testing.assert_allclose(got[0].numpy(), want[0].numpy(), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(got[1].numpy(), want[1].numpy(), rtol=1e-5,
                               atol=1e-4)


# ----------------------------------------------------- targets and losses

def test_fcos_targets_match_jax():
    rng = np.random.RandomState(15)
    sizes, strides = [(16, 20), (8, 10), (4, 5), (2, 3), (1, 2)], \
        (8, 16, 32, 64, 128)
    ranges = ((-1, 64), (64, 128), (128, 256), (256, 512), (512, 1e8))
    b, g = 3, 9
    ctr = rng.uniform(0, 160, (b, g, 2))
    wh = rng.uniform(4, 150, (b, g, 2))
    gtb = np.concatenate([ctr - wh / 2, ctr + wh / 2], -1).astype(np.float32)
    gtb[0, 1] = gtb[0, 0]                       # a tie of areas
    labels = rng.randint(1, 81, (b, g)).astype(np.int32)
    labels[:, 6:] = 0                           # padding
    pts, strd, rng_ = all_points(sizes, strides, ranges)
    jp, js, jr = j_all_points(sizes, strides, ranges)
    for cs in (True, False):
        want = j_fcos_targets(jnp.asarray(gtb), jnp.asarray(labels), jp, jr,
                              js, cs, 1.5)
        got = fcos_targets(T(gtb), T(labels), pts, rng_, strd, cs, 1.5)
        assert int((got["labels"] > 0).sum()) > 20
        for k in ("labels", "gt_inds"):
            np.testing.assert_array_equal(got[k].numpy(),
                                          np.asarray(want[k]), err_msg=k)
        np.testing.assert_array_equal(got["bbox_targets"].numpy(),
                                      np.asarray(want["bbox_targets"]))
        np.testing.assert_allclose(
            centerness_target(got["bbox_targets"].clamp(min=0)).numpy(),
            np.asarray(j_centerness(jnp.clip(want["bbox_targets"], 0))),
            rtol=1e-6, atol=1e-7)


def test_losses_match_jax():
    rng = np.random.RandomState(16)
    n, c = 300, 7
    logits = (rng.randn(n, c) * 3).astype(np.float32)
    labels = rng.randint(0, c + 1, n).astype(np.int32)
    ctr = rng.uniform(0, 100, (n, 2))
    pred = np.concatenate([ctr - rng.uniform(1, 30, (n, 2)),
                           ctr + rng.uniform(1, 30, (n, 2))], -1
                          ).astype(np.float32)
    tgt = np.concatenate([ctr - rng.uniform(1, 30, (n, 2)),
                          ctr + rng.uniform(1, 30, (n, 2))], -1
                         ).astype(np.float32)
    w = rng.rand(n).astype(np.float32)
    t = rng.rand(n).astype(np.float32)
    cases = [
        (lambda L, a: L.sigmoid_focal_loss(a[0], a[1], c, 2.0, 0.25,
                                           avg_factor=37.0),
         (logits, labels)),
        (lambda L, a: L.iou_loss(a[0], a[1], weight=a[2], avg_factor=5.0),
         (pred, tgt, w)),
        (lambda L, a: L.giou_loss(a[0], a[1], weight=a[2], avg_factor=5.0),
         (pred, tgt, w)),
        (lambda L, a: L.bce_with_logits(a[0], a[1], weight=a[2],
                                        avg_factor=3.0),
         (logits[:, 0], t, w)),
    ]
    for fn, args in cases:
        want, vjp = jax.vjp(lambda x: fn(jlosses, (x,) + tuple(
            jnp.asarray(a) for a in args[1:])), jnp.asarray(args[0]))
        xt = T(args[0]).requires_grad_(True)
        got = fn(plosses, (xt,) + tuple(T(a) for a in args[1:]))
        got.backward()
        # f32 sums over up to 2100 terms, in another order
        np.testing.assert_allclose(float(got.detach()), float(want),
                                   rtol=1e-5)
        np.testing.assert_allclose(xt.grad.numpy(),
                                   np.asarray(vjp(jnp.float32(1.0))[0]),
                                   rtol=1e-4, atol=1e-7)
    np.testing.assert_allclose(
        bbox_overlaps(T(pred), T(tgt), is_aligned=True, eps=1e-9).numpy(),
        np.asarray(jboxes.bbox_overlaps(pred, tgt, is_aligned=True,
                                        eps=1e-9)), rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(center_size(T(pred)).numpy(),
                                  np.asarray(jboxes.center_size(pred)))


# ------------------------------------------------------------------ NMS

def _greedy_nms_oracle(boxes, scores, iou_thr):
    """Greedy NMS with the +1 IoU, one pick at a time (the oracle of
    tests/test_ops.py, with each pick's IoU row in numpy)."""
    order = np.argsort(-scores, kind="stable")
    area = (boxes[:, 2] - boxes[:, 0] + 1) * (boxes[:, 3] - boxes[:, 1] + 1)
    keep = []
    suppressed = np.zeros(len(boxes), bool)
    for i in order:
        if suppressed[i]:
            continue
        keep.append(i)
        iw = np.maximum(np.minimum(boxes[i, 2], boxes[:, 2]) -
                        np.maximum(boxes[i, 0], boxes[:, 0]) + 1, 0)
        ih = np.maximum(np.minimum(boxes[i, 3], boxes[:, 3]) -
                        np.maximum(boxes[i, 1], boxes[:, 1]) + 1, 0)
        inter = iw * ih
        suppressed |= inter / (area[i] + area - inter) > iou_thr
        suppressed[i] = True
    return keep


def _multiclass_oracle(boxes, scores, max_img):
    """Per-class greedy NMS, concatenated: (must, optional) keep sets, the
    optional ones tied with the max_img-th score."""
    pairs = []
    for cc in range(scores.shape[1]):
        s = scores[:, cc].copy()
        s[s <= 0.05] = -1
        keep = _greedy_nms_oracle(boxes, s, 0.5)
        pairs += [(i, cc, s[i]) for i in keep if s[i] > 0.05]
    pairs.sort(key=lambda t: -t[2])
    kth = pairs[max_img - 1][2] if len(pairs) >= max_img else -1
    must = {(i, cc) for i, cc, s in pairs[:max_img] if s > kth}
    opt = {(i, cc) for i, cc, s in pairs if s == kth}
    return must, opt, min(max_img, len(pairs))


def _kept(out):
    v = out["valid"].numpy()
    return set(zip(out["idxs"].numpy()[v].tolist(),
                   out["labels"].numpy()[v].tolist()))


class TestMulticlassNMS:
    """The keep-set cases of tests/test_ops.py::TestNMS on the port."""

    def test_single_class_matches_greedy_oracle(self):
        rng = np.random.RandomState(0)
        n = 60
        boxes = rng.uniform(0, 80, (n, 4)).astype(np.float32)
        boxes[:, 2:] = boxes[:, :2] + rng.uniform(5, 40, (n, 2))
        scores = rng.rand(n).astype(np.float32)
        expect = [i for i in _greedy_nms_oracle(boxes, scores, 0.5)
                  if scores[i] > 0.05][:30]
        out = multiclass_nms_idx(T(boxes), T(scores[:, None]), 0.05, 0.5, 30)
        v = out["valid"].numpy()
        assert out["idxs"].numpy()[v].tolist() == expect

    def test_basic(self):
        boxes = torch.tensor([[0, 0, 10, 10], [1, 1, 11, 11],
                              [50, 50, 60, 60], [0, 0, 10, 10]],
                             dtype=torch.float32)
        scores = torch.tensor([[0.9, 0.01], [0.8, 0.01], [0.7, 0.01],
                               [0.01, 0.6]])
        out = multiclass_nms_idx(boxes, scores, 0.05, 0.5, 10)
        assert out["valid"].sum() == 3
        assert _kept(out) == {(0, 0), (2, 0), (3, 1)}

    def test_degenerate_box_not_repicked(self):
        boxes = torch.tensor([[50.0, 50.0, 40.0, 40.0],
                              [0, 0, 10, 10], [100, 100, 110, 110]])
        scores = torch.tensor([[0.95], [0.9], [0.8]])
        out = multiclass_nms_idx(boxes, scores, 0.05, 0.5, 5)
        v = out["valid"].numpy()
        assert v.sum() == 3
        assert out["idxs"].numpy()[v].tolist() == [0, 1, 2]

    def test_tied_scores_early_stop_exact(self):
        rng = np.random.RandomState(7)
        n, c = 400, 12
        boxes = rng.uniform(0, 200, (n, 4)).astype(np.float32)
        boxes[:, 2:] = boxes[:, :2] + rng.uniform(4, 60, (n, 2))
        scores = (np.round(rng.rand(n, c) * 8) / 8).astype(np.float32)
        out = multiclass_nms_idx(T(boxes), T(scores), 0.05, 0.5, 50)
        got = _kept(out)
        must, opt, count = _multiclass_oracle(boxes, scores, 50)
        assert must <= got
        assert got - must <= opt
        assert len(got) == count

    def test_suppression_chain_within_wave(self):
        boxes = torch.tensor([[0, 0, 10, 10], [3, 0, 13, 10],
                              [6, 0, 16, 10]], dtype=torch.float32)
        scores = torch.tensor([[0.9], [0.8], [0.7]])
        out = multiclass_nms_idx(boxes, scores, 0.05, 0.5, 5)
        v = out["valid"].numpy()
        assert out["idxs"].numpy()[v].tolist() == [0, 2]

    def test_fuzz_vs_oracle(self):
        rng = np.random.RandomState(42)
        for trial in range(12):
            n = int(rng.randint(5, 160))
            c = int(rng.randint(1, 9))
            max_img = int(rng.randint(1, 40))
            centers = rng.uniform(0, 300, (max(1, n // 12), 2))
            ctr = centers[rng.randint(0, len(centers), n)] + \
                rng.randn(n, 2) * 6
            wh = rng.uniform(8, 50, (n, 2))
            boxes = np.concatenate([ctr - wh / 2, ctr + wh / 2],
                                   1).astype(np.float32)
            deg = rng.rand(n) < 0.1
            boxes[deg, 2] = boxes[deg, 0] - 3.0
            scores = (np.round(rng.rand(n, c) * 16) / 16).astype(np.float32)
            out = multiclass_nms_idx(T(boxes), T(scores), 0.05, 0.5, max_img)
            got = _kept(out)
            must, opt, count = _multiclass_oracle(boxes, scores, max_img)
            assert must <= got, f"trial {trial}: missing {must - got}"
            assert got - must <= opt, f"trial {trial}: extras"
            assert len(got) == count, f"trial {trial}"

    def test_score_factor_ordering(self):
        boxes = torch.tensor([[0, 0, 10, 10], [100, 100, 110, 110]],
                             dtype=torch.float32)
        scores = torch.tensor([[0.9], [0.8]])
        out = multiclass_nms_idx(boxes, scores, 0.05, 0.5, 2,
                                 score_factors=torch.tensor([0.1, 1.0]))
        assert out["idxs"][0] == 1
        np.testing.assert_allclose(out["scores"].numpy()[:2], [0.8, 0.09],
                                   rtol=1e-5)

    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_identical_to_jax(self, seed):
        """Same picks in the same order, ties included: the stable sort
        reproduces lax.top_k's lower-index-first rule."""
        rng = np.random.RandomState(seed)
        n, c = 300, 6
        ctr = rng.uniform(0, 200, (n, 2))
        wh = rng.uniform(5, 60, (n, 2))
        boxes = np.concatenate([ctr - wh / 2, ctr + wh / 2],
                               1).astype(np.float32)
        scores = (np.round(rng.rand(n, c) * 32) / 32).astype(np.float32)
        factors = (np.round(rng.rand(n) * 4) / 4).astype(np.float32)
        want = j_multiclass_nms_idx(jnp.asarray(boxes), jnp.asarray(scores),
                                    0.05, 0.5, 100,
                                    score_factors=jnp.asarray(factors))
        got = multiclass_nms_idx(T(boxes), T(scores), 0.05, 0.5, 100,
                                 score_factors=T(factors))
        v = np.asarray(want["valid"])
        np.testing.assert_array_equal(got["valid"].numpy(), v)
        for k in ("idxs", "labels"):
            np.testing.assert_array_equal(got[k].numpy()[v],
                                          np.asarray(want[k])[v])
        for k in ("scores", "boxes"):
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                       rtol=1e-6, atol=1e-6)


# ------------------------------------------------- masks, geometry, resize

def test_assemble_masks_matches_jax():
    rng = np.random.RandomState(5)
    h, w, nb, n = 19, 23, 8, 7
    basis = rng.randn(h, w, nb).astype(np.float32)
    cofs = rng.randn(n, 4 * nb).astype(np.float32)
    boxes = np.array([[1, 1, 9, 9], [4, 2, 15, 13], [0, 0, 23, 19],
                      [5, 5, 6.5, 7.2], [-4, -3, 30, 25], [10, 8, 9, 7],
                      [2.5, 3.3, 2.55, 3.4]], np.float32)
    want = j_assemble_masks(jnp.asarray(basis), jnp.asarray(cofs),
                            jnp.asarray(boxes))
    got = assemble_masks(T(basis), T(cofs), T(boxes))
    # sigmoid of f32 32-term dot products; the crop masks are exact
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_array_equal(got.numpy() > 0, np.asarray(want) > 0)


@pytest.mark.parametrize("size,out", [((3, 5), (6, 10)), ((2, 3), (8, 12)),
                                      ((3, 4), (7, 9))])
def test_resize_bilinear_matches_jax(size, out):
    x = np.random.RandomState(6).randn(2, *size, 3).astype(np.float32)
    want = jax.image.resize(jnp.asarray(x), (2, *out, 3), method="bilinear")
    got = resize_bilinear(_nchw(x), *out)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(),
                               np.asarray(want), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("size,out", [((3, 5), (6, 10)), ((2, 3), (8, 12))])
def test_resize_nearest_matches_jax(size, out):
    x = np.random.RandomState(7).randn(2, *size, 3).astype(np.float32)
    want = jax.image.resize(jnp.asarray(x), (2, *out, 3), method="nearest")
    got = resize_nearest(_nchw(x), *out)
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(),
                                  np.asarray(want))


def test_box_geometry_and_points_match_jax():
    rng = np.random.RandomState(8)
    b1 = rng.uniform(0, 50, (7, 4)).astype(np.float32)
    b2 = rng.uniform(0, 50, (9, 4)).astype(np.float32)
    b2[:, 2:] = b2[:, :2] + rng.uniform(-3, 30, (9, 2))   # some degenerate
    np.testing.assert_allclose(bbox_overlaps(T(b1), T(b2)).numpy(),
                               np.asarray(jboxes.bbox_overlaps(b1, b2)),
                               rtol=1e-6, atol=1e-7)
    pts = rng.uniform(0, 100, (11, 2)).astype(np.float32)
    dist = rng.uniform(0, 40, (11, 4)).astype(np.float32)
    np.testing.assert_array_equal(distance2bbox(T(pts), T(dist)).numpy(),
                                  np.asarray(jboxes.distance2bbox(pts, dist)))
    sizes, strides = [(16, 20), (8, 10), (1, 2)], (8, 16, 128)
    ranges = ((-1, 64), (64, 128), (128, 1e8))
    for got, want in zip(all_points(sizes, strides, ranges),
                         j_all_points(sizes, strides, ranges)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ------------------------------------------------------- package and build

def test_import_leaves_jax_flax_cv2_and_the_jax_package_out():
    """No module of JAX, flax, cv2, PIL or the JAX package is imported, by
    name or by file: no loaded module's file lies under sipmask_tpu/."""
    code = (
        "import importlib, os, pkgutil, sys\n"
        "import sipmask_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "vis = ('models.track', 'data.ytvos', 'eval.ytvos_eval',\n"
        "       'apis.test_video', 'tools.synth_ytvis', 'tools.test_video',\n"
        "       'ops.roi', 'models.ssd_vgg', 'models.bfp', 'core.assigners')\n"
        "assert all('sipmask_tpu_torch.' + m in sys.modules for m in vis)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in\n"
        "       ('jax', 'flax', 'cv2', 'PIL', 'sipmask_tpu')]\n"
        "assert not bad, bad\n"
        "jax_pkg = os.path.realpath('sipmask_tpu') + os.sep\n"
        "files = [(n, os.path.realpath(m.__file__))\n"
        "         for n, m in list(sys.modules.items())\n"
        "         if getattr(m, '__file__', None)]\n"
        "bad = [(n, f) for n, f in files if f.startswith(jax_pkg)]\n"
        "assert not bad, bad\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=root)
    assert res.returncode == 0, res.stderr


def test_port_presets_equal_the_jax_packages():
    """The port's own copy of the presets gives the JAX package's configs,
    field for field, for every preset."""
    import dataclasses
    from sipmask_tpu import config as j_config
    from sipmask_tpu_torch import config as p_config
    assert p_config.list_configs() == j_config.list_configs()
    for name in j_config.list_configs():
        assert dataclasses.asdict(p_config.get_config(name)) == \
            dataclasses.asdict(j_config.get_config(name)), name


def test_kernel_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setattr(native, "_LIBS", {})
    with pytest.raises(RuntimeError, match="nvcc not found"):
        native.load("gn_relu")
    assert not (tmp_path / "kernels").exists()
