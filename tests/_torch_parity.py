"""Shared set-up of the port's parity tests (tests/test_torch_*.py): one
shrunk config and one set of weights, carried from the port's init into the
JAX package and back through ``params_from_jax``."""

import contextlib
import copy

import numpy as np
import torch

SEED = 5
CLS_BIAS = -2.5   # sigmoid = 0.076: about half the scores pass score_thr
REG_BIAS = 2.0    # boxes of 2 strides a side: decoded boxes are not points
OFFSET_STD = 0.5  # conv_offset weights: offsets of a few px, not zero


def shrunk_cfg():
    """The flagship at golden's shrink (tests/test_golden.py): R50, FPN and
    head 32 wide, stacked_convs 2, test scale 160x128 (long, short)."""
    from sipmask_tpu.config import _r, get_config
    cfg = get_config("sipmask_r50_fpn_gn_1x")
    cfg = _r(cfg, "model.fpn", out_channels=32)
    cfg = _r(cfg, "model.head", in_channels=32, feat_channels=32,
             stacked_convs=2)
    return _r(cfg, "data", img_scale=(160, 128))


def bumped_state_dict(model, seed=SEED):
    """``init_weights`` from ``seed``, then random non-zero ``conv_offset``
    weights and the cls/reg bias bumps, so that the deformable conv is not a
    plain 3x3 conv and decode has detections."""
    from sipmask_tpu_torch.utils.convert import init_weights
    init_weights(model, torch.Generator().manual_seed(seed))
    rng = np.random.RandomState(seed)
    head = model.bbox_head
    with torch.no_grad():
        w = head.feat_align.conv_offset.weight
        w.copy_(torch.from_numpy(
            rng.randn(*w.shape).astype(np.float32) * OFFSET_STD))
        head.fcos_cls.bias.fill_(CLS_BIAS)
        head.fcos_reg.bias.fill_(REG_BIAS)
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def jax_variables(state_dict):
    """The same weights as the JAX package's (params, constants) trees."""
    from sipmask_tpu.utils.torch_convert import torch_to_flax
    params, constants = torch_to_flax(
        {k: v.numpy() for k, v in state_dict.items()})
    return {"params": params, "constants": constants}


def images(n=2, h=64, w=96, seed=0):
    """Normalized (caffe-mean-subtracted) images, NHWC float32."""
    rng = np.random.RandomState(seed)
    return (rng.rand(n, h, w, 3) * 255 - 115).astype(np.float32)


def nhwc(t):
    """A port NCHW tensor as an NHWC numpy array."""
    return t.detach().permute(0, 2, 3, 1).cpu().numpy()


def assert_close(got, want, rel, err_msg=""):
    """|got - want| <= rel * max|want| everywhere."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (err_msg, got.shape, want.shape)
    scale = float(np.abs(want).max()) or 1.0
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * scale,
                               err_msg=err_msg)


# ---------------------------------------------------------------- SipMask++

PP_HW = (256, 256)   # the rescoring tower needs a >= 127 px mask grid


def pp_cfg(depth=101):
    """SipMask++ at 256x256 with FPN and head 32 wide (R101, or R50 with
    the same DCN stages)."""
    from sipmask_tpu.config import _r, get_config
    cfg = get_config("sipmaskpp_r101_fpn_ssd_6x")
    cfg = _r(cfg, "model.backbone", depth=depth)
    cfg = _r(cfg, "model.fpn", out_channels=32)
    cfg = _r(cfg, "model.head", in_channels=32, feat_channels=32)
    return _r(cfg, "data", fixed_size=PP_HW, train_size=PP_HW)


def pp_state_dict(model, images_nchw, seed=11, training=False):
    """``init_weights``, ``bump_weights`` (``training``: its training
    variant) and ``calibrate_frozen_bn``: a random SipMask++ whose
    activations stay near unit scale, with non-zero offset convs and
    detections to decode."""
    from sipmask_tpu_torch.utils.convert import init_weights
    from sipmask_tpu_torch.utils.demo_inputs import (bump_weights,
                                                     calibrate_frozen_bn)
    init_weights(model, torch.Generator().manual_seed(seed))
    bump_weights(model, torch.Generator().manual_seed(seed), training)
    calibrate_frozen_bn(model.backbone, images_nchw)
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def pp_variables(state_dict, depth):
    """The same weights as the JAX package's trees, at ``depth``."""
    from sipmask_tpu.utils.torch_convert import torch_to_flax
    params, constants = torch_to_flax(
        {k: v.numpy() for k, v in state_dict.items()}, depth=depth)
    return {"params": params, "constants": constants}


def pp_images(n=2, seed=0):
    """Normalized images at PP_HW, NHWC float32."""
    return images(n, *PP_HW, seed=seed)


# ------------------------------------------------------- pinned ReLU masks
#
# A ReLU's derivative jumps at 0, and the calibrated backbone's
# pre-activations are centred on 0: in f32 a few dozen of them fall on the
# other side of 0 than in f64 (or than in the other package's f32), and each
# such flip moves a whole row of a weight gradient. At 8x8 C5 maps a row is a
# sum of 128 products, so a few flips move a layer4 gradient by up to 13%
# of its max (tests/test_torch_pp_train.py measures this). Pinning every
# trainable-stage ReLU of the backbone to the sign mask of one f64 forward,
# as ``x * mask``, makes both packages compute the same piecewise-linear
# function, whose gradient is smooth in the rounding: then f32 gradients
# can be held tightly.

def backbone_relu_masks(backbone, images_nchw, dtype=torch.float64):
    """The sign masks (x > 0) of the port backbone's ReLUs, in call order,
    from a forward of a copy of it in ``dtype``; None for the frozen stem
    and stage 1 (no gradient passes them), NCHW bool arrays after that."""
    net = copy.deepcopy(backbone).to(dtype)
    frozen = 1 + 3 * len(net.layer1)       # the stem's ReLU and stage 1's
    real, masks = torch.relu, []

    def record(x):
        masks.append(None if len(masks) < frozen else (x > 0).numpy())
        return real(x)
    torch.relu = record
    try:
        with torch.no_grad():
            net(images_nchw.to(dtype))
    finally:
        torch.relu = real
    return masks


@contextlib.contextmanager
def pin_port_relus(backbone, masks):
    """Within the context the port backbone's i-th ReLU call returns
    ``x * masks[i]`` (cycling, one pass per forward; None: a plain ReLU).
    Yields the list holding the call count."""
    real, calls = torch.relu, [0]

    def pinned(x):
        m = masks[calls[0] % len(masks)]
        calls[0] += 1
        if m is None:
            return real(x)
        assert m.shape == tuple(x.shape), (m.shape, tuple(x.shape))
        return x * torch.from_numpy(m).to(x.dtype)

    def on(*_):
        torch.relu = pinned

    def off(*_):
        torch.relu = real
    hooks = [backbone.register_forward_pre_hook(on),
             backbone.register_forward_hook(off)]
    try:
        yield calls
    finally:
        for h in hooks:
            h.remove()
        torch.relu = real


@contextlib.contextmanager
def pin_jax_relus(masks, jmodule=None):
    """The same pins for the JAX package's ResNet (NHWC), whose blocks call
    ``sipmask_tpu.models.resnet.relu`` in the port's order (or for the
    module ``jmodule`` whose ``relu`` is called so). Traces made inside the
    context keep the pins. Yields the list holding the call count."""
    import jax.numpy as jnp
    import sipmask_tpu.models.resnet as jresnet
    jresnet = jmodule or jresnet
    real, calls = jresnet.relu, [0]
    nhwc_masks = [None if m is None else np.ascontiguousarray(
        m.transpose(0, 2, 3, 1)) for m in masks]

    def pinned(x):
        m = nhwc_masks[calls[0] % len(masks)]
        calls[0] += 1
        if m is None:
            return real(x)
        assert m.shape == tuple(x.shape), (m.shape, tuple(x.shape))
        return jnp.where(jnp.asarray(m), x, jnp.zeros((), x.dtype))
    jresnet.relu = pinned
    try:
        yield calls
    finally:
        jresnet.relu = real
