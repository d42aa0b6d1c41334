"""Shared set-up of the port's parity tests (tests/test_torch_*.py): one
shrunk config and one set of weights, carried from the port's init into the
JAX package and back through ``params_from_jax``."""

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
