"""The port's serving slice against the JAX package's, end to end: detector
-> decode_batch, and inference_detector, on the same weights at golden's
shrunk config (f32, CPU). The cls and reg biases are bumped so that the
decode has detections to keep (see _torch_parity)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (bumped_state_dict, images, jax_variables,
                           shrunk_cfg)
from sipmask_tpu.apis.inference import Detector as JDetector
from sipmask_tpu.apis.inference import inference_detector as j_inference
from sipmask_tpu.models import build_model as j_build_model
from sipmask_tpu.models.decode import decode_batch as j_decode_batch
from sipmask_tpu_torch.apis.inference import (inference_detector,
                                              init_detector, preprocess)
from sipmask_tpu_torch.models.decode import decode_batch
from sipmask_tpu_torch.utils.convert import params_from_jax

IMG_SHAPES = np.array([[120.0, 160.0], [128.0, 150.0]], np.float32)
SCALES = np.array([[1.0] * 4, [0.8] * 4], np.float32)


@pytest.fixture(scope="module")
def setup():
    cfg = shrunk_cfg()
    det = init_detector(cfg, "cpu")
    variables = jax_variables(bumped_state_dict(det.model))
    det.model.load_state_dict(params_from_jax(variables["params"],
                                              variables["constants"]))
    x = images(2, 128, 160)
    jm = j_build_model(cfg.model)
    j_out = jax.jit(jm.apply)(variables, jnp.asarray(x))
    j_dec = jax.jit(lambda o: j_decode_batch(
        o, jnp.asarray(IMG_SHAPES), jnp.asarray(SCALES), cfg.model))(j_out)
    with torch.no_grad():
        out = det.model(torch.from_numpy(x).permute(0, 3, 1, 2).contiguous())
    return dict(cfg=cfg, det=det, variables=variables, jm=jm,
                j_out=jax.tree_util.tree_map(np.asarray, j_out),
                j_dec=jax.tree_util.tree_map(np.asarray, j_dec), out=out)


def _check_decoded(got, want):
    v = want["valid"]
    assert v.sum() > 0, "the bias bumps must give detections"
    np.testing.assert_array_equal(got["valid"].numpy(), v)
    np.testing.assert_array_equal(got["labels"].numpy()[v], want["labels"][v])
    # scores: sigmoid products of f32 logits; boxes: points +- stride-scaled
    # f32 regressions of ~16 px
    np.testing.assert_allclose(got["scores"].numpy(), want["scores"],
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(got["boxes"].numpy(), want["boxes"], rtol=0,
                               atol=1e-3)
    np.testing.assert_allclose(got["masks"].numpy(), want["masks"], rtol=0,
                               atol=1e-4)


def _nchw_outputs(j_out):
    """The JAX head's NHWC outputs as the port's NCHW tensors."""
    return {k: ([torch.from_numpy(a.transpose(0, 3, 1, 2).copy())
                 for a in v] if isinstance(v, list) else
                torch.from_numpy(v.transpose(0, 3, 1, 2).copy()))
            for k, v in j_out.items()}


def test_decode_matches_jax_on_the_same_head_outputs(setup):
    """Same inputs to both decodes: any difference is the decode's own."""
    nchw = _nchw_outputs(setup["j_out"])
    got = decode_batch(nchw, torch.from_numpy(IMG_SHAPES),
                       torch.from_numpy(SCALES), setup["cfg"].model)
    _check_decoded(got, setup["j_dec"])


def test_fast_nms_decode_matches_jax_on_the_same_head_outputs(setup):
    """The real-time presets' decode (``ssd_flag``: fast NMS on score x
    centerness, as ``sipmask_r50_fpn_ssd_6x`` tests) without rescoring, on
    the same head outputs. score_thr is lowered from the preset's 0.1 so
    that the bumped scores (~0.08 x centerness) keep detections."""
    from sipmask_tpu.config import _r
    cfg = _r(setup["cfg"].model, "head", ssd_flag=True)
    cfg = _r(cfg, "test", score_thr=0.02, use_fast_nms=True, nms_pre=1000)
    want = jax.tree_util.tree_map(np.asarray, jax.jit(
        lambda o: j_decode_batch(o, jnp.asarray(IMG_SHAPES),
                                 jnp.asarray(SCALES), cfg))(setup["j_out"]))
    nchw = _nchw_outputs(setup["j_out"])
    got = decode_batch(nchw, torch.from_numpy(IMG_SHAPES),
                       torch.from_numpy(SCALES), cfg)
    assert "mask_scores" not in got
    _check_decoded(got, want)


@pytest.mark.parametrize("method", ["linear", "gaussian"])
def test_soft_nms_decode_matches_jax_on_the_same_head_outputs(setup, method):
    """``test.nms_type="soft_nms"``: per-class soft-NMS on the candidates,
    then the mask assembly on its detections, as JAX's decode: boxes,
    labels, scores and masks. The candidates' scores lie within 0.06 of
    each other, so a linear decay (a factor 1 - IoU below 0.5) sends a
    box below the top 100 and linear keeps the hard path's detections;
    gaussian decays the slightly overlapping ones too, and keeps others."""
    from sipmask_tpu.config import _r
    cfg = _r(setup["cfg"].model, "test", nms_type="soft_nms",
             soft_nms_method=method)
    want = jax.tree_util.tree_map(np.asarray, jax.jit(
        lambda o: j_decode_batch(o, jnp.asarray(IMG_SHAPES),
                                 jnp.asarray(SCALES), cfg))(setup["j_out"]))
    got = decode_batch(_nchw_outputs(setup["j_out"]),
                       torch.from_numpy(IMG_SHAPES),
                       torch.from_numpy(SCALES), cfg)
    _check_decoded(got, want)
    same = np.array_equal(want["scores"], setup["j_dec"]["scores"])
    assert same == (method == "linear")


def test_detector_and_decode_match_jax(setup):
    got = decode_batch(setup["out"], torch.from_numpy(IMG_SHAPES),
                       torch.from_numpy(SCALES), setup["cfg"].model)
    _check_decoded(got, setup["j_dec"])


def test_inference_detector_matches_jax(setup):
    img = (np.random.RandomState(3).rand(120, 160, 3) * 255).astype(np.uint8)
    want = j_inference(JDetector(setup["cfg"], setup["jm"],
                                 setup["variables"]), img)
    got = inference_detector(setup["det"], img)
    assert len(want["labels"]) > 0
    np.testing.assert_array_equal(got["labels"], want["labels"])
    np.testing.assert_allclose(got["scores"], want["scores"], rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(got["boxes"], want["boxes"], rtol=0,
                               atol=1e-3)
    assert got["masks"].shape == want["masks"].shape == (
        len(want["labels"]), 120, 160)
    # thresholded at mask_thr: only pixels whose probability lies within
    # float noise of the threshold may flip
    assert (got["masks"] != want["masks"]).mean() < 1e-4


@pytest.mark.parametrize("hw", [(120, 160), (100, 150), (150, 100)],
                         ids=["test_scale", "landscape_resized",
                              "portrait_resized"])
def test_preprocess_matches_jax_test_transform(setup, hw):
    """preprocess is TestTransform: the keep-ratio resize (cv2's uint8
    bilinear, bit for bit), normalization and the pad to the static bucket
    (128x160 landscape, 160x128 portrait at this img_scale), exactly."""
    from sipmask_tpu.data.transforms import TestTransform
    cfg = setup["cfg"]
    img = (np.random.RandomState(4).rand(*hw, 3) * 255).astype(np.uint8)
    want = TestTransform(cfg.data)(img)
    padded, img_shape, scale = preprocess(img, cfg)
    assert padded.shape == want.image.shape == (
        (128, 160, 3) if hw[1] >= hw[0] else (160, 128, 3))
    np.testing.assert_array_equal(padded, want.image)
    np.testing.assert_array_equal(img_shape, want.img_shape)
    np.testing.assert_array_equal(scale, want.scale_factor)


def test_inference_detector_matches_jax_after_a_resize(setup):
    """A 100x150 image is resized by 160/150 before the model, so the mask
    paste runs at a scale factor != 1 (fx = 2 / 1.0667): the port's device
    paste with cv2's map against JAX's cv2.resize. Boxes to 1e-3; masks
    thresholded at mask_thr, at most 0.5% of pixels apart."""
    img = (np.random.RandomState(6).rand(100, 150, 3) * 255).astype(np.uint8)
    want = j_inference(JDetector(setup["cfg"], setup["jm"],
                                 setup["variables"]), img)
    got = inference_detector(setup["det"], img)
    assert len(want["labels"]) > 0
    np.testing.assert_array_equal(got["labels"], want["labels"])
    np.testing.assert_allclose(got["scores"], want["scores"], rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(got["boxes"], want["boxes"], rtol=0,
                               atol=1e-3)
    assert got["masks"].shape == want["masks"].shape == (
        len(want["labels"]), 100, 150)
    assert (got["masks"] != want["masks"]).mean() <= 5e-3
