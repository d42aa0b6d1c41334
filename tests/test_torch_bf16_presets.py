"""The port's compute_dtype="bfloat16" graph of the last three image presets
against the JAX package's bf16 graph, on the CPU: ResNeXt-101
(``sipmask_x101_fpn_gn_ms_2x``), HRNet-W18 with HRFPN
(``sipmask_hrnet_w32_fpn_gn_1x``) and the SipMask-benchmark fork
(``sipmask_benchmark_r50_fpn_1x``), shrunk as tests/test_torch_backbones.py
shrinks them (FPN/HRFPN and head 32 wide, ``stacked_convs`` 2, 128x160).

``Detector.infer`` end to end is held as tests/test_torch_bf16.py holds the
flagship's and the real-time preset's (its module note gives the bound: as
many detections, and each image's sorted scores within DETECTION_BOUND
drifts of JAX's bf16 run). The fork's losses in bf16, with the NMS-0.9 dedup
of its mask positives firing (``fcos_reg`` bias 10, as chip_smoke.py's
phase 29 sets it: boxes wide enough that neighbours overlap by more than
0.9), are held on JAX's bf16 head outputs as tests/test_torch_bf16.py holds
the flagship's: the losses at rtol 1e-4, their cotangents within one bf16
unit of each output's max.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import bumped_state_dict
from sipmask_tpu.config import _r, get_config
from sipmask_tpu.models import build_model as j_build_model
from sipmask_tpu.models.decode import decode_batch as j_decode_batch
from sipmask_tpu.models.loss import compute_losses as j_compute_losses
from sipmask_tpu.ops.nms import NEG
from sipmask_tpu.utils.torch_convert import torch_to_flax
from sipmask_tpu_torch.apis.inference import init_detector
from sipmask_tpu_torch.models.loss import compute_losses
from sipmask_tpu_torch.ops.nms import hard_nms
from sipmask_tpu_torch.utils.convert import params_from_jax
from sipmask_tpu_torch.utils.demo_inputs import batch_to_tensors, demo_batch
from test_torch_bf16 import (BF, DETECTION_BOUND, IMG_SHAPES, SCALES, ULP,
                             _head_flat, _sorted_scores, assert_within_drift,
                             f32, nhwc, sample_ref_rounding, strict, to_torch)

MAX_POS = 16
HW = (128, 160)
FORK_REG_BIAS = 10.0


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread while this module runs (tests/test_torch_vis.py:
    six workers' OpenMP pools spin against each other)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _shrink(cfg):
    cfg = _r(cfg, "model.fpn", out_channels=32)
    cfg = _r(cfg, "model.head", in_channels=32, feat_channels=32,
             stacked_convs=2)
    return _r(_r(cfg, "data", img_scale=(160, 128)), "train",
              max_pos=MAX_POS)


PRESETS = {
    "x101": lambda: _r(get_config("sipmask_x101_fpn_gn_ms_2x"),
                       "model.backbone", depth=101),
    "hrnet": lambda: _r(get_config("sipmask_hrnet_w32_fpn_gn_1x"),
                        "model.backbone", hrnet_width=18),
    "fork": lambda: get_config("sipmask_benchmark_r50_fpn_1x"),
}


def _cfgs(preset):
    cfg = _shrink(PRESETS[preset]())
    return cfg, _r(cfg, "model", compute_dtype="bfloat16")


def _variables(sd, cfg):
    params, constants = torch_to_flax({k: v.numpy() for k, v in sd.items()},
                                      depth=cfg.model.backbone.depth)
    return {"params": params, "constants": constants}


def _images(seed=9):
    rng = np.random.RandomState(seed)
    return (rng.rand(2, *HW, 3) * 255 - 115).astype(np.float32)


@pytest.mark.parametrize("preset", list(PRESETS))
def test_detector_infer_matches_jax_bf16(preset):
    """``Detector.infer`` in bf16 end to end against the JAX package's
    bf16 model and decode on the same weights and images."""
    cfg, cfg16 = _cfgs(preset)
    det = init_detector(cfg16, "cpu", seed=2)
    var = _variables(bumped_state_dict(det.model), cfg)
    det.model.load_state_dict(params_from_jax(var["params"],
                                              var["constants"]))
    x = _images()

    def run(c):
        jm = j_build_model(c.model)
        return jax.tree_util.tree_map(np.asarray, strict(
            lambda v, im: j_decode_batch(jm.apply(v, im),
                                         jnp.asarray(IMG_SHAPES),
                                         jnp.asarray(SCALES), c.model),
            var, jnp.asarray(x)))
    j16, j32 = run(cfg16), run(cfg)
    with sample_ref_rounding():
        got = det.infer(torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(),
                        torch.from_numpy(IMG_SHAPES),
                        torch.from_numpy(SCALES))
    got = {k: v.numpy() for k, v in got.items()}
    assert np.isfinite(got["boxes"]).all() and np.isfinite(got["masks"]).all()
    np.testing.assert_array_equal(got["valid"].sum(1), j16["valid"].sum(1))
    for i in range(x.shape[0]):
        assert got["valid"][i].sum() > 0
        assert_within_drift(_sorted_scores(got, i), _sorted_scores(j16, i),
                            _sorted_scores(j32, i),
                            f"{preset} image {i}'s sorted scores",
                            DETECTION_BOUND)


def test_fork_bf16_losses_with_the_dedup_firing_match_jax(monkeypatch):
    """The fork's bf16 model with ``fcos_reg`` bias 10: JAX's bf16 head
    outputs through both packages' losses. The dedup must drop selected
    positives; the losses equal JAX's (rtol 1e-4) and their cotangents lie
    within one bf16 unit of each output's max."""
    import sipmask_tpu_torch.models.loss as loss_mod
    cfg, cfg16 = _cfgs("fork")
    det = init_detector(cfg16, "cpu", seed=2)
    sd = bumped_state_dict(det.model)
    sd["bbox_head.fcos_reg.bias"].fill_(FORK_REG_BIAS)
    var = _variables(sd, cfg)
    batch = demo_batch(batch_size=2, height=HW[0], width=HW[1], max_gts=8,
                       seed=7)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jm16 = j_build_model(cfg16.model)
    h16 = strict(lambda v, im: jm16.apply(v, im), var, jb["images"])

    def loss(out):
        losses = j_compute_losses(out, jb, cfg.model.head, max_pos=MAX_POS)
        return sum(losses.values()), losses
    (_, jlosses), dh16 = strict(jax.value_and_grad(loss, has_aux=True), h16)

    counts = []

    def recorded(boxes, scores, thr, max_out):
        kept = hard_nms(boxes, scores, thr, max_out)
        counts.append((int((scores > NEG / 2).sum()), int(kept[2].sum())))
        return kept
    monkeypatch.setattr(loss_mod, "hard_nms", recorded)
    outs = {}
    for key, _, a in _head_flat(h16):
        t = to_torch(a, torch.float32 if key == "bbox_preds" else BF)
        outs.setdefault(key, []).append(t.requires_grad_(True))
    outs["feat_masks"] = outs["feat_masks"][0]
    losses = compute_losses(outs, batch_to_tensors(batch), cfg16.model.head,
                            max_pos=MAX_POS)
    (sel, kept), = counts
    assert 0 < kept < sel, "the dedup must drop selected positives"
    assert float(losses["loss_mask"]) > 0
    assert set(losses) == set(jlosses)
    for k, v in losses.items():
        np.testing.assert_allclose(float(v), float(jlosses[k]), rtol=1e-4,
                                   atol=1e-6, err_msg=k)
    sum(losses.values()).backward()
    got = [t for _, _, t in _head_flat(outs)]
    for (key, lvl, want), t in zip(_head_flat(dh16), got):
        g, w = nhwc(t.grad.float()), f32(want)
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=ULP * max(np.abs(w).max(), 1e-30),
                                   err_msg=f"{key}[{lvl}]")
