"""The last three image presets of the port (sipmask_tpu_torch) against the
JAX package on the CPU: ResNeXt (``sipmask_x101_fpn_gn_ms_2x``), HRNet with
HRFPN (``sipmask_hrnet_w32_fpn_gn_1x``) and the SipMask-benchmark fork's
loss (``sipmask_benchmark_r50_fpn_1x``).

Shrunk as the other parity tests are: FPN/HRFPN and head 32 wide,
``stacked_convs`` 2, HRNet-W18 in place of W32, at 128x160 (and HRNet also
at 96x224, where the HRFPN pools floor 1.5 and 3.5 to 1 and 3 and the last
window is clamped to the map). The same weights go into both packages
through ``torch_to_flax``; every kernel wrapper of the port runs its plain
version here. f32 outputs are held at 1e-5 of each tensor's max, losses at
``test_torch_train.py``'s rtol; bf16 modules within JAX's own bf16-vs-f32
drift, as ``test_torch_bf16.py`` holds them (its module note). Like
``test_torch_vis.py``, the module runs on one torch thread.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from _torch_parity import (assert_close, bumped_state_dict, images,
                           jax_variables, nhwc)
from sipmask_tpu.config import _r, get_config
from sipmask_tpu.core.losses import giou_loss_ltrb as j_giou_loss_ltrb
from sipmask_tpu.models import build_model as j_build_model
from sipmask_tpu.models.decode import decode_batch as j_decode_batch
from sipmask_tpu.models.fpn import FPN as JFPN
from sipmask_tpu.models.hrnet import HRFPN as JHRFPN
from sipmask_tpu.models.hrnet import BasicBlock as JBasicBlock
from sipmask_tpu.models.hrnet import HRModule as JHRModule
from sipmask_tpu.models.loss import compute_losses as j_compute_losses
from sipmask_tpu.models.resnet import Bottleneck as JBottleneck
from sipmask_tpu.ops.nms import NEG, hard_nms as j_hard_nms
from sipmask_tpu.train import make_optimizer as j_make_optimizer
from sipmask_tpu.train import make_train_step as j_make_train_step
from sipmask_tpu.train.optim import _label_params
from sipmask_tpu.train.state import TrainState as JTrainState
from sipmask_tpu.utils.torch_convert import torch_to_flax
from sipmask_tpu_torch.core.losses import giou_loss_ltrb
from sipmask_tpu_torch.models.decode import decode_batch
from sipmask_tpu_torch.models.detector import build_model
from sipmask_tpu_torch.models.fpn import FPN
from sipmask_tpu_torch.models.hrnet import HRFPN, BasicBlock, HRModule
from sipmask_tpu_torch.models.loss import compute_losses
from sipmask_tpu_torch.models.resnet import Bottleneck
from sipmask_tpu_torch.ops.nms import hard_nms
from sipmask_tpu_torch.train import (create_train_state, make_optimizer,
                                     make_train_step)
from sipmask_tpu_torch.utils.convert import (_jax_path_to_torch,
                                             grads_from_jax, params_from_jax)
from sipmask_tpu_torch.utils.demo_inputs import batch_to_tensors, demo_batch

FWD_REL = 1e-5     # f32 forward, relative to each tensor's max
HEAD_REL = 1e-4    # head outputs: test_torch_model.py's bound
LOSS_RTOL = 1e-4   # test_torch_train.py's
# Gradients relative to each tensor's max, as test_torch_train.py states
# them: the head and neck 2e-3; the random backbone's, whose activations
# grow through ~60 layers with identity frozen BN, 3e-2
GRAD_REL = 2e-3
BACKBONE_GRAD_REL = 3e-2
# absolute: a gradient that is 0 in exact arithmetic (the bias of the conv
# before HRFPN's one-pixel level, whose GroupNorm removes any shift) reads
# as rounding noise of ~1e-19 in both packages
GRAD_ATOL = 1e-12
HW = (128, 160)
FLOOR_HW = (96, 224)
MAX_POS = 16
IMG_SHAPES = np.array([[120.0, 160.0], [128.0, 150.0]], np.float32)
SCALES = np.array([[1.0] * 4, [0.8] * 4], np.float32)
BF = torch.bfloat16
STRICT = {"xla_allow_excess_precision": False}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread while this module runs (see
    tests/test_torch_vis.py: six workers' OpenMP pools spin against each
    other)."""
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


def hrnet_cfg():
    """``sipmask_hrnet_w32_fpn_gn_1x`` with HRNet-W18."""
    return _shrink(_r(get_config("sipmask_hrnet_w32_fpn_gn_1x"),
                      "model.backbone", hrnet_width=18))


def x101_cfg(depth=101):
    """``sipmask_x101_fpn_gn_ms_2x`` (32x4d groups) at ``depth``."""
    return _shrink(_r(get_config("sipmask_x101_fpn_gn_ms_2x"),
                      "model.backbone", depth=depth))


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(
        np.asarray(a, np.float32).transpose(0, 3, 1, 2)))


def _weights(cfg):
    """Bumped weights as the port's state_dict, and the JAX variables."""
    sd = bumped_state_dict(build_model(cfg.model))
    params, constants = torch_to_flax({k: v.numpy() for k, v in sd.items()},
                                      depth=cfg.model.backbone.depth)
    return sd, {"params": params, "constants": constants}


# ------------------------------------------------------------ the weights

@pytest.mark.parametrize("name", ["sipmask_hrnet_w32_fpn_gn_1x",
                                  "sipmask_x101_fpn_gn_ms_2x"])
def test_torch_to_flax_of_the_port_gives_the_jax_params(name):
    """Full size: random JAX trees through ``params_from_jax`` give exactly
    the port's state_dict keys and shapes, and the JAX package's own
    ``torch_to_flax`` of that state_dict gives the trees back, value for
    value: a reference-named checkpoint loads into the port by name."""
    cfg = get_config(name)
    shapes = jax.eval_shape(j_build_model(cfg.model).init,
                            jax.random.PRNGKey(0),
                            jnp.zeros((1, 64, 64, 3), jnp.float32))
    rng = np.random.RandomState(0)
    trees = [{k: np.asarray(rng.randn(*v.shape), np.float32) for k, v in
              traverse_util.flatten_dict(shapes[c]).items()}
             for c in ("params", "constants")]
    sd = params_from_jax(*(traverse_util.unflatten_dict(t) for t in trees))
    port = build_model(cfg.model).state_dict()
    assert set(sd) == set(port), set(sd) ^ set(port)
    for k, v in port.items():
        assert tuple(sd[k].shape) == tuple(v.shape), k
    back = torch_to_flax({k: v.numpy() for k, v in sd.items()},
                         depth=cfg.model.backbone.depth)
    for want, got in zip(trees, back):
        got = traverse_util.flatten_dict(got)
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=str(k))


def test_hrnet_init_and_frozen_set_follow_the_jax_package():
    """HRNet freezes exactly what the JAX package's ``_label_params`` labels
    frozen, stage 1's Bottlenecks (``backbone/layer1_*``), while its stem
    trains; the HRFPN neck draws kaiming fan_out with zero biases."""
    cfg = hrnet_cfg()
    model = build_model(cfg.model)
    shapes = jax.eval_shape(j_build_model(cfg.model).init,
                            jax.random.PRNGKey(0),
                            jnp.zeros((1, 64, 64, 3), jnp.float32))
    labels = traverse_util.flatten_dict(_label_params(
        shapes["params"], cfg.model.backbone.frozen_stages))
    by_name = {_jax_path_to_torch("/".join(k)): v for k, v in labels.items()}
    opt = make_optimizer(cfg.train.optim, model)
    group_of = {id(p): g["name"] for g in opt.param_groups
                for p in g["params"]}
    params = dict(model.named_parameters())
    assert set(by_name) == set(params)
    for n, label in by_name.items():
        assert group_of.get(id(params[n]), "frozen") == label, n
    frozen = {n for n, p in params.items() if not p.requires_grad}
    assert frozen and all(n.startswith("backbone.layer1.") for n in frozen)
    assert params["backbone.conv1.weight"].requires_grad
    sd = bumped_state_dict(model)
    w = sd["neck.fpn_convs.0.conv.weight"]              # fan_out 32 * 9
    assert abs(float(w.std()) - np.sqrt(2 / 288)) < 0.01
    assert not sd["neck.reduction_conv.conv.bias"].any()


# --------------------------------------------------------- f32 forwards

def _jax_forward(cfg, variables, x, head=False):
    """The JAX package's backbone and neck outputs on x (NHWC), and with
    ``head`` its head outputs and decode, numpy."""
    jm = j_build_model(cfg.model)

    def stages(m, x):
        c = m.backbone(x)
        p = m.neck(c)
        if not head:
            return c, p
        out = m.head(p)
        return c, p, out, j_decode_batch(out, jnp.asarray(IMG_SHAPES),
                                         jnp.asarray(SCALES), cfg.model)
    return jax.tree_util.tree_map(np.asarray, jax.jit(
        lambda v, x: jm.apply(v, x, method=stages))(variables,
                                                     jnp.asarray(x)))


@pytest.fixture(scope="module", params=["x101", "hrnet"])
def detector(request):
    """A whole shrunk detector (X101 at depth 101, HRNet-W18) on bumped
    weights at 128x160: the port's stages, head outputs and model, and
    JAX's, from one JAX compile."""
    cfg = x101_cfg() if request.param == "x101" else hrnet_cfg()
    sd, variables = _weights(cfg)
    x = images(2, *HW)
    want = _jax_forward(cfg, variables, x, head=True)
    model = build_model(cfg.model)
    model.load_state_dict(sd)
    with torch.no_grad():
        c = model.backbone(_nchw(x))
        p = model.neck(c)
        out = model.bbox_head(p)
    return dict(name=request.param, cfg=cfg, got=(c, p, out), want=want)


def test_resnext50_backbone_and_fpn_match_jax():
    cfg = x101_cfg(depth=50)
    sd, variables = _weights(cfg)
    x = images(2, *HW)
    want_c, want_p = _jax_forward(cfg, variables, x)
    model = build_model(cfg.model)
    model.load_state_dict(sd)
    assert model.backbone.layer3[0].conv2.groups == 32
    assert model.backbone.layer3[0].conv2.weight.shape[:2] == (512, 16)
    with torch.no_grad():
        c = model.backbone(_nchw(x))
        p = model.neck(c)
    for i, (g, w) in enumerate(zip(c, want_c)):
        assert_close(nhwc(g), w, FWD_REL, f"C{i + 2}")
    for i, (g, w) in enumerate(zip(p, want_p)):
        assert_close(nhwc(g), w, FWD_REL, f"P{i + 3}")


def _module_weights(jmod, x, prefix, port_prefix, seed):
    """A JAX module's random trees (frozen BNs drawn away from identity)
    and the same weights as the port module's state_dict."""
    variables = jmod.init(jax.random.PRNGKey(seed), x)
    consts = _random_constants(variables.get("constants", {}),
                               np.random.RandomState(seed))
    variables = {"params": variables["params"], "constants": consts}
    return variables, _port_weights(prefix, port_prefix,
                                    variables["params"], consts)


@pytest.mark.parametrize("opts", [
    dict(extra_convs_on_inputs=True),
    dict(relu_before_extra_convs=False),
    dict(add_extra_convs=False)], ids=["on_inputs", "no_relu", "no_extra"])
def test_fpn_options_match_jax(opts):
    """The FPN settings no preset uses, which the port builds as the JAX
    package does: extra levels from C5, without the ReLU between them, or
    none (one level an input)."""
    rng = np.random.RandomState(5)
    chans = (16, 32, 64, 128)
    xs = [rng.randn(2, 32 >> i, 40 >> i, c).astype(np.float32)
          for i, c in enumerate(chans)]
    jmod = JFPN(out_channels=16, **opts)
    variables, sd = _module_weights(jmod, xs, "neck", "neck.", 5)
    port = FPN(chans, 16, **opts)
    port.load_state_dict(sd)
    want = jmod.apply(variables, xs)
    with torch.no_grad():
        got = port([_nchw(x) for x in xs])
    assert len(got) == len(want) == (3 if not opts.get(
        "add_extra_convs", True) else 5)
    for i, (g, w) in enumerate(zip(got, want)):
        assert_close(nhwc(g), np.asarray(w), FWD_REL, f"level {i}")


def test_pytorch_style_bottleneck_matches_jax():
    """``style="pytorch"`` puts a block's stride on its 3x3 conv (caffe
    style on the first 1x1), with groups as ResNeXt has them."""
    x = np.random.RandomState(6).randn(2, 16, 20, 64).astype(np.float32)
    jmod = JBottleneck(32, stride=2, downsample=True, style="pytorch",
                       groups=4, base_width=8)
    variables, sd = _module_weights(jmod, x, "backbone/layer2_0",
                                    "backbone.layer2.0.", 6)
    port = Bottleneck(64, 32, 2, True, groups=4, base_width=8,
                      style="pytorch")
    port.load_state_dict(sd)
    assert port.conv1.stride == (1, 1) and port.conv2.stride == (2, 2)
    with torch.no_grad():
        got = port(_nchw(x))
    assert_close(nhwc(got), np.asarray(jmod.apply(variables, x)), FWD_REL)


def _check_hrnet(c, p, want_c, want_p, hw):
    h, w = hw[0] // 4, hw[1] // 4
    assert [tuple(t.shape[2:]) for t in c] == [
        (h >> i, w >> i) for i in range(4)]
    # floor sizes, the window clamped to the map
    assert [tuple(t.shape[2:]) for t in p] == [
        (h // min(2 ** i, h), w // min(2 ** i, w)) for i in range(1, 6)]
    for i, (g, v) in enumerate(zip(c, want_c)):
        assert_close(nhwc(g), v, FWD_REL, f"branch {i}")
    for i, (g, v) in enumerate(zip(p, want_p)):
        assert_close(nhwc(g), v, FWD_REL, f"level {i}")


def test_shrunk_detector_backbone_and_neck_match_jax(detector):
    """X101-32x4d's C2..C5 and FPN levels, or HRNet's branches and HRFPN's
    levels, at FWD_REL of each tensor's max."""
    c, p, _ = detector["got"]
    want_c, want_p = detector["want"][:2]
    if detector["name"] == "hrnet":
        _check_hrnet(c, p, want_c, want_p, HW)
        return
    for i, (g, w) in enumerate(zip(c, want_c)):
        assert_close(nhwc(g), w, FWD_REL, f"C{i + 2}")
    for i, (g, w) in enumerate(zip(p, want_p)):
        assert_close(nhwc(g), w, FWD_REL, f"P{i + 3}")


def test_hrnet_and_hrfpn_match_jax_where_the_pools_floor():
    cfg = hrnet_cfg()
    sd, variables = _weights(cfg)
    x = images(2, *FLOOR_HW)
    want_c, want_p = _jax_forward(cfg, variables, x)
    model = build_model(cfg.model)
    model.load_state_dict(sd)
    with torch.no_grad():
        c = model.backbone(_nchw(x))
        p = model.neck(c)
    _check_hrnet(c, p, want_c, want_p, FLOOR_HW)


def _check_decoded(got, want):
    v = want["valid"]
    assert v.sum() > 0, "the bias bumps must give detections"
    np.testing.assert_array_equal(got["valid"].numpy(), v)
    np.testing.assert_array_equal(got["labels"].numpy()[v], want["labels"][v])
    np.testing.assert_allclose(got["scores"].numpy(), want["scores"],
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(got["boxes"].numpy(), want["boxes"], rtol=0,
                               atol=1e-3)
    np.testing.assert_allclose(got["masks"].numpy(), want["masks"], rtol=0,
                               atol=1e-4)


def test_shrunk_detector_head_and_decode_match_jax(detector):
    """Every head level at HEAD_REL of its max, then the decode. A level of
    one pixel (HRFPN's last at 128x160) puts one pixel in each GroupNorm
    group, whose output is then rounding noise around the GN bias: such a
    level is held at HEAD_REL of the output's largest level."""
    _, _, out = detector["got"]
    _, _, j_out, j_dec = detector["want"]
    for key in ("cls_scores", "bbox_preds", "centernesses", "cof_preds"):
        assert len(out[key]) == len(j_out[key]) == 5
        top = max(float(np.abs(w).max()) for w in j_out[key])
        for i, (g, w) in enumerate(zip(out[key], j_out[key])):
            if g.shape[2] * g.shape[3] == 1:
                np.testing.assert_allclose(nhwc(g), w, rtol=0,
                                           atol=HEAD_REL * top,
                                           err_msg=f"{key} {i}")
            else:
                assert_close(nhwc(g), w, HEAD_REL, f"{key} {i}")
    assert_close(nhwc(out["feat_masks"]), j_out["feat_masks"], HEAD_REL,
                 "feat_masks")
    got = decode_batch(out, torch.from_numpy(IMG_SHAPES),
                       torch.from_numpy(SCALES), detector["cfg"].model)
    _check_decoded(got, j_dec)


# ------------------------------------------- HRNet training against JAX

def test_hrnet_losses_gradients_and_two_sgd_steps_match_jax():
    """One JAX compile of its train step gives the first step's losses and,
    from the first update (no momentum yet: delta = -lr*mult*(g + wd*p)),
    its gradients; then the two-step trajectory. Stage 1 stays where it
    was in both packages, the stem moves."""
    cfg = hrnet_cfg()
    sd, variables = _weights(cfg)
    batch = demo_batch(batch_size=2, height=HW[0], width=HW[1], max_gts=8,
                       seed=7)
    spe = 10
    jm = j_build_model(cfg.model)
    tx = j_make_optimizer(cfg.train.optim, spe, variables["params"],
                          frozen_stages=cfg.model.backbone.frozen_stages)
    state = JTrainState(step=jnp.zeros((), jnp.int32),
                        params=variables["params"],
                        constants=variables["constants"],
                        opt_state=tx.init(variables["params"]))
    jstep = j_make_train_step(jm, tx, cfg, donate=False)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jstates, jmetrics = [], []
    for _ in range(2):
        state, m = jstep(state, jb)
        jstates.append(params_from_jax(state.params, {}))
        jmetrics.append({k: float(v) for k, v in m.items()})

    port = create_train_state(cfg, "cpu", state_dict=sd,
                              steps_per_epoch=spe)
    model = port.model
    tb = batch_to_tensors(batch)
    losses = compute_losses(model(tb["images"]), tb, cfg.model.head,
                            max_pos=MAX_POS)
    sum(losses.values()).backward()
    assert float(losses["loss_mask"].detach()) > 0
    for k, v in losses.items():
        np.testing.assert_allclose(float(v.detach()), jmetrics[0][k],
                                   rtol=LOSS_RTOL,
                                   atol=1e-6, err_msg=k)
    o = cfg.train.optim
    lr = o.lr * o.warmup_ratio     # step 0 of the constant warmup
    trainable = {n: p for n, p in model.named_parameters() if p.requires_grad}
    for n, p in trainable.items():
        bias = n.endswith(".bias")
        mult = o.bias_lr_mult if bias else 1.0
        wd = o.weight_decay * (o.bias_decay_mult if bias else 1.0)
        p0 = sd[n].numpy().astype(np.float64)
        want = -(jstates[0][n].numpy() - p0) / (lr * mult) - wd * p0
        got = p.grad.numpy()
        rel = BACKBONE_GRAD_REL if n.startswith("backbone.") else GRAD_REL
        # the update is rounded to the f32 grid of the weights
        ulp = 4 * float(np.spacing(np.abs(sd[n].numpy()).max())) / (lr * mult)
        err = float(np.abs(got - want).max())
        assert err <= rel * float(np.abs(want).max()) + ulp + GRAD_ATOL, \
            (n, err)
    assert np.abs(trainable["backbone.conv1.weight"].grad.numpy()).max() > 0
    model.zero_grad(set_to_none=True)

    step = make_train_step(port, cfg)
    metrics = [{k: float(v) for k, v in step(tb).items()} for _ in range(2)]
    for i, (got, want) in enumerate(zip(metrics, jmetrics)):
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=LOSS_RTOL,
                                       atol=1e-6, err_msg=f"step {i} {k}")
    for n, p in model.named_parameters():
        delta = p.detach().numpy() - sd[n].numpy()
        want = jstates[1][n].numpy() - sd[n].numpy()
        if n.startswith("backbone.layer1."):
            assert not delta.any() and not want.any(), n
            continue
        rel = 3 * (BACKBONE_GRAD_REL if n.startswith("backbone.")
                   else GRAD_REL)
        ulp = 4 * float(np.spacing(np.abs(sd[n].numpy()).max()))
        err = float(np.abs(delta - want).max())
        assert err <= rel * float(np.abs(want).max()) + ulp + GRAD_ATOL, \
            (n, err)


# ------------------------------------------- the benchmark fork's loss

def test_giou_loss_ltrb_matches_jax():
    rng = np.random.RandomState(3)
    pred = (rng.rand(6, 40, 4) * 8).astype(np.float32)
    target = (rng.rand(6, 40, 4) * 8 + 0.5).astype(np.float32)
    pred[0, :5] = 0.0                      # relu'd to nothing
    weight = rng.rand(6, 40).astype(np.float32)
    want = j_giou_loss_ltrb(jnp.asarray(pred), jnp.asarray(target),
                            weight=jnp.asarray(weight), avg_factor=7.0)
    got = giou_loss_ltrb(torch.from_numpy(pred), torch.from_numpy(target),
                         weight=torch.from_numpy(weight), avg_factor=7.0)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def test_hard_nms_matches_jax_with_ties_and_empty_slots():
    """Batched rows against the JAX package's ``hard_nms`` row by row:
    scores with ties (to the lower index first), candidates marked invalid
    (NEG), duplicated and degenerate boxes, and ``max_out`` below and above
    the number kept (empty slots: -1, NEG, False)."""
    rng = np.random.RandomState(0)
    jfn = jax.jit(j_hard_nms, static_argnums=(2, 3))
    for thr, max_out in ((0.9, 6), (0.5, 40), (0.1, 3)):
        n = 32
        xy = rng.rand(4, n, 2) * 20
        wh = rng.rand(4, n, 2) * 10
        wh[0, :4] = -1.5                   # degenerate: zero +1-IoU
        boxes = np.concatenate([xy, xy + wh], -1).astype(np.float32)
        boxes[1, 8:16] = boxes[1, 0]       # duplicates
        scores = (rng.randint(0, 5, (4, n)) / 4).astype(np.float32)
        scores[rng.rand(4, n) < 0.2] = NEG
        scores[3] = NEG                     # nothing to keep
        got = hard_nms(torch.from_numpy(boxes), torch.from_numpy(scores),
                       thr, max_out)
        for i in range(4):
            want = jfn(jnp.asarray(boxes[i]), jnp.asarray(scores[i]), thr,
                       max_out)
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g[i].numpy(), np.asarray(w),
                                              err_msg=f"{thr} row {i}")
        assert not got[2][3].any()


def _fork_outputs(shift, cof_scale, seed=11):
    """Synthetic head outputs (NHWC numpy) and a batch at 64x96 with 8
    classes, as test_torch_train.py's; ``shift`` px added to every
    regression (wide boxes that overlap their neighbours' by > 0.9),
    ``cof_scale`` on the coefficients (large: a mask loss above 1)."""
    head = _r(get_config("sipmask_benchmark_r50_fpn_1x"), "model.head",
              num_classes=8).model.head
    rng = np.random.RandomState(seed)
    b, hw = 2, (64, 96)
    sizes = [(hw[0] // s, hw[1] // s) for s in head.strides]
    out = dict(
        cls_scores=[rng.randn(b, h, w, 8).astype(np.float32)
                    for h, w in sizes],
        bbox_preds=[(rng.rand(b, h, w, 4) * 24 + 8 + shift).astype(
            np.float32) for h, w in sizes],
        centernesses=[rng.randn(b, h, w, 1).astype(np.float32)
                      for h, w in sizes],
        cof_preds=[rng.randn(b, h, w, 128).astype(np.float32) * cof_scale
                   for h, w in sizes],
        feat_masks=rng.randn(b, hw[0] // 2, hw[1] // 2, 32).astype(
            np.float32),
    )
    batch = demo_batch(batch_size=b, height=hw[0], width=hw[1], max_gts=8,
                       seed=13, num_classes=8)
    return head, out, batch


@pytest.mark.parametrize("case", ["dedup", "cap", "giou"])
def test_benchmark_fork_losses_and_gradients_match_jax(case, monkeypatch):
    """``compute_losses`` with ``benchmark_loss_extras`` where the NMS-0.9
    dedup drops selected positives (wide boxes), where the x0.5 cap fires
    (a mask loss above 2 before it), and ``iou_loss_mode="giou"`` without
    the extras: every loss at LOSS_RTOL, and the gradients of their sum
    with respect to the head outputs at GRAD_REL of each tensor's max."""
    import sipmask_tpu_torch.models.loss as loss_mod
    head, out, batch = _fork_outputs(shift=150.0 if case == "dedup" else 0.0,
                                     cof_scale=3.0 if case == "cap" else 0.1)
    if case == "giou":
        head = _r(get_config("sipmask_r50_fpn_gn_1x"), "model.head",
                  num_classes=8, iou_loss_mode="giou").model.head
    counts = []

    def recorded(boxes, scores, thr, max_out):
        kept = hard_nms(boxes, scores, thr, max_out)
        counts.append((int((scores > NEG / 2).sum()), int(kept[2].sum())))
        return kept
    monkeypatch.setattr(loss_mod, "hard_nms", recorded)

    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}

    def jloss(o):
        losses = j_compute_losses(o, jbatch, head, max_pos=MAX_POS)
        return sum(losses.values()), losses
    (_, want), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        jax.tree_util.tree_map(jnp.asarray, out))
    leaves = {k: ([_nchw(a).requires_grad_(True) for a in v]
                  if isinstance(v, list) else _nchw(v).requires_grad_(True))
              for k, v in out.items()}
    got = compute_losses(leaves, batch_to_tensors(batch), head,
                         max_pos=MAX_POS)
    sum(got.values()).backward()
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(float(got[k].detach()), float(want[k]),
                                   rtol=LOSS_RTOL, atol=1e-6, err_msg=k)
    if case == "giou":
        assert not counts
    else:
        (sel, kept), = counts
        assert 0 < kept <= sel
        if case == "dedup":
            assert kept < sel, "the dedup must drop positives here"
        else:
            assert float(got["loss_mask"].detach()) > 1.0, \
                "the cap must have fired (the loss before it above 2)"
    for k, v in leaves.items():
        for i, t in enumerate(v if isinstance(v, list) else [v]):
            w = np.asarray(jgrads[k][i] if isinstance(v, list)
                           else jgrads[k]).transpose(0, 3, 1, 2)
            if w.size == 0:      # the 64x96 image has no stride-128 level
                continue
            err = float(np.abs(t.grad.numpy() - w).max())
            assert err <= GRAD_REL * float(np.abs(w).max()) + 1e-9, (k, i)


def test_benchmark_fork_trains_through_the_step_on_the_cpu():
    """The shrunk ``sipmask_benchmark_r50_fpn_1x`` through
    ``make_train_step``: the JAX package's first-step losses."""
    cfg = _shrink(get_config("sipmask_benchmark_r50_fpn_1x"))
    sd, variables = _weights(cfg)
    batch = demo_batch(batch_size=2, height=HW[0], width=HW[1], max_gts=8,
                       seed=7)
    jm = j_build_model(cfg.model)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    want = jax.jit(lambda v, b: j_compute_losses(
        jm.apply(v, b["images"]), b, cfg.model.head, max_pos=MAX_POS))(
            variables, jb)
    port = create_train_state(cfg, "cpu", state_dict=sd, steps_per_epoch=10)
    got = make_train_step(port, cfg)(batch_to_tensors(batch))
    assert got["loss_mask"] > 0
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]),
                                   rtol=LOSS_RTOL, atol=1e-6, err_msg=k)


# ---------------------------------------------------------- bfloat16

def strict(fn, *args):
    """``fn(*args)`` compiled by XLA with no excess precision."""
    return jax.jit(fn).lower(*args).compile(STRICT)(*args)


def _f32(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def norm_ratio(got, want16, want32):
    """||got - want16|| / ||want16 - want32||."""
    got, w16, w32 = (np.asarray(a, np.float64) for a in (got, want16, want32))
    assert got.shape == w16.shape == w32.shape, (got.shape, w16.shape)
    drift = np.linalg.norm(w16 - w32)
    err = np.linalg.norm(got - w16)
    return err / drift if drift > 0 else (0.0 if err == 0 else np.inf)


def _random_constants(tree, rng):
    """Frozen-BN constants drawn away from identity, so that folding or
    not folding them matters."""
    flat = traverse_util.flatten_dict(tree)
    draw = {"gamma": lambda s: rng.uniform(0.5, 1.5, s),
            "beta": lambda s: rng.randn(*s) * 0.1,
            "mean": lambda s: rng.randn(*s) * 0.1,
            "var": lambda s: rng.uniform(0.5, 1.5, s)}
    return traverse_util.unflatten_dict(
        {k: jnp.asarray(draw[k[-1]](v.shape), jnp.float32)
         for k, v in flat.items()})


def _nest(prefix, tree):
    for p in reversed(prefix.split("/")):
        tree = {p: tree}
    return tree


def _port_weights(prefix, port_prefix, params, constants):
    """A JAX module's trees, placed at ``prefix`` in the detector's trees,
    as the port module's state_dict: the bridge's names less
    ``port_prefix``."""
    sd = params_from_jax(_nest(prefix, params), _nest(prefix, constants))
    assert all(k.startswith(port_prefix) for k in sd)
    return {k[len(port_prefix):]: v for k, v in sd.items()}


def _bf16_module_case(jmod16, jmod32, port, prefix, port_prefix, xs,
                      seed):
    """The JAX module in bf16 (strict) and f32 and the port's in bf16 on the
    same bf16 inputs ``xs`` (a list of NHWC arrays: a list input where it
    has more than one) and one bf16 cotangent: outputs within one drift,
    input and parameter gradients within sqrt(2) drifts (test_torch_bf16.py's
    GRAD_BOUND)."""
    rng = np.random.RandomState(seed)
    multi = len(xs) > 1
    x16 = [jnp.asarray(x).astype(jnp.bfloat16) for x in xs]
    x32 = [x.astype(jnp.float32) for x in x16]
    variables = jmod32.init(jax.random.PRNGKey(seed),
                            x32 if multi else x32[0])
    params = variables["params"]
    consts = _random_constants(variables.get("constants", {}), rng)
    port.load_state_dict(_port_weights(prefix, port_prefix, params, consts))

    def run(mod):
        def fwd(p, xs):
            y = mod.apply({"params": p, "constants": consts},
                          xs if multi else xs[0])
            return list(y) if isinstance(y, (list, tuple)) else [y]

        def f(p, xs, cts):
            y, vjp = jax.vjp(fwd, p, xs)
            return y, vjp(cts)
        return fwd, f
    shapes = jax.eval_shape(run(jmod16)[0], params, x16)
    cts = [jnp.asarray(rng.randn(*y.shape), jnp.bfloat16) for y in shapes]
    y16, (gp16, gx16) = strict(run(jmod16)[1], params, x16, cts)
    y32, (gp32, gx32) = jax.jit(run(jmod32)[1])(
        params, x32, [c.astype(jnp.float32) for c in cts])

    tx = [torch.from_numpy(_f32(x).transpose(0, 3, 1, 2).copy()).to(BF)
          .requires_grad_(True) for x in x16]
    ty = port(tx if multi else tx[0])
    ty = list(ty) if isinstance(ty, (list, tuple)) else [ty]
    assert all(t.dtype == BF for t in ty)
    torch.autograd.backward(ty, [torch.from_numpy(
        _f32(c).transpose(0, 3, 1, 2).copy()).to(BF) for c in cts])
    ratios = {}
    for i, (g, w16, w32) in enumerate(zip(ty, y16, y32)):
        ratios[f"out {i}"] = norm_ratio(nhwc(g.detach().float()), _f32(w16),
                                        _f32(w32))
    for i, (t, w16, w32) in enumerate(zip(tx, gx16, gx32)):
        ratios[f"d input {i}"] = norm_ratio(
            nhwc(t.grad.float()), _f32(w16), _f32(w32)) / 2 ** 0.5
    g16 = _port_weights(prefix, port_prefix, gp16, {})
    g32 = _port_weights(prefix, port_prefix, gp32, {})
    named = dict(port.named_parameters())
    assert set(g16) == set(named)
    for n in g16:
        ratios[n] = norm_ratio(named[n].grad.numpy(), _f32(g16[n]),
                               _f32(g32[n])) / 2 ** 0.5
    worst = max(ratios, key=ratios.get)
    print(f"{prefix}: worst {worst} {ratios[worst]:.3f} of its bound")
    assert ratios[worst] <= 1.0, (worst, ratios[worst], ratios)


def test_resnext_block_in_bf16_within_jax_drift():
    """A ResNeXt-101 32x4d Bottleneck of stage 2 (stride 2, downsample,
    grouped conv2, every BN folded) in bf16."""
    rng = np.random.RandomState(1)
    x = rng.randn(2, 16, 20, 256).astype(np.float32)
    kw = dict(planes=128, stride=2, downsample=True, groups=32, base_width=4)
    port = Bottleneck(256, 128, 2, True, groups=32, base_width=4, dtype=BF)
    _bf16_module_case(JBottleneck(dtype=jnp.bfloat16, **kw),
                      JBottleneck(dtype=jnp.float32, **kw), port,
                      "backbone/layer2_0", "backbone.layer2.0.", [x], 1)


def test_hrnet_modules_in_bf16_within_jax_drift():
    """HRNet-W18's BasicBlock and a three-branch HRModule (unfolded BN, the
    fuse unit's nearest repetition and stride-2 chains) in bf16."""
    rng = np.random.RandomState(2)
    x = rng.randn(2, 16, 20, 18).astype(np.float32)
    _bf16_module_case(JBasicBlock(18, dtype=jnp.bfloat16),
                      JBasicBlock(18, dtype=jnp.float32),
                      BasicBlock(18, BF), "backbone/stage2_m0/branch0_block0",
                      "backbone.stage2.0.branches.0.0.", [x], 2)
    ws = (18, 36, 72)
    xs = [rng.randn(2, 16 >> i, 20 >> i, w).astype(np.float32)
          for i, w in enumerate(ws)]
    _bf16_module_case(JHRModule(ws, num_blocks=1, dtype=jnp.bfloat16),
                      JHRModule(ws, num_blocks=1, dtype=jnp.float32),
                      HRModule(ws, 1, BF), "backbone/stage3_m0",
                      "backbone.stage3.0.", xs, 3)


def test_hrfpn_in_bf16_within_jax_drift(monkeypatch):
    """HRFPN in bf16. Two rounding points differ by design. The bilinear
    resize: XLA rounds JAX's einsum after the width and again after the
    height, the port's F.interpolate rounds once (rounding after each axis
    too held this module at 0.77 drifts, and moved SipMask++'s basis-branch
    gradients in tests/test_torch_bf16_pp_vis.py to 1.70). The average
    pools: XLA on the CPU sums a bf16 window one element at a time in bf16
    (with or without excess precision), which at the last level's 32x32
    window moves a mean by up to a quarter of its size, where the port sums
    in f32 and rounds once (as F.avg_pool2d does in bf16). JAX's pool is
    given that f32 sum here, so that the comparison sees the rest of the
    module's rounding (unpatched, the last level reads 1.007 drifts)."""
    import flax.linen

    real = flax.linen.avg_pool
    monkeypatch.setattr(flax.linen, "avg_pool", lambda x, w, s: real(
        x.astype(jnp.float32), w, s).astype(x.dtype))
    rng = np.random.RandomState(4)
    ws = (18, 36, 72, 144)
    xs = [rng.randn(2, 24 >> i, 56 >> i, w).astype(np.float32)
          for i, w in enumerate(ws)]
    _bf16_module_case(JHRFPN(out_channels=32, dtype=jnp.bfloat16),
                      JHRFPN(out_channels=32, dtype=jnp.float32),
                      HRFPN(ws, 32, 5, BF), "neck", "neck.", xs, 4)


# ---------------------------------------------------------------- CLIs

def test_train_and_test_clis_run_the_hrnet_preset(tmp_path):
    """tools/train.py for 2 steps and tools/test.py on its checkpoint with
    the shrunk ``sipmask_hrnet_w32_fpn_gn_1x`` (HRNet-W18): finite losses,
    an HRNet checkpoint, bbox and segm stats."""
    from sipmask_tpu_torch.tools import test as test_cli
    from sipmask_tpu_torch.tools import train as train_cli
    from sipmask_tpu_torch.tools.synth_coco import make_dataset
    from sipmask_tpu_torch.utils.checkpoint import latest_checkpoint
    ann, imgs = make_dataset(str(tmp_path / "synth"),
                             sizes=((160, 120), (150, 100)), repeat=1,
                             min_objs=3, max_objs=5, seed=3)
    shrink = ["model.backbone.hrnet_width=18", "model.fpn.out_channels=32",
              "model.head.in_channels=32", "model.head.feat_channels=32",
              "model.head.stacked_convs=2", "data.img_scale=(160,128)",
              "data.max_gts=8", "data.num_workers=1",
              "train.imgs_per_device=2", "train.max_pos=16",
              "train.log_interval=1"]
    wd = str(tmp_path / "wd")
    state = train_cli.main(["sipmask_hrnet_w32_fpn_gn_1x", "--ann", ann,
                            "--img-prefix", imgs, "--work-dir", wd,
                            "--max-steps", "2", "--device", "cpu",
                            "--cfg-options", *shrink])
    assert state.step == 2
    with open(f"{wd}/train.log.json") as f:
        rows = [r for r in map(json.loads, f) if "loss_total" in r]
    assert rows and all(np.isfinite(r["loss_total"]) for r in rows)
    sd = torch.load(latest_checkpoint(wd), map_location="cpu")
    sd = sd.get("state_dict", sd)
    assert any(k.startswith("backbone.stage4.") for k in sd)
    stats = test_cli.main(["sipmask_hrnet_w32_fpn_gn_1x",
                           latest_checkpoint(wd), "--ann", ann,
                           "--img-prefix", imgs, "--batch-size", "2",
                           "--device", "cpu", "--cfg-options", *shrink])
    assert set(stats) == {"bbox", "segm"}
