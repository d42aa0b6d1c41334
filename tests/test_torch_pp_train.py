"""SipMask++ training in the PyTorch port (sipmask_tpu_torch) against the
JAX package, f32 on the CPU: the losses with the rescoring MSE
(``loss_iou``), the whole model's gradients tensor by tensor (the DCN
offset convs and the rescoring head included) and a 2-step SGD trajectory
against ``make_train_step``; and the cause of the backbone's f32 gradient
spread, against the port's own f64. R50 with SipMask++'s DCN stages (2-4)
keeps the JAX compile short; ``tests/test_torch_pp.py`` runs the R101
forward.

The random backbone's ReLU kinks make its f32 gradients jump (see
``_torch_parity``'s note on pinned ReLU masks), so the comparisons with
JAX pin every trainable-stage ReLU of the backbone, in both packages, to
the sign masks of one f64 forward of the port."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (PP_HW, backbone_relu_masks, pin_jax_relus,
                           pin_port_relus, pp_cfg, pp_state_dict,
                           pp_variables)
from sipmask_tpu.config import _r
from sipmask_tpu.models import build_model as j_build_model
from sipmask_tpu.models.loss import compute_losses as j_compute_losses
from sipmask_tpu.train import make_optimizer as j_make_optimizer
from sipmask_tpu.train import make_train_step as j_make_train_step
from sipmask_tpu.train.state import TrainState as JTrainState
from sipmask_tpu_torch.models.detector import build_model
from sipmask_tpu_torch.models.loss import compute_losses
from sipmask_tpu_torch.train import create_train_state, make_train_step
from sipmask_tpu_torch.utils.convert import grads_from_jax, params_from_jax
from sipmask_tpu_torch.utils.demo_inputs import batch_to_tensors, demo_batch

MAX_POS = 16
# Gradients and updates, relative to each tensor's max |value|, with the
# backbone's ReLUs pinned: f32 sums in another order. Measured: backbone
# gradients 8.4e-4, the head's 2.4e-3 (sip_mask_lat0's bias, whose own
# ReLUs are not pinned); 2-step updates 2.6e-3 beyond the 4 ulps below.
GRAD_REL = 5e-3
# The one exception: a DCN block's conv_offset update at step 2. Its
# gradient is the one-sided floor derivative of the sampling positions,
# which jumps where a position crosses an integer; at the step-2 weights one
# layer3.0 position lies closer to an integer than the two packages' f32
# offsets agree (to 2.3e-5 px), its floor differs between them, and that
# block's offset update differs by 5.7e-2 of its max. A zero or
# sign-flipped update is still 1 or 2 off.
OFFSET_UPDATE_REL = 0.15
LOSS_RTOL = 1e-4   # the same losses, summed in another order
DCN_BLOCKS = ("layer2.0", "layer2.3", "layer3.0", "layer3.3", "layer4.0")


@pytest.fixture(scope="module")
def weights():
    """SipMask++ (R50 + DCN stages 2-4, FPN and head 32 wide) with bumped
    (for training) and calibrated weights, its JAX trees, a batch at
    256x256 and the backbone's f64 ReLU masks on it."""
    cfg = _r(pp_cfg(50), "train", max_pos=MAX_POS)
    batch = demo_batch(batch_size=2, height=PP_HW[0], width=PP_HW[1],
                       max_gts=8, seed=7)
    images = batch_to_tensors(batch)["images"]
    model = build_model(cfg.model)
    sd = pp_state_dict(model, images, training=True)
    masks = backbone_relu_masks(model.backbone, images)
    return cfg, sd, pp_variables(sd, 50), batch, masks


def _assert_tensors_close(got, want, names, what, rel=None, atol=None):
    for n in names:
        g, w = got[n], np.asarray(want[n])
        assert g.shape == w.shape, (n, g.shape, w.shape)
        bound = (rel or {}).get(n, GRAD_REL) * float(np.abs(w).max()) + (
            atol[n] if atol else 0.0)
        err = float(np.abs(g - w).max())
        assert err <= bound, f"{what} of {n}: {err:.3e} > {bound:.3e}"


def test_sipmaskpp_losses_and_gradients_match_jax(weights):
    cfg, sd, variables, batch, masks = weights
    jm = j_build_model(cfg.model)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    def loss_fn(params):
        v = {"params": params, "constants": variables["constants"]}
        out = jm.apply(v, jb["images"])
        losses = j_compute_losses(
            out, jb, cfg.model.head, max_pos=MAX_POS,
            rescore_fn=lambda m: jm.apply(v, m, method=jm.rescore))
        return sum(losses.values()), losses

    with pin_jax_relus(masks) as jcalls:
        (_, jlosses), jgrads = jax.jit(jax.value_and_grad(
            loss_fn, has_aux=True))(variables["params"])
    assert jcalls[0] == len(masks)          # one trace, every ReLU pinned

    model = build_model(cfg.model)
    model.load_state_dict(sd)
    tb = batch_to_tensors(batch)
    with pin_port_relus(model.backbone, masks) as calls:
        losses = compute_losses(model(tb["images"]), tb, cfg.model.head,
                                max_pos=MAX_POS, rescore_fn=model.rescore)
    assert calls[0] == len(masks)
    sum(losses.values()).backward()
    assert set(losses) == set(jlosses) and "loss_iou" in losses
    assert float(losses["loss_mask"].detach()) > 0
    assert float(losses["loss_iou"].detach()) > 0
    for k, v in losses.items():
        np.testing.assert_allclose(float(v.detach()), float(jlosses[k]),
                                   rtol=LOSS_RTOL, atol=1e-6, err_msg=k)

    want = grads_from_jax(jgrads)
    params = dict(model.named_parameters())
    assert set(want) == set(params)
    trainable = [n for n, p in params.items() if p.requires_grad]
    for n, p in params.items():
        if not p.requires_grad:   # frozen stem and stage 1: JAX's are 0
            assert p.grad is None
            assert not want[n].any(), n
    got = {n: params[n].grad.numpy() for n in trainable}
    _assert_tensors_close(got, want, trainable, "gradient")
    # every DCN block's offsets train (the one-sided rule), and so does the
    # rescoring head
    for blk in DCN_BLOCKS:
        assert np.abs(got[f"backbone.{blk}.conv2.conv_offset.weight"]
                      ).max() > 0, blk
    assert np.abs(got["bbox_head.mask_scoring.weight"]).max() > 0


def test_sipmaskpp_two_sgd_steps_match_jax(weights):
    """Both steps run with the masks pinned at the initial weights: the two
    packages take two SGD steps on the same piecewise-linear backbone."""
    cfg, sd, variables, batch, masks = weights
    steps_per_epoch = 10
    jm = j_build_model(cfg.model)
    tx = j_make_optimizer(cfg.train.optim, steps_per_epoch,
                          variables["params"],
                          frozen_stages=cfg.model.backbone.frozen_stages)
    state = JTrainState(step=jnp.zeros((), jnp.int32),
                        params=variables["params"],
                        constants=variables["constants"],
                        opt_state=tx.init(variables["params"]))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jmetrics = []
    with pin_jax_relus(masks) as jcalls:
        jstep = j_make_train_step(jm, tx, cfg, donate=False)
        for _ in range(2):
            state, m = jstep(state, jb)
            jmetrics.append({k: float(v) for k, v in m.items()})
    assert jcalls[0] == len(masks)          # traced once, pinned

    port = create_train_state(cfg, "cpu", state_dict=sd,
                              steps_per_epoch=steps_per_epoch)
    step = make_train_step(port, cfg)
    tb = batch_to_tensors(batch)
    with pin_port_relus(port.model.backbone, masks) as calls:
        metrics = [{k: float(v) for k, v in step(tb).items()}
                   for _ in range(2)]
    assert calls[0] == 2 * len(masks)
    for i, (got, want) in enumerate(zip(metrics, jmetrics)):
        assert set(got) == set(want) and "loss_iou" in got
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=LOSS_RTOL,
                                       atol=1e-6, err_msg=f"step {i} {k}")
    p0 = params_from_jax(variables["params"], {})
    want = {n: v.numpy() - p0[n].numpy()
            for n, v in params_from_jax(state.params, {}).items()}
    got = {n: p.detach().numpy() - sd[n].numpy()
           for n, p in port.model.named_parameters()}
    moved = [n for n, p in port.model.named_parameters() if p.requires_grad]
    for n in set(got) - set(moved):   # frozen: neither package moves them
        assert not got[n].any() and not want[n].any(), n
    # each update is rounded to the f32 grid of the weights it is added to,
    # so updates may also differ by a few units in their last place
    ulps = {n: 4 * float(np.spacing(np.abs(sd[n].numpy()).max()))
            for n in moved}
    offsets = {n: OFFSET_UPDATE_REL for n in moved
               if n.startswith("backbone.") and ".conv_offset." in n}
    assert len(offsets) == 2 * len(DCN_BLOCKS)
    _assert_tensors_close(got, want, moved, "2-step update", rel=offsets,
                          atol=ulps)
    for blk in DCN_BLOCKS:
        assert np.abs(got[f"backbone.{blk}.conv2.conv_offset.weight"]
                      ).max() > 0, blk


def _backbone_grads(cfg, sd, images, cots, dtype, masks=None):
    """The port backbone's parameter gradients in ``dtype`` under the fixed
    cotangents ``cots`` at C2..C5, its ReLUs pinned to ``masks`` if given."""
    model = build_model(cfg.model)
    model.load_state_dict(sd)
    net = model.backbone.to(dtype)
    if masks is None:
        outs = net(images.to(dtype))
    else:
        with pin_port_relus(net, masks):
            outs = net(images.to(dtype))
    pairs = [(o, c.to(dtype)) for o, c in zip(outs, cots) if o.requires_grad]
    torch.autograd.backward([o for o, _ in pairs], [c for _, c in pairs])
    return {n: p.grad.double() for n, p in net.named_parameters()
            if p.requires_grad}


def test_sipmaskpp_backbone_f32_gradients_differ_from_f64_by_relu_kinks(
        weights):
    """Why the comparisons above pin the ReLUs: under the loss's own
    cotangent at C2..C5, the port's f32 backbone gradients lie up to 13%
    of a tensor's max from its f64 ones (measured), and f32 puts some
    pre-activations (57 measured) on the other side of 0 than f64. With the
    f32 ReLUs pinned to the f64 masks (and nothing else changed) the f32
    gradients agree with f64 to 1e-3 (1.2e-4 measured): the spread is the
    ReLU kinks, not the sampled route, which runs in both."""
    cfg, sd, _, batch, masks = weights
    images = batch_to_tensors(batch)["images"]
    model = build_model(cfg.model)
    model.load_state_dict(sd)
    feats = tuple(f.detach().requires_grad_(True)
                  for f in model.backbone(images))
    losses = compute_losses(model.bbox_head(model.neck(feats)),
                            batch_to_tensors(batch), cfg.model.head,
                            max_pos=MAX_POS, rescore_fn=model.rescore)
    cots = [torch.zeros_like(f) if g is None else g
            for f, g in zip(feats, torch.autograd.grad(
                sum(losses.values()), feats, allow_unused=True))]

    g64 = _backbone_grads(cfg, sd, images, cots, torch.float64)
    g32 = _backbone_grads(cfg, sd, images, cots, torch.float32)
    pinned = _backbone_grads(cfg, sd, images, cots, torch.float32, masks)
    assert any(".conv_offset." in n for n in g64)

    def gap(got):
        return max(float((got[n] - g64[n]).abs().max() /
                         g64[n].abs().max()) for n in g64)
    masks32 = backbone_relu_masks(model.backbone, images, torch.float32)
    flips = sum(int((a != b).sum()) for a, b in zip(masks32, masks)
                if a is not None)
    free, held = gap(g32), gap(pinned)
    print(f"backbone gradients vs f64, max over tensors relative to the "
          f"tensor's max: f32 {free:.3e} with {flips} ReLU flips; f32 with "
          f"the f64 ReLU masks {held:.3e}")
    assert flips > 0
    assert held <= 1e-3, held
    assert free > 10 * held, (free, held)
