"""SipMask++ in the PyTorch port (sipmask_tpu_torch) against the JAX package,
f32 on the CPU: the plain versions of kernels K5 (p-major deformable
sampling), K5c (its backward) and K6 (SP mask assembly) against the JAX
package's Pallas kernels in interpret mode and its XLA references;
fast_nms; the sampled deform-conv route (DCNv1 and DCNv2) with gradients;
the DCN ResNet; the rescoring head and loss; and the whole SipMask++ model
with its fast-NMS decode and mask_scores at 256x256."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (PP_HW, assert_close, pp_cfg, pp_images,
                           pp_state_dict, pp_variables)
from sipmask_tpu.core.boxes import jaccard_nop1 as j_jaccard_nop1
from sipmask_tpu.models import build_model as j_build_model
from sipmask_tpu.models.decode import decode_batch as j_decode_batch
from sipmask_tpu.models.loss import _rescoring_loss as j_rescoring_loss
from sipmask_tpu.models.resnet import ResNet as JResNet
from sipmask_tpu.ops.deform_conv import deform_conv2d as j_deform_conv2d
from sipmask_tpu.ops.nms import fast_nms as j_fast_nms
from sipmask_tpu.ops.pallas.deform_gather import (_sample_pallas,
                                                  _sample_pallas_bwd,
                                                  _sample_pallas_sep,
                                                  sample_ref)
from sipmask_tpu.ops.pallas.mask_assembly import assemble_masks_pallas
from sipmask_tpu.utils.torch_convert import torch_to_flax
from sipmask_tpu_torch.core.boxes import jaccard_nop1
from sipmask_tpu_torch.models.decode import decode_batch
from sipmask_tpu_torch.models.detector import build_model
from sipmask_tpu_torch.models.loss import _rescoring_loss
from sipmask_tpu_torch.models.resnet import ResNet
from sipmask_tpu_torch.ops import deform_conv, deform_sample, mask_assembly
from sipmask_tpu_torch.ops.crop_split import assemble_masks
from sipmask_tpu_torch.ops.nms import fast_nms
from sipmask_tpu_torch.utils.convert import init_weights
from sipmask_tpu_torch.utils.demo_inputs import calibrate_frozen_bn

T = torch.from_numpy
# The plain versions repeat sample_ref's f32 arithmetic (the same products
# in the same order): equal to rounding. The Pallas kernels in interpret
# mode build the same sums as tent-weighted dot products over every
# in-band grid point, summed in another order.
SAMPLE_TOL = 1e-5
# d x sums up to 4*K corner contributions per row, d pyx sums Cg products;
# autodiff and the Pallas kernels add them in other orders
SAMPLE_GRAD_TOL = 1e-4


def _nchw(a):
    return T(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2)))


def _positions(rng, n, k, p, h, w, far=False, integer=False):
    """Sampling positions spanning the map, its borders and beyond; with
    ``far`` a third are +-300 px out, with ``integer`` a third are exact
    integers (the zero-offset case)."""
    pyx = rng.rand(n, k, p, 2).astype(np.float32) * np.float32(
        [h + 3, w + 3]) - 1.5
    if far:
        pyx[:, :, : p // 3] += rng.choice([-300.0, 300.0], (n, k, p // 3, 2))
    if integer:
        pyx[:, :, -(p // 3):] = np.round(pyx[:, :, -(p // 3):])
    return pyx.astype(np.float32)


# --------------------------------------------------------------- K5, K5c

@pytest.mark.parametrize("n,h,w,cg,k,p,far", [
    (2, 10, 12, 8, 9, 70, False),
    (1, 9, 7, 16, 4, 50, True),
    (3, 5, 17, 4, 9, 33, True),
])
def test_deform_rows_plain_matches_pallas_and_sample_ref(n, h, w, cg, k, p,
                                                         far):
    rng = np.random.RandomState(0)
    x = rng.randn(n, h * w, cg).astype(np.float32)
    pyx = _positions(rng, n, k, p, h, w, far=far, integer=True)
    got = deform_sample.deform_rows(T(x), T(pyx), h, w).numpy()
    assert got.shape == (n, p, k, cg)
    want = np.asarray(sample_ref(jnp.asarray(x), jnp.asarray(pyx), h, w))
    np.testing.assert_allclose(got, want, rtol=0, atol=SAMPLE_TOL)
    for kern in (_sample_pallas_sep, _sample_pallas):
        pal = np.asarray(kern(jnp.asarray(x), jnp.asarray(pyx), h, w,
                              interpret=True))
        np.testing.assert_allclose(got, pal, rtol=0, atol=SAMPLE_TOL,
                                   err_msg=kern.__name__)
    if far:   # a position 300 px out has all four corners outside: zero
        assert np.all(got[:, : p // 3] == 0.0)


@pytest.mark.parametrize("n,h,w,cg,k,p,far", [
    (2, 9, 11, 8, 2, 60, False),
    (1, 8, 8, 16, 9, 40, True),
])
def test_deform_rows_backward_plain_matches_pallas_and_autodiff(
        n, h, w, cg, k, p, far):
    rng = np.random.RandomState(5)
    x = rng.randn(n, h * w, cg).astype(np.float32)
    pyx = _positions(rng, n, k, p, h, w, far=far, integer=True)
    g = rng.randn(n, p, k, cg).astype(np.float32)
    dx, dp = (t.numpy() for t in deform_sample.deform_rows_backward(
        T(x), T(pyx), T(g), h, w))
    _, vjp = jax.vjp(lambda xr, pp: sample_ref(xr, pp, h, w),
                     jnp.asarray(x), jnp.asarray(pyx))
    want_dx, want_dp = (np.asarray(t) for t in vjp(jnp.asarray(g)))
    pal_dx, pal_dp = (np.asarray(t) for t in _sample_pallas_bwd(
        jnp.asarray(x), jnp.asarray(pyx), jnp.asarray(g), h, w,
        interpret=True))
    for want, pal, got, name in ((want_dx, pal_dx, dx, "dx"),
                                 (want_dp, pal_dp, dp, "dpyx")):
        np.testing.assert_allclose(got, want, rtol=0, atol=SAMPLE_GRAD_TOL,
                                   err_msg=name)
        np.testing.assert_allclose(got, pal, rtol=0, atol=SAMPLE_GRAD_TOL,
                                   err_msg=name)
    # integer positions keep one-sided, non-zero position gradients
    assert np.abs(dp[:, :, -(p // 3):]).max() > 0


# -------------------------------------------------------------------- K6

def _assembly_inputs(rng, b, h, w, nb, n):
    basis = rng.randn(b, h, w, nb).astype(np.float32)
    cofs = (rng.randn(b, n, 4 * nb) * 0.5).astype(np.float32)
    x1 = rng.uniform(-4, w, (b, n))
    y1 = rng.uniform(-4, h, (b, n))
    boxes = np.stack([x1, y1, x1 + rng.uniform(0, w / 2, (b, n)),
                      y1 + rng.uniform(0, h / 2, (b, n))], -1)
    boxes[:, 0] = [-1.0, -1.0, w + 1.0, h + 1.0]      # the whole image
    boxes[:, 1] = [3.0, 4.0, 3.0, 9.0]                # zero width
    boxes[:, 2] = [5.5, 2.25, 5.7, 2.3]               # under one pixel
    boxes[:, 3] = [w - 2.0, h - 2.0, w + 40.0, h + 40.0]   # past the edge
    return basis, cofs, boxes.astype(np.float32)


@pytest.mark.parametrize("b,h,w,nb,n", [(2, 24, 20, 32, 7), (1, 13, 30, 8, 5)])
def test_assemble_masks_plain_matches_pallas(b, h, w, nb, n):
    rng = np.random.RandomState(3)
    basis, cofs, boxes = _assembly_inputs(rng, b, h, w, nb, n)
    got = mask_assembly.assemble_masks(T(basis), T(cofs), T(boxes)).numpy()
    want = np.asarray(assemble_masks_pallas(
        jnp.asarray(basis), jnp.asarray(cofs), jnp.asarray(boxes), h, w,
        interpret=True))
    # sigmoid of an nb-term f32 dot, summed in another order
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    # the box crop is the same bits: zero exactly where the kernel's is
    np.testing.assert_array_equal(got == 0, want == 0)
    assert np.all(got[:, :, :, 1] == 0)                 # zero width
    assert np.all(got[:, :, :, 0] > 0)                  # the whole image
    # the unbatched entry point of crop_split is the same function
    one = assemble_masks(T(basis[0]), T(cofs[0]), T(boxes[0])).numpy()
    np.testing.assert_array_equal(one, got[0])


# ---------------------------------------------------------------- fast_nms

def test_fast_nms_matches_jax_with_ties():
    rng = np.random.RandomState(4)
    n, c = 60, 5
    xy = rng.uniform(0, 80, (n, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(2, 30, (n, 2))], 1)
    boxes[10:20] = boxes[0:10] + rng.uniform(-1, 1, (10, 4))  # overlaps
    boxes[25] = boxes[24]                                      # duplicate
    boxes = boxes.astype(np.float32)
    scores = rng.rand(c, n).astype(np.float32)
    scores[:, 30:40] = 0.5        # ties inside a class
    scores[1, 24] = scores[1, 25] = 0.9   # tied duplicates
    scores[2] = scores[3]         # ties across classes in the flat top-k
    cofs = rng.randn(n, 6).astype(np.float32)
    np.testing.assert_allclose(
        jaccard_nop1(T(boxes), T(boxes)).numpy(),
        np.asarray(j_jaccard_nop1(boxes, boxes)), rtol=1e-6, atol=1e-7)
    for top_k, max_out in ((200, 100), (20, 30), (200, 280)):
        got = fast_nms(T(boxes), T(scores), T(cofs), iou_thr=0.5,
                       top_k=top_k, score_thr=0.1, max_out=max_out)
        want = j_fast_nms(jnp.asarray(boxes), jnp.asarray(scores),
                          jnp.asarray(cofs), iou_thr=0.5, top_k=top_k,
                          score_thr=0.1, max_out=max_out)
        for key in ("valid", "labels", "idxs", "scores", "boxes", "cofs"):
            np.testing.assert_array_equal(got[key].numpy(),
                                          np.asarray(want[key]), err_msg=key)
        assert int(got["valid"].sum()) > 0
    # with room for all, some candidates were suppressed or under threshold
    assert int(got["valid"].sum()) < 280


# ------------------------------------------------- the sampled deform conv

@pytest.mark.parametrize("modulated", [False, True])
@pytest.mark.parametrize("b,c,o,g,h,w,stride", [
    (2, 8, 6, 1, 9, 11, 1),
    (1, 8, 4, 2, 10, 8, 2),
])
def test_deform_conv2d_rows_matches_jax_with_gradients(b, c, o, g, h, w,
                                                       stride, modulated):
    rng = np.random.RandomState(6)
    ho = (h + 2 - 3) // stride + 1
    wo = (w + 2 - 3) // stride + 1
    x = rng.randn(b, h, w, c).astype(np.float32)
    off = (rng.randn(b, ho, wo, g * 18) * 2).astype(np.float32)
    off[:, :, : wo // 2] = 0.0        # zero offsets: integer positions
    wt = (rng.randn(3, 3, c, o) * 0.2).astype(np.float32)
    mask = rng.rand(b, ho, wo, g * 9).astype(np.float32)
    dy = rng.randn(b, ho, wo, o).astype(np.float32)

    def j_fn(x, off, wt, mask):
        return j_deform_conv2d(x, off, wt, stride=stride, padding=1,
                               deform_groups=g,
                               mask=mask if modulated else None)
    want, vjp = jax.vjp(j_fn, *(jnp.asarray(a) for a in (x, off, wt, mask)))
    wants = [np.asarray(want)] + [np.asarray(t) for t in vjp(jnp.asarray(dy))]

    xs, offs, mk = (_nchw(a).requires_grad_(True) for a in (x, off, mask))
    wts = T(np.ascontiguousarray(wt.transpose(3, 2, 0, 1))).requires_grad_(
        True)
    if modulated:
        out = deform_conv.modulated_deform_conv2d(
            xs, offs, mk, wts, stride=stride, padding=1, deform_groups=g)
    else:
        out = deform_conv.deform_conv2d_rows(
            xs, offs, wts, stride=stride, padding=1, deform_groups=g)
    out.backward(_nchw(dy))
    gots = [out.detach().permute(0, 2, 3, 1).numpy(),
            xs.grad.permute(0, 2, 3, 1).numpy(),
            offs.grad.permute(0, 2, 3, 1).numpy(),
            wts.grad.permute(2, 3, 1, 0).numpy()]
    if modulated:
        gots.append(mk.grad.permute(0, 2, 3, 1).numpy())
    names = ("out", "dx", "doffsets", "dweight", "dmask")
    for got, want, name in zip(gots, wants, names):
        # f32 sums of up to 9*C products, reordered
        assert_close(got, want, 1e-5, err_msg=name)
    assert np.abs(gots[2]).max() > 0


# ------------------------------------------------------------ DCN backbone

def _randomize_offsets(model, rng):
    """Random non-zero DCN offset convs, as ``bump_weights`` makes them:
    weights of std 0.25/sqrt(fan_in) and biases of std 0.5, offsets of
    about half a pixel on unit-scale inputs."""
    with torch.no_grad():
        for name, m in model.named_modules():
            if name.endswith("conv_offset"):
                fan_in = m.weight[0].numel()
                m.weight.copy_(T(rng.randn(*m.weight.shape).astype(
                    np.float32) * (0.25 / fan_in ** 0.5)))
                m.bias.copy_(T(rng.randn(*m.bias.shape).astype(
                    np.float32) * 0.5))


def test_dcn_resnet_matches_jax():
    """R50 with DCN in stages 2-4 (blocks b % 3 == 0), calibrated frozen BN
    and random offset convs, against the JAX ResNet."""
    stage_with_dcn = (False, True, True, True)
    net = ResNet(50, stage_with_dcn=stage_with_dcn).eval()
    assert sorted(n for n, m in net.named_modules()
                  if hasattr(m, "conv_offset")) == [
        "layer2.0.conv2", "layer2.3.conv2", "layer3.0.conv2",
        "layer3.3.conv2", "layer4.0.conv2"]
    init_weights(net, torch.Generator().manual_seed(2))
    rng = np.random.RandomState(2)
    _randomize_offsets(net, rng)
    x = (rng.rand(2, 128, 96, 3) * 255 - 115).astype(np.float32)
    calibrate_frozen_bn(net, _nchw(x))
    sd = {f"backbone.{k}": v.numpy() for k, v in net.state_dict().items()}
    params, constants = torch_to_flax(sd)
    jnet = JResNet(depth=50, stage_with_dcn=stage_with_dcn)
    want = jnet.apply({"params": params["backbone"],
                       "constants": constants["backbone"]}, jnp.asarray(x))
    with torch.no_grad():
        got = net(_nchw(x))
    for i, (a, e) in enumerate(zip(got, want)):
        # f32 convolutions through 16 blocks, summed in another order; the
        # calibrated BN divides each channel by its spread over as few as
        # 24 samples at C5, which amplifies that rounding: 2.9e-4 measured
        # at C5, and about the same with the DCN stages off
        assert_close(a.permute(0, 2, 3, 1).numpy(), np.asarray(e), 1e-3,
                     err_msg=f"C{i + 2}")


# ------------------------------------------------------ rescoring + model

@pytest.fixture(scope="module")
def pp101():
    """The depth-101 SipMask++ forward and decode in both packages."""
    cfg = pp_cfg(101)
    model = build_model(cfg.model).eval()
    x = pp_images()
    sd = pp_state_dict(model, _nchw(x))
    variables = pp_variables(sd, 101)
    jm = j_build_model(cfg.model)
    H, W = PP_HW
    img_shapes = np.array([[H, W], [H - 16, W - 40]], np.float32)
    scales = np.array([[1.0] * 4, [0.8, 0.75, 0.8, 0.75]], np.float32)

    def j_run(v, x):
        out = jm.apply(v, x)
        dec = j_decode_batch(out, jnp.asarray(img_shapes),
                             jnp.asarray(scales), cfg.model,
                             rescore_fn=lambda m: jm.apply(
                                 v, m, method=jm.rescore))
        return out, dec
    j_out, j_dec = jax.jit(j_run)(variables, jnp.asarray(x))
    j_out = jax.tree_util.tree_map(np.asarray, j_out)
    with torch.no_grad():
        out = model(_nchw(x))
        # the decode runs on the JAX model's outputs, so that it is held to
        # the JAX decode on the same scores (near-ties among ~2000
        # candidates would otherwise reorder detections)
        dec = decode_batch(jax.tree_util.tree_map(_nchw, j_out),
                           T(img_shapes), T(scales), cfg.model,
                           rescore_fn=model.rescore)
    return dict(out=out, dec=dec, model=model, variables=variables, jm=jm,
                j_out=j_out, j_dec=jax.tree_util.tree_map(np.asarray, j_dec))


def test_sipmaskpp_head_outputs_match_jax(pp101):
    """Absolute tolerances, as the JAX package's own SipMask++ parity test
    states them (tests/test_full_model_parity_pp.py): each DCN block's
    sampling positions come from features the earlier blocks sampled, so
    f32 rounding grows through R101's eleven DCN blocks (1.2e-5 measured
    at most, on logits of ~1 and boxes of up to 256 px)."""
    out, want = pp101["out"], pp101["j_out"]
    for key, atol in (("cls_scores", 1e-4), ("bbox_preds", 1e-3),
                      ("centernesses", 1e-4), ("cof_preds", 1e-4)):
        for lvl, (a, e) in enumerate(zip(out[key], want[key])):
            np.testing.assert_allclose(a.permute(0, 2, 3, 1).numpy(), e,
                                       rtol=0, atol=atol,
                                       err_msg=f"{key}[{lvl}]")
    np.testing.assert_allclose(out["feat_masks"].permute(0, 2, 3, 1).numpy(),
                               want["feat_masks"], rtol=0, atol=1e-4)


def _pairs(got, want, i):
    """Index pairs (got, want) of image i's detections: the same slot,
    except where two scores within 1e-6 (a 1-ulp difference of the two
    frameworks' sigmoid) swapped order; those pair by label and box."""
    gl, wl = got["labels"][i].numpy(), want["labels"][i]
    gb, wb = got["boxes"][i].numpy(), want["boxes"][i]
    gs, ws = got["scores"][i].numpy(), want["scores"][i]
    pairs = []
    for a in range(len(gl)):
        near = [b for b in range(max(0, a - 3), min(len(wl), a + 4))
                if wl[b] == gl[a] and abs(ws[b] - gs[a]) <= 1e-6
                and np.abs(wb[b] - gb[a]).max() <= 1e-3]
        assert near, (i, a)
        pairs.append((a, a if a in near else near[0]))
    assert len({b for _, b in pairs}) == len(pairs)
    return pairs


def test_sipmaskpp_fast_nms_decode_and_mask_scores_match_jax(pp101):
    """The port's decode on the JAX model's head outputs against the JAX
    decode: fast NMS, masks and the rescored mask_scores."""
    got, want = pp101["dec"], pp101["j_dec"]
    v = want["valid"]
    assert v.sum(1).min() > 0, "the bias bumps must give detections"
    np.testing.assert_array_equal(got["valid"].numpy(), v)
    # scores: sigmoid products of the same logits; ranked the same but for
    # 1-ulp near-ties (_pairs)
    np.testing.assert_allclose(got["scores"].numpy(), want["scores"],
                               rtol=0, atol=1e-6)
    ms = got["mask_scores"].numpy()
    assert ms[v].min() > 0
    for i in range(v.shape[0]):
        a, b = np.array(_pairs(got, want, i)).T
        np.testing.assert_array_equal(got["labels"][i].numpy()[a],
                                      want["labels"][i][b])
        # boxes: points +- stride-scaled regressions, rescaled
        np.testing.assert_allclose(got["boxes"][i].numpy()[a],
                                   want["boxes"][i][b], rtol=0, atol=1e-3)
        # sigmoid of a 32-term dot in another order (colmix, both)
        np.testing.assert_allclose(got["masks"][i].numpy()[a],
                                   want["masks"][i][b], rtol=0, atol=1e-5)
        # the rescoring tower's six convs on those masks, then a product
        np.testing.assert_allclose(ms[i][a], want["mask_scores"][i][b],
                                   rtol=0, atol=1e-5)


def test_sipmaskpp_decode_needs_rescore_fn():
    """A rescoring head decoded without its tower would rank SipMask++'s
    detections unrescored: decode refuses, as ``compute_losses`` does."""
    with pytest.raises(ValueError, match="rescore_fn"):
        decode_batch({}, torch.zeros((1, 2)), torch.ones((1, 4)),
                     pp_cfg().model)


def test_rescoring_head_and_loss_match_jax(pp101):
    model, jm, variables = pp101["model"], pp101["jm"], pp101["variables"]
    rng = np.random.RandomState(8)
    b, k, hm, wm, nb, g = 2, 12, 128, 128, 32, 5
    basis = (rng.randn(b, hm, wm, nb) * 0.5).astype(np.float32)
    cofs = (rng.randn(b, k, 4 * nb) * 0.5).astype(np.float32)
    x1 = rng.uniform(0, wm / 2, (b, k))
    y1 = rng.uniform(0, hm / 2, (b, k))
    boxes = np.stack([x1, y1, x1 + rng.uniform(10, wm / 2, (b, k)),
                      y1 + rng.uniform(10, hm / 2, (b, k))],
                     -1).astype(np.float32)
    gt = np.zeros((b, g, hm, wm), np.uint8)
    for i in range(b):
        for j in range(g):
            gx, gy = rng.randint(0, wm // 2, 2)
            gt[i, j, gy:gy + rng.randint(8, 60), gx:gx + rng.randint(8, 60)] = 1
    gtidx = rng.randint(0, g, (b, k)).astype(np.int32)
    sel_valid = rng.rand(b, k) > 0.2
    labels = rng.randint(0, 80, (b, k)).astype(np.int32)

    masks = rng.rand(6, hm, wm, 1).astype(np.float32)
    want = np.asarray(jm.apply(variables, jnp.asarray(masks),
                               method=jm.rescore))
    with torch.no_grad():
        got = model.rescore(_nchw(masks)).numpy()
    assert_close(got, want, 1e-5, err_msg="rescore")

    aux = dict(cof_sel=jnp.asarray(cofs), box_sel=jnp.asarray(boxes),
               gtidx_sel=jnp.asarray(gtidx), sel_valid=jnp.asarray(sel_valid),
               labels_sel=jnp.asarray(labels))
    want_loss = float(j_rescoring_loss(
        aux, jnp.asarray(basis), jnp.asarray(gt),
        lambda m: jm.apply(variables, m, method=jm.rescore)))
    with torch.no_grad():
        got_loss = float(_rescoring_loss(
            _nchw(basis), T(gt), T(cofs), T(boxes), T(gtidx).long(),
            T(sel_valid), T(labels).long(), model.rescore))
    assert want_loss > 0
    # thresholds at 0.4 on the same probabilities, then f32 sums
    np.testing.assert_allclose(got_loss, want_loss, rtol=1e-5)
