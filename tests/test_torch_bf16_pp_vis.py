"""SipMask++ and SipMask-VIS in the port's compute_dtype="bfloat16"
(sipmask_tpu_torch) against the JAX package's bf16 graph, on the CPU: the
plain versions of K5 and K5c (the DCN backbone's row sampling and its
backward) against ``sample_ref`` and its VJP in bf16, a DCN ``Bottleneck``
forward and backward, the SipMask++ model at tests/test_torch_pp_train.py's
shrink (R50 with DCN stages 2-4, FPN and head 32 wide, 256x256: head
outputs, rescoring, losses with ``loss_iou``, gradients, ``Detector.infer``
with fast NMS and rescoring), and SipMask-VIS at tests/test_torch_vis.py's
shrink (the track branch on both frames, ``loss_match``, gradients,
``tracker_step`` on bf16 embeddings).

The bounds are tests/test_torch_bf16.py's (see its module note): each
result is held against JAX's bf16 result on the same inputs relative to
JAX's own bf16-vs-f32 drift, in the 2-norm; gradients get sqrt(2) drifts,
results carried end to end through the network (head outputs from images,
detections) 2 drifts. Every JAX function is compiled with
``xla_allow_excess_precision`` off.

Rounding points that differ by design: JAX's CPU sampling rounds each
bilinear weight, corner product and partial sum to bf16, and its VJP adds
dX's scattered contributions in bf16; K5 and its plain version interpolate
in f32 and round once, K5c sums dX in f32 and rounds once. The K5 and K5c
tests hold that design; the model comparisons give the port's plain K5
``sample_ref``'s roundings, and its plain K1 too (test_torch_bf16.py's
``sample_ref_rounding``), so that they see the rest of the graph's.

Both random models are calibrated and bumped as the chip smoke test makes
them (``calibrate_frozen_bn``, ``bump_weights``): a calibrated backbone
centres its pre-activations on 0, so the backbone's ReLUs are pinned, in
both packages and in both dtypes, to the sign masks of one float64 forward
of the port (tests/_torch_parity.py), as tests/test_torch_pp_train.py pins
them in f32.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (PP_HW, backbone_relu_masks, bumped_state_dict,
                           jax_variables, nhwc, pin_jax_relus,
                           pin_port_relus, pp_cfg, pp_images,
                           pp_state_dict, pp_variables)
from sipmask_tpu.config import _r
from sipmask_tpu.models import build_model as j_build_model
from sipmask_tpu.models import track as jtrack
from sipmask_tpu.models.decode import decode_batch as j_decode_batch
from sipmask_tpu.models.loss import compute_losses as j_compute_losses
from sipmask_tpu.models.resnet import STAGE_BLOCKS
from sipmask_tpu.models.resnet import Bottleneck as JBottleneck
from sipmask_tpu.ops.pallas.deform_gather import sample_ref
from sipmask_tpu_torch.apis.inference import Detector
from sipmask_tpu_torch.models import track
from sipmask_tpu_torch.models.detector import build_model
from sipmask_tpu_torch.models.loss import compute_losses
from sipmask_tpu_torch.ops import deform_sample
from sipmask_tpu_torch.utils.convert import grads_from_jax
from sipmask_tpu_torch.utils.demo_inputs import batch_to_tensors, demo_batch
from test_torch_bf16 import (BF, DETECTION_BOUND, GRAD_BOUND, ULP,
                             _port_vjp, assert_within_drift, f32,
                             sample_ref_rounding, strict, to_torch)
from test_torch_vis import (_random_stream, head_relu_masks,
                            pinned_head_relus, vis_batch, vis_cfg)

MAX_POS = 16


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread while this module runs (see
    tests/test_torch_vis.py: six workers' OpenMP pools spin against each
    other)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@contextlib.contextmanager
def rows_sample_ref_rounding():
    """Within the context, the port's plain K5 rounds a bf16 x_rows'
    samples as ``sample_ref`` does in bf16: each corner's weight, product
    and partial sum rounded to bf16 (differentiable by autograd, as JAX's
    VJP of it)."""
    real = deform_sample.deform_rows_plain

    def patched(x_rows, pyx, h, w):
        if x_rows.dtype != BF:
            return real(x_rows, pyx, h, w)
        n, cg, k, p = deform_sample._check_rows(x_rows, pyx, h, w)
        py, px = pyx[..., 0], pyx[..., 1]
        y0, x0 = torch.floor(py), torch.floor(px)
        out = torch.zeros((n, k, p, cg), dtype=BF)
        for dy in (0, 1):
            for dx in (0, 1):
                yy, xx = y0 + dy, x0 + dx
                wgt = ((py - y0 if dy else 1.0 - (py - y0)) *
                       (px - x0 if dx else 1.0 - (px - x0)))
                inb = (yy >= 0) & (yy <= h - 1) & (xx >= 0) & (xx <= w - 1)
                qi = (yy.clamp(0, h - 1) * w + xx.clamp(0, w - 1)).long()
                v = torch.gather(x_rows, 1, qi.reshape(n, k * p, 1)
                                 .expand(n, k * p, cg))
                out = out + v.reshape(n, k, p, cg) * (wgt * inb).to(
                    BF)[..., None]
        return out.permute(0, 2, 1, 3).contiguous()
    deform_sample.deform_rows_plain = patched
    try:
        yield
    finally:
        deform_sample.deform_rows_plain = real


def assert_rounds_once(got, want16, want32, what):
    """A bf16 result that is an f32 result rounded once, against JAX's
    bf16 result that rounds at every step: no further from the f32 result
    than JAX's (||got - want32|| <= the drift), and within sqrt(2) drifts
    of JAX's (two bf16 results with independent errors of at most the
    drift's size)."""
    assert_within_drift(got, want32, want16, f"{what} against f32")
    assert_within_drift(got, want16, want32, what, GRAD_BOUND)


@contextlib.contextmanager
def jax_sampling():
    """Both plain samplings of the port with JAX's CPU bf16 roundings."""
    with sample_ref_rounding(), rows_sample_ref_rounding():
        yield


# ------------------------------------------------ K5 and K5c, plain versions

def _k5_inputs(seed=3, n=2, h=14, w=18, cg=16, k=9):
    """x_rows (N, h*w, Cg) and positions (N, K, P, 2) at a 3x3 conv's taps
    plus offsets of ~2 px, a third of the pixels +-300 px out of the map."""
    rng = np.random.RandomState(seed)
    x = rng.randn(n, h * w, cg).astype(np.float32)
    ky, kx = np.divmod(np.arange(k), 3)
    py = (np.arange(h)[:, None] - 1 + ky[:, None, None]).repeat(w, 2)
    px = (np.arange(w)[None, :] - 1 + kx[:, None, None]).repeat(h, 1)
    base = np.stack([py, px], -1).reshape(k, h * w, 2)
    off = rng.randn(n, k, h * w, 2) * 2.0
    off[:, :, : (h * w) // 3] *= 150.0
    return x, (base[None] + off).astype(np.float32)


@pytest.mark.parametrize("cg", [16, 12])
def test_k5_plain_bf16_matches_jax_sampling(cg):
    """K5's plain bf16 version against ``sample_ref`` in bf16, within
    JAX's bf16-vs-f32 drift; tighter: it is the f32 sampling of the same
    bf16 values rounded once to bf16 (the kernel's arithmetic), and lies
    within one bf16 unit of JAX's f32 sampling of them, rounded."""
    x, pyx = _k5_inputs(cg=cg)
    h, w = 14, 18
    xb, pt = torch.from_numpy(x).to(BF), torch.from_numpy(pyx)
    got = deform_sample.deform_rows_plain(xb, pt, h, w)
    assert got.dtype == BF and tuple(got.shape) == (2, h * w, 9, cg)
    assert torch.equal(got, deform_sample.deform_rows_plain(
        xb.float(), pt, h, w).to(BF))
    x16 = jnp.asarray(x).astype(jnp.bfloat16)
    ref = lambda xr: sample_ref(xr, jnp.asarray(pyx), h, w)   # noqa: E731
    j16 = f32(strict(ref, x16))
    j32 = f32(strict(ref, jnp.asarray(x)))
    once = f32(strict(ref, x16.astype(jnp.float32)).astype(jnp.bfloat16))
    assert_rounds_once(got.float().numpy(), j16, j32, "K5 samples")
    np.testing.assert_allclose(got.float().numpy(), once, rtol=0,
                               atol=ULP * np.abs(once).max())


@pytest.mark.parametrize("cg", [16, 12])
def test_k5c_plain_bf16_matches_jax_vjp(cg):
    """K5c's plain bf16 version (dx bf16, d positions f32) against the VJP
    of ``sample_ref`` in bf16: dx within the drift, d positions within
    sqrt(2) drifts; tighter: dx is the f32 backward of the upcasts rounded
    once to bf16 and d positions are its f32 ones, exactly."""
    x, pyx = _k5_inputs(seed=4, cg=cg)
    h, w = 14, 18
    g = np.random.RandomState(5).randn(2, h * w, 9, cg).astype(np.float32)
    xb, pt = torch.from_numpy(x).to(BF), torch.from_numpy(pyx)
    gb = torch.from_numpy(g).to(BF)
    dx, dp = deform_sample.deform_rows_backward_plain(xb, pt, gb, h, w)
    assert (dx.dtype, dp.dtype) == (BF, torch.float32)
    dx32, dp32 = deform_sample.deform_rows_backward_plain(
        xb.float(), pt, gb.float(), h, w)
    assert torch.equal(dx, dx32.to(BF)) and torch.equal(dp, dp32)
    assert float(dp.abs().max()) > 0

    def vjp(xr, pp, ct):
        return jax.vjp(lambda a, b: sample_ref(a, b, h, w), xr, pp)[1](ct)
    x16 = jnp.asarray(x).astype(jnp.bfloat16)
    g16 = jnp.asarray(g).astype(jnp.bfloat16)
    j16 = strict(vjp, x16, jnp.asarray(pyx), g16)
    j32 = strict(vjp, x16.astype(jnp.float32), jnp.asarray(pyx),
                 g16.astype(jnp.float32))
    assert_rounds_once(dx.float().numpy(), f32(j16[0]), f32(j32[0]),
                       "K5c dx")
    assert_within_drift(dp.numpy(), f32(j16[1]), f32(j32[1]),
                        "K5c d positions", GRAD_BOUND)


@pytest.mark.parametrize("groups, modulated", [(2, False), (1, True)])
def test_sampled_route_bf16_refuses_groups_and_masks(groups, modulated):
    """In bf16 the sampled route takes DeformConvPack's one deform group
    and no modulation mask; other settings raise, in the plain version as
    on the card."""
    from sipmask_tpu_torch.ops.deform_conv import deform_conv2d_rows
    x = torch.zeros((1, 8, 6, 6), dtype=torch.bfloat16)
    off = torch.zeros((1, groups * 18, 6, 6))
    mask = torch.ones((1, groups * 9, 6, 6)) if modulated else None
    with pytest.raises(NotImplementedError, match="one deform group"):
        deform_conv2d_rows(x, off, torch.zeros((4, 8, 3, 3)),
                           deform_groups=groups, mask=mask)


# ---------------------------------------------------- a DCN Bottleneck

def test_dcn_bottleneck_matches_jax_bf16(pp):
    """The first block of stage 2 (DCN conv2, stride 2, downsample) in
    bf16 on common bf16 inputs and cotangents: the output within the
    drift, the gradients of its input and its parameters (the DCN weight
    and offset conv included, f32) within sqrt(2) drifts."""
    var = pp["var"]
    rng = np.random.RandomState(6)
    x16 = jnp.asarray(np.maximum(rng.randn(2, 64, 64, 256), 0).astype(
        np.float32)).astype(jnp.bfloat16)
    ct16 = jnp.asarray(rng.randn(2, 32, 32, 512).astype(
        np.float32)).astype(jnp.bfloat16)
    params = var["params"]["backbone"]["layer2_0"]
    consts = var["constants"]["backbone"]["layer2_0"]

    def run(dtype):
        blk = JBottleneck(128, stride=2, downsample=True, with_dcn=True,
                          dtype=dtype)

        def vjp(p, x, ct):
            out, f = jax.vjp(lambda pp, xx: blk.apply(
                {"params": pp, "constants": consts}, xx), p, x)
            return out, f(ct)
        return vjp
    up = lambda a: a.astype(jnp.float32)   # noqa: E731
    (o16, (dp16, dx16)) = strict(run(jnp.bfloat16), params, x16, ct16)
    (o32, (dp32, dx32)) = strict(run(jnp.float32), params, up(x16),
                                 up(ct16))
    blk = _loaded(pp["cfg16"], pp["sd"]).backbone.layer2[0]
    xt = to_torch(x16).requires_grad_(True)
    with jax_sampling():
        out = blk(xt)
        out.backward(to_torch(ct16))
    assert out.dtype == BF and xt.grad.dtype == BF
    assert_within_drift(nhwc(out.float()), f32(o16), f32(o32), "output")
    assert_within_drift(nhwc(xt.grad.float()), f32(dx16), f32(dx32),
                        "input gradient", GRAD_BOUND)
    want16 = grads_from_jax({"backbone": {"layer2_0": dp16}})
    want32 = grads_from_jax({"backbone": {"layer2_0": dp32}})
    got = {f"backbone.layer2.0.{n}": p.grad
           for n, p in blk.named_parameters()}
    assert "backbone.layer2.0.conv2.conv_offset.weight" in got
    for n, g in got.items():
        assert g.dtype == torch.float32, n
        assert_within_drift(g.numpy(), want16[n].numpy(), want32[n].numpy(),
                            f"gradient of {n}", GRAD_BOUND)


# ---------------------------------------------------------------- SipMask++

def _levels(out):
    """(key, level, tensor) of a head output dict, levels in order."""
    for key in ("cls_scores", "bbox_preds", "centernesses", "cof_preds",
                "feat_masks", "track_feats", "track_feats_ref"):
        if key in out:
            vals = out[key] if isinstance(out[key], (list, tuple)) else \
                [out[key]]
            for lvl, t in enumerate(vals):
                yield key, lvl, t


def _to_port(jax_out):
    """A JAX head output dict -> the port's NCHW dict, bf16 but the f32
    box regressions."""
    outs = {}
    for key, _, a in _levels(jax_out):
        outs.setdefault(key, []).append(
            to_torch(a, torch.float32 if key == "bbox_preds" else BF))
    for key in ("feat_masks", "track_feats", "track_feats_ref"):
        if key in outs:
            outs[key] = outs[key][0]
    return outs


def _up(tree):
    return jax.tree_util.tree_map(lambda a: a.astype(jnp.float32), tree)


def _vjp(fn):
    """(p, x, ct) -> (fn(p, x), (d p, d x))."""
    def run(p, x, ct):
        out, f = jax.vjp(fn, p, x)
        return out, f(ct)
    return run


def _loaded(cfg, sd):
    m = build_model(cfg.model)
    m.load_state_dict(sd)
    return m


def _grads_within(got, g16, g32, what, bound=GRAD_BOUND):
    """Every gradient in ``got`` {port name: f32 tensor} within ``bound``
    drifts of JAX's trees ``g16`` / ``g32``. The one-element parameters
    (the head's five ``Scale``s, the centerness bias) are held as one
    vector: the ratio of two rounding errors of one number has no useful
    bound (read on the VIS head: 0.98, 1.10 and 1.45 for the three scales
    with positives)."""
    want16, want32 = grads_from_jax(g16), grads_from_jax(g32)
    assert got
    scalars = [n for n, g in got.items() if g.numel() == 1]
    groups = [([n], n) for n in got if n not in scalars]
    if scalars:
        groups.append((scalars, "the scalars " + ", ".join(scalars)))
    for names, label in groups:
        assert all(got[n].dtype == torch.float32 for n in names), label
        vec = [np.stack([t[n].reshape(-1).numpy() for n in names])
               for t in (got, want16, want32)]
        assert_within_drift(*vec, f"{what} gradient of {label}", bound)


@pytest.fixture(scope="module")
def pp():
    """SipMask++ (R50 + DCN stages 2-4, FPN and head 32 wide) with bumped
    (for training) and calibrated weights and a batch at 256x256. JAX's
    bf16 and f32 graphs from the images (the backbone's ReLUs pinned), the
    loss and its cotangents on JAX's bf16 head outputs, and the backward
    module by module on JAX's bf16 inputs and cotangents: the head, and
    the backbone's stages 2-4 (each stage's ReLUs pinned); with the port's
    bf16 modules on the same inputs and cotangents."""
    cfg = _r(pp_cfg(50), "train", max_pos=MAX_POS)
    cfg16 = _r(cfg, "model", compute_dtype="bfloat16")
    batch = demo_batch(batch_size=2, height=PP_HW[0], width=PP_HW[1],
                       max_gts=8, seed=7)
    tb = batch_to_tensors(batch)
    sd = pp_state_dict(build_model(cfg.model), tb["images"], training=True)
    var = pp_variables(sd, 50)
    P, consts = var["params"], var["constants"]
    masks = backbone_relu_masks(_loaded(cfg, sd).backbone, tb["images"])
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    j = {}
    for c in (cfg16, cfg):
        jm = j_build_model(c.model)

        def method(fn, jm=jm):
            return lambda p, *a: jm.apply({"params": p, "constants": consts},
                                          *a, method=fn)

        def loss(out, rp, jm=jm, c=c):
            v = {"params": {**P, "rescoring": rp}, "constants": consts}
            losses = j_compute_losses(
                out, jb, c.model.head, max_pos=MAX_POS,
                rescore_fn=lambda m: jm.apply(v, m, method=jm.rescore))
            return sum(losses.values()), losses
        j[c.model.compute_dtype] = dict(
            bb=method(lambda m, x: m.backbone(x)),
            neck=method(lambda m, x: m.neck(x)),
            head=method(lambda m, f: m.head(f)),
            loss=jax.value_and_grad(loss, argnums=(0, 1), has_aux=True))
    j16, j32 = j["bfloat16"], j["float32"]
    with pin_jax_relus(masks):
        c16 = strict(j16["bb"], P, jb["images"])
        c32 = strict(j32["bb"], P, jb["images"])
    p16, p32 = strict(j16["neck"], P, c16), strict(j32["neck"], P, c32)
    h16, h32 = strict(j16["head"], P, p16), strict(j32["head"], P, p32)
    (_, jl16), (dh16, drp16) = strict(j16["loss"], h16, P["rescoring"])
    (_, jl32), (_, drp32) = strict(j32["loss"], _up(h16), P["rescoring"])
    head = [strict(_vjp(jj["head"]), P, p, ct) for jj, p, ct in (
        (j16, p16, dh16), (j32, _up(p16), _up(dh16)))]
    # stage s's cotangent: the one the neck sends to C_s
    dc16 = strict(_vjp(j16["neck"]), P, c16,
                  strict(_vjp(j16["head"]), P, p16, dh16)[1][1])[1][1]
    stages, first = {}, 1 + 3 * STAGE_BLOCKS[50][0]
    for s in (2, 3, 4):
        n_relu = 3 * STAGE_BLOCKS[50][s - 1]
        pins = masks[first:first + n_relu]
        first += n_relu
        sub = {f"layer{s}_{i}": P["backbone"][f"layer{s}_{i}"]
               for i in range(STAGE_BLOCKS[50][s - 1])}
        runs = []
        for dt, x, ct in ((jnp.bfloat16, c16[s - 2], dc16[s - 1]),
                          (jnp.float32, _up(c16[s - 2]), _up(dc16[s - 1]))):
            with pin_jax_relus(pins):
                runs.append(strict(_vjp(_stage(s, dt, consts["backbone"])),
                                   sub, x, ct))
        stages[s] = (runs, pins)

    # the port: the whole model from the images, then module by module
    model16 = _loaded(cfg16, sd)
    named = dict(model16.named_parameters())
    with pin_port_relus(model16.backbone, masks), jax_sampling(), \
            torch.no_grad():
        out = model16(tb["images"])
    with jax_sampling():
        port_head = _port_vjp(
            lambda ins: [t for _, _, t in _levels(model16.bbox_head(ins))],
            {n: p for n, p in named.items() if n.startswith("bbox_head.")},
            [to_torch(a) for a in p16],
            [t for _, _, t in _levels(_to_port(dh16))])
        port_stages = {}
        for s in (2, 3, 4):
            layer = getattr(model16.backbone, f"layer{s}")
            with pin_port_relus(layer, stages[s][1]):
                port_stages[s] = _port_vjp(
                    lambda ins, layer=layer: [layer(ins[0])],
                    {n: p for n, p in named.items()
                     if n.startswith(f"backbone.layer{s}.")},
                    [to_torch(c16[s - 2])], [to_torch(dc16[s - 1])])
    return dict(cfg=cfg, cfg16=cfg16, sd=sd, var=var, batch=batch,
                model16=model16, out=out, h16=h16, h32=h32, jl16=jl16,
                jl32=jl32, dh16=dh16, drp16=drp16, drp32=drp32, head=head,
                stages=stages, port_head=port_head, port_stages=port_stages)


def _stage(s, dtype, consts):
    """The JAX ResNet-50's stage s (1-based) with SipMask++'s DCN blocks
    (b % 3 == 0) as a function of (params of its blocks, x)."""
    blocks = [(f"layer{s}_{i}", JBottleneck(
        64 * 2 ** (s - 1), stride=2 if i == 0 else 1, downsample=i == 0,
        with_dcn=i % 3 == 0, dtype=dtype))
        for i in range(STAGE_BLOCKS[50][s - 1])]

    def run(params, x):
        for name, blk in blocks:
            x = blk.apply({"params": params[name], "constants": consts[name]},
                          x)
        return x
    return run


def test_sipmaskpp_bf16_model_dtypes(pp):
    """f32 parameters with f32 gradients; every head output bf16 but the
    f32 box regressions; the DCN blocks sample in bf16."""
    m = pp["model16"]
    for n, p in m.named_parameters():
        assert p.dtype == torch.float32, n
        assert p.grad is None or p.grad.dtype == torch.float32, n
    for key, _, t in _levels(pp["out"]):
        assert t.dtype == (torch.float32 if key == "bbox_preds" else BF), key
    assert m.backbone.layer2[0].conv2.dtype == BF


def test_sipmaskpp_head_outputs_match_jax_bf16(pp):
    """Each head output from the images, carried end to end through the
    DCN backbone (2 drifts; 0.63 read at most)."""
    j16 = {(k, lvl): a for k, lvl, a in _levels(pp["h16"])}
    j32 = {(k, lvl): a for k, lvl, a in _levels(pp["h32"])}
    for k, lvl, t in _levels(pp["out"]):
        assert_within_drift(nhwc(t.float()), f32(j16[k, lvl]),
                            f32(j32[k, lvl]), f"{k}[{lvl}]",
                            DETECTION_BOUND)


def test_sipmaskpp_rescoring_matches_jax_bf16(pp):
    """The rescoring head in bf16 on common f32 masks: bf16 scores (the
    masks cast at its first conv) within the drift."""
    masks = np.random.RandomState(8).rand(4, 128, 128, 1).astype(np.float32)
    want = []
    for c in (pp["cfg16"], pp["cfg"]):
        jm = j_build_model(c.model)
        want.append(strict(lambda v, m, jm=jm: jm.apply(
            v, m, method=jm.rescore), pp["var"], jnp.asarray(masks)))
    assert want[0].dtype == jnp.bfloat16
    with torch.no_grad():
        got = pp["model16"].rescore(torch.from_numpy(masks).permute(
            0, 3, 1, 2).contiguous())
    assert got.dtype == BF
    assert_within_drift(got.float().numpy(), f32(want[0]), f32(want[1]),
                        "rescoring scores")


def test_sipmaskpp_losses_and_head_cotangents_match_jax(pp):
    """The losses on JAX's bf16 head outputs: the port upcasts them as JAX
    does, so every loss but loss_iou is the f32 loss of the same values
    (rtol 1e-4); loss_iou, from the bf16 rescoring head, within the drift
    of JAX's bf16 loss_iou from its f32 head's; the cotangents of the head
    outputs, rounded to their bf16, within one bf16 unit of each one's
    max; the rescoring head's gradients within sqrt(2) drifts."""
    outs = _to_port(pp["h16"])
    for t in (t for _, _, t in _levels(outs)):
        t.requires_grad_(True)
    m16 = pp["model16"]
    named = dict(m16.named_parameters())
    for p in named.values():
        p.grad = None
    losses = compute_losses(outs, batch_to_tensors(pp["batch"]),
                            pp["cfg16"].model.head, max_pos=MAX_POS,
                            rescore_fn=m16.rescore)
    jl16, jl32 = pp["jl16"], pp["jl32"]
    assert set(losses) == set(jl16) and float(losses["loss_iou"]) > 0
    for k, v in losses.items():
        if k != "loss_iou":
            np.testing.assert_allclose(float(v), float(jl16[k]), rtol=1e-4,
                                       atol=1e-6, err_msg=k)
    assert_within_drift(float(losses["loss_iou"]), float(jl16["loss_iou"]),
                        float(jl32["loss_iou"]), "loss_iou")
    sum(losses.values()).backward()
    for (key, lvl, want), (_, _, t) in zip(_levels(pp["dh16"]),
                                           _levels(outs)):
        w = f32(want)
        np.testing.assert_allclose(nhwc(t.grad.float()), w, rtol=0,
                                   atol=ULP * max(np.abs(w).max(), 1e-30),
                                   err_msg=f"{key}[{lvl}]")
    got = {n: p.grad for n, p in named.items() if p.grad is not None}
    assert all(".convs_scoring." in n or ".mask_scoring." in n for n in got)
    _grads_within(got, {"rescoring": pp["drp16"]},
                  {"rescoring": pp["drp32"]}, "rescoring")


def test_sipmaskpp_head_gradients_match_jax_bf16(pp):
    """The head's parameter gradients (f32, through the casts) and the
    gradients it passes to P3..P7, on JAX's bf16 inputs and cotangents,
    within sqrt(2) drifts."""
    (_, (g16, dx16)), (_, (g32, dx32)) = pp["head"]
    _, grads, dp = pp["port_head"]
    _grads_within({n: g for n, g in grads.items()
                   if ".convs_scoring." not in n and ".mask_scoring." not in n},
                  g16, g32, "head")
    for lvl, (got, w16, w32) in enumerate(zip(dp, dx16, dx32)):
        assert got.dtype == BF
        assert_within_drift(nhwc(got.float()), f32(w16), f32(w32),
                            f"head's input gradient [{lvl}]", GRAD_BOUND)


@pytest.mark.parametrize("s", [2, 3, 4])
def test_sipmaskpp_dcn_stage_matches_jax_bf16(pp, s):
    """Backbone stage s with its DCN blocks on JAX's bf16 input and
    cotangent, its ReLUs pinned: the output within the drift; its
    parameter gradients (the DCN weights and offset convs included) and
    its input gradient within sqrt(2) drifts."""
    ((o16, (g16, dx16)), (o32, (g32, dx32))), _ = pp["stages"][s]
    (out,), grads, (dx,) = pp["port_stages"][s]
    assert out.dtype == BF and dx.dtype == BF
    assert_within_drift(nhwc(out.detach().float()), f32(o16), f32(o32),
                        f"C{s + 1}")
    assert_within_drift(nhwc(dx.float()), f32(dx16), f32(dx32),
                        f"C{s}'s gradient", GRAD_BOUND)
    assert any(".conv2.conv_offset." in n for n in grads)
    _grads_within({n: g for n, g in grads.items()},
                  {"backbone": g16}, {"backbone": g32}, f"stage {s}")


def _sorted(d, key, i):
    return np.sort(d[key][i][d["valid"][i]])[::-1]


def test_sipmaskpp_detector_infer_matches_jax_bf16(pp):
    """``Detector.infer`` in bf16 (fast NMS, rescoring) against JAX's bf16
    model and decode on the same weights and images: as many detections,
    and each image's sorted detection scores and mask scores within
    DETECTION_BOUND drifts of JAX's (1.20 read at most)."""
    cfg, cfg16 = pp["cfg"], pp["cfg16"]
    x = pp["batch"]["images"]
    shapes = np.array([[256.0, 256.0], [240.0, 216.0]], np.float32)
    scales = np.array([[1.0] * 4, [0.8, 0.75, 0.8, 0.75]], np.float32)

    def run(c, var):
        jm = j_build_model(c.model)
        return jax.tree_util.tree_map(np.asarray, strict(
            lambda v, im: j_decode_batch(
                jm.apply(v, im), jnp.asarray(shapes), jnp.asarray(scales),
                c.model, rescore_fn=lambda m: jm.apply(v, m,
                                                       method=jm.rescore)),
            var, jnp.asarray(x)))
    # the serving bumps (bump_weights): fast NMS keeps score x centerness
    # over its threshold
    model = build_model(cfg16.model)
    sd = pp_state_dict(model, torch.from_numpy(x).permute(0, 3, 1, 2), 13)
    var = pp_variables(sd, 50)
    j16, j32 = run(cfg16, var), run(cfg, var)
    det = Detector(cfg16, model.eval(), "cpu")
    with jax_sampling():
        got = det.infer(torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(),
                        torch.from_numpy(shapes), torch.from_numpy(scales))
    got = {k: v.numpy() for k, v in got.items()}
    assert got["mask_scores"].dtype == np.float32
    np.testing.assert_array_equal(got["valid"].sum(1), j16["valid"].sum(1))
    for i in range(x.shape[0]):
        assert got["valid"][i].sum() > 0
        assert got["mask_scores"][i][got["valid"][i]].min() > 0
        for key in ("scores", "mask_scores"):
            assert_within_drift(_sorted(got, key, i), _sorted(j16, key, i),
                                _sorted(j32, key, i),
                                f"image {i}'s sorted {key}", DETECTION_BOUND)


# -------------------------------------------------------------- SipMask-VIS

@pytest.fixture(scope="module")
def vis():
    """SipMask-VIS at test_torch_vis.py's shrink with bumped weights, both
    frames of its batch at 256x320, the head's ReLUs pinned in both
    packages (test_torch_vis.py's masks): JAX's bf16 and f32 graphs from
    the images, the loss and its cotangents on JAX's bf16 head outputs,
    and the head's backward on JAX's bf16 inputs and cotangents; the
    port's bf16 model from the images and its head on the same inputs and
    cotangents."""
    cfg = vis_cfg()
    cfg16 = _r(cfg, "model", compute_dtype="bfloat16")
    sd = bumped_state_dict(build_model(cfg.model))
    var = jax_variables(sd)
    P, consts = var["params"], var["constants"]
    batch = vis_batch()
    masks = head_relu_masks(cfg, sd, batch)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    j = {}
    for c in (cfg16, cfg):
        jm = j_build_model(c.model)

        def method(fn, jm=jm):
            return lambda p, *a: jm.apply({"params": p, "constants": consts},
                                          *a, method=fn)

        def loss(out, c=c):
            losses = j_compute_losses(out, jb, c.model.head, max_pos=MAX_POS)
            return sum(v for k, v in losses.items()
                       if k.startswith("loss")), losses
        j[c.model.compute_dtype] = dict(
            feats=method(lambda m, x, r: (m.extract_feats(x),
                                          m.extract_feats(r))),
            head=method(lambda m, fr: m.head(*fr)),
            loss=jax.value_and_grad(loss, has_aux=True))
    j16, j32 = j["bfloat16"], j["float32"]
    f16 = strict(j16["feats"], P, jb["images"], jb["ref_images"])
    f32_ = strict(j32["feats"], P, jb["images"], jb["ref_images"])
    with pinned_head_relus(None, masks):
        h16 = strict(j16["head"], P, f16)
        h32 = strict(j32["head"], P, f32_)
        (_, jl16), dh16 = strict(j16["loss"], h16)
        (_, jl32), _ = strict(j32["loss"], _up(h16))
        head = [strict(_vjp(jj["head"]), P, f, ct) for jj, f, ct in (
            (j16, f16, dh16), (j32, _up(f16), _up(dh16)))]

    model16 = _loaded(cfg16, sd)
    named = dict(model16.named_parameters())
    tb = batch_to_tensors(batch)
    with sample_ref_rounding(), pinned_head_relus(model16, masks):
        with torch.no_grad():
            out = model16(tb["images"], tb["ref_images"])
        port_head = _port_vjp(
            lambda ins: [t for _, _, t in _levels(model16.bbox_head(
                ins[:5], ins[5:]))],
            {n: p for n, p in named.items() if n.startswith("bbox_head.")},
            [to_torch(a) for a in (*f16[0], *f16[1])],
            [t for _, _, t in _levels(_to_port(dh16))])
    return dict(cfg=cfg, cfg16=cfg16, model16=model16, out=out, batch=batch,
                h16=h16, h32=h32, jl16=jl16, jl32=jl32, dh16=dh16,
                head=head, port_head=port_head)


def test_vis_track_feats_match_jax_bf16(vis):
    """``track_feats`` of the current and the reference frame, bf16, from
    the images (2 drifts; 1.13 read)."""
    for key in ("track_feats", "track_feats_ref"):
        got = vis["out"][key]
        assert got.dtype == BF
        assert_within_drift(nhwc(got.float()), f32(vis["h16"][key]),
                            f32(vis["h32"][key]), key, DETECTION_BOUND)


def test_vis_losses_match_jax_bf16(vis):
    """The losses on JAX's bf16 head outputs: every loss but loss_match is
    the f32 loss of the same upcast values (rtol 1e-4); loss_match, a bf16
    product and log-softmax in both (NEG rounds to -9984), within the
    drift of JAX's bf16 loss_match from its f32 one on the same
    outputs; and on fixed selections within the drift too."""
    jl16, jl32 = vis["jl16"], vis["jl32"]
    outs = _to_port(vis["h16"])
    tb = batch_to_tensors(vis["batch"])
    with torch.no_grad():
        got = compute_losses(outs, tb, vis["cfg16"].model.head,
                             max_pos=MAX_POS)
    assert set(got) == set(jl16) and float(got["loss_match"]) > 0
    for k, v in got.items():
        if k != "loss_match":
            np.testing.assert_allclose(float(v), float(jl16[k]), rtol=1e-4,
                                       atol=1e-6, err_msg=k)
    assert_within_drift(float(got["loss_match"]), float(jl16["loss_match"]),
                        float(jl32["loss_match"]), "loss_match")

    rng = np.random.RandomState(2)
    b, k, g = 2, 12, 8
    xy = rng.uniform(0, 120, (b, k, 2))
    box_sel = np.concatenate([xy, xy + rng.uniform(4, 40, (b, k, 2))],
                             -1).astype(np.float32)
    sel_valid = rng.rand(b, k) < 0.8
    gtidx = rng.randint(0, g, (b, k)).astype(np.int32)
    batch = vis["batch"]
    jbatch = {key: jnp.asarray(batch[key]) for key in
              ("gt_pids", "ref_bboxes_jit", "ref_labels")}
    aux = {"box_sel": jnp.asarray(box_sel),
           "sel_valid": jnp.asarray(sel_valid),
           "gtidx_sel": jnp.asarray(gtidx)}

    def jloss(tf, tr):
        return jtrack.track_match_loss({"track_feats": tf,
                                        "track_feats_ref": tr}, jbatch, aux)
    t16, r16 = vis["h16"]["track_feats"], vis["h16"]["track_feats_ref"]
    w16 = strict(jloss, t16, r16)
    w32 = strict(jloss, *_up((t16, r16)))
    t = lambda a: torch.from_numpy(np.asarray(a))   # noqa: E731
    loss, _ = track.track_match_loss(
        {"track_feats": to_torch(t16), "track_feats_ref": to_torch(r16)},
        {key: t(batch[key]) for key in jbatch}, t(box_sel), t(sel_valid),
        t(gtidx))
    assert loss.dtype == torch.float32 and float(loss) > 0
    assert_within_drift(float(loss), float(w16[0]), float(w32[0]),
                        "loss_match on fixed selections")


def test_vis_head_gradients_match_jax_bf16(vis):
    """The head's parameter gradients (the track branch on both frames
    included) and the gradients it passes to both frames' P3..P7, on
    JAX's bf16 inputs and cotangents, within sqrt(2) drifts; the track
    branch trains."""
    (_, (g16, (dx16, dr16))), (_, (g32, (dx32, dr32))) = vis["head"]
    _, grads, dp = vis["port_head"]
    _grads_within(grads, g16, g32, "head")
    for n in ("bbox_head.track_convs.0.conv.weight",
              "bbox_head.sipmask_track.weight"):
        assert float(grads[n].abs().max()) > 0, n
    for lvl, (got, w16, w32) in enumerate(zip(
            dp, (*dx16, *dr16), (*dx32, *dr32))):
        if lvl >= 8:   # the reference frame's P6, P7 feed nothing
            assert got is None and not np.any(f32(w16)), lvl
            continue
        assert got.dtype == BF
        assert_within_drift(nhwc(got.float()), f32(w16), f32(w32),
                            f"head's input gradient [{lvl}]", GRAD_BOUND)


def test_tracker_step_on_bf16_embeddings_matches_jax():
    """A stream of bf16 embeddings (values exact in bf16) into the f32
    tracker state: JAX promotes ``det_feats @ state.feats.T`` to f32, the
    port casts to the same product; object ids and every state field
    equal after each frame, the memory staying f32."""
    m, frames = _random_stream()
    dim = frames[0][4].shape[1]
    jstate, state = jtrack.tracker_init(m, dim), track.tracker_init(m, dim)
    jstep = jax.jit(jtrack.tracker_step)
    for f, (boxes, scores, labels, valid, feats) in enumerate(frames):
        assert np.array_equal(np.asarray(jnp.asarray(feats).astype(
            jnp.bfloat16).astype(jnp.float32)), feats)
        arrs = (np.asarray(boxes, np.float32), np.asarray(scores, np.float32),
                np.asarray(labels, np.int32), np.asarray(valid, bool))
        jstate, jids = jstep(jstate, *map(jnp.asarray, arrs),
                             jnp.asarray(feats).astype(jnp.bfloat16),
                             jnp.asarray(f == 0))
        state, ids = track.tracker_step(
            state, *map(torch.from_numpy, arrs),
            torch.from_numpy(feats).to(BF), f == 0)
        np.testing.assert_array_equal(ids.numpy(), np.asarray(jids),
                                      err_msg=f"frame {f}")
        assert state.feats.dtype == torch.float32
        for field in track.TrackerState._fields:
            np.testing.assert_array_equal(
                getattr(state, field).numpy(),
                np.asarray(getattr(jstate, field)),
                err_msg=f"frame {f}, {field}")
    assert int(state.count) > m


# --------------------------------------------------------------- the CLIs

PP_SHRINK = ["model.backbone.depth=50", "model.fpn.out_channels=32",
             "model.head.in_channels=32", "model.head.feat_channels=32",
             "data.fixed_size=(256,256)", "data.train_size=(256,256)",
             "data.max_gts=8", "data.num_workers=1",
             "train.imgs_per_device=2", "train.max_pos=16",
             "train.log_interval=1"]


@pytest.mark.parametrize("preset", ["sipmaskpp_r101_fpn_ssd_6x",
                                    "sipmask_vis_r50"])
def test_train_and_test_clis_take_bf16_from_cfg_options(preset, tmp_path):
    """tools/train.py for 2 steps with ``--cfg-options
    model.compute_dtype=bfloat16`` on a synthetic set (SipMask++: COCO;
    VIS: YouTube-VIS frame pairs) from the tests' bumped weights (SipMask++:
    calibrated too, as a pretrained backbone would hold its activations),
    then the preset's test CLI on its checkpoint in bf16: a bf16 model with
    f32 checkpoints, finite losses (loss_iou, or loss_match), results that
    decode."""
    import json
    import os
    from sipmask_tpu_torch.eval.rle import decode_mask, rle_area
    from sipmask_tpu_torch.tools import test as test_cli
    from sipmask_tpu_torch.tools import test_video as video_cli
    from sipmask_tpu_torch.tools import train as train_cli
    from sipmask_tpu_torch.tools import synth_coco, synth_ytvis
    from sipmask_tpu_torch.utils.checkpoint import latest_checkpoint
    from test_torch_vis import SHRINK
    vis = preset == "sipmask_vis_r50"
    if vis:
        ann, imgs = synth_ytvis.make_dataset(str(tmp_path / "set"),
                                             num_videos=2, frames=3,
                                             size=96, seed=3)
        shrink, extra = SHRINK, "loss_match"
        sd = bumped_state_dict(build_model(vis_cfg().model))
    else:
        ann, imgs = synth_coco.make_dataset(
            str(tmp_path / "set"), sizes=((256, 256), (240, 200)), repeat=1,
            min_objs=3, max_objs=5, seed=3)
        shrink, extra = PP_SHRINK, "loss_iou"
        sd = pp_state_dict(build_model(pp_cfg(50).model),
                           torch.from_numpy(pp_images()).permute(0, 3, 1, 2),
                           training=True)
    weights = str(tmp_path / "bumped.pth")
    torch.save(sd, weights)
    opts = ["--cfg-options", *shrink, "model.compute_dtype=bfloat16"]
    wd = str(tmp_path / "wd")
    state = train_cli.main([preset, "--ann", ann, "--img-prefix", imgs,
                            "--work-dir", wd, "--load-from", weights,
                            "--max-steps", "2", "--device", "cpu", *opts])
    assert state.step == 2 and state.model.backbone.dtype == BF
    with open(os.path.join(wd, "train.log.json")) as f:
        rows = [r for r in map(json.loads, f) if "loss_total" in r]
    assert len(rows) == 2 and all(np.isfinite(r["loss_total"])
                                  and np.isfinite(r[extra]) for r in rows)
    ckpt = latest_checkpoint(wd)
    sd = torch.load(ckpt, map_location="cpu", weights_only=False)
    sd = sd.get("state_dict", sd)
    assert all(v.dtype != BF for v in sd.values() if torch.is_tensor(v))
    if vis:
        results, stats = video_cli.main([preset, ckpt, "--ann", ann,
                                         "--img-prefix", imgs, "--out",
                                         str(tmp_path / "results.json"),
                                         "--eval", "--device", "cpu",
                                         *opts])
        assert results and all(np.isfinite(v) for v in stats.values())
        for r in results:
            for seg in r["segmentations"]:
                if seg is not None:
                    assert int(decode_mask(seg).sum()) == rle_area(seg)
    else:
        stats = test_cli.main([preset, ckpt, "--ann", ann, "--img-prefix",
                               imgs, "--batch-size", "2", "--device", "cpu",
                               *opts])
        assert set(stats) == {"bbox", "segm"}
