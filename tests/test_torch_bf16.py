"""The port's compute_dtype="bfloat16" graph (sipmask_tpu_torch) against the
JAX package's, on the CPU, at golden's shrink (FPN and head 32 wide, 2
images at 128x160): the plain versions of K1, K2, K4a and K4b against the
JAX package's XLA paths in bf16, then the backbone, FPN and head level by
level with the losses and the gradients of one train step, and the decode
of a flagship and a real-time batch.

The bound. Each comparison holds the port's bf16 result against JAX's bf16
result on the same inputs, relative to how far JAX's own bf16 graph lies
from its f32 graph on those inputs (its "drift"):
||port_bf16 - jax_bf16|| <= ||jax_bf16 - jax_f32||, in the 2-norm of each
output, level or gradient tensor, unless another bound is stated. The
2-norm and not the largest element: two bf16 graphs that round at the same
points but sum in another order round a value near a rounding boundary to
neighbouring bf16 numbers, and such single elements may sit further apart
than the drift's largest element while the whole tensor sits well inside
it (measured on the head's levels before K1's rounding was matched: up to
1.9x in the largest element, at most 0.8x in the 2-norm). Tighter bounds
are stated where the port rounds where JAX rounds (the FPN, the head but
its basis masks) or where the drift is zero (f32 sums of the same values).

Gradients, and the detections end to end, get sqrt(2) and 2 drifts. Their
differences start as the same single flipped roundings and grow through a
backward pass (or the whole network and a top-k with NMS) into rounding
noise of the drift's own size that is no longer correlated with JAX's:
two such bf16 runs lie sqrt(2) drifts apart when their errors against f32
are independent and equally large, and a bound of one drift would fail on
a fair run about as often as it passes (measured 2-norm ratios: the 88
parameter gradients up to 1.22, median 0.47; sorted detection scores
1.10-1.49).

The modules are compared on common inputs, each fed JAX's bf16 output of
the module before it (and, backward, JAX's bf16 cotangent of the module
after it), so that every comparison sees one module's rounding: chained
through the 16 blocks of the backbone, rounding differences that start as
single flipped elements grow to the size of the drift itself (a 2-norm
ratio of 1.05 at C5 measured from images), and the 2x1 P7 maps then tip
GroupNorm's single-pass variance one way or the other.

XLA on the CPU keeps f32 values where a bf16 program rounds (its
``xla_allow_excess_precision``, on by default): a conv's f32 sum reaches the
GroupNorm after it unrounded. Every JAX function here is compiled with that
off, so that the JAX package rounds where its code casts, as the port does.

Rounding points that differ by design: JAX's CPU sampling (``sample_ref``)
rounds each bilinear weight, corner product and partial sum to bf16, K1 and
its plain version interpolate in f32 and round once (the port's kernel's
arithmetic). ``test_k1_plain_bf16_matches_jax_sampling`` holds that
design; the model comparisons give the port's plain K1 sample_ref's
roundings (:func:`sample_ref_rounding`), so that they see the rest of the
graph's (unpatched, the FeatureAlign branch's outputs carry K1's more
accurate values: 1.8 drifts on a GroupNorm bias's gradient behind it).
"""

import contextlib
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import bumped_state_dict, jax_variables, nhwc, shrunk_cfg
from sipmask_tpu.config import _r, get_config
from sipmask_tpu.models import build_model as j_build_model
from sipmask_tpu.models.decode import decode_batch as j_decode_batch
from sipmask_tpu.models.layers import group_norm_nhwc, relu as j_relu
from sipmask_tpu.models.loss import compute_losses as j_compute_losses
from sipmask_tpu.models.resnet import STAGE_BLOCKS, Bottleneck
from sipmask_tpu.ops.deform_conv import _sample_positions
from sipmask_tpu.ops.deform_conv import deform_conv2d as j_deform_conv2d
from sipmask_tpu.ops.pallas.deform_gather import sample_ref
from sipmask_tpu_torch.apis.inference import init_detector
from sipmask_tpu_torch.models.decode import decode_batch
from sipmask_tpu_torch.models.detector import build_model
from sipmask_tpu_torch.models.loss import compute_losses
from sipmask_tpu_torch.ops import deform_conv, deform_sample, gn_relu
from sipmask_tpu_torch.train import create_train_state, make_train_step
from sipmask_tpu_torch.utils.convert import grads_from_jax, params_from_jax
from sipmask_tpu_torch.utils.demo_inputs import batch_to_tensors, demo_batch

BF = torch.bfloat16
STRICT = {"xla_allow_excess_precision": False}
ULP = 2.0 ** -7   # one bf16 unit, relative to the top of its binade
GRAD_BOUND = 2 ** 0.5    # drifts: gradients (the module note)
DETECTION_BOUND = 2.0    # drifts: sorted detection scores end to end
MAX_POS = 16
IMG_SHAPES = np.array([[120.0, 160.0], [128.0, 150.0]], np.float32)
SCALES = np.array([[1.0] * 4, [0.8] * 4], np.float32)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread while this module runs (see
    tests/test_torch_vis.py: six workers' OpenMP pools spin against each
    other)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def strict(fn, *args):
    """``fn(*args)`` compiled by XLA with no excess precision."""
    return jax.jit(fn).lower(*args).compile(STRICT)(*args)


def f32(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def to_torch(a, dtype=BF):
    """A JAX NHWC array -> an NCHW torch tensor in ``dtype``."""
    return torch.from_numpy(np.ascontiguousarray(
        f32(a).transpose(0, 3, 1, 2))).to(dtype)


def norm_ratio(got, want16, want32):
    """||got - want16|| / ||want16 - want32||, arrays of one layout."""
    got, w16, w32 = (np.asarray(a, np.float64) for a in (got, want16, want32))
    assert got.shape == w16.shape == w32.shape, (got.shape, w16.shape)
    drift = np.linalg.norm(w16 - w32)
    err = np.linalg.norm(got - w16)
    return err / drift if drift > 0 else (0.0 if err == 0 else np.inf)


def assert_within_drift(got, want16, want32, what, bound=1.0):
    r = norm_ratio(got, want16, want32)
    assert r <= bound, f"{what}: ||port - jax_bf16|| is {r:.3f} of the " \
                       f"drift (bound {bound})"


@contextlib.contextmanager
def sample_ref_rounding():
    """Within the context, the port's plain K1 rounds a bf16 x's samples
    as JAX's CPU path does (``sample_ref`` in bf16): each corner's weight,
    product and partial sum rounded to bf16."""
    real = deform_sample.deform_im2col_plain

    def patched(x, offsets, kernel_size=(3, 3), stride=1, padding=1,
                dilation=1, deform_groups=1):
        if x.dtype != BF:
            return real(x, offsets, kernel_size, stride, padding, dilation,
                        deform_groups)
        kh, kw = kernel_size
        b, c, h, w, g, k, ho, wo = deform_sample._check(
            x, offsets, kh, kw, stride, padding, dilation, deform_groups)
        cg, p = c // g, ho * wo
        py, px = deform_sample.sample_positions(offsets, kh, kw, stride,
                                                padding, dilation, g)
        y0, x0 = torch.floor(py), torch.floor(px)
        xg = x.reshape(b, g, cg, h * w)
        out = torch.zeros((b, g, cg, k, p), dtype=BF)
        for dy in (0, 1):
            for dx in (0, 1):
                yy, xx = y0 + dy, x0 + dx
                wgt = ((py - y0 if dy else 1.0 - (py - y0)) *
                       (px - x0 if dx else 1.0 - (px - x0)))
                inb = (yy >= 0) & (yy <= h - 1) & (xx >= 0) & (xx <= w - 1)
                qi = (yy.clamp(0, h - 1) * w + xx.clamp(0, w - 1)).long()
                v = torch.gather(xg, 3, qi.reshape(b, g, 1, k * p)
                                 .expand(b, g, cg, k * p))
                out = out + v.reshape(b, g, cg, k, p) * (wgt * inb).to(
                    BF).reshape(b, g, 1, k, p)
        return out.permute(0, 1, 3, 2, 4).reshape(b, g * k * cg, p)
    deform_sample.deform_im2col_plain = patched
    try:
        yield
    finally:
        deform_sample.deform_im2col_plain = real


def cfgs():
    cfg = _r(shrunk_cfg(), "train", max_pos=MAX_POS)
    return cfg, _r(cfg, "model", compute_dtype="bfloat16")


# ------------------------------------------------- the kernels' plain versions

def _k1_inputs(seed=3, b=2, c=32, h=16, w=20, g=4):
    rng = np.random.RandomState(seed)
    x = rng.randn(b, c, h, w).astype(np.float32)
    off = (rng.randn(b, g * 18, h, w) * 2).astype(np.float32)
    off[:, :, :3] *= 20      # some taps far outside the map
    return x, off


def test_k1_plain_bf16_matches_jax_sampling():
    """K1's plain bf16 version against ``sample_ref`` (JAX's CPU sampling)
    in bf16, within JAX's bf16-vs-f32 drift; tighter: it equals JAX's f32
    sampling of the same bf16 values rounded once to bf16."""
    x, off = _k1_inputs()
    b, c, h, w = x.shape
    g, cg = 4, c // 4
    xb = torch.from_numpy(x).to(BF)
    got = deform_sample.deform_im2col_plain(
        xb, torch.from_numpy(off), (3, 3), 1, 1, 1, g)
    assert got.dtype == BF and tuple(got.shape) == (b, g * 9 * cg, h * w)
    pyx = _sample_positions(jnp.asarray(off.transpose(0, 2, 3, 1)), 3, 3, 1,
                            1, 1, g)

    def jax_cols(xr):      # (B, C, H, W) -> cols (B, G*K*Cg, P) like K1's
        rows = xr.reshape(b, g, cg, h * w).transpose(0, 1, 3, 2).reshape(
            b * g, h * w, cg)
        s = sample_ref(rows, pyx, h, w)          # (N, P, K, Cg)
        return s.reshape(b, g, h * w, 9, cg).transpose(0, 1, 3, 4, 2
                                                       ).reshape(b, -1, h * w)
    x16 = jnp.asarray(x).astype(jnp.bfloat16)
    j16 = f32(strict(jax_cols, x16))
    j32 = f32(strict(jax_cols, jnp.asarray(x)))
    once = f32(strict(jax_cols, x16.astype(jnp.float32)).astype(jnp.bfloat16))
    assert_within_drift(got.float().numpy(), j16, j32, "K1 cols")
    np.testing.assert_allclose(got.float().numpy(), once, rtol=0,
                               atol=ULP * np.abs(once).max())


def test_k2_plain_bf16_matches_jax_backward():
    """K2's plain bf16 version (dx bf16, d offsets and d w2 f32) against
    the VJP of the JAX package's bf16 deformable conv on the CPU: dx within
    the drift, the gradients of the offsets and the weight within sqrt(2)
    drifts (the module note; K1's cols, rounded once, enter both)."""
    x, off = _k1_inputs(seed=4)
    b, c, h, w = x.shape
    rng = np.random.RandomState(5)
    wt = (rng.randn(3, 3, c, 24) * 0.05).astype(np.float32)      # HWIO
    dy = rng.randn(b, h, w, 24).astype(np.float32)
    x16 = jnp.asarray(x.transpose(0, 2, 3, 1)).astype(jnp.bfloat16)
    w16 = jnp.asarray(wt).astype(jnp.bfloat16)
    dy16 = jnp.asarray(dy).astype(jnp.bfloat16)
    offj = jnp.asarray(off.transpose(0, 2, 3, 1))

    def vjp(xx, oo, ww, ct):
        _, f = jax.vjp(lambda a, o, k: j_deform_conv2d(
            a, o, k, padding=1, deform_groups=4), xx, oo, ww)
        return f(ct)
    j16 = strict(vjp, x16, offj, w16, dy16)
    j32 = strict(vjp, x16.astype(jnp.float32), offj, w16.astype(jnp.float32),
                 dy16.astype(jnp.float32))
    weight = torch.from_numpy(f32(w16).transpose(3, 2, 0, 1).copy()).to(BF)
    dx, doff, dw2 = deform_conv.deform_conv_backward_plain(
        to_torch(x16), torch.from_numpy(off), deform_conv._w2(weight, 4),
        to_torch(dy16), (3, 3), 1, 1, 1, 4)
    assert (dx.dtype, doff.dtype, dw2.dtype) == (BF, torch.float32,
                                                 torch.float32)
    # d w2 (O, G*K*Cg) back to HWIO; JAX's weight is bf16, so its
    # gradient is rounded to bf16 once, as the port's model rounds K2's f32
    # d w2 where the f32 weight was cast (autograd's cast of a gradient to
    # its input's dtype)
    dw = dw2.to(BF).float().reshape(24, 4, 9, c // 4).permute(
        2, 1, 3, 0).reshape(3, 3, c, 24)
    for name, got, k, bound in (("dx", nhwc(dx.float()), 0, 1.0),
                                ("d offsets", nhwc(doff), 1, GRAD_BOUND),
                                ("d weight", dw.numpy(), 2, GRAD_BOUND)):
        assert_within_drift(got, f32(j16[k]), f32(j32[k]), f"K2 {name}",
                            bound)


def _k4_inputs(seed=6, b=2, c=32, h=12, w=10):
    rng = np.random.RandomState(seed)
    x = (rng.randn(b, h, w, c) * 3 + 1).astype(np.float32)
    wt = (rng.rand(c) + 0.5).astype(np.float32)
    bs = (rng.randn(c) * 0.2).astype(np.float32)
    dy = rng.randn(b, h, w, c).astype(np.float32)
    return (jnp.asarray(x).astype(jnp.bfloat16), wt, bs,
            jnp.asarray(dy).astype(jnp.bfloat16))


@pytest.mark.parametrize("act", [True, False])
def test_k4a_plain_bf16_matches_jax_group_norm(act):
    """K4a's plain bf16 version against ``group_norm_nhwc`` (+ ReLU) in
    bf16: f32 statistics, y rounded once. Tighter than the drift: within
    one bf16 unit of y's max."""
    x16, wt, bs, _ = _k4_inputs()

    def gn(x):
        y = group_norm_nhwc(x, jnp.asarray(wt), jnp.asarray(bs), 8, 1e-5)
        return j_relu(y) if act else y
    want = f32(strict(gn, x16))
    want32 = f32(strict(gn, x16.astype(jnp.float32)))
    got = gn_relu.gn_relu_plain(to_torch(x16), torch.from_numpy(wt),
                                torch.from_numpy(bs), 8, 1e-5, act)
    assert got.dtype == BF
    got = nhwc(got.float())
    assert_within_drift(got, want, want32, "K4a y")
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=ULP * np.abs(want).max())


@pytest.mark.parametrize("act", [True, False])
def test_k4b_plain_bf16_matches_jax_group_norm_vjp(act):
    """K4b's plain bf16 version (dx bf16, d weight and d bias f32) against
    the VJP of ``group_norm_nhwc`` (+ ReLU) in bf16: dx within the drift;
    d weight and d bias are f32 sums of the same bf16 values in both (a
    drift of 0): within 1e-5 of their max."""
    x16, wt, bs, dy16 = _k4_inputs(seed=7)

    def vjp(x, s, b_, ct):
        def f(a, ss, bb):
            y = group_norm_nhwc(a, ss, bb, 8, 1e-5)
            return j_relu(y) if act else y
        return jax.vjp(f, x, s, b_)[1](ct)
    j16 = strict(vjp, x16, jnp.asarray(wt), jnp.asarray(bs), dy16)
    j32 = strict(vjp, x16.astype(jnp.float32), jnp.asarray(wt),
                 jnp.asarray(bs), dy16.astype(jnp.float32))
    xt = to_torch(x16)
    w_t, b_t = torch.from_numpy(wt), torch.from_numpy(bs)
    _, stats = gn_relu.gn_relu_forward(xt, w_t, b_t, 8, 1e-5, act)
    dx, dwt, dbs = gn_relu.gn_relu_backward_plain(xt, w_t, b_t, stats,
                                                  to_torch(dy16), 8, act)
    assert (dx.dtype, dwt.dtype) == (BF, torch.float32)
    assert_within_drift(nhwc(dx.float()), f32(j16[0]), f32(j32[0]),
                        "K4b dx")
    for name, got, k in (("d weight", dwt, 1), ("d bias", dbs, 2)):
        want = f32(j16[k])
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1e-5 * np.abs(want).max(),
                                   err_msg=name)


# ------------------------------------------------------- the model, by module

def _stage_fn(jm_dtype, s, variables):
    """The JAX ResNet's stage s (1-based) as a function of (params of its
    blocks, x), in ``jm_dtype``."""
    blocks = []
    for i in range(STAGE_BLOCKS[50][s - 1]):
        name = f"layer{s}_{i}"
        blocks.append((name, Bottleneck(64 * 2 ** (s - 1),
                                        stride=2 if i == 0 else 1,
                                        downsample=i == 0, dtype=jm_dtype)))
    consts = variables["constants"]["backbone"]

    def run(params, x):
        for name, blk in blocks:
            x = blk.apply({"params": params[name], "constants": consts[name]},
                          x)
        return x
    return run, [name for name, _ in blocks]


def _vjp_both(fn16, fn32, params, x16, ct16):
    """(outputs, (d params, d x)) of fn16 on bf16 inputs and cotangents, and
    of fn32 on their f32 upcasts (the drift's reference)."""
    def vjp(fn):
        def run(p, x, ct):
            out, f = jax.vjp(fn, p, x)
            return out, f(ct)
        return run
    up = lambda t: jax.tree_util.tree_map(lambda a: a.astype(jnp.float32), t)
    return (strict(vjp(fn16), params, x16, ct16),
            strict(vjp(fn32), params, up(x16), up(ct16)))


@pytest.fixture(scope="module")
def chain():
    """JAX's bf16 graph of one train step module by module, with the f32
    graph beside each module on the same inputs, and the port's bf16
    modules on the same inputs and cotangents."""
    cfg, cfg16 = cfgs()
    sd = bumped_state_dict(build_model(cfg.model))
    var = jax_variables(sd)
    batch = demo_batch(batch_size=2, height=128, width=160, max_gts=8,
                       seed=7)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jm16, jm32 = j_build_model(cfg16.model), j_build_model(cfg.model)
    P = var["params"]

    def method(jm, fn):
        return lambda p, *a: jm.apply(
            {"params": p, "constants": var["constants"]}, *a, method=fn)
    # forward: C2..C5 from the images, P3..P7 from JAX's bf16 C
    bb16 = method(jm16, lambda m, x: m.backbone(x))
    c16 = strict(bb16, P, jb["images"])
    c32 = strict(method(jm32, lambda m, x: m.backbone(x)), P, jb["images"])
    neck16 = method(jm16, lambda m, c: m.neck(c))
    neck32 = method(jm32, lambda m, c: m.neck(c))
    p16 = strict(neck16, P, c16)
    # the loss on JAX's bf16 head outputs: values and cotangents
    head16 = method(jm16, lambda m, f: m.head(f))
    head32 = method(jm32, lambda m, f: m.head(f))
    h16 = strict(head16, P, p16)

    def loss(out):
        losses = j_compute_losses(out, jb, cfg.model.head, max_pos=MAX_POS)
        return sum(losses.values()), losses
    (_, jlosses), dh16 = strict(jax.value_and_grad(loss, has_aux=True), h16)
    # backward, module by module, each on JAX's bf16 cotangent
    head = _vjp_both(head16, head32, P, p16, dh16)
    neck = _vjp_both(neck16, neck32, P, c16, head[0][1][1])
    dc16 = neck[0][1][1]
    stages = {}
    for s in (2, 3, 4):
        run16, names = _stage_fn(jnp.bfloat16, s, var)
        run32, _ = _stage_fn(jnp.float32, s, var)
        sub = {n: P["backbone"][n] for n in names}
        stages[s] = _vjp_both(run16, run32, sub, c16[s - 2], dc16[s - 1])

    model = build_model(cfg16.model)
    model.load_state_dict(params_from_jax(var["params"], var["constants"]))
    return dict(cfg=cfg16, var=var, batch=batch, model=model, c16=c16,
                c32=c32, p16=p16, h16=h16, dh16=dh16, jlosses=jlosses,
                head=head, neck=neck, stages=stages)


def _port_vjp(module_fn, params, inputs, cots):
    """Run ``module_fn(inputs)`` (leaf bf16 tensors) and backpropagate
    ``cots``; returns (outputs, {param name: grad}, input grads)."""
    for p in params.values():
        p.grad = None
    ins = [t.detach().requires_grad_(True) for t in inputs]
    outs = module_fn(ins)
    pairs = [(o, c) for o, c in zip(outs, cots) if c is not None]
    torch.autograd.backward([o for o, _ in pairs], [c for _, c in pairs])
    return outs, {n: p.grad for n, p in params.items()
                  if p.grad is not None}, [t.grad for t in ins]


def _head_flat(out):
    """(key, level, tensor) of a head output dict, levels in order."""
    for key in ("cls_scores", "bbox_preds", "centernesses", "cof_preds",
                "feat_masks"):
        vals = out[key] if isinstance(out[key], (list, tuple)) else \
            [out[key]]
        for lvl, t in enumerate(vals):
            yield key, lvl, t


@pytest.fixture(scope="module")
def port_chain(chain):
    """The port's bf16 modules on JAX's bf16 inputs and cotangents."""
    m, c = chain["model"], chain
    named = dict(m.named_parameters())
    # head
    j_out = list(_head_flat(c["h16"]))
    j_ct = list(_head_flat(c["dh16"]))

    def head_fn(ins):
        out = m.bbox_head(ins)
        return [t for _, _, t in _head_flat(out)]
    cots = [to_torch(ct, torch.float32 if key == "bbox_preds" else BF)
            for key, _, ct in j_ct]
    with sample_ref_rounding():
        h_out, h_grads, h_dp = _port_vjp(
            head_fn, {n: p for n, p in named.items()
                      if n.startswith("bbox_head.")},
            [to_torch(a) for a in c["p16"]], cots)
    # neck, on JAX's cotangent of the head's inputs
    n_out, n_grads, n_dc = _port_vjp(
        lambda ins: list(m.neck(ins)),
        {n: p for n, p in named.items() if n.startswith("neck.")},
        [to_torch(a) for a in c["c16"]],
        [to_torch(a) for a in c["head"][0][1][1]])
    # the backbone's trainable stages, on JAX's cotangent of the neck's
    # inputs
    stages = {}
    for s in (2, 3, 4):
        layer = getattr(m.backbone, f"layer{s}")
        stages[s] = _port_vjp(
            lambda ins, layer=layer: [layer(ins[0])],
            {n: p for n, p in named.items()
             if n.startswith(f"backbone.layer{s}.")},
            [to_torch(c["c16"][s - 2])],
            [to_torch(c["neck"][0][1][1][s - 1])])
    with torch.no_grad():
        c2 = m.backbone(torch.from_numpy(np.ascontiguousarray(
            c["batch"]["images"].transpose(0, 3, 1, 2))))[0]
    return dict(head=(h_out, h_grads, h_dp), neck=(n_out, n_grads, n_dc),
                stages=stages, c2=c2, j_out=j_out)


def test_bf16_model_dtypes(chain):
    """f32 parameters; bf16 activations; bbox_preds upcast to f32."""
    m = chain["model"]
    assert all(p.dtype == torch.float32 for p in m.parameters())
    with torch.no_grad():
        out = m(torch.from_numpy(np.ascontiguousarray(
            chain["batch"]["images"].transpose(0, 3, 1, 2))))
    for key, _, t in _head_flat(out):
        assert t.dtype == (torch.float32 if key == "bbox_preds" else BF), key


def test_backbone_levels_match_jax_bf16(chain, port_chain):
    """C2 from the images; C3..C5 each from JAX's bf16 level before it."""
    c = chain
    assert port_chain["c2"].dtype == BF
    assert_within_drift(nhwc(port_chain["c2"].float()), f32(c["c16"][0]),
                        f32(c["c32"][0]), "C2")
    for s in (2, 3, 4):
        (j16, _), (j32, _) = c["stages"][s]
        got = port_chain["stages"][s][0][0]
        assert got.dtype == BF
        assert_within_drift(nhwc(got.float()), f32(j16), f32(j32),
                            f"C{s + 1}")


def test_fpn_levels_match_jax_bf16(chain, port_chain):
    """P3..P7 from JAX's bf16 C3..C5. Tighter: the FPN adds its biases
    after the conv as JAX does, so it rounds where JAX rounds (measured
    equal bits but for a few elements): within a tenth of the drift."""
    (j16, _), (j32, _) = chain["neck"]
    got = port_chain["neck"][0]
    for lvl in range(5):
        assert got[lvl].dtype == BF
        assert_within_drift(nhwc(got[lvl].float()), f32(j16[lvl]),
                            f32(j32[lvl]), f"P{lvl + 3}", bound=0.1)


# with K1 rounding as sample_ref does, the head rounds where JAX rounds
# (measured: equal bits but for cls_scores and cof_preds at P3 and P4, 0.07
# to 0.11 drifts); the basis masks' bilinear upsampling rounds once in
# F.interpolate and after each axis in jax.image.resize (0.61 drifts)
HEAD_BOUND = {"feat_masks": 1.0}


@pytest.mark.parametrize("key", ["cls_scores", "bbox_preds", "centernesses",
                                 "cof_preds", "feat_masks"])
def test_head_outputs_match_jax_bf16(chain, port_chain, key):
    """Each head output, level by level, from JAX's bf16 P3..P7."""
    (j16, _), (j32, _) = chain["head"]
    j16 = {(k, lvl): a for k, lvl, a in _head_flat(j16)}
    j32 = {(k, lvl): a for k, lvl, a in _head_flat(j32)}
    got = port_chain["head"][0]
    for (k, lvl, _), t in zip(port_chain["j_out"], got):
        if k != key:
            continue
        assert_within_drift(nhwc(t.float()), f32(j16[k, lvl]),
                            f32(j32[k, lvl]), f"{k}[{lvl}]",
                            HEAD_BOUND.get(k, 0.25))


def test_losses_and_head_cotangents_match_jax(chain):
    """The loss on JAX's bf16 head outputs: the port upcasts every output
    as JAX does, so the losses are the f32 losses of the same values
    (rtol 1e-4, as tests/test_torch_train.py) and their cotangents, rounded
    to the outputs' bf16, within one bf16 unit of each one's max."""
    c = chain
    outs = {}
    for key, lvl, a in _head_flat(c["h16"]):
        t = to_torch(a, torch.float32 if key == "bbox_preds" else BF)
        outs.setdefault(key, []).append(t.requires_grad_(True))
    outs["feat_masks"] = outs["feat_masks"][0]
    tb = batch_to_tensors(c["batch"])
    losses = compute_losses(outs, tb, c["cfg"].model.head, max_pos=MAX_POS)
    assert float(losses["loss_mask"]) > 0
    for k, v in losses.items():
        np.testing.assert_allclose(float(v), float(c["jlosses"][k]),
                                   rtol=1e-4, atol=1e-6, err_msg=k)
    sum(losses.values()).backward()
    got = [t for _, _, t in _head_flat({k: v for k, v in outs.items()})]
    for (key, lvl, want), t in zip(_head_flat(c["dh16"]), got):
        g = nhwc(t.grad.float())
        w = f32(want)
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=ULP * max(np.abs(w).max(), 1e-30),
                                   err_msg=f"{key}[{lvl}]")


def _grads_close(got, j16_params, j32_params, prefix, what):
    want16, want32 = grads_from_jax(j16_params), grads_from_jax(j32_params)
    names = [n for n in got if n.startswith(prefix)]
    assert names
    for n in names:
        assert got[n].dtype == torch.float32, n
        assert_within_drift(got[n].numpy(), want16[n].numpy(),
                            want32[n].numpy(), f"{what} gradient of {n}",
                            GRAD_BOUND)


@pytest.mark.parametrize("module", ["head", "neck", "backbone"])
def test_gradients_match_jax_bf16(chain, port_chain, module):
    """One train step's parameter gradients (f32, through the casts), each
    module on JAX's bf16 inputs and cotangents; and the gradient each
    passes to the module before it."""
    c, pc = chain, port_chain
    if module == "backbone":
        for s in (2, 3, 4):
            (_, (g16, _)), (_, (g32, _)) = c["stages"][s]
            _grads_close(pc["stages"][s][1], {"backbone": g16},
                         {"backbone": g32}, f"backbone.layer{s}.",
                         "backbone")
        return
    (_, (g16, dx16)), (_, (g32, dx32)) = c[module]
    _grads_close(pc[module][1], g16, g32,
                 "bbox_head." if module == "head" else "neck.", module)
    for lvl, (got, w16, w32) in enumerate(zip(pc[module][2], dx16, dx32)):
        if module == "neck" and lvl == 0:
            continue               # C2 feeds nothing (start_level 1)
        assert got.dtype == BF
        assert_within_drift(nhwc(got.float()), f32(w16), f32(w32),
                            f"{module}'s input gradient [{lvl}]", GRAD_BOUND)


# -------------------------------------------------------- decode and serving

def test_decode_upcasts_bf16_head_outputs(chain):
    """The same bf16 head outputs into both decodes: each upcasts every
    output to f32 first, so the detections are the f32 decode's (the
    tolerances of tests/test_torch_slice.py)."""
    c = chain
    nchw = {}
    for key, lvl, a in _head_flat(c["h16"]):
        nchw.setdefault(key, []).append(
            to_torch(a, torch.float32 if key == "bbox_preds" else BF))
    nchw["feat_masks"] = nchw["feat_masks"][0]
    cfg = c["cfg"]
    want = jax.tree_util.tree_map(np.asarray, strict(
        lambda o: j_decode_batch(o, jnp.asarray(IMG_SHAPES),
                                 jnp.asarray(SCALES), cfg.model), c["h16"]))
    got = decode_batch(nchw, torch.from_numpy(IMG_SHAPES),
                       torch.from_numpy(SCALES), cfg.model)
    v = want["valid"]
    assert v.sum() > 0
    np.testing.assert_array_equal(got["valid"].numpy(), v)
    np.testing.assert_array_equal(got["labels"].numpy()[v],
                                  want["labels"][v])
    np.testing.assert_allclose(got["scores"].numpy(), want["scores"],
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(got["boxes"].numpy(), want["boxes"], rtol=0,
                               atol=1e-3)
    np.testing.assert_allclose(got["masks"].numpy(), want["masks"], rtol=0,
                               atol=1e-4)


def _rt_cfgs():
    cfg = get_config("sipmask_r50_fpn_ssd_6x")
    cfg = _r(cfg, "model.fpn", out_channels=32)
    cfg = _r(cfg, "model.head", in_channels=32, feat_channels=32)
    cfg = _r(cfg, "data", fixed_size=(128, 128))
    return cfg, _r(cfg, "model", compute_dtype="bfloat16")


def _sorted_scores(d, i):
    return np.sort(d["scores"][i][d["valid"][i]])[::-1]


@pytest.mark.parametrize("preset", ["flagship", "realtime"])
def test_detector_infer_matches_jax_bf16(preset):
    """``Detector.infer`` in bf16 end to end against the JAX package's
    bf16 model and decode on the same weights and images: as many
    detections, and each image's detection scores, sorted (which the NMS's
    choices among ~100 near-equal random-weight scores cannot reorder),
    within DETECTION_BOUND drifts of JAX's bf16 run's."""
    if preset == "flagship":
        cfg, cfg16 = cfgs()
        hw, shapes, scales = (128, 160), IMG_SHAPES, SCALES
    else:
        cfg, cfg16 = _rt_cfgs()
        hw = (128, 128)
        shapes = np.array([[128.0, 128.0]] * 2, np.float32)
        scales = np.array([[0.2, 0.3, 0.2, 0.3]] * 2, np.float32)
    det = init_detector(cfg16, "cpu", seed=2)
    sd = bumped_state_dict(det.model)
    var = jax_variables(sd)
    det.model.load_state_dict(params_from_jax(var["params"],
                                              var["constants"]))
    rng = np.random.RandomState(9)
    x = (rng.rand(2, *hw, 3) * 255 - 115).astype(np.float32)

    def run(c):
        jm = j_build_model(c.model)
        return jax.tree_util.tree_map(np.asarray, strict(
            lambda v, im: j_decode_batch(jm.apply(v, im), jnp.asarray(shapes),
                                         jnp.asarray(scales), c.model),
            var, jnp.asarray(x)))
    j16, j32 = run(cfg16), run(cfg)
    with sample_ref_rounding():
        got = det.infer(torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(),
                        torch.from_numpy(shapes), torch.from_numpy(scales))
    got = {k: v.numpy() for k, v in got.items()}
    assert np.isfinite(got["boxes"]).all() and np.isfinite(got["masks"]).all()
    np.testing.assert_array_equal(got["valid"].sum(1), j16["valid"].sum(1))
    for i in range(x.shape[0]):
        assert got["valid"][i].sum() > 0
        assert_within_drift(_sorted_scores(got, i), _sorted_scores(j16, i),
                            _sorted_scores(j32, i),
                            f"{preset} image {i}'s sorted scores",
                            DETECTION_BOUND)


# ------------------------------------------------------------------ training

def test_bf16_train_step_runs_in_f32_params():
    """``make_train_step`` on the bf16 flagship: gradients reach the f32
    parameters through the casts, the losses are finite and move, the
    frozen stages stay."""
    _, cfg16 = cfgs()
    state = create_train_state(cfg16, "cpu", seed=0)
    bumped_state_dict(state.model)
    frozen = {n: p.detach().clone() for n, p in
              state.model.named_parameters() if not p.requires_grad}
    step = make_train_step(state, cfg16)
    batch = batch_to_tensors(demo_batch(batch_size=2, height=128, width=160,
                                        max_gts=8, seed=7))
    m0, m1 = step(batch), step(batch)
    for m in (m0, m1):
        assert all(np.isfinite(float(v)) for v in m.values())
    assert float(m0["loss_mask"]) > 0
    assert float(m1["loss_total"]) != float(m0["loss_total"])
    for n, p in state.model.named_parameters():
        assert p.dtype == torch.float32
        if p.requires_grad:
            assert p.grad.dtype == torch.float32, n
        else:
            assert torch.equal(p.detach(), frozen[n]), n


def test_bf16_presets_build_and_the_rest_refuse():
    """bf16 builds all four families with f32 parameters: the flagship,
    the real-time preset, SipMask++ (DCN stages, rescoring) and
    SipMask-VIS (the track branch; its multi-scale variant too). ResNeXt
    groups and HRNet, which the port does not run in any dtype, still
    refuse it."""
    for name in ("sipmask_r50_fpn_gn_1x", "sipmask_r50_fpn_ssd_6x",
                 "sipmaskpp_r101_fpn_ssd_6x", "sipmask_vis_r50",
                 "sipmask_vis_r50_ms"):
        m = build_model(_r(get_config(name), "model",
                           compute_dtype="bfloat16").model)
        assert m.backbone.dtype == m.bbox_head.dtype == BF, name
        assert all(p.dtype == torch.float32 for p in m.parameters()), name
    dcn = build_model(_r(get_config("sipmaskpp_r101_fpn_ssd_6x"), "model",
                         compute_dtype="bfloat16").model)
    assert dcn.backbone.layer3[0].conv2.dtype == BF
    for name in ("sipmask_x101_fpn_gn_ms_2x", "sipmask_hrnet_w32_fpn_gn_1x"):
        with pytest.raises(NotImplementedError, match="ResNeXt"):
            build_model(_r(get_config(name), "model",
                           compute_dtype="bfloat16").model)



def test_train_and_test_clis_take_bf16_from_cfg_options(tmp_path):
    """tools/train.py for 2 steps and tools/test.py on its checkpoint, both
    with ``--cfg-options model.compute_dtype=bfloat16`` and no other
    argument for it: finite losses, f32 checkpoints, bbox and segm stats."""
    from sipmask_tpu_torch.tools import test as test_cli
    from sipmask_tpu_torch.tools import train as train_cli
    from sipmask_tpu_torch.tools.synth_coco import make_dataset
    from sipmask_tpu_torch.utils.checkpoint import latest_checkpoint
    ann, images = make_dataset(str(tmp_path / "synth"),
                               sizes=((160, 120), (150, 100)), repeat=1,
                               min_objs=3, max_objs=5, seed=3)
    shrink = ["model.fpn.out_channels=32", "model.head.in_channels=32",
              "model.head.feat_channels=32", "model.head.stacked_convs=2",
              "data.img_scale=(160,128)", "data.max_gts=8",
              "data.num_workers=1", "train.imgs_per_device=2",
              "train.max_pos=16", "train.log_interval=1",
              "model.compute_dtype=bfloat16"]
    wd = str(tmp_path / "wd")
    state = train_cli.main(["sipmask_r50_fpn_gn_1x", "--ann", ann,
                            "--img-prefix", images, "--work-dir", wd,
                            "--max-steps", "2", "--device", "cpu",
                            "--cfg-options", *shrink])
    assert state.step == 2 and state.model.backbone.dtype == BF
    with open(f"{wd}/train.log.json") as f:
        rows = [r for r in map(json.loads, f) if "loss_total" in r]
    assert rows and all(np.isfinite(r["loss_total"]) for r in rows)
    ckpt = torch.load(latest_checkpoint(wd), map_location="cpu")
    sd = ckpt.get("state_dict", ckpt)
    assert all(v.dtype != BF for v in sd.values() if torch.is_tensor(v))
    stats = test_cli.main(["sipmask_r50_fpn_gn_1x", latest_checkpoint(wd),
                           "--ann", ann, "--img-prefix", images,
                           "--batch-size", "2", "--device", "cpu",
                           "--cfg-options", *shrink])
    assert set(stats) == {"bbox", "segm"}
