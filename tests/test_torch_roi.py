"""The port's RoI ops (sipmask_tpu_torch/ops/roi.py) against the JAX
package's, on the CPU: the same numpy inputs through both, values and the
gradients of a random cotangent with respect to every input.

Tolerances: roi_align, grid_sample, carafe, masked_conv2d and
deform_roi_pool within 1e-5 (rtol and atol), at sample points off the
integer grid; roi_pool exact, its gradient too, on ReLU'd features full of
ties; the deformable RoI-pooling packs, with random non-zero last layers,
within 1e-5 in their outputs and the gradients to the features and to every
FC weight.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from sipmask_tpu.ops import roi as jroi
from sipmask_tpu_torch.ops import roi
from sipmask_tpu_torch.utils.convert import grads_from_jax, params_from_jax

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread while this module runs (tests/test_torch_vis.py:
    six workers' OpenMP pools spin against each other)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def nchw(a):
    return np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2))


def leaf(a):
    return torch.tensor(np.asarray(a), requires_grad=True)


def jax_vjp(fn, args, ct):
    """fn(*args) and the cotangent ``ct``'s gradients, numpy (one compiled
    program: XLA compiles it faster than JAX dispatches the ops)."""
    def run(args, ct):
        out, vjp = jax.vjp(fn, *args)
        return out, vjp(ct)
    out, grads = jax.jit(run)(jax.tree_util.tree_map(jnp.asarray, args),
                              jnp.asarray(ct))
    return jax.tree_util.tree_map(np.asarray, (out, grads))


def port_vjp(fn, args, ct):
    leaves = [leaf(a) for a in args]
    out = fn(*leaves)
    out.backward(torch.from_numpy(np.ascontiguousarray(ct)))
    return out.detach().numpy(), [
        np.zeros(t.shape, np.float32) if t.grad is None else t.grad.numpy()
        for t in leaves]


ROIS = np.array([[0, 2.3, 1.7, 17.9, 13.2],
                 [1, -6.1, 3.4, 31.3, 29.8],     # past the image
                 [0, 9.6, 8.1, 10.2, 8.9],       # smaller than a pixel
                 [1, 20.2, 0.4, 27.7, 22.1]], np.float32)


@pytest.mark.parametrize("aligned", [False, True])
def test_roi_align_matches_jax(aligned):
    rng = np.random.RandomState(0)
    feats = rng.randn(2, 12, 14, 5).astype(np.float32)
    ct = rng.randn(4, 3, 3, 5).astype(np.float32)
    want, (wf, wr) = jax_vjp(lambda f, r: jroi.roi_align(
        f, r, 3, 0.5, sample_num=2, aligned=aligned), (feats, ROIS), ct)
    got, (gf, gr) = port_vjp(lambda f, r: roi.roi_align(
        f, r, 3, 0.5, sample_num=2, aligned=aligned),
        (nchw(feats), ROIS), nchw(ct))
    np.testing.assert_allclose(got, nchw(want), **TOL)
    np.testing.assert_allclose(gf, nchw(wf), **TOL)
    np.testing.assert_allclose(gr, wr, **TOL)
    assert np.abs(wr[:, 1:]).max() > 0


def test_roi_pool_values_and_tied_gradients_equal_jax():
    """ReLU'd features on a coarse grid (ties in most bins) and RoIs past
    the image and below one pixel: values and gradients exactly JAX's."""
    rng = np.random.RandomState(1)
    feats = np.maximum(np.round(rng.randn(2, 12, 14, 3) * 2) / 2, 0).astype(
        np.float32)
    ct = rng.randn(4, 3, 3, 3).astype(np.float32)
    want, (wf, _) = jax_vjp(lambda f, r: jroi.roi_pool(f, r, 3, 0.5),
                            (feats, ROIS), ct)
    got, (gf, _) = port_vjp(lambda f, r: roi.roi_pool(f, r, 3, 0.5),
                            (nchw(feats), ROIS), nchw(ct))
    np.testing.assert_array_equal(got, nchw(want))
    np.testing.assert_array_equal(gf, nchw(wf))
    assert (got == 0).any() and len(np.unique(gf)) > 3


def test_roi_pool_splits_a_tied_gradient_in_two_stages():
    """The bin [[1, 1], [1, 0]]: JAX's two-stage max gives the gradient
    [[0.25, 0.5], [0.25, 0]], not a third each."""
    feats = np.array([[1, 1], [1, 0]], np.float32).reshape(1, 1, 2, 2)
    f = leaf(feats)
    rois = torch.tensor([[0, 0.0, 0.0, 1.0, 1.0]])
    roi.roi_pool(f, rois, 1, 1.0).sum().backward()
    np.testing.assert_array_equal(f.grad.numpy()[0, 0],
                                  [[0.25, 0.5], [0.25, 0.0]])
    _, (wf, _) = jax_vjp(lambda f, r: jroi.roi_pool(f, r, 1, 1.0),
                         (feats.transpose(0, 2, 3, 1), rois.numpy()),
                         np.ones((1, 1, 1, 1), np.float32))
    np.testing.assert_array_equal(f.grad.numpy(), nchw(wf))


@pytest.mark.parametrize("align_corners", [True, False])
def test_grid_sample_matches_jax(align_corners):
    rng = np.random.RandomState(2)
    feats = rng.randn(2, 7, 9, 4).astype(np.float32)
    grid = rng.uniform(-1.2, 1.2, (2, 5, 6, 2)).astype(np.float32)
    ct = rng.randn(2, 5, 6, 4).astype(np.float32)
    want, (wf, wg) = jax_vjp(lambda f, g: jroi.grid_sample(
        f, g, align_corners), (feats, grid), ct)
    got, (gf, gg) = port_vjp(lambda f, g: roi.grid_sample(
        f, g, align_corners), (nchw(feats), grid), nchw(ct))
    np.testing.assert_allclose(got, nchw(want), **TOL)
    np.testing.assert_allclose(gf, nchw(wf), **TOL)
    np.testing.assert_allclose(gg, wg, **TOL)


def test_masked_conv2d_matches_jax():
    rng = np.random.RandomState(3)
    x = rng.randn(2, 8, 9, 4).astype(np.float32)
    mask = (rng.rand(2, 8, 9) > 0.5).astype(np.float32)
    w = rng.randn(3, 3, 4, 5).astype(np.float32)
    b = rng.randn(5).astype(np.float32)
    ct = rng.randn(2, 8, 9, 5).astype(np.float32)
    want, (wx, ww, wb) = jax_vjp(lambda x, w, b: jroi.masked_conv2d(
        x, jnp.asarray(mask), w, b), (x, w, b), ct)
    got, (gx, gw, gb) = port_vjp(lambda x, w, b: roi.masked_conv2d(
        x, torch.from_numpy(mask), w, b),
        (nchw(x), w.transpose(3, 2, 0, 1), b), nchw(ct))
    np.testing.assert_allclose(got, nchw(want), **TOL)
    np.testing.assert_allclose(gx, nchw(wx), **TOL)
    np.testing.assert_allclose(gw, ww.transpose(3, 2, 0, 1), **TOL)
    np.testing.assert_allclose(gb, wb, **TOL)


@pytest.mark.parametrize("up,k", [(2, 5), (3, 3), (2, 4)])
def test_carafe_matches_jax(up, k):
    rng = np.random.RandomState(4)
    x = rng.randn(2, 6, 7, 3).astype(np.float32)
    ker = rng.rand(2, 6 * up, 7 * up, k * k).astype(np.float32)
    ker /= ker.sum(-1, keepdims=True)
    ct = rng.randn(2, 6 * up, 7 * up, 3).astype(np.float32)
    want, (wx, wk) = jax_vjp(lambda x, kk: jroi.carafe(x, kk, up, k),
                             (x, ker), ct)
    got, (gx, gk) = port_vjp(lambda x, kk: roi.carafe(x, kk, up, k),
                             (nchw(x), nchw(ker)), nchw(ct))
    np.testing.assert_allclose(got, nchw(want), **TOL)
    np.testing.assert_allclose(gx, nchw(wx), **TOL)
    np.testing.assert_allclose(gk, nchw(wk), **TOL)


# deform_roi_pool: (P, D, G, classes, sample_per_part, trans_std, scale)
DRP_CASES = {"groups": (3, 4, 2, 1, 2, 0.1, 0.5),
             "classes": (3, 6, 1, 3, 3, 0.2, 0.5),
             "classes_groups": (2, 4, 2, 2, 2, 0.1, 0.25),
             "no_trans": (4, 6, 1, 0, 3, 0.0, 0.25)}
DRP_ROIS = np.array([[0, 2.0, 2.0, 20.0, 16.0],
                     [1, -4.0, 1.0, 30.0, 30.0],      # past the image
                     [0, 6.3, 7.8, 9.2, 11.9],
                     [0, 2.5, 3.5, 18.5, 15.5],       # exact .5
                     [1, 11.5, 0.5, 40.5, 2.5]], np.float32)


@pytest.mark.parametrize("case", list(DRP_CASES))
def test_deform_roi_pool_matches_jax(case):
    p, d, g, ncls, s, std, scale = DRP_CASES[case]
    rng = np.random.RandomState(5)
    feats = rng.randn(2, 12, 14, d * g * g).astype(np.float32)
    ct = rng.randn(len(DRP_ROIS), p, p, d).astype(np.float32)
    kw = dict(group_size=g, sample_per_part=s, trans_std=std)
    if ncls:
        trans = (rng.randn(len(DRP_ROIS), 2 * ncls, p, p) * 2).astype(
            np.float32)
        want, (wf, wt) = jax_vjp(lambda f, t: jroi.deform_roi_pool(
            f, jnp.asarray(DRP_ROIS), t, p, scale, d, False, **kw),
            (feats, trans), ct)
        got, (gf, gt) = port_vjp(lambda f, t: roi.deform_roi_pool(
            f, torch.from_numpy(DRP_ROIS), t, p, scale, d, False, **kw),
            (nchw(feats), trans), nchw(ct))
        np.testing.assert_allclose(gt, wt, **TOL)
        assert np.abs(wt).max() > 0
    else:
        want, (wf,) = jax_vjp(lambda f: jroi.deform_roi_pool(
            f, jnp.asarray(DRP_ROIS), None, p, scale, d, True, **kw),
            (feats,), ct)
        got, (gf,) = port_vjp(lambda f: roi.deform_roi_pool(
            f, torch.from_numpy(DRP_ROIS), None, p, scale, d, True, **kw),
            (nchw(feats),), nchw(ct))
    np.testing.assert_allclose(got, nchw(want), **TOL)
    np.testing.assert_allclose(gf, nchw(wf), **TOL)


@pytest.mark.parametrize("modulated", [False, True])
def test_deform_roi_pooling_packs_match_jax(modulated):
    """Random weights in every layer (the last ones too), through
    ``params_from_jax``: the first FC of each stack reads the pool flattened
    in (P, P, D) order in JAX and (D, P, P) in the port, so only a bridge
    that permutes its input columns agrees."""
    p, d, fc = 3, 4, 16
    kw = dict(spatial_scale=0.5, out_size=p, out_channels=d,
              trans_std=0.1, deform_fc_channels=fc)
    jcls = (jroi.ModulatedDeformRoIPoolingPack if modulated
            else jroi.DeformRoIPoolingPack)
    pcls = (roi.ModulatedDeformRoIPoolingPack if modulated
            else roi.DeformRoIPoolingPack)
    rng = np.random.RandomState(6)
    feats = rng.randn(2, 12, 14, d).astype(np.float32)
    rois = DRP_ROIS[:4]
    jm = jcls(**kw)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                            jnp.asarray(feats), jnp.asarray(rois))["params"]
    flat = {k: (rng.randn(*v.shape) * 0.5).astype(np.float32)
            for k, v in traverse_util.flatten_dict(shapes).items()}
    params = traverse_util.unflatten_dict(flat)
    ct = rng.randn(len(rois), p, p, d).astype(np.float32)

    def jfn(prm, f):
        return jm.apply({"params": prm}, f, jnp.asarray(rois))
    want, (wparams, wf) = jax_vjp(jfn, (params, feats), ct)
    pm = pcls(**kw)
    sd = params_from_jax(params, {})
    pm.load_state_dict(sd)
    # the same tree under a parent maps to the same weights under its name
    nested = params_from_jax({"roi_layer": params}, {})
    assert set(nested) == {f"roi_layer.{k}" for k in sd}
    assert all(torch.equal(nested[f"roi_layer.{k}"], v)
               for k, v in sd.items())
    f = leaf(nchw(feats))
    got = pm(f, torch.from_numpy(rois))
    got.backward(torch.from_numpy(nchw(ct)))
    np.testing.assert_allclose(got.detach().numpy(), nchw(want), **TOL)
    np.testing.assert_allclose(f.grad.numpy(), nchw(wf), **TOL)
    wgrads = grads_from_jax(wparams)
    named = dict(pm.named_parameters())
    assert set(wgrads) == set(named)
    for k, t in named.items():
        np.testing.assert_allclose(t.grad.numpy(), wgrads[k].numpy(),
                                   err_msg=k, **TOL)
    # the first pooling's flatten order reaches the output
    with torch.no_grad():
        plain = pm.pool(torch.from_numpy(nchw(feats)),
                        torch.from_numpy(rois), None)
    assert np.abs(got.detach().numpy() - plain.numpy()).max() > 1e-2


@pytest.mark.parametrize("modulated", [False, True])
def test_pack_init_starts_as_the_plain_pool(modulated):
    """``init_weights`` zeroes the last layers: no offset, and the
    modulated pack's mask at sigmoid(0) = 0.5."""
    from sipmask_tpu_torch.utils.convert import init_weights
    pcls = (roi.ModulatedDeformRoIPoolingPack if modulated
            else roi.DeformRoIPoolingPack)
    pm = pcls(0.5, 7, 4, trans_std=0.1)
    init_weights(pm, torch.Generator().manual_seed(0))
    rng = np.random.RandomState(7)
    feats = torch.from_numpy(rng.randn(1, 4, 16, 16).astype(np.float32))
    rois = torch.tensor([[0, 2.0, 2.0, 12.0, 12.0]])
    with torch.no_grad():
        got = pm(feats, rois)
        plain = roi.deform_roi_pool(feats, rois, None, 7, 0.5, 4, True)
    np.testing.assert_allclose(got.numpy(),
                               plain.numpy() * (0.5 if modulated else 1.0),
                               rtol=1e-6, atol=1e-6)
    w = pm.offset_fc[0].weight
    std = float(w.detach().std())
    assert abs(std - (1 / w.shape[1]) ** 0.5) < 0.1 * std


@pytest.mark.parametrize("name", ["bfp_non_local", "bfp_conv", "roi_align",
                                  "roi_pool",
                                  "modulated_deform_roi_pooling_pack",
                                  "carafe", "masked_conv2d", "grid_sample"])
def test_library_checks_hold_on_the_cpu(name):
    """chip_smoke.py's phase 36 (tools/library_check.py) at its small sizes
    on the CPU: f32 against float64, forward and backward, within its
    bound (SSD-VGG's case, seconds on one thread here, runs on the card in
    tests/test_torch_cuda.py)."""
    from sipmask_tpu_torch.tools import library_check as lc
    case = {c.name: c for c in lc.cases(dict(lc.SMALL, ssd=()),
                                        "cpu")}[name]
    res = lc.compare(case, "cpu")
    assert res["f32"]["err"] <= lc.F32_TOL and res["f32"]["ms"] is None


def test_assign_check_holds_on_the_cpu():
    from sipmask_tpu_torch.tools import library_check as lc
    res = lc.check_assign(lc.SMALL, "cpu")
    assert res["positives"] > 0 and res["differ"] <= res["close"]
