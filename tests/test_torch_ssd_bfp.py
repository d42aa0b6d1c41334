"""The port's SSD-VGG backbone and BFP neck (sipmask_tpu_torch/models/
ssd_vgg.py, bfp.py) against the JAX package's, on the CPU, on the JAX
package's own init carried over by ``params_from_jax``.

Bounds. SSD-VGG's levels within rtol 1e-4, atol 5e-3, the bound that
tests/test_full_model_parity.py holds the JAX module to against the
reference (VGG has no norm: activations reach O(100) and the convs' sum
order moves them by ~1e-3). Its gradients at 300 within 1e-4 of each
tensor's largest value, with the ReLUs pinned (see the test). BFP within
1e-5.

In bf16 each output lies within JAX's own bf16 drift,
||port_bf16 - jax_bf16|| <= bound * ||jax_bf16 - jax_f32|| in the 2-norm,
with JAX compiled without excess precision so that it rounds where its code
casts (tests/test_torch_bf16.py's bound, for the reasons its module note
gives). BFP, a few ops on common inputs, takes one drift. SSD-VGG's levels
come from the image through 10 to 22 convs, like tests/test_torch_bf16.py's
end-to-end cases: single flipped roundings grow along the chain into
rounding noise that is no longer correlated with JAX's, and two such bf16
runs lie sqrt(2) drifts apart (measured at 300: 0.62 drifts at conv4_3,
0.80 at fc7, 1.04 at the last 1x1 level).
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sipmask_tpu.models.ssd_vgg as jssd
from _torch_parity import pin_jax_relus, pin_port_relus
from sipmask_tpu.models.bfp import BFP as JBFP
from sipmask_tpu.models.ssd_vgg import SSDVGG as JSSDVGG
from sipmask_tpu_torch.models.bfp import BFP
from sipmask_tpu_torch.models.ssd_vgg import SSDVGG, ceil_max_pool_2x2
from sipmask_tpu_torch.utils.convert import grads_from_jax, params_from_jax

BF = torch.bfloat16
STRICT = {"xla_allow_excess_precision": False}
SSD_TOL = dict(rtol=1e-4, atol=5e-3)
SSD_GRAD_REL = 1e-4
SSD_BF16_BOUND = 2 ** 0.5   # drifts: levels through the whole chain
BFP_TOL = dict(rtol=1e-5, atol=1e-5)
BFP_SIZES = (32, 16, 8, 4, 2)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread while this module runs (tests/test_torch_vis.py:
    six workers' OpenMP pools spin against each other)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(
        np.asarray(a, np.float32).transpose(0, 3, 1, 2)))


def nhwc(t):
    return t.detach().float().permute(0, 2, 3, 1).numpy()


def strict(fn, *args):
    """``fn(*args)`` compiled by XLA with no excess precision, numpy."""
    out = jax.jit(fn).lower(*args).compile(STRICT)(*args)
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), out)


def within_drift(got, want16, want32, what, bound=1.0):
    err = float(np.linalg.norm(got - want16))
    drift = float(np.linalg.norm(want16 - want32))
    assert drift > 0 and err <= bound * drift, (what, err, drift)


def _ssd(input_size, seed=31):
    img = (np.random.RandomState(seed).randn(1, input_size, input_size, 3)
           * 40).astype(np.float32)
    jm = JSSDVGG(input_size=input_size)
    params = jax.jit(jm.init)(jax.random.PRNGKey(input_size),
                              jnp.asarray(img))["params"]
    return jm, params, img


@pytest.mark.parametrize("input_size,n_levels", [(300, 6), (512, 7)])
def test_ssd_vgg_levels_match_jax(input_size, n_levels):
    jm, params, img = _ssd(input_size)
    want = jax.jit(jm.apply)({"params": params}, jnp.asarray(img))
    port = SSDVGG(input_size)
    port.load_state_dict(params_from_jax(params, {}))
    with torch.no_grad():
        got = port(nchw(img))
    assert len(got) == len(want) == n_levels
    for lvl, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(nhwc(g), np.asarray(w), err_msg=str(lvl),
                                   **SSD_TOL)


def ssd_relu_masks(port, img):
    """The sign masks (x > 0) of the port SSD-VGG's ReLUs, in call order,
    from a float64 forward of a copy of it."""
    net, real, masks = copy.deepcopy(port).double(), torch.relu, []

    def record(x):
        masks.append((x > 0).numpy())
        return real(x)
    torch.relu = record
    try:
        with torch.no_grad():
            net(nchw(img).double())
    finally:
        torch.relu = real
    return masks


def test_ssd_vgg_gradients_match_jax():
    """The gradient of sum(level * cotangent) over the levels at 300 to
    conv1_1 (through every layer), to every other weight and to the L2Norm
    weight, with both packages' ReLUs pinned to one float64 forward's masks
    (tests/_torch_parity.py): unpinned, f32 rounding flips ReLU kinks of the
    random VGG, and either package's f32 gradients then lie up to ~1e-2 of
    their max from the float64 ones (measured: the port's fc6 weight 2.9e-3,
    conv4_2 8.6e-3; JAX's 1.2e-3)."""
    jm, params, img = _ssd(300)
    rng = np.random.RandomState(1)
    shapes = jax.eval_shape(jm.apply, {"params": params}, jnp.asarray(img))
    cts = [rng.randn(*s.shape).astype(np.float32) for s in shapes]
    port = SSDVGG(300)
    port.load_state_dict(params_from_jax(params, {}))
    masks = ssd_relu_masks(port, img)

    def loss(p):
        outs = jm.apply({"params": p}, jnp.asarray(img))
        return sum((o * c).sum() for o, c in zip(outs, cts))
    with pin_jax_relus(masks, jssd):
        want = grads_from_jax(jax.tree_util.tree_map(
            np.asarray, jax.jit(jax.grad(loss))(params)))
    with pin_port_relus(port, masks) as calls:
        outs = port(nchw(img))
    assert calls[0] == len(masks)
    sum((o * nchw(c)).sum() for o, c in zip(outs, cts)).backward()
    named = dict(port.named_parameters())
    assert set(named) == set(want)
    for k in named:
        g, w = named[k].grad.numpy(), want[k].numpy()
        err = float(np.abs(g - w).max())
        assert err <= SSD_GRAD_REL * float(np.abs(w).max()), (k, err)


def test_ssd_vgg_in_bf16_within_jax_drift():
    jm, params, img = _ssd(300)
    x = jnp.asarray(img)
    want32 = strict(lambda p, x: jm.apply({"params": p}, x), params, x)
    jm16 = JSSDVGG(input_size=300, dtype=jnp.bfloat16)
    want16 = strict(lambda p, x: jm16.apply({"params": p}, x), params, x)
    port = SSDVGG(300, dtype=BF)
    port.load_state_dict(params_from_jax(params, {}))
    with torch.no_grad():
        got = port(nchw(img))
    for lvl, (g, w16, w32) in enumerate(zip(got, want16, want32)):
        assert g.dtype == BF
        within_drift(nhwc(g), w16, w32, f"level {lvl}", SSD_BF16_BOUND)


def test_ceil_max_pool_keeps_the_last_odd_window():
    x = torch.arange(2 * 5 * 7, dtype=torch.float32).view(1, 2, 5, 7)
    out = ceil_max_pool_2x2(x)
    assert out.shape == (1, 2, 3, 4)
    assert torch.equal(out[..., -1, -1], x[..., -1, -1])


def _bfp(refine_type, dtype=jnp.float32, seed=0):
    rng = np.random.RandomState(seed)
    feats = [rng.randn(2, s, s, 16).astype(np.float32) for s in BFP_SIZES]
    jm = JBFP(out_channels=16, refine_level=2, refine_type=refine_type,
              dtype=dtype)
    params = jax.jit(jm.init)(jax.random.PRNGKey(seed),
                              [jnp.asarray(f) for f in feats])
    params = params.get("params", {})
    if refine_type == "non_local":    # a zero conv_out would hide the block
        k = params["refine"]["conv_out"]["kernel"]
        params = jax.tree_util.tree_map(lambda a: a, params)
        params["refine"]["conv_out"]["kernel"] = jnp.asarray(
            rng.randn(*k.shape).astype(np.float32) * 0.2)
    return jm, params, feats


@pytest.mark.parametrize("refine_type", [None, "conv", "non_local"])
def test_bfp_matches_jax(refine_type):
    jm, params, feats = _bfp(refine_type)
    ct = [np.random.RandomState(9).randn(*f.shape).astype(np.float32)
          for f in feats]

    def run(p, fs):
        out, vjp = jax.vjp(lambda p, fs: jm.apply({"params": p}, fs), p, fs)
        return out, vjp(tuple(jnp.asarray(c) for c in ct))
    want, (wp, wf) = jax.jit(run)(params, [jnp.asarray(f) for f in feats])
    port = BFP(16, 2, refine_type)
    port.load_state_dict(params_from_jax(params, {}))
    xs = [nchw(f).requires_grad_(True) for f in feats]
    got = port(xs)
    sum((g * nchw(c)).sum() for g, c in zip(got, ct)).backward()
    for lvl, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(nhwc(g), np.asarray(w), err_msg=str(lvl),
                                   **BFP_TOL)
    for lvl, (x, w) in enumerate(zip(xs, wf)):
        np.testing.assert_allclose(nhwc(x.grad), np.asarray(w),
                                   err_msg=f"dx {lvl}", **BFP_TOL)
    wgrads = grads_from_jax(jax.tree_util.tree_map(np.asarray, wp))
    named = dict(port.named_parameters())
    assert set(wgrads) == set(named)
    for k, t in named.items():
        np.testing.assert_allclose(t.grad.numpy(), wgrads[k].numpy(),
                                   err_msg=k, **BFP_TOL)


@pytest.mark.parametrize("refine_type", ["conv", "non_local"])
def test_bfp_in_bf16_within_jax_drift(refine_type):
    jm, params, feats = _bfp(refine_type)
    jm16 = JBFP(out_channels=16, refine_level=2, refine_type=refine_type,
                dtype=jnp.bfloat16)
    fs = [jnp.asarray(f) for f in feats]
    want32 = strict(lambda p, fs: jm.apply({"params": p}, fs), params, fs)
    fs16 = [f.astype(jnp.bfloat16) for f in fs]
    want16 = strict(lambda p, fs: jm16.apply({"params": p}, fs), params,
                    fs16)
    port = BFP(16, 2, refine_type, dtype=BF)
    port.load_state_dict(params_from_jax(params, {}))
    with torch.no_grad():
        got = port([nchw(f).to(BF) for f in feats])
    for lvl, (g, w16, w32) in enumerate(zip(got, want16, want32)):
        assert g.dtype == BF
        within_drift(nhwc(g), w16, w32, f"level {lvl}")


def test_bfp_refuses_levels_off_power_of_2_ratios():
    """Five levels at strides 8-128 of an 800x1344 image (P6 13x21 and P7
    7x11 are not P5's halves): the port raises ValueError naming the
    sizes; the JAX package fails on the same pyramid."""
    sizes = [(100, 168), (50, 84), (25, 42), (13, 21), (7, 11)]
    feats = [torch.zeros(1, 4, h, w) for h, w in sizes]
    with pytest.raises(ValueError, match=r"\(13, 21\)"):
        BFP(4, 2, None)(feats)
    jm = JBFP(out_channels=4, refine_level=2, refine_type=None)
    with pytest.raises(TypeError):
        jm.apply({}, [jnp.zeros((1, h, w, 4)) for h, w in sizes])
