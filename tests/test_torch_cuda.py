"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU and nvcc and skips without them. This
file imports neither JAX nor the JAX package, so it also runs where JAX is
not installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from sipmask_tpu_torch.ops import deform_sample, gn_relu

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is False)")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _offsets(rng, b, n_off, ho, wo, far):
    off = rng.randn(b, n_off, ho, wo).astype(np.float32) * 2.0
    if far:   # a third of the pixels +-300 px out, where an unchecked
        # gather would read outside the feature map
        third = (ho * wo) // 3
        flat = off.reshape(b, n_off, ho * wo)
        flat[:, :, :third] *= 150.0
    return off


@pytest.mark.parametrize("b,c,g,h,w,stride,dil,far", [
    (2, 256, 4, 100, 168, 1, 1, True),    # FeatureAlign at P3, 800x1344
    (2, 256, 4, 7, 11, 1, 1, False),      # P7
    (1, 20, 4, 13, 9, 2, 1, True),        # Cg = 5: a ragged channel chunk
    (2, 32, 1, 17, 15, 1, 2, True),
])
def test_deform_im2col_kernel_matches_plain(dev, b, c, g, h, w, stride, dil,
                                            far):
    rng = np.random.RandomState(0)
    pad = dil
    ho, wo = deform_sample.out_size(h, w, 3, 3, stride, pad, dil)
    x = torch.from_numpy(rng.randn(b, c, h, w).astype(np.float32)).to(dev)
    off = torch.from_numpy(_offsets(rng, b, g * 18, ho, wo, far)).to(dev)
    before = deform_sample.deform_im2col.launches
    got = deform_sample.deform_im2col(x, off, (3, 3), stride, pad, dil, g)
    torch.cuda.synchronize()
    assert deform_sample.deform_im2col.launches == before + 1
    want = deform_sample.deform_im2col_plain(x, off, (3, 3), stride, pad, dil,
                                             g)
    # the same four f32 products; the kernel may fuse them into FMAs
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def _device_kernels(fn, attempts=5):
    """Names of the device kernels of one fn() in each of ``attempts``
    profiler sessions (each behind a marker kernel: the card's profiler
    sometimes misses a session's kernels, the first or all, and never adds
    one, so the fullest session counts)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()   # builds
    torch.cuda.synchronize()
    sessions = []
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            torch.cuda._sleep(1000)
            torch.cuda.synchronize()
            fn()
            torch.cuda.synchronize()
        sessions.append([e.name for e in prof.events()
                         if e.device_type == DeviceType.CUDA
                         and "spin_kernel" not in e.name])
    return sessions


def _last_run_kernels(fn, want, reps=8, attempts=5):
    """Names, in launch order, of the device kernels of the last of
    ``reps`` fn() runs in a profiler session, taken from the first of
    ``attempts`` sessions whose last two runs of ``want`` kernels agree
    name for name. Late in a long run the card's profiler dropped up to
    tens of a session's first kernels (never adding one), which one run
    alone cannot outlast. Every session must hold at most reps * want."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()   # builds
    torch.cuda.synchronize()
    sessions = []
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            torch.cuda._sleep(1000)
            torch.cuda.synchronize()
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        names = [e.name for e in sorted(
            (e for e in prof.events() if e.device_type == DeviceType.CUDA
             and "spin_kernel" not in e.name),
            key=lambda e: e.time_range.start)]
        assert len(names) <= reps * want, names
        if len(names) >= 2 * want and \
                names[-want:] == names[-2 * want:-want]:
            return names[-want:]
        sessions.append(names)
    raise AssertionError(f"no session held two whole runs of {want} "
                         f"kernels: {sessions}")


@pytest.mark.parametrize("b,c,g,h,w", [(2, 256, 4, 100, 168),   # P3
                                       (1, 20, 4, 13, 9)])      # Cg = 5
def test_deform_im2col_is_two_device_kernels(dev, b, c, g, h, w):
    """A K1 call is its transpose of x into channels-last rows and its
    gather, and no other device work."""
    rng = np.random.RandomState(6)
    x = torch.from_numpy(rng.randn(b, c, h, w).astype(np.float32)).to(dev)
    off = torch.from_numpy(_offsets(rng, b, g * 18, h, w, True)).to(dev)
    sessions = _device_kernels(
        lambda: deform_sample.deform_im2col(x, off, (3, 3), 1, 1, 1, g))
    assert all(len(names) <= 2 for names in sessions), sessions
    names = max(sessions, key=len)
    assert len(names) == 2, sessions
    assert sum("deform_im2col_rows_kernel" in n for n in names) == 1, names
    assert sum("deform_im2col_kernel" in n for n in names) == 1, names


@pytest.mark.parametrize("act", [True, False])
@pytest.mark.parametrize("shape", [(2, 256, 100, 168), (2, 256, 25, 42),
                                   (1, 64, 7, 11)])
def test_gn_relu_kernel_matches_plain(dev, shape, act):
    rng = np.random.RandomState(1)
    c = shape[1]
    x = torch.from_numpy((rng.randn(*shape) * 3 + 1).astype(np.float32)
                         ).to(dev)
    wt = torch.from_numpy((rng.rand(c) + 0.5).astype(np.float32)).to(dev)
    bs = torch.from_numpy((rng.randn(c) * 0.2).astype(np.float32)).to(dev)
    before = gn_relu.gn_relu.launches
    got = gn_relu.gn_relu(x, wt, bs, 32, 1e-5, act)   # keeps no statistics
    again, stats = gn_relu.gn_relu_forward(x, wt, bs, 32, 1e-5, act)
    third, stats2 = gn_relu.gn_relu_forward(x, wt, bs, 32, 1e-5, act)
    torch.cuda.synchronize()
    assert gn_relu.gn_relu.launches == before + 3
    # fixed reduction order, no atomics: the same bits on every call
    assert torch.equal(got, again) and torch.equal(got, third)
    assert torch.equal(stats, stats2)
    want, want_stats = gn_relu.gn_relu_forward(x.cpu(), wt.cpu(), bs.cpu(),
                                               32, 1e-5, act)
    # f32 sums over up to 134400 elements per group, in another order
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(stats.cpu(), want_stats, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("act", [True, False])
@pytest.mark.parametrize("shape", [(2, 256, 50, 84), (2, 256, 13, 21)])
def test_gn_relu_forward_then_backward_match_plain(dev, shape, act):
    """K4a then K4b through the autograd Function (the statistics saved as
    a view of K4a's scratch) against the plain forward, and against the
    plain backward of the kernel's statistics."""
    rng = np.random.RandomState(8)
    c = shape[1]
    x = torch.from_numpy((rng.randn(*shape) * 3 + 1).astype(np.float32)
                         ).to(dev).requires_grad_(True)
    dy = torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(dev)
    wt = torch.from_numpy((rng.rand(c) + 0.5).astype(np.float32)
                          ).to(dev).requires_grad_(True)
    bs = torch.from_numpy((rng.randn(c) * 0.2).astype(np.float32)
                          ).to(dev).requires_grad_(True)
    before = (gn_relu.gn_relu.launches, gn_relu.gn_relu_backward.launches)
    y = gn_relu.gn_relu(x, wt, bs, 32, 1e-5, act)
    got = torch.autograd.grad(y, (x, wt, bs), dy)
    torch.cuda.synchronize()
    assert (gn_relu.gn_relu.launches, gn_relu.gn_relu_backward.launches) == (
        before[0] + 1, before[1] + 1)
    xd, wd, bd = (t.detach() for t in (x, wt, bs))
    want_y, _ = gn_relu.gn_relu_forward(xd.cpu(), wd.cpu(), bd.cpu(), 32,
                                        1e-5, act)
    # f32 sums over up to 33600 elements per group, in another order
    torch.testing.assert_close(y.detach().cpu(), want_y, rtol=1e-4,
                               atol=1e-4)
    _, stats = gn_relu.gn_relu_forward(xd, wd, bd, 32, 1e-5, act)
    want = gn_relu.gn_relu_backward_plain(xd, wd, bd, stats, dy, 32, act)
    for name, a, e in zip(("dx", "dweight", "dbias"), got, want):
        err = float((a - e).abs().max()) / max(float(e.abs().max()), 1e-30)
        assert err <= 1e-5, (name, err)


@pytest.mark.parametrize("shape", [(4, 256, 100, 168), (4, 256, 7, 11)])
def test_gn_relu_forward_is_two_device_kernels(dev, shape):
    """One K4a call runs its two kernels and no other device work."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    rng = np.random.RandomState(9)
    x = torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(dev)
    wt = torch.ones(shape[1], device=dev)
    bs = torch.zeros(shape[1], device=dev)
    gn_relu.gn_relu_forward(x, wt, bs, 32)   # builds
    torch.cuda.synchronize()
    # a marker kernel starts each session, and one of three sessions must
    # see both kernels (the card's profiler sometimes misses some)
    sessions = []
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            torch.cuda._sleep(1000)
            torch.cuda.synchronize()
            gn_relu.gn_relu_forward(x, wt, bs, 32)
            torch.cuda.synchronize()
        sessions.append(sorted(e.name for e in prof.events()
                               if e.device_type == DeviceType.CUDA
                               and "spin_kernel" not in e.name))
    assert all(len(names) <= 2 for names in sessions), sessions
    names = max(sessions, key=len)
    assert len(names) == 2, sessions
    assert "gn_apply_kernel" in names[0], names
    assert "gn_stats_kernel" in names[1], names


def test_kernel_wrappers_refuse_what_the_kernels_do_not_take(dev):
    x = torch.zeros((1, 8, 6, 6), device=dev)
    off = torch.zeros((1, 36, 6, 6), device=dev)
    with pytest.raises(TypeError):
        deform_sample.deform_im2col(x.double(), off.double(), (3, 3), 1, 1, 1,
                                    2)
    with pytest.raises(ValueError, match="contiguous"):
        deform_sample.deform_im2col(x.transpose(2, 3), off, (3, 3), 1, 1, 1,
                                    2)
    w, b = torch.ones(8, device=dev), torch.zeros(8, device=dev)
    with pytest.raises(TypeError):
        gn_relu.gn_relu(x.half(), w, b, 4)
    with pytest.raises(ValueError, match="contiguous"):
        gn_relu.gn_relu(x.transpose(2, 3), w, b, 4)


# ------------------------------------------------- K2, K3a/K3b, K4b (training)

def _deform_case(dev, b, c, g, h, w, regime, o=None, seed=2):
    """x, offsets (CUDA layout), w2 and dy at one FeatureAlign level:
    'random' offsets of ~2 px with a third of the pixels +-300 px out,
    'zero' offsets (conv_offset's initial state: every sample on the grid),
    'far' offsets of +-300 px everywhere (every corner out of the map)."""
    rng = np.random.RandomState(seed)
    o = o or c
    x = torch.from_numpy(rng.randn(b, c, h, w).astype(np.float32)).to(dev)
    if regime == "zero":
        off = np.zeros((b, g * 18, h, w), np.float32)
    elif regime == "far":
        off = rng.choice([-300.0, 300.0], (b, g * 18, h, w)).astype(
            np.float32)
    else:
        off = _offsets(rng, b, g * 18, h, w, far=True)
    off = torch.from_numpy(off).to(dev)
    w2 = torch.from_numpy((rng.randn(o, 9 * c) * 0.02).astype(np.float32)
                          ).to(dev)
    dy = torch.from_numpy(rng.randn(b, o, h, w).astype(np.float32)).to(dev)
    return x, off, w2, dy


@pytest.mark.parametrize("b,c,g,h,w,regime", [
    (2, 256, 4, 100, 168, "random"),   # FeatureAlign at P3, 800x1344
    (2, 256, 4, 100, 168, "zero"),
    (2, 256, 4, 7, 11, "random"),      # P7
    (1, 20, 4, 13, 9, "random"),       # ragged GEMM tiles, Cg = 5
    (1, 256, 4, 25, 42, "random"),     # B = 1, P % 4 != 0: 4-byte copies
    (1, 256, 4, 13, 21, "zero"),       # B = 1, ragged P, on the grid
    (2, 256, 4, 50, 84, "far"),        # every sample +-300 px out
])
def test_deform_conv_backward_kernel_matches_plain(dev, b, c, g, h, w,
                                                   regime):
    from sipmask_tpu_torch.ops import deform_conv
    x, off, w2, dy = _deform_case(dev, b, c, g, h, w, regime)
    cols = deform_sample.deform_im2col(x, off, (3, 3), 1, 1, 1, g)
    before = deform_conv.deform_conv_backward.launches
    got = deform_conv.deform_conv_backward(x, off, cols, w2, dy, (3, 3), 1,
                                           1, 1, g)
    torch.cuda.synchronize()
    assert deform_conv.deform_conv_backward.launches == before + 1
    want = deform_conv.deform_conv_backward_plain(x, off, w2, dy, (3, 3), 1,
                                                  1, 1, g)
    for name, a, e in zip(("dx", "doffsets", "dw2"), got, want):
        assert torch.isfinite(a).all(), name
        # relative to the largest |value|: the 3xTF32 GEMMs drop the
        # small*small products and sum 256 (dcols) or B*P (dw2) products in
        # another order than cuBLAS, and dx's atomics add in run-to-run order
        err = float((a - e).abs().max()) / max(float(e.abs().max()), 1e-30)
        assert err <= 1e-5, (name, err)
    if regime == "zero":   # the one-sided rule: offsets train from zero
        assert float(got[1].abs().max()) > 0
    if regime == "far":    # no corner in the map: exact zeros
        assert not got[0].any() and not got[1].any()


def _mask_case(dev, b, k, g, h, w, seed=3, regime="random"):
    """Basis, coefficients, boxes, gt masks, gt indices and validity.
    Boxes: 'random' ones covering 5-60% of the map (a few degenerate or off
    the map); 'crowded', k positives jittered +-3 px around g gt boxes, as
    FCOS positives of one gt are, each indexing its gt (hundreds of boxes
    touch a tile); 'edges', corners at and beside multiples of 8, 16 and 32
    (the pixel tiles' edges), at x.5 and at 0 and the map's width or
    height; 'split', odd-width boxes whose half-split passes between two
    columns of a tile and between the two rows of a warp; 'live', boxes
    that cover the map, every positive valid."""
    rng = np.random.RandomState(seed)
    basis = torch.from_numpy(rng.randn(b, 32, h, w).astype(np.float32))
    cofs = torch.from_numpy((rng.randn(b, k, 128) * 0.3).astype(np.float32))
    gt_idx = None
    if regime == "crowded":
        gt_idx = rng.randint(0, g, (b, k))
        frac = np.sqrt(rng.uniform(0.05, 0.6, (b, g, 1)))
        wh = frac * np.array([w, h])
        ctr = rng.uniform(0.2, 0.8, (b, g, 2)) * np.array([w, h])
        gts = np.concatenate([ctr - wh / 2, ctr + wh / 2], -1)
        boxes = (np.take_along_axis(gts, gt_idx[..., None], 1)
                 + rng.uniform(-3, 3, (b, k, 4))).astype(np.float32)
    elif regime == "edges":
        xs = np.float32([0, 0.5, 7.5, 8, 31, 31.5, 32, 32.5, 40, 63, 64,
                         w - 1, w - 0.5, w, w + 0.5])
        ys = np.float32([0, 0.5, 7, 7.5, 8, 8.5, 15, 16, 24, 31, 32, h - 1,
                         h - 0.5, h])
        bx = np.sort(rng.choice(xs, (b, k, 2)), -1)
        by = np.sort(rng.choice(ys, (b, k, 2)), -1)
        boxes = np.stack([bx[..., 0], by[..., 0], bx[..., 1], by[..., 1]],
                         -1)
    elif regime == "split":
        r, s = rng.randint(2, 40, (b, k)), rng.randint(2, 30, (b, k))
        cx = 32 * rng.randint(0, w // 32, (b, k)) + rng.randint(1, 31, (b, k))
        cy = 16 * rng.randint(0, h // 16, (b, k)) + 2 * rng.randint(0, 8,
                                                                    (b, k))
        boxes = np.stack([cx - r, cy - s, cx + r + 1, cy + s + 1],
                         -1).astype(np.float32)
    elif regime == "live":
        lo = rng.uniform(-5, 5, (b, k, 2))
        hi = rng.uniform(-5, 5, (b, k, 2)) + np.array([w, h])
        boxes = np.concatenate([lo, hi], -1).astype(np.float32)
    else:
        frac = np.sqrt(rng.uniform(0.05, 0.6, (b, k, 1)))
        wh = frac * np.array([w, h], np.float32)
        ctr = rng.uniform(0, 1, (b, k, 2)) * np.array([w, h], np.float32)
        boxes = np.concatenate([ctr - wh / 2, ctr + wh / 2], -1).astype(
            np.float32)
        boxes[:, ::17] = [5.3, 7.1, 5.2, 30.0]      # degenerate (x2 < x1)
        boxes[:, 1::23] += np.float32(2 * w)         # off the map
    gt = torch.from_numpy((rng.rand(b, g, h, w) > 0.5).astype(np.uint8))
    if gt_idx is None:
        gt_idx = rng.randint(0, g, (b, k))
    gt_idx = torch.from_numpy(gt_idx)
    valid = torch.from_numpy((rng.rand(b, k) > 0.2) | (regime == "live"))
    return [t.to(dev) for t in (basis, cofs, torch.from_numpy(boxes), gt,
                                gt_idx, valid)]


@pytest.mark.parametrize("b,k,g,h,w,regime", [
    # the flagship's basis grid, max_pos, max_gts
    (2, 512, 64, 400, 672, "random"),
    (1, 37, 5, 33, 47, "random"),      # ragged tiles; K < one chunk
    (2, 512, 8, 400, 672, "crowded"),  # hundreds of hits a tile
    (1, 100, 5, 64, 96, "edges"),      # K not a multiple of the chunk
    (1, 130, 5, 61, 101, "edges"),     # and ragged tiles
    (1, 100, 70, 64, 96, "random"),    # G > 64: gt bytes, not bit masks
])
def test_mask_bce_kernels_match_plain(dev, b, k, g, h, w, regime):
    from sipmask_tpu_torch.ops import mask_loss
    args = _mask_case(dev, b, k, g, h, w, regime=regime)
    grad = torch.from_numpy(np.random.RandomState(4).rand(b, k).astype(
        np.float32)).to(dev)
    grad[:, ::5] = 0.0                       # skipped: zero cotangent
    f0, b0 = (mask_loss.mask_bce_forward.launches,
              mask_loss.mask_bce_backward.launches)
    pre = mask_loss.mask_bce_forward(*args)
    pre_again = mask_loss.mask_bce_forward(*args)
    dbasis, dcofs = mask_loss.mask_bce_backward(*args, grad)
    again = mask_loss.mask_bce_backward(*args, grad)
    torch.cuda.synchronize()
    assert mask_loss.mask_bce_forward.launches == f0 + 2
    assert mask_loss.mask_bce_backward.launches == b0 + 2
    # fixed-order folds, no atomics: the same bits on every run
    assert torch.equal(pre, pre_again)
    assert torch.equal(dbasis, again[0]) and torch.equal(dcofs, again[1])
    want_pre = mask_loss.mask_bce_loss_plain(*args)
    want_db, want_dc = mask_loss.mask_bce_backward_plain(*args, grad)
    assert bool((pre[~args[5]] == 0).all())
    # relative to the largest |value|: per-pixel 32-term dots and sums over
    # up to 268800 pixels, in another order than the plain matmuls
    for name, a, e in (("pre", pre, want_pre), ("dbasis", dbasis, want_db),
                       ("dcofs", dcofs, want_dc)):
        err = float((a - e).abs().max()) / max(float(e.abs().max()), 1e-30)
        assert err <= 1e-5, (name, err)


@pytest.mark.parametrize("case", ["zero_grad", "split", "live"])
def test_mask_bce_backward_kernels_where_they_branch(dev, case):
    """K3b's tile kernels where their paths branch: an all-zero cotangent
    (every hit dropped at staging: exact zeros); half-splits through a
    warp's columns and between its two rows (a reduce-scatter for each
    quadrant of a warp); K = 200 positives that all touch every tile with
    a live cotangent (four staging chunks, each folding its d cofs sums in
    eight sub-chunks of the shared buffer)."""
    from sipmask_tpu_torch.ops import mask_loss
    b, k, g, h, w = 2, 200 if case == "live" else 150, 5, 80, 128
    args = _mask_case(dev, b, k, g, h, w,
                      regime="random" if case == "zero_grad" else case)
    grad = torch.from_numpy(np.random.RandomState(4).rand(b, k).astype(
        np.float32) + 0.1).to(dev)
    if case == "zero_grad":
        grad.zero_()
    if case == "live":
        assert mask_loss.tile_hits(args[2].cpu(), args[5].cpu(), h, w).all()
    dbasis, dcofs = mask_loss.mask_bce_backward(*args, grad)
    again = mask_loss.mask_bce_backward(*args, grad)
    torch.cuda.synchronize()
    assert torch.equal(dbasis, again[0]) and torch.equal(dcofs, again[1])
    if case == "zero_grad":
        assert not dbasis.any() and not dcofs.any()
        return
    want_db, want_dc = mask_loss.mask_bce_backward_plain(*args, grad)
    for name, a, e in (("dbasis", dbasis, want_db), ("dcofs", dcofs, want_dc)):
        err = float((a - e).abs().max()) / max(float(e.abs().max()), 1e-30)
        assert err <= 1e-5, (name, err)


@pytest.mark.parametrize("act", [True, False])
@pytest.mark.parametrize("shape", [(2, 256, 100, 168), (2, 256, 25, 42),
                                   (1, 64, 7, 11)])
def test_gn_relu_backward_kernel_matches_plain(dev, shape, act):
    rng = np.random.RandomState(5)
    c = shape[1]
    x = torch.from_numpy((rng.randn(*shape) * 3 + 1).astype(np.float32)
                         ).to(dev)
    dy = torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(dev)
    wt = torch.from_numpy((rng.rand(c) + 0.5).astype(np.float32)).to(dev)
    bs = torch.from_numpy((rng.randn(c) * 0.2).astype(np.float32)).to(dev)
    _, stats = gn_relu.gn_relu_forward(x, wt, bs, 32, 1e-5, act)
    before = gn_relu.gn_relu_backward.launches
    got = gn_relu.gn_relu_backward(x, wt, bs, stats, dy, 32, act)
    again = gn_relu.gn_relu_backward(x, wt, bs, stats, dy, 32, act)
    torch.cuda.synchronize()
    assert gn_relu.gn_relu_backward.launches == before + 2
    assert all(torch.equal(a, e) for a, e in zip(got, again))
    want = gn_relu.gn_relu_backward_plain(x, wt, bs, stats, dy, 32, act)
    for name, a, e in zip(("dx", "dweight", "dbias"), got, want):
        # sums over up to 16800 elements per (image, channel), reordered
        err = float((a - e).abs().max()) / max(float(e.abs().max()), 1e-30)
        assert err <= 1e-5, (name, err)


@pytest.mark.parametrize("act", [True, False])
@pytest.mark.parametrize("b", [1, 8])
def test_gn_relu_backward_is_two_device_kernels(dev, b, act):
    """One K4b call runs its two kernels and no other device work: the
    coefficients are formed inside the second kernel."""
    rng = np.random.RandomState(6)
    shape = (b, 256, 25, 42)
    x = torch.from_numpy((rng.randn(*shape) * 3 + 1).astype(np.float32)
                         ).to(dev)
    dy = torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(dev)
    wt = torch.from_numpy((rng.rand(256) + 0.5).astype(np.float32)).to(dev)
    bs = torch.from_numpy((rng.randn(256) * 0.2).astype(np.float32)).to(dev)
    _, stats = gn_relu.gn_relu_forward(x, wt, bs, 32, 1e-5, act)
    names = sorted(_last_run_kernels(
        lambda: gn_relu.gn_relu_backward(x, wt, bs, stats, dy, 32, act), 2))
    assert "gn_bwd_apply_kernel" in names[0], names
    assert "gn_bwd_reduce_kernel" in names[1], names
    got = gn_relu.gn_relu_backward(x, wt, bs, stats, dy, 32, act)
    want = gn_relu.gn_relu_backward_plain(x, wt, bs, stats, dy, 32, act)
    for name, a, e in zip(("dx", "dweight", "dbias"), got, want):
        # sums over 1050 elements per (image, channel), reordered
        err = float((a - e).abs().max()) / max(float(e.abs().max()), 1e-30)
        assert err <= 1e-5, (name, err)


def test_autograd_functions_keep_the_graph(dev):
    """Outputs of the kernels' autograd Functions carry a grad_fn and their
    backward launches the kernels; a direct K1 or K3a call that would drop
    the graph raises instead."""
    from sipmask_tpu_torch.ops import deform_conv, mask_loss
    x, off, w2, _ = _deform_case(dev, 1, 16, 4, 9, 10, "random", o=8)
    x.requires_grad_(True)
    off.requires_grad_(True)
    weight = torch.randn(8, 16, 3, 3, device=dev, requires_grad=True)
    out = deform_conv.deform_conv2d(x, off, weight, padding=1,
                                    deform_groups=4)
    assert out.grad_fn is not None
    k2 = deform_conv.deform_conv_backward.launches
    out.square().sum().backward()
    assert deform_conv.deform_conv_backward.launches == k2 + 1
    assert x.grad is not None and off.grad is not None
    assert weight.grad is not None
    with pytest.raises(RuntimeError, match="no gradient"):
        deform_sample.deform_im2col(x, off, (3, 3), 1, 1, 1, 4)

    wt = torch.ones(16, device=dev, requires_grad=True)
    bs = torch.zeros(16, device=dev, requires_grad=True)
    y = gn_relu.gn_relu(x, wt, bs, 4)
    assert y.grad_fn is not None
    k4b = gn_relu.gn_relu_backward.launches
    y.sum().backward()
    assert gn_relu.gn_relu_backward.launches == k4b + 1
    assert wt.grad is not None and bs.grad is not None

    args = _mask_case(dev, 1, 9, 3, 20, 24)
    args[0].requires_grad_(True)
    args[1].requires_grad_(True)
    pre = mask_loss.mask_bce_loss(*args)
    assert pre.grad_fn is not None
    k3b = mask_loss.mask_bce_backward.launches
    pre.sum().backward()
    assert mask_loss.mask_bce_backward.launches == k3b + 1
    assert args[0].grad is not None and args[1].grad is not None
    with pytest.raises(RuntimeError, match="no gradient"):
        mask_loss.mask_bce_forward(*args)


def test_training_wrappers_refuse_what_the_kernels_do_not_take(dev):
    from sipmask_tpu_torch.ops import deform_conv, mask_loss
    x, off, w2, dy = _deform_case(dev, 1, 16, 4, 6, 7, "random", o=8)
    cols = deform_sample.deform_im2col(x, off, (3, 3), 1, 1, 1, 4)
    with pytest.raises(TypeError):
        deform_conv.deform_conv_backward(x, off, cols, w2.double(), dy,
                                         (3, 3), 1, 1, 1, 4)
    with pytest.raises(ValueError, match="contiguous"):
        deform_conv.deform_conv_backward(x, off, cols, w2,
                                         dy.transpose(2, 3).contiguous()
                                         .transpose(2, 3), (3, 3), 1, 1, 1, 4)
    with pytest.raises(ValueError, match="device"):
        deform_conv.deform_conv_backward(x, off, cols, w2.cpu(), dy, (3, 3),
                                         1, 1, 1, 4)
    args = _mask_case(dev, 1, 9, 3, 20, 24)
    with pytest.raises(TypeError):
        mask_loss.mask_bce_forward(args[0].double(), *args[1:])
    with pytest.raises(ValueError, match="contiguous"):
        mask_loss.mask_bce_forward(
            args[0].transpose(2, 3).contiguous().transpose(2, 3), *args[1:])
    with pytest.raises(ValueError, match="device"):
        mask_loss.mask_bce_forward(*args[:3], args[3].cpu(), *args[4:])
    wt, bs = torch.ones(16, device=dev), torch.zeros(16, device=dev)
    _, stats = gn_relu.gn_relu_forward(x, wt, bs, 4)
    with pytest.raises(ValueError, match="dy"):
        gn_relu.gn_relu_backward(x, wt, bs, stats, dy[:, :4], 4, True)
    with pytest.raises(ValueError, match="contiguous"):
        gn_relu.gn_relu_backward(
            x.transpose(2, 3).contiguous().transpose(2, 3), wt, bs, stats,
            x, 4, True)
    with pytest.raises(ValueError, match="stats"):
        gn_relu.gn_relu_backward(x, wt, bs, stats[:, :2], x, 4, True)


# --------------------------------------------- K5, K5c, K6 (SipMask++ slice)

def _rows_case(dev, n, h, w, cg, k, p, regime, seed=3):
    """x_rows, pyx and a cotangent: 'random' positions over the map and its
    borders with a third +-300 px out, 'zero' offsets (integer positions,
    DeformConvPack's initial state), or '6px': a 3x3 conv's taps (k = 9,
    p = h*w) moved by offsets of up to +-6 px."""
    rng = np.random.RandomState(seed)
    x = rng.randn(n, h * w, cg).astype(np.float32)
    if regime == "zero":
        yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
        base = np.stack([yy, xx], -1).reshape(-1, 2)[:p].astype(np.float32)
        pyx = np.broadcast_to(base, (n, k, p, 2)).copy()
    elif regime == "6px":
        off = rng.uniform(-6.0, 6.0, (n, 2 * k, h, w)).astype(np.float32)
        pyx = deform_sample.positions(torch.from_numpy(off), 3, 3, 1, 1, 1,
                                      1).numpy()
    else:
        pyx = (rng.rand(n, k, p, 2) * np.float32([h + 3, w + 3]) - 1.5
               ).astype(np.float32)
        pyx[:, :, : p // 3] += rng.choice([-300.0, 300.0], (n, k, p // 3, 2))
    g = rng.randn(n, p, k, cg).astype(np.float32)
    return [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
            for a in (x, pyx, g)]


@pytest.mark.parametrize("n,h,w,cg,k,regime", [
    (2, 17, 17, 512, 9, "random"),   # layer4 at 544, Cg % 4 == 0: vectors
    (2, 34, 34, 256, 9, "zero"),     # layer3, every position on the grid
    (1, 9, 7, 6, 4, "random"),       # Cg % 4 != 0: the scalar path
    # the SipMask++ train step's DCN convs (576x576)
    (2, 72, 72, 128, 9, "random"),
    (2, 72, 72, 128, 9, "zero"),
    (2, 36, 36, 256, 9, "random"),
    (2, 36, 36, 256, 9, "zero"),
    (2, 18, 18, 512, 9, "random"),
    (2, 18, 18, 512, 9, "zero"),
    (2, 36, 36, 256, 9, "6px"),
    (1, 9, 7, 6, 9, "6px"),          # Cg = 6: scalar atomics
])
def test_deform_rows_kernels_match_plain(dev, n, h, w, cg, k, regime):
    from sipmask_tpu_torch.ops import deform_sample as ds
    p = h * w
    x, pyx, g = _rows_case(dev, n, h, w, cg, k, p, regime)
    before = (ds.deform_rows.launches, ds.deform_rows_backward.launches)
    got = ds.deform_rows(x, pyx, h, w)
    dx, dp = ds.deform_rows_backward(x, pyx, g, h, w)
    again = ds.deform_rows_backward(x, pyx, g, h, w)[1]
    torch.cuda.synchronize()
    assert (ds.deform_rows.launches, ds.deform_rows_backward.launches) == (
        before[0] + 1, before[1] + 2)
    want = ds.deform_rows_plain(x, pyx, h, w)
    # the same four f32 products; the kernel may fuse them into FMAs
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    want_dx, want_dp = ds.deform_rows_backward_plain(x, pyx, g, h, w)
    for a, e, name in ((dx, want_dx, "dx"), (dp, want_dp, "dpyx")):
        # dx: atomics in run-to-run order; dpyx: Cg products summed across
        # a warp
        err = float((a - e).abs().max()) / max(float(e.abs().max()), 1e-30)
        assert err <= 1e-5, (name, err)
    # dpyx is summed in a fixed order: the same bits on every call
    assert torch.equal(dp, again)
    if regime == "zero":   # the one-sided rule at integer positions
        assert float(dp.abs().max()) > 0


@pytest.mark.parametrize("cg", [64, 6])
def test_deform_rows_backward_is_one_kernel_after_the_fill(dev, cg):
    """A K5c call is its kernel after the zeroing of dx (a fill kernel at
    this size), and no other device work, with 16-byte vectors
    (Cg % 4 == 0) or without."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from sipmask_tpu_torch.ops import deform_sample as ds
    h = w = 18
    x, pyx, g = _rows_case(dev, 2, h, w, cg, 9, h * w, "random", seed=7)
    ds.deform_rows_backward(x, pyx, g, h, w)   # builds
    torch.cuda.synchronize()
    # a marker kernel starts each session, and one of three sessions must
    # see both kernels (the card's profiler sometimes misses some)
    sessions = []
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            torch.cuda._sleep(1000)
            torch.cuda.synchronize()
            ds.deform_rows_backward(x, pyx, g, h, w)
            torch.cuda.synchronize()
        sessions.append([e.name for e in prof.events()
                         if e.device_type == DeviceType.CUDA
                         and "spin_kernel" not in e.name])
    assert all(len(names) <= 2 for names in sessions), sessions
    names = max(sessions, key=len)
    assert len(names) == 2, sessions
    assert sum("deform_rows_bwd_kernel" in n for n in names) == 1, names
    assert sum("FillFunctor" in n for n in names) == 1, names


@pytest.mark.parametrize("b,h,w,n", [(2, 68, 68, 100), (1, 36, 40, 256)])
def test_assemble_masks_kernel_matches_plain(dev, b, h, w, n):
    from sipmask_tpu_torch.ops import mask_assembly
    rng = np.random.RandomState(4)
    basis = torch.from_numpy(rng.randn(b, 32, h, w).astype(np.float32)
                             ).to(dev).permute(0, 2, 3, 1)   # an NCHW view
    cofs = torch.from_numpy((rng.randn(b, n, 128) * 0.3).astype(np.float32)
                            ).to(dev)
    x1 = rng.uniform(-4, w, (b, n))
    y1 = rng.uniform(-4, h, (b, n))
    boxes = np.stack([x1, y1, x1 + rng.uniform(0, w / 2, (b, n)),
                      y1 + rng.uniform(0, h / 2, (b, n))], -1)
    boxes[:, 0] = [-1.0, -1.0, w + 1.0, h + 1.0]
    boxes[:, 1] = [3.0, 4.0, 3.0, 9.0]
    boxes = torch.from_numpy(boxes.astype(np.float32)).to(dev)
    before = mask_assembly.assemble_masks.launches
    got = mask_assembly.assemble_masks(basis, cofs, boxes)
    torch.cuda.synchronize()
    assert mask_assembly.assemble_masks.launches == before + 1
    want = mask_assembly.assemble_masks_plain(basis, cofs, boxes)
    # sigmoid of a 32-term f32 dot summed in another order
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
    # the crop compares the split points of CropSplit's f32 expressions:
    # the same zeros
    assert torch.equal(got == 0, want == 0)
    # detection-major: the callers' (B, N, h, w) masks, with no copy
    assert got.shape == (b, h, w, n)
    nchw = got.permute(0, 3, 1, 2)
    assert nchw.is_contiguous()
    assert nchw.contiguous().data_ptr() == got.data_ptr()


@pytest.mark.parametrize("h,w", [(13, 30), (40, 72), (8, 3)])
def test_assemble_masks_kernel_at_box_edges(dev, h, w):
    """Boxes on pixel edges, fractional, negative, past the grid, of zero
    width, infinite and NaN, on grids whose width is not a multiple of the
    kernel's 32-pixel segments: the plain version's values and zeros."""
    from sipmask_tpu_torch.ops import mask_assembly
    rng = np.random.RandomState(12)
    b, n = 2, 48
    basis = torch.from_numpy(rng.randn(b, 32, h, w).astype(np.float32)
                             ).to(dev).permute(0, 2, 3, 1)
    cofs = torch.from_numpy((rng.randn(b, n, 128) * 0.3).astype(np.float32)
                            ).to(dev)
    edges = np.array([-3.0, -0.5, 0.0, 0.5, 1.0, 2.5, 7.0, 7.5, 31.0, 32.0,
                      w - 1.0, w - 0.5, w, w + 0.5, w + 9.0])
    xs = np.sort(rng.choice(edges, (b, n, 2)), -1)
    ys = np.sort(rng.choice(edges * h / w, (b, n, 2)), -1)
    boxes = np.stack([xs[..., 0], ys[..., 0], xs[..., 1], ys[..., 1]], -1)
    boxes[:, 0] = [-np.inf, -np.inf, np.inf, np.inf]
    boxes[:, 1] = [np.nan, 0.0, w, h]
    boxes[:, 2] = [2.0, 1.0, 2.0, h]               # zero width
    boxes = torch.from_numpy(boxes.astype(np.float32)).to(dev)
    got = mask_assembly.assemble_masks(basis, cofs, boxes)
    want = mask_assembly.assemble_masks_plain(basis, cofs, boxes)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
    assert torch.equal(got == 0, want == 0)
    assert bool((got[..., 0] > 0).all())
    assert not got[..., 1:3].any()


@pytest.mark.parametrize("b,h,w,n", [(8, 272, 272, 100), (1, 36, 40, 256)])
def test_assemble_masks_is_one_device_kernel(dev, b, h, w, n):
    """A K6 call on an NCHW basis view, contiguous cofs and f32 boxes is
    at most its kernel and no other device work."""
    from sipmask_tpu_torch.ops import mask_assembly
    rng = np.random.RandomState(8)
    basis = torch.from_numpy(rng.randn(b, 32, h, w).astype(np.float32)
                             ).to(dev).permute(0, 2, 3, 1)
    cofs = torch.from_numpy((rng.randn(b, n, 128) * 0.3).astype(np.float32)
                            ).to(dev)
    x1 = rng.uniform(-4, w, (b, n))
    y1 = rng.uniform(-4, h, (b, n))
    boxes = torch.from_numpy(np.stack(
        [x1, y1, x1 + rng.uniform(0, w / 2, (b, n)),
         y1 + rng.uniform(0, h / 2, (b, n))], -1).astype(np.float32)).to(dev)
    # late in a long run the card's profiler dropped this kernel from most
    # sessions: 4 calls a session, and every kernel seen must be K6's, at
    # most one a call
    sessions = _device_kernels(
        lambda: [mask_assembly.assemble_masks(basis, cofs, boxes)
                 for _ in range(4)], attempts=8)
    assert all(len(names) <= 4 for names in sessions), sessions
    assert all("assemble_masks_kernel" in n for names in sessions
               for n in names), sessions
    assert max(len(names) for names in sessions) >= 1, sessions


def test_slice_wrappers_refuse_what_the_kernels_do_not_take(dev):
    from sipmask_tpu_torch.ops import deform_sample as ds
    from sipmask_tpu_torch.ops import mask_assembly
    x, pyx, g = _rows_case(dev, 1, 6, 5, 8, 9, 30, "random")
    with pytest.raises(TypeError):
        ds.deform_rows(x.double(), pyx.double(), 6, 5)
    with pytest.raises(ValueError, match="contiguous"):
        ds.deform_rows(x.transpose(1, 2).contiguous().transpose(1, 2), pyx,
                       6, 5)
    with pytest.raises(ValueError, match="dsampled"):
        ds.deform_rows_backward(x, pyx, g[:, :4], 6, 5)
    with pytest.raises(RuntimeError, match="no gradient"):
        ds.deform_rows(x.requires_grad_(True), pyx, 6, 5)
    basis = torch.zeros((1, 8, 8, 32), device=dev)
    with pytest.raises(TypeError):
        mask_assembly.assemble_masks(basis.double(),
                                     torch.zeros((1, 3, 128), device=dev),
                                     torch.zeros((1, 3, 4), device=dev))
    with pytest.raises(ValueError, match="fit"):
        mask_assembly.assemble_masks(basis,
                                     torch.zeros((1, 3, 64), device=dev),
                                     torch.zeros((1, 3, 4), device=dev))
    with pytest.raises(ValueError, match="32 basis masks"):
        mask_assembly.assemble_masks(torch.zeros((1, 8, 8, 8), device=dev),
                                     torch.zeros((1, 3, 32), device=dev),
                                     torch.zeros((1, 3, 4), device=dev))


def test_rt_serving_kernels_match_plain(dev, monkeypatch):
    """sipmask_r50_fpn_ssd_6x (norm-free 2-conv head, ssd_flag, fast NMS)
    at a small width (FPN and head 32 wide) and a 128x128 stretch, serving
    a batch of two non-square images (sx != sy): a forward launches K1 at
    each of the 5 levels and the decode K6 once, and every detection is
    the plain versions' (label, box within 0.01 px, score and mask
    probabilities within 1e-4)."""
    from sipmask_tpu_torch.apis.inference import init_detector, preprocess
    from sipmask_tpu_torch.config import apply_overrides, get_config
    from sipmask_tpu_torch.ops import deform_conv, mask_assembly
    from sipmask_tpu_torch.utils.demo_inputs import (bump_weights,
                                                     calibrate_frozen_bn)
    cfg = apply_overrides(get_config("sipmask_r50_fpn_ssd_6x"), [
        "model.fpn.out_channels=32", "model.head.in_channels=32",
        "model.head.feat_channels=32", "data.fixed_size=(128,128)"])
    det = init_detector(cfg, dev, seed=0)
    bump_weights(det.model, torch.Generator().manual_seed(0))
    rng = np.random.RandomState(0)
    prepped = [preprocess((rng.rand(*hw, 3) * 255).astype(np.uint8), cfg)
               for hw in ((96, 128), (150, 100))]
    assert all(p[2][0] != p[2][1] for p in prepped)
    images = torch.stack([torch.from_numpy(p[0]).permute(2, 0, 1)
                          for p in prepped]).to(dev)
    shapes = torch.from_numpy(np.stack([p[1] for p in prepped]))
    scales = torch.from_numpy(np.stack([p[2] for p in prepped]))
    calibrate_frozen_bn(det.model.backbone, images)
    k1 = deform_sample.deform_im2col.launches
    k6 = mask_assembly.assemble_masks.launches
    got = det.infer(images, shapes, scales)
    assert deform_sample.deform_im2col.launches - k1 == 5
    assert mask_assembly.assemble_masks.launches - k6 == 1
    monkeypatch.setattr(deform_conv, "deform_conv2d",
                        deform_conv.deform_conv2d_plain)
    monkeypatch.setattr(mask_assembly, "assemble_masks",
                        mask_assembly.assemble_masks_plain)
    want = det.infer(images, shapes, scales)
    assert deform_sample.deform_im2col.launches - k1 == 5
    assert torch.equal(got["valid"].sum(1), want["valid"].sum(1))
    assert int(got["valid"].sum()) > 0
    for i in range(2):
        g, w = got["valid"][i], want["valid"][i]
        same = ((got["labels"][i][g][:, None] == want["labels"][i][w][None])
                & ((got["boxes"][i][g][:, None] - want["boxes"][i][w][None])
                   .abs().amax(-1) <= 1e-2)
                & ((got["scores"][i][g][:, None]
                    - want["scores"][i][w][None]).abs() <= 1e-4))
        assert bool(same.any(1).all()), i
        pairs = same.float().argmax(1)
        masks_g, masks_w = got["masks"][i][g], want["masks"][i][w][pairs]
        assert float((masks_g - masks_w).abs().max()) <= 1e-4


# ------------------------------------- bf16 variants (compute_dtype bfloat16)

BF16 = torch.bfloat16
# a bf16 kernel and its plain version round the same f32 values, summed in
# another order, so a value near a rounding boundary may land one bf16 unit
# apart: 2**-7 of an output's max bounds one unit anywhere
BF16_TOL = 2.0 ** -7


def _close_to_max(got, want, tol=BF16_TOL):
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        err = float((g.float() - w.float()).abs().max())
        assert err <= tol * float(w.float().abs().max()), err


@pytest.mark.parametrize("b,c,g,h,w,stride,far", [
    (2, 256, 4, 100, 168, 1, True),    # P3: Cg = 64, 16-byte gathers
    (2, 256, 4, 7, 11, 1, False),      # P7: P % 4 != 0
    (1, 20, 4, 13, 9, 2, True),        # Cg = 5: scalar gathers
    (2, 48, 2, 17, 15, 1, True),       # Cg = 24: 16-byte gathers, no CG
])
def test_bf16_deform_im2col_kernel_matches_plain(dev, b, c, g, h, w, stride,
                                                 far):
    rng = np.random.RandomState(1)
    ho, wo = deform_sample.out_size(h, w, 3, 3, stride, 1, 1)
    x = torch.from_numpy(rng.randn(b, c, h, w).astype(np.float32)).to(
        dev).to(BF16)
    off = torch.from_numpy(_offsets(rng, b, g * 18, ho, wo, far)).to(dev)
    before = (deform_sample.deform_im2col.launches,
              deform_sample.deform_im2col.bf16_launches)
    got = deform_sample.deform_im2col(x, off, (3, 3), stride, 1, 1, g)
    torch.cuda.synchronize()
    assert (deform_sample.deform_im2col.launches,
            deform_sample.deform_im2col.bf16_launches) == (before[0],
                                                           before[1] + 1)
    want = deform_sample.deform_im2col_plain(x, off, (3, 3), stride, 1, 1, g)
    _close_to_max([got], [want])


# FeatureAlign's levels as the presets run them: 800x1344 (the flagship,
# X101, HRNet's P3-P7 and the fork), SipMask++ and the real-time preset at
# 544 (serving) and 576 (training), VIS at 384x640, HRFPN's floor-pooled
# 12x21 and 6x10
K1_LEVELS = sorted({(100, 168), (50, 84), (25, 42), (13, 21), (7, 11),
                    (68, 68), (34, 34), (17, 17), (9, 9), (5, 5),
                    (72, 72), (36, 36), (18, 18), (48, 80), (24, 40),
                    (12, 20), (6, 10), (3, 5), (12, 21)})


@pytest.mark.parametrize("regime", ["random", "far", "zero"])
@pytest.mark.parametrize("h,w", K1_LEVELS)
def test_bf16_deform_im2col_at_the_preset_levels(dev, h, w, regime):
    """The bf16 K1 (Cg = 64: the TMA store where P % 8 == 0, else register
    stores) against its plain version at every FeatureAlign level the
    presets run, offsets ~2 px, a third +-300 px out, or 0: within one bf16
    unit of the output's max, the same bits in two calls."""
    rng = np.random.RandomState(h * 1000 + w)
    b, c, g = 2, 256, 4
    x = torch.from_numpy(rng.randn(b, c, h, w).astype(np.float32)).to(
        dev).to(BF16)
    off = _offsets(rng, b, g * 18, h, w, regime == "far")
    off = torch.from_numpy(off * (regime != "zero")).to(dev)
    got = deform_sample.deform_im2col(x, off, (3, 3), 1, 1, 1, g)
    again = deform_sample.deform_im2col(x, off, (3, 3), 1, 1, 1, g)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    want = deform_sample.deform_im2col_plain(x, off, (3, 3), 1, 1, 1, g)
    _close_to_max([got], [want])


@pytest.mark.parametrize("c,g,h,w,misalign", [
    (256, 4, 100, 168, False),   # P % 8 == 0: the TMA store
    (256, 4, 34, 34, False),     # P % 4 == 0: 8-byte register stores
    (256, 4, 25, 42, False),     # P even: 4-byte stores
    (256, 4, 7, 11, False),      # P odd: 2-byte stores
    (48, 2, 17, 15, False),      # Cg = 24: Cg a runtime value
    (20, 4, 13, 9, False),       # Cg = 5: the scalar kernels
    (256, 4, 25, 42, True),      # x not 16-byte aligned: the scalar kernels
])
def test_bf16_deform_im2col_device_kernels(dev, c, g, h, w, misalign):
    """A bf16 K1 call is two device kernels, by name: the bf16 design's
    transpose and gather where Cg % 8 == 0 and the pointers are 16-byte
    aligned, its gather storing as the CPU mirror's route says (template
    arguments <CG, STORE>: Cg when 64, else 0; 0 for the TMA store, else
    the elements a register store), else the scalar kernels; each route
    against the plain version and giving the same bits twice."""
    rng = np.random.RandomState(7)
    b = 2
    n = b * c * h * w
    buf = torch.from_numpy(rng.randn(n + 1).astype(np.float32)).to(dev).to(
        BF16)
    x = (buf[1:] if misalign else buf[:n]).view(b, c, h, w)
    assert (x.data_ptr() % 16 != 0) == misalign
    off = torch.from_numpy(_offsets(rng, b, g * 18, h, w, True)).to(dev)
    names = _last_run_kernels(
        lambda: deform_sample.deform_im2col(x, off, (3, 3), 1, 1, 1, g), 2)
    cg = c // g
    store = deform_sample.im2col_bf16_route(cg, h * w, not misalign)
    kernels = (("deform_im2col_rows_kernel", "deform_im2col_kernel")
               if store < 0 else
               ("deform_im2col_rows_bf16_kernel",
                f"deform_im2col_bf16_kernel<{64 if cg == 64 else 0}, "
                f"{store}>"))
    assert [sum(k in n for n in names) for k in kernels] == [1, 1], names
    got = deform_sample.deform_im2col(x, off, (3, 3), 1, 1, 1, g)
    again = deform_sample.deform_im2col(x, off, (3, 3), 1, 1, 1, g)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    _close_to_max([got], [deform_sample.deform_im2col_plain(
        x, off, (3, 3), 1, 1, 1, g)])


@pytest.mark.parametrize("b,c,g,h,w,regime", [
    (2, 256, 4, 100, 168, "random"),   # P3: the wgmma GEMMs (TMA)
    (2, 256, 4, 50, 84, "zero"),       # zero-weight corners skipped
    (2, 256, 4, 7, 11, "far"),         # P % 8 != 0: padded rows
    (1, 20, 4, 9, 13, "random"),       # Cg = 5, odd: scalar lanes
    (2, 256, 4, 25, 42, "random"),     # P5, P % 8 == 2: padded rows
    (2, 256, 4, 12, 21, "random"),     # HRFPN's 12x21: padded, P odd
    (4, 256, 4, 100, 168, "random"),   # batch 4 at P3
    (1, 256, 4, 13, 21, "zero"),       # the skip on the padded route
    (2, 32, 4, 25, 42, "random"),      # K*Cg = 72: mma.sync, float4 lanes
])
def test_bf16_deform_conv_backward_kernel_matches_plain(dev, b, c, g, h, w,
                                                        regime):
    from sipmask_tpu_torch.ops import deform_conv
    x, off, w2, dy = _deform_case(dev, b, c, g, h, w, regime)
    x, w2, dy = x.to(BF16), w2.to(BF16), dy.to(BF16)
    cols = deform_sample.deform_im2col(x, off, (3, 3), 1, 1, 1, g)
    before = deform_conv.deform_conv_backward.bf16_launches
    got = deform_conv.deform_conv_backward(x, off, cols, w2, dy, (3, 3), 1,
                                           1, 1, g)
    torch.cuda.synchronize()
    assert deform_conv.deform_conv_backward.bf16_launches == before + 1
    assert [t.dtype for t in got] == [BF16, torch.float32, torch.float32]
    want = deform_conv.deform_conv_backward_plain(x, off, w2, dy, (3, 3), 1,
                                                  1, 1, g)
    _close_to_max(got, want)
    if regime == "zero":   # the one-sided rule: offsets train from zero
        assert float(got[1].abs().max()) > 0
    # dW2 (partials folded in order) and d offsets (fixed shuffle trees)
    # take no atomics: the same bits from call to call
    again = deform_conv.deform_conv_backward(x, off, cols, w2, dy, (3, 3),
                                             1, 1, 1, g)
    assert torch.equal(again[1], got[1]) and torch.equal(again[2], got[2])


@pytest.mark.parametrize("c,h,w,gemms", [
    (256, 100, 168, ("deform_bwd_gemm_wgmma_dcols",
                     "deform_bwd_gemm_wgmma_dw2")),       # P % 8 == 0
    (256, 25, 42, ("pad_rows_kernel", "deform_bwd_gemm_wgmma_dcols",
                   "deform_bwd_gemm_wgmma_dw2")),         # P % 8 == 2
    (32, 25, 42, ("deform_bwd_gemm_bf16_kernel",) * 2),   # K*Cg = 72
])
def test_bf16_deform_conv_backward_device_kernels(dev, c, h, w, gemms):
    """A bf16 K2 call is the kernels csrc/deform_col2im.cu states: the
    transpose of x (which also zeroes the dX scratch), the GEMMs of the
    route its shape takes (where P % 8 != 0 after the copy of dy and cols
    into padded rows; mma.sync where K*Cg is no multiple of 192), the fold
    of the partials, the half-warp scatter (Cg % 4 == 0) and the transpose
    of dX: six kernels, seven with the copy."""
    from sipmask_tpu_torch.ops import deform_conv
    b, g = 2, 4
    x, off, w2, dy = _deform_case(dev, b, c, g, h, w, "random")
    x, w2, dy = x.to(BF16), w2.to(BF16), dy.to(BF16)
    cols = deform_sample.deform_im2col(x, off, (3, 3), 1, 1, 1, g)
    names = _last_run_kernels(lambda: deform_conv.deform_conv_backward(
        x, off, cols, w2, dy, (3, 3), 1, 1, 1, g), 4 + len(gemms))
    want = ["deform_bwd_transpose_kernel", "deform_bwd_transpose_kernel",
            *gemms, "fold_partials_kernel", "deform_col2im_bf16x4_kernel"]
    for kernel in set(want):
        assert sum(kernel in n for n in names) == want.count(kernel), (
            kernel, names)


@pytest.mark.parametrize("act", [True, False])
@pytest.mark.parametrize("shape", [(2, 256, 100, 168), (2, 256, 7, 11),
                                   (1, 64, 5, 7)])
def test_bf16_gn_relu_kernels_match_plain(dev, shape, act):
    rng = np.random.RandomState(4)
    x = torch.from_numpy((rng.randn(*shape) * 3 + 1).astype(np.float32)
                         ).to(dev).to(BF16)
    dy = torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(dev).to(
        BF16)
    c = shape[1]
    wt = torch.from_numpy((rng.rand(c) + 0.5).astype(np.float32)).to(dev)
    bs = torch.from_numpy((rng.randn(c) * 0.2).astype(np.float32)).to(dev)
    before = (gn_relu.gn_relu.bf16_launches,
              gn_relu.gn_relu_backward.bf16_launches)
    y, stats = gn_relu.gn_relu_forward(x, wt, bs, 32, 1e-5, act)
    back = gn_relu.gn_relu_backward(x, wt, bs, stats, dy, 32, act)
    torch.cuda.synchronize()
    assert (gn_relu.gn_relu.bf16_launches,
            gn_relu.gn_relu_backward.bf16_launches) == (before[0] + 1,
                                                        before[1] + 1)
    want_y, want_stats = gn_relu._forward_plain(x, wt, bs, 32, 1e-5, act)
    _close_to_max([y, stats], [want_y, want_stats])
    _close_to_max(back, gn_relu.gn_relu_backward_plain(x, wt, bs, stats, dy,
                                                       32, act))


# K4a and K4b in bf16 at the shapes of every preset's GroupNorm kind: the
# flagship's five 800x1344 levels, a VIS level (384x640), an HRFPN level,
# and a slab past what a cluster holds (the two-pass kernels); then Cg = 4,
# whose 468-element slabs take 8-byte vectors that straddle channels
GN_BF16_SHAPES = [(2, 256, 100, 168), (2, 256, 50, 84), (2, 256, 25, 42),
                  (2, 256, 13, 21), (2, 256, 7, 11), (2, 256, 48, 80),
                  (2, 256, 12, 21), (1, 256, 256, 272), (2, 128, 9, 13)]


@pytest.mark.parametrize("act", [True, False])
@pytest.mark.parametrize("shape", GN_BF16_SHAPES)
def test_bf16_gn_relu_one_pass_matches_plain_and_repeats_its_bits(
        dev, shape, act):
    """The bf16 K4a and K4b (one-pass cluster kernels, or past capacity the
    two-pass ones) match their plain versions within one bf16 unit of each
    output's max, and give the same bits twice."""
    rng = np.random.RandomState(8)
    x = torch.from_numpy((rng.randn(*shape) * 3 + 1).astype(np.float32)
                         ).to(dev).to(BF16)
    dy = torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(dev).to(
        BF16)
    c = shape[1]
    wt = torch.from_numpy((rng.rand(c) + 0.5).astype(np.float32)).to(dev)
    bs = torch.from_numpy((rng.randn(c) * 0.2).astype(np.float32)).to(dev)
    y, stats = gn_relu.gn_relu_forward(x, wt, bs, 32, 1e-5, act)
    back = gn_relu.gn_relu_backward(x, wt, bs, stats, dy, 32, act)
    y2, stats2 = gn_relu.gn_relu_forward(x, wt, bs, 32, 1e-5, act)
    back2 = gn_relu.gn_relu_backward(x, wt, bs, stats, dy, 32, act)
    torch.cuda.synchronize()
    assert torch.equal(y, y2) and torch.equal(stats, stats2)
    assert all(torch.equal(a, b) for a, b in zip(back, back2))
    want_y, want_stats = gn_relu._forward_plain(x, wt, bs, 32, 1e-5, act)
    _close_to_max([y, stats], [want_y, want_stats])
    _close_to_max(back, gn_relu.gn_relu_backward_plain(x, wt, bs, stats, dy,
                                                       32, act))


@pytest.mark.parametrize("shape", [(4, 256, 100, 168), (4, 256, 7, 11),
                                   (1, 256, 256, 272)])
def test_bf16_gn_relu_device_kernels(dev, shape):
    """A bf16 K4a call is one device kernel and a K4b call one where
    gn_schedule says one-pass (the cluster kernels, K4b's d weight and d
    bias folded by the last cluster of each group); past capacity each is
    its two two-pass kernels. The C entry's plan is the mirror's."""
    import ctypes
    rng = np.random.RandomState(9)
    b, c, h, w = shape
    x = torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(dev).to(
        BF16)
    dy = torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(dev).to(
        BF16)
    wt = torch.ones(c, device=dev)
    bs = torch.zeros(c, device=dev)
    _, stats = gn_relu.gn_relu_forward(x, wt, bs, 32)
    plan = gn_relu.gn_schedule(b, c, h * w, 32)
    want = {"one-pass": (["gn_fwd_cluster_kernel"],
                         ["gn_bwd_cluster_kernel"]),
            "two-pass": (["gn_stats_kernel", "gn_apply_kernel"],
                         ["gn_bwd_reduce_kernel", "gn_bwd_apply_kernel"])}
    for i, (direction, fn) in enumerate((
            ("forward", lambda: gn_relu.gn_relu_forward(x, wt, bs, 32)),
            ("backward", lambda: gn_relu.gn_relu_backward(
                x, wt, bs, stats, dy, 32, True)))):
        kernels = want[plan[direction]["path"]][i]
        names = _last_run_kernels(fn, len(kernels))
        for kernel in kernels:
            assert sum(kernel in n for n in names) == 1, (kernel, names)
        out = (ctypes.c_longlong * 5)()
        gn_relu._lib().gn_relu_bf16_plan(c // 32 * h * w, b * 32, c // 32,
                                         x.data_ptr(), i, out)
        one, k, t, _ = gn_relu._one_plan(c // 32 * h * w // 8, b * 32,
                                         c // 32, bool(i))
        assert tuple(out)[:3] == (int(one), k, t)
        if one:
            p = plan[direction]
            assert (p["cluster"], p["threads"], p["vector_bytes"]) == (
                k, t, 2 * out[4])


def test_bf16_wrappers_refuse_what_the_kernels_do_not_take(dev):
    from sipmask_tpu_torch.ops import deform_conv
    x, off, w2, dy = _deform_case(dev, 1, 16, 4, 6, 7, "random", o=8)
    xb = x.to(BF16)
    with pytest.raises(TypeError):    # bf16 offsets: K1 takes f32 ones
        deform_sample.deform_im2col(xb, off.to(BF16), (3, 3), 1, 1, 1, 4)
    cols = deform_sample.deform_im2col(xb, off, (3, 3), 1, 1, 1, 4)
    with pytest.raises(TypeError):    # f32 w2 with bf16 x
        deform_conv.deform_conv_backward(xb, off, cols, w2, dy.to(BF16),
                                         (3, 3), 1, 1, 1, 4)
    wt, bs = torch.ones(16, device=dev), torch.zeros(16, device=dev)
    with pytest.raises(TypeError):    # bf16 weight and bias
        gn_relu.gn_relu(xb, wt.to(BF16), bs.to(BF16), 4)
    _, stats = gn_relu.gn_relu_forward(xb, wt, bs, 4)
    with pytest.raises(ValueError, match="dy"):   # f32 dy with bf16 x
        gn_relu.gn_relu_backward(xb, wt, bs, stats, x, 4, True)


@pytest.mark.parametrize("n,h,w,cg,k,regime,misalign", [
    (2, 17, 17, 512, 9, "random", False),  # layer4 at 544: 8-byte lanes
    (2, 68, 68, 128, 9, "random", False),  # layer2 at 544
    (2, 68, 68, 128, 9, "zero", False),    # every position on the grid
    (2, 34, 34, 256, 9, "zero", False),
    (2, 36, 36, 256, 9, "6px", False),
    (1, 9, 7, 12, 9, "random", False),     # Cg % 8 != 0: the vector path
    (1, 9, 7, 36, 9, "6px", False),
    (1, 9, 7, 18, 9, "random", False),     # Cg % 4 != 0: scalars
    (1, 9, 7, 6, 9, "6px", False),
    (2, 17, 17, 64, 9, "random", True),    # Cg % 4 == 0, pointers not
])                                          # 8-byte aligned: scalars
def test_bf16_deform_rows_kernels_match_plain(dev, n, h, w, cg, k, regime,
                                              misalign):
    """K5 and K5c in bf16 (bf16 x_rows and dsampled, f32 positions; a third
    of the random positions +-300 px out) against their plain bf16
    versions, each output within one bf16 unit of its max; d positions the
    same bits on every call."""
    from sipmask_tpu_torch.ops import deform_sample as ds
    p = h * w
    x, pyx, g = _rows_case(dev, n, h, w, cg, k, p, regime, seed=5)
    x, g = x.to(BF16), g.to(BF16)
    if misalign:   # the same values one element into a buffer
        buf = torch.empty(x.numel() + 1, device=dev, dtype=BF16)
        buf[1:].copy_(x.reshape(-1))
        x = buf[1:].view(x.shape)
        assert x.is_contiguous() and x.data_ptr() % 16
    before = (ds.deform_rows.bf16_launches,
              ds.deform_rows_backward.bf16_launches,
              ds.deform_rows.launches, ds.deform_rows_backward.launches)
    got = ds.deform_rows(x, pyx, h, w)
    dx, dp = ds.deform_rows_backward(x, pyx, g, h, w)
    again = ds.deform_rows_backward(x, pyx, g, h, w)[1]
    torch.cuda.synchronize()
    assert (ds.deform_rows.bf16_launches,
            ds.deform_rows_backward.bf16_launches,
            ds.deform_rows.launches, ds.deform_rows_backward.launches) == (
        before[0] + 1, before[1] + 2, before[2], before[3])
    assert (got.dtype, dx.dtype, dp.dtype) == (BF16, BF16, torch.float32)
    _close_to_max([got], [ds.deform_rows_plain(x, pyx, h, w)])
    _close_to_max([dx, dp], ds.deform_rows_backward_plain(x, pyx, g, h, w))
    assert torch.equal(dp, again)
    if regime == "zero":   # the one-sided rule at integer positions
        assert float(dp.abs().max()) > 0


@pytest.mark.parametrize("cg,scatter", [
    (128, "deform_rows_bwd_bf16x4_kernel"),   # lanes of 4 channels
    (64, "deform_rows_bwd_bf16x4_kernel"),
    (6, "deform_rows_bwd_kernel")])           # scalars
def test_bf16_deform_rows_backward_kernels(dev, cg, scatter):
    """A bf16 K5c call is the zeroing of its f32 dx (a memset inside the C
    entry), its scatter kernel and the kernel that rounds dx once to bf16,
    and no other device work."""
    from sipmask_tpu_torch.ops import deform_sample as ds
    h = w = 18
    x, pyx, g = _rows_case(dev, 2, h, w, cg, 9, h * w, "random", seed=7)
    x, g = x.to(BF16), g.to(BF16)
    names = _last_run_kernels(
        lambda: ds.deform_rows_backward(x, pyx, g, h, w), 3)
    for part in (scatter, "round_bf16_kernel", "Memset"):
        assert sum(part in n for n in names) == 1, (part, names)


@pytest.mark.parametrize("cg", [6, 12, 18, 36, 64, 128, 256, 512])
def test_bf16_deform_rows_backward_positions_are_the_same_bits(dev, cg):
    """K5c in bf16 sums d positions by a fixed shuffle tree whose width is
    the item's (a half-warp on the vector path, a warp on the scalar one):
    the same bits on every call at every Cg, while dx's sums may change
    order."""
    from sipmask_tpu_torch.ops import deform_sample as ds
    h, w = 13, 11
    x, pyx, g = _rows_case(dev, 2, h, w, cg, 9, h * w, "random", seed=11)
    x, g = x.to(BF16), g.to(BF16)
    first = ds.deform_rows_backward(x, pyx, g, h, w)[1]
    for _ in range(3):
        assert torch.equal(first, ds.deform_rows_backward(x, pyx, g, h,
                                                          w)[1])
    _close_to_max([first], [ds.deform_rows_backward_plain(x, pyx, g, h,
                                                          w)[1]])


def test_bf16_rows_wrappers_refuse_what_the_kernels_do_not_take(dev):
    from sipmask_tpu_torch.ops import deform_sample as ds
    x, pyx, g = _rows_case(dev, 1, 6, 5, 8, 9, 30, "random")
    xb, gb = x.to(BF16), g.to(BF16)
    with pytest.raises(TypeError):    # bf16 positions
        ds.deform_rows(xb, pyx.to(BF16), 6, 5)
    with pytest.raises(TypeError):    # f32 dsampled with bf16 x_rows
        ds.deform_rows_backward(xb, pyx, g, 6, 5)
    with pytest.raises(TypeError):    # bf16 dsampled with f32 x_rows
        ds.deform_rows_backward(x, pyx, gb, 6, 5)


# ------------------------------------- the modules outside the presets

LIBRARY_CASES = ("ssd300", "bfp_non_local", "bfp_conv", "roi_align",
                 "roi_pool", "modulated_deform_roi_pooling_pack", "carafe",
                 "masked_conv2d", "grid_sample")


@pytest.mark.parametrize("name", LIBRARY_CASES)
def test_library_module_on_the_card_matches_float64(dev, name):
    """chip_smoke.py's phase 36 at small sizes: the module forward and
    backward in f32 (and SSD-VGG in bf16) on CUDA tensors against the same
    module and weights in float64 on the card."""
    from sipmask_tpu_torch.tools import library_check as lc
    case = {c.name: c for c in lc.cases(lc.SMALL, dev)}[name]
    res = lc.compare(case, dev)
    assert res["f32"]["err"] <= lc.F32_TOL and res["f32"]["ms"] > 0


def test_max_iou_assign_and_random_sample_on_the_card(dev):
    from sipmask_tpu_torch.tools import library_check as lc
    res = lc.check_assign(lc.SMALL, dev)
    assert res["positives"] > 0 and res["ms"] > 0
