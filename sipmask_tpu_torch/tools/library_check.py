"""The port's modules outside the presets, each run forward and backward in
f32 and held against the same module and weights in float64 on the same
device: the RoI ops and the modulated deformable RoI-pooling pack
(``ops/roi.py``), SSD-VGG (``models/ssd_vgg.py``, also in bf16), BFP
(``models/bfp.py``), the MaxIoU assigner and the random sampler
(``core/assigners.py``). ``chip_smoke.py``'s phase 36 runs the cases at
deployment sizes (``DEPLOYMENT``, from mmdetection v1's configs of these
families) on the card; the tests run them at ``SMALL`` sizes.

Every output and every gradient (to the float inputs and to the weights)
must lie on the device and within ``F32_TOL`` (outputs) or ``GRAD_TOL``
(gradients) of the float64 one's largest absolute value (SSD-VGG's bf16
run within ``BF16_TOL``). The ReLUs and max
pools are pinned to the float64 run's choices in the other runs
(:func:`pinned_kinks`): a random network puts pre-activations within
rounding of 0 and near-equal values in pool windows, and a choice that f32
rounding flips moves a whole row of a weight gradient (measured on SSD300:
one pool4 window of 184,832 picked otherwise moved conv1_1's gradient by
2e-3 of its max). RoIs stay f32 in every run, as a detector hands them
over, so that the RoI ops quantize them alike.
"""

from __future__ import annotations

import contextlib
import copy
import math
import time
from typing import Callable, NamedTuple, Optional, Sequence

import torch
from torch import nn

from ..core.assigners import max_iou_assign, random_sample
from ..core.boxes import bbox_overlaps
from ..models.bfp import BFP
from ..models.ssd_vgg import SSDVGG
from ..ops import roi
from ..utils.convert import init_weights

F32_TOL = 1e-4     # outputs, of the float64 output's largest |value|
# gradients: a weight gradient sums B*H*W products in f32 (2.1M for
# SSD512's conv1_2 at batch 8, whose cuDNN gradient read 1.48e-4 of its max
# from float64 on the H100)
GRAD_TOL = 1e-3
BF16_TOL = 5e-2    # SSD-VGG's bf16 run: 22 convs rounding to bf16
# a gradient is held relative to its own largest value, or to this share of
# the case's largest gradient where that is more: a gradient that is 0 in
# exact arithmetic (NonLocal2D's phi bias: the softmax ignores a shift
# common to a row) is rounding noise in both runs
ZERO_GRAD = 1e-3

DEPLOYMENT = dict(
    ssd=((300, 8), (512, 8)),          # SSD300/512: imgs_per_gpu 8
    # Libra R-CNN's BFP: 5 levels at strides 4-64 of 2 images at 768x1280
    bfp=(2, 256, ((192, 320), (96, 160), (48, 80), (24, 40), (12, 20))),
    roi_feats=(2, 256, 192, 320),      # the stride-4 level of that pyramid
    rois=1024, pack_rois=512, pack=(7, 256, 1024),
    dense=(2, 256, 96, 160),           # carafe, masked_conv2d
    grid=(8, 256, 100, 168),
    anchors=(120000, 100, 512))
SMALL = dict(
    ssd=((300, 1),),
    bfp=(1, 16, ((32, 32), (16, 16), (8, 8), (4, 4), (2, 2))),
    roi_feats=(2, 8, 24, 40), rois=48, pack_rois=24, pack=(3, 8, 32),
    dense=(2, 8, 12, 20), grid=(2, 8, 10, 17), anchors=(4000, 20, 64))


class Case(NamedTuple):
    name: str
    module: Optional[nn.Module]   # f32 weights; copied to float64
    fn: Callable                  # fn(module, *inputs) -> tensor(s)
    inputs: Sequence[torch.Tensor]
    diff: Sequence[bool]          # inputs cast to float64 and differentiated
    bf16: Optional[nn.Module] = None   # the same weights in bf16 compute


@contextlib.contextmanager
def pinned_kinks(pins: list):
    """Within the context each ``torch.relu`` call, each max pool
    (``torch.max_pool2d``, which ``F.max_pool2d`` calls) and each sampling
    of ``roi.deform_roi_pool`` (``roi._sample_cells``) records its choices
    into ``pins`` (a list given empty): the mask (x > 0), the argmax of
    each window, the samples counted and their corner pixels. With ``pins``
    given full, the i-th call makes the i-th call's choices instead:
    ``x * mask``, x read at the recorded argmaxes, the recorded samples and
    corners with the fractions of its own coordinates. So every run
    computes one piecewise-linear function, whatever side of a kink its
    rounding puts a value on (a ReLU input near 0, two near-equal values in
    a pool window, a sampling coordinate near an integer)."""
    relu, pool, cells = torch.relu, torch.max_pool2d, roi._sample_cells
    record, calls = not pins, [0]

    def replay(x):
        pin = pins[calls[0]]
        calls[0] += 1
        lead = (pin[0] if isinstance(pin, tuple) else pin).shape[:2]
        if lead != x.shape[:2]:
            raise AssertionError(f"call {calls[0]}: pin {tuple(lead)}, "
                                 f"input {tuple(x.shape)}")
        return pin

    def pinned_relu(x):
        if record:
            pins.append(x.detach() > 0)
            return relu(x)
        return x * replay(x).to(x.dtype)

    def pinned_pool(x, kernel_size, stride=(), padding=0, dilation=1,
                    ceil_mode=False):
        if record:
            out, idx = torch._C._nn.max_pool2d_with_indices(
                x, kernel_size, stride, padding, dilation, ceil_mode)
            pins.append(idx)
            return out
        idx = replay(x)
        return x.flatten(2).gather(2, idx.flatten(2)).view(idx.shape)

    def pinned_cells(xs, ys, h, w):
        if record:
            out = cells(xs, ys, h, w)
            pins.append(tuple(t.detach() for t in out[:5]))
            return out
        valid, x0, x1, y0, y1 = (t if t.dtype == torch.bool else
                                 t.to(xs.dtype) for t in replay(xs))
        xc, yc = xs.clamp(0.0, w - 1.0), ys.clamp(0.0, h - 1.0)
        return valid, x0, x1, y0, y1, xc - x0, yc - y0
    torch.relu, torch.max_pool2d = pinned_relu, pinned_pool
    roi._sample_cells = pinned_cells
    try:
        yield
    finally:
        torch.relu, torch.max_pool2d = relu, pool
        roi._sample_cells = cells
    if not record and calls[0] != len(pins):
        raise AssertionError(f"{calls[0]} pinned calls, {len(pins)} pins")


def _boxes(n, hw, longest, gen, dev):
    """n xyxy boxes on an (h, w) image: sides log-uniform from 16 px to
    ``longest``, centres uniform, so that some reach past the image."""
    u = torch.rand(n, 4, generator=gen, device=dev)
    side = torch.exp(math.log(16) + u[:, 2:] * math.log(longest / 16))
    ctr = u[:, :2] * torch.tensor(hw[::-1], device=dev, dtype=torch.float32)
    return torch.cat([ctr - side / 2, ctr + side / 2], 1)


def _rois(n, batch, hw, gen, dev):
    """n RoIs on a batch of (h, w) images, sides 16-128 px: the proposals
    FPN's mapping sends to the stride-4 level."""
    b = torch.randint(0, batch, (n, 1), generator=gen, device=dev)
    return torch.cat([b.float(), _boxes(n, hw, 128, gen, dev)], 1)


def cases(scale: dict, dev, seed: int = 0) -> list:
    """The cases at ``scale`` (DEPLOYMENT or SMALL) on ``dev``, inputs and
    weights from ``seed``."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    wgen = torch.Generator().manual_seed(seed)

    def randn(*shape, std=1.0):
        return torch.randn(*shape, generator=gen, device=dev) * std
    out = []
    for size, batch in scale["ssd"]:
        m = SSDVGG(size)
        init_weights(m, wgen)
        m16 = SSDVGG(size, dtype=torch.bfloat16)
        m16.load_state_dict(m.state_dict())
        # images at the scale of caffe-normalized pixels: VGG's activations
        # reach O(100)
        out.append(Case(f"ssd{size}", m.to(dev),
                        lambda m, x: m(x), [randn(batch, 3, size, size,
                                                  std=40.0)],
                        [True], m16.to(dev)))
    b, c, sizes = scale["bfp"]
    feats = [randn(b, c, h, w) for h, w in sizes]
    for refine in ("non_local", "conv"):
        m = BFP(c, 2, refine)
        init_weights(m, wgen)
        if refine == "non_local":   # its zero conv_out would hide the block
            with torch.no_grad():
                m.refine.conv_out.conv.weight.normal_(0, 0.05, generator=wgen)
        out.append(Case(f"bfp_{refine}", m.to(dev),
                        lambda m, *fs: m(list(fs)), feats, [True] * len(feats)))
    b, c, h, w = scale["roi_feats"]
    fmap = randn(b, c, h, w)
    rois = _rois(scale["rois"], b, (4 * h, 4 * w), gen, dev)
    out.append(Case("roi_align", None, lambda _, f, r: roi.roi_align(
        f, r, 7, 0.25, sample_num=2), [fmap, rois], [True, False]))
    # ReLU'd features, as a backbone hands them over: ties in the max
    out.append(Case("roi_pool", None, lambda _, f, r: roi.roi_pool(
        f, r, 7, 0.25), [fmap.clamp(min=0), rois], [True, False]))
    p, d, fc = scale["pack"]
    pack = roi.ModulatedDeformRoIPoolingPack(
        0.25, p, d, group_size=1, sample_per_part=4, trans_std=0.1,
        deform_fc_channels=fc)
    init_weights(pack, wgen)
    with torch.no_grad():   # offsets and a mask that move with the input
        for stack in (pack.offset_fc, pack.mask_fc):
            last = [x for x in stack if isinstance(x, nn.Linear)][-1]
            last.weight.normal_(0, last.weight.shape[1] ** -0.5,
                                generator=wgen)
    prois = _rois(scale["pack_rois"], b, (4 * h, 4 * w), gen, dev)
    out.append(Case("modulated_deform_roi_pooling_pack", pack.to(dev),
                    lambda m, f, r: m(f, r), [fmap[:, :d].contiguous(),
                                              prois], [True, False]))
    b, c, h, w = scale["dense"]
    x = randn(b, c, h, w)
    ker = torch.softmax(randn(b, 25, 2 * h, 2 * w), 1)
    out.append(Case("carafe", None, lambda _, x, k: roi.carafe(x, k, 2, 5),
                    [x, ker], [True, True]))
    mask = (torch.rand(b, h, w, generator=gen, device=dev) < 0.5).float()
    wt, bias = randn(c, c, 3, 3, std=(9 * c) ** -0.5), randn(c, std=0.1)
    out.append(Case("masked_conv2d", None,
                    lambda _, x, wt, bias, mk: roi.masked_conv2d(
                        x, mk, wt, bias), [x, wt, bias, mask],
                    [True, True, True, False]))
    b, c, h, w = scale["grid"]
    grid = torch.rand(b, h, w, 2, generator=gen, device=dev) * 2.2 - 1.1
    out.append(Case("grid_sample", None, lambda _, f, g: roi.grid_sample(
        f, g, align_corners=False), [randn(b, c, h, w), grid], [True, True]))
    return out


def _run(case: Case, module, dtype, pins=None):
    """fn forward and backward with ``dtype`` float inputs (the diff ones
    as leaves), the kinks pinned by ``pins`` (None: not pinned) and a
    seeded cotangent on each output: (outputs, {name: gradient})."""
    ins = [t.detach().to(dtype).requires_grad_(True) if d else t
           for t, d in zip(case.inputs, case.diff)]
    if module is not None:
        module.zero_grad(set_to_none=True)
    with (contextlib.nullcontext() if pins is None else pinned_kinks(pins)):
        outs = case.fn(module, *ins)
    outs = list(outs) if isinstance(outs, (tuple, list)) else [outs]
    gen = torch.Generator(device=outs[0].device).manual_seed(1)
    cts = [torch.randn(o.shape, generator=gen, device=o.device).to(o.dtype)
           for o in outs]
    torch.autograd.backward(outs, cts)
    grads = {f"input{i}": t.grad for i, t in enumerate(ins)
             if t.requires_grad}
    if module is not None:
        grads.update((n, p.grad) for n, p in module.named_parameters())
    return outs, grads


def _rel(got, want, floor=1e-300):
    got, want = got.detach(), want.detach()
    return float((got.double() - want).abs().max()
                 / want.abs().max().clamp(min=floor))


def _time(fn, reps=3):
    """(ms of fn() by CUDA events after a warm-up, peak GiB allocated in
    one call)."""
    fn()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps, peak


def compare(case: Case, dev, log=print) -> dict:
    """Runs ``case`` in float64 (recording its kinks' choices), then in f32
    and, for SSD-VGG, in bf16 compute, both pinned to those choices; raises
    unless every output and gradient is on ``dev`` and within its bound.
    On CUDA it then times each unpinned forward + backward. Returns
    {label: {"err": largest error, "out_err": the outputs' largest, "ms":
    CUDA-event ms (warm), "peak_gib": the peak allocation in one call}} for
    labels "f32" and "bf16"."""
    pins = []
    m64 = None if case.module is None else copy.deepcopy(case.module).double()
    t0 = time.perf_counter()
    out64, g64 = _run(case, m64, torch.float64, pins)
    seconds = {"float64": time.perf_counter() - t0}
    floor = ZERO_GRAD * max([float(g.abs().max()) for g in g64.values()])
    res = {}
    runs = [("f32", case.module, F32_TOL)]
    if case.bf16 is not None:
        runs.append(("bf16", case.bf16, BF16_TOL))
    for label, module, tol in runs:
        t0 = time.perf_counter()
        outs, grads = _run(case, module, torch.float32, list(pins))
        seconds[label] = time.perf_counter() - t0
        errs = {f"out{i}": _rel(o, w) for i, (o, w) in
                enumerate(zip(outs, out64))}
        errs.update((k, _rel(grads[k], g64[k], floor)) for k in g64)
        bounds = {k: tol if label == "bf16" or k.startswith("out")
                  else GRAD_TOL for k in errs}
        for k, t in [(f"out{i}", o) for i, o in enumerate(outs)] + list(
                grads.items()):
            if t is None or t.device.type != torch.device(dev).type:
                raise AssertionError(f"{case.name} {label}: {k} is "
                                     f"{None if t is None else t.device}")
        worst = max(errs, key=errs.get)
        log(f"36: {case.name} {label} vs float64: largest error "
            f"{errs[worst]:.2e} of the max ({worst}); outputs "
            f"{[tuple(o.shape) for o in outs]}")
        bad = {k: v for k, v in errs.items() if not v <= bounds[k]}
        if bad:
            raise AssertionError(f"{case.name} {label}: off float64 by more "
                                 f"than its bound of the max: {bad}")
        out_err = max(v for k, v in errs.items() if k.startswith("out"))
        res[label] = {"err": errs[worst], "out_err": out_err, "ms": None,
                      "peak_gib": None}
    del out64, g64, m64
    if torch.device(dev).type == "cuda":
        t0 = time.perf_counter()
        for label, module, _ in runs:
            ms, peak = _time(lambda: _run(case, module, torch.float32))
            res[label].update(ms=ms, peak_gib=peak)
        seconds["timing"] = time.perf_counter() - t0
    log(f"36: {case.name} seconds: " + ", ".join(
        f"{k} {v:.1f}" for k, v in seconds.items()))
    return res


def check_assign(scale: dict, dev, seed: int = 0, log=print) -> dict:
    """``max_iou_assign`` on ~RetinaNet's anchor count at 800x1333 against
    a float64 run: every box assigned alike but where the float64 IoUs
    leave the choice to rounding (within 1e-5 of a threshold, of the
    runner-up gt, or of a gt's best box); then ``random_sample``: its caps,
    validity and disjoint picks. Returns the counts and the ms of the pair
    (CUDA events, warm) and peak allocation."""
    n, g, num = scale["anchors"]
    gen = torch.Generator(device=dev).manual_seed(seed)
    boxes = _boxes(n, (800, 1333), 512, gen, dev)
    gts = _boxes(g, (800, 1333), 512, gen, dev)
    labels = torch.randint(1, 81, (g,), generator=gen, device=dev)
    valid = torch.arange(g, device=dev) < g - g // 10   # padded gts too
    a32 = max_iou_assign(boxes, gts, labels, valid)
    a64 = max_iou_assign(boxes.double(), gts.double(), labels, valid)
    iou = torch.where(valid[None], bbox_overlaps(boxes.double(),
                                                 gts.double()), -1.0)
    top2 = iou.topk(2, 1).values
    close = (top2[:, 0] - top2[:, 1] < 1e-5) & (top2[:, 0] > 0.5 - 1e-5)
    for thr in (0.4, 0.5):
        close |= (top2[:, 0] - thr).abs() < 1e-5
    best = iou.max(0).values
    claims = valid & (best > 0)
    close |= ((best[None] - iou < 1e-5) & claims[None]).any(1)
    diff = a32.gt_inds != a64.gt_inds
    if bool((diff & ~close).any()):
        raise AssertionError(f"assign: {int((diff & ~close).sum())} boxes "
                             f"assigned otherwise than in float64")
    err = float((a32.max_overlaps.double() - a64.max_overlaps).abs().max())
    if err > F32_TOL:
        raise AssertionError(f"assign: max_overlaps off float64 by {err}")
    s = random_sample(a32, torch.Generator(device=dev).manual_seed(seed),
                      num=num)
    inds = a32.gt_inds
    pos, neg = s.pos_inds[s.pos_valid].long(), s.neg_inds[s.neg_valid].long()
    n_pos, n_neg = int((inds > 0).sum()), int((inds == 0).sum())
    ok = (len(pos) == min(num // 2, n_pos) and
          len(neg) == min(num - num // 2, n_neg) and
          bool((inds[pos] > 0).all()) and bool((inds[neg] == 0).all()) and
          len(set(pos.tolist())) == len(pos) and
          len(set(neg.tolist())) == len(neg) and s.pos_inds.is_cuda ==
          (torch.device(dev).type == "cuda"))
    if not ok:
        raise AssertionError(f"random_sample: {len(pos)} of {n_pos} "
                             f"positives, {len(neg)} of {n_neg} negatives")
    res = dict(boxes=n, gts=g, positives=n_pos, negatives=n_neg,
               differ=int(diff.sum()), close=int(close.sum()),
               max_overlaps_err=err, ms=None, peak_gib=None)
    log(f"36: max_iou_assign {n} boxes x {g} gts: {n_pos} positive, "
        f"{n_neg} negative; {res['differ']} assigned otherwise than in "
        f"float64, all among the {res['close']} rounding decides; "
        f"random_sample({num}): {len(pos)} + {len(neg)} picks")
    if torch.device(dev).type == "cuda":
        def step():
            random_sample(max_iou_assign(boxes, gts, labels, valid), gen,
                          num=num)
        res["ms"], res["peak_gib"] = _time(step, reps=5)
    return res
