"""CPU mirrors of how the K1 and K6 kernels cut their work, checked against
the rules they must keep (no card needed):

- K6 (``csrc/mask_assembly.cu``) fills every 32-pixel segment of a
  detection's flattened mask plane with zeros, with no dot, unless its
  warp-uniform cull (``mask_assembly.segment_hits``) says the box holds a
  pixel of it: the cull must select exactly the segments that hold a
  pixel inside the box by CropSplit's float rule (``_quadrant_bounds``).
- K1 (``csrc/deform_im2col.cu``) transposes x in 32x32 tiles, gathers a
  (pixel, channel) tile per tap and writes it out in rows: with ragged
  channels and pixel counts, each element must be written exactly once
  (``deform_sample.im2col_schedule``).
- K2 (``csrc/deform_col2im.cu``) in bf16 routes its two GEMMs by shape to
  the TMA-fed wgmma kernels (on row-padded copies where P % 8 != 0) or the
  mma.sync ones, splits dW2 into
  2048-pixel partials and scatters by half-warp or warp: at every
  FeatureAlign level the presets run, each dcols element and each partial
  element is written once, the chunks cover P, each (image·group, pixel,
  tap) is scattered once, and no wgmma dcols block straddles a group
  (``deform_conv.col2im_schedule``).
"""

import numpy as np
import pytest
import torch

from sipmask_tpu_torch.ops import deform_conv, deform_sample, mask_assembly


def _boxes(regime, rng, b, n, h, w):
    """(b, n, 4) f32 boxes in mask coordinates of one regime."""
    if regime == "random":
        x1 = rng.uniform(-4, w, (b, n))
        y1 = rng.uniform(-4, h, (b, n))
        boxes = np.stack([x1, y1, x1 + rng.uniform(0, w / 2, (b, n)),
                          y1 + rng.uniform(0, h / 2, (b, n))], -1)
    elif regime == "edges":   # on and beside pixel and segment edges
        xs = np.array([0.0, 0.5, 1.0, 7.0, 7.5, 31.0, 31.5, 32.0, 32.5,
                       w - 1.0, w - 0.5, w])
        ys = np.array([0.0, 0.5, 1.0, h / 2, h - 1.0, h - 0.5, h])
        bx = np.sort(rng.choice(xs, (b, n, 2)), -1)
        by = np.sort(rng.choice(ys, (b, n, 2)), -1)
        boxes = np.stack([bx[..., 0], by[..., 0], bx[..., 1], by[..., 1]],
                         -1)
    elif regime == "fractional":   # under a pixel and between pixels
        x1 = rng.randint(-1, w + 1, (b, n)) + rng.uniform(0.01, 0.99, (b, n))
        y1 = rng.randint(-1, h + 1, (b, n)) + rng.uniform(0.01, 0.99, (b, n))
        boxes = np.stack([x1, y1, x1 + rng.uniform(0, 1.5, (b, n)),
                          y1 + rng.uniform(0, 1.5, (b, n))], -1)
    elif regime == "off_grid":   # negative and past the grid
        x1 = rng.uniform(-3 * w, 2 * w, (b, n))
        y1 = rng.uniform(-3 * h, 2 * h, (b, n))
        boxes = np.stack([x1, y1, x1 + rng.uniform(0, 2 * w, (b, n)),
                          y1 + rng.uniform(0, 2 * h, (b, n))], -1)
    elif regime == "degenerate":   # zero width or height, and inverted
        x1 = rng.uniform(0, w, (b, n))
        y1 = rng.uniform(0, h, (b, n))
        x2 = np.where(np.arange(n) % 2, x1, x1 - 1.0)
        y2 = np.where(np.arange(n) % 3, y1 + 3.0, y1)
        boxes = np.stack([x1, y1, x2, y2], -1)
    else:   # "special": infinities and NaN
        vals = np.array([-np.inf, np.inf, np.nan, -1.0, 0.0, 3.5, w, h])
        boxes = rng.choice(vals, (b, n, 4))
        boxes[:, 0] = [-np.inf, -np.inf, np.inf, np.inf]
    return torch.from_numpy(boxes.astype(np.float32))


@pytest.mark.parametrize("h,w", [(24, 64), (13, 30), (9, 100), (5, 3),
                                 (1, 1)])
@pytest.mark.parametrize("regime", ["random", "edges", "fractional",
                                    "off_grid", "degenerate", "special"])
def test_mask_assembly_cull_selects_exactly_the_in_box_segments(regime, h,
                                                                w):
    """K6's segment cull against CropSplit's float rule: a segment is
    computed iff the box holds one of its pixels, so every in-box pixel is
    computed and every zero the cull writes is the plain version's; the
    integer bounds pick the same pixels as the float compares."""
    rng = np.random.RandomState(len(regime) * 100 + h * w)
    b, n = 2, 40
    boxes = _boxes(regime, rng, b, n, h, w)
    hits = mask_assembly.segment_hits(boxes, h, w)
    n_seg = -(-h * w // mask_assembly.SEGMENT)
    assert hits.shape == (b, n, n_seg)
    in_box = torch.stack([mask_assembly._quadrant_bounds(boxes[i], h, w)[0]
                          for i in range(b)])                # (b, h, w, n)
    plane = in_box.permute(0, 3, 1, 2).reshape(b, n, h * w)
    held = torch.nn.functional.pad(plane, (0, n_seg * 32 - h * w)).reshape(
        b, n, n_seg, 32).any(-1)
    assert torch.equal(hits, held)
    c_lo, c_hi, r_lo, r_hi = mask_assembly.pixel_bounds(boxes, h, w)
    col = torch.arange(w)[None, None, :, None]
    row = torch.arange(h)[None, None, None, :]
    rect = ((col >= c_lo[..., None, None]) & (col <= c_hi[..., None, None])
            & (row >= r_lo[..., None, None]) & (row <= r_hi[..., None, None]))
    assert torch.equal(rect, in_box.permute(0, 3, 2, 1))
    if regime in ("random", "edges"):
        assert hits.any() and not hits.all()


def test_mask_assembly_cull_keeps_the_plain_masks():
    """The plain masks with the culled segments zeroed are the plain masks:
    nothing the kernel skips is non-zero."""
    rng = np.random.RandomState(5)
    b, n, h, w = 2, 24, 20, 36
    basis = torch.from_numpy(rng.randn(b, h, w, 32).astype(np.float32))
    cofs = torch.from_numpy((rng.randn(b, n, 128) * 0.3).astype(np.float32))
    boxes = _boxes("random", rng, b, n, h, w)
    want = mask_assembly.assemble_masks_plain(basis, cofs, boxes)
    hits = mask_assembly.segment_hits(boxes, h, w)
    keep = hits[..., None].expand(b, n, hits.shape[-1], 32).reshape(
        b, n, -1)[..., : h * w].reshape(b, n, h, w).permute(0, 2, 3, 1)
    assert torch.equal(want * keep, want)
    assert bool((~keep).any())


@pytest.mark.parametrize("b,g,cg,k,ho,wo,h,w", [
    (1, 4, 5, 9, 7, 5, 13, 9),       # Cg = 5: scalars, stride 2
    (2, 1, 32, 9, 17, 15, 17, 15),   # P = 255: a ragged pixel tile
    (2, 4, 64, 9, 7, 11, 7, 11),     # P7 of FeatureAlign: P = 77
    (1, 4, 64, 9, 25, 42, 25, 42),   # P5: P = 1050, not a multiple of 4
    (1, 4, 64, 9, 50, 84, 50, 84),   # P4: float4 rows, ragged last tile
    (1, 2, 8, 9, 13, 16, 13, 16),    # P % 4 == 0, Cg under a transpose tile
    (1, 1, 36, 4, 5, 8, 6, 9),       # a 2x2 kernel, Cg past a tile
    (1, 1, 33, 9, 16, 16, 16, 16),   # scalars, float4 rows, Cg = 32 + 1
])
def test_deform_im2col_schedule_writes_each_element_once(b, g, cg, k, ho,
                                                         wo, h, w):
    x_rows, tile, cols = deform_sample.im2col_schedule(b, g, cg, k,
                                                       ho * wo, h * w)
    assert x_rows.shape == (b * g, h * w, cg)
    assert bool((x_rows == 1).all())
    n_tiles = -(-ho * wo // deform_sample.IM2COL_TILE)
    assert tile.shape == (b * g, n_tiles, k, deform_sample.IM2COL_TILE, cg)
    assert bool((tile == 1).all())
    assert cols.shape == (b, g * k * cg, ho * wo)
    assert bool((cols == 1).all())


# FeatureAlign's levels as the presets run them (h, w, batch): 800x1344
# (flagship, X101, the fork), HRFPN's floor-pooled 12x21 and 6x10, 544
# (SipMask++ and real-time serving), 576 (their training), VIS's 384x640
K2_LEVELS = (
    [(h, w, 4) for h, w in ((100, 168), (50, 84), (25, 42), (13, 21),
                            (7, 11), (12, 21), (6, 10))]
    + [(h, w, 8) for h, w in ((68, 68), (34, 34), (17, 17), (9, 9), (5, 5),
                              (72, 72), (36, 36), (18, 18))]
    + [(h, w, 4) for h, w in ((48, 80), (24, 40), (12, 20), (6, 10),
                              (3, 5))])


def _cells_cover_once(cover, rows, cols):
    counts, er, ec = cover
    assert int(er[0]) == 0 and int(er[-1]) == rows
    assert int(ec[0]) == 0 and int(ec[-1]) == cols
    return bool((counts == 1).all())


@pytest.mark.parametrize("b,g,cg,h,w,o", [
    (b, 4, 64, h, w, 256) for h, w, b in K2_LEVELS] + [
    (1, 4, 5, 13, 9, 20)])   # Cg = 5: odd, the scalar scatter lanes
def test_deform_col2im_schedule_writes_each_element_once(b, g, cg, h, w, o):
    k, p = 9, h * w
    kcg = k * cg
    plan = deform_conv.col2im_schedule(b, g, cg, k, p, o)
    # every preset's level on the wgmma GEMMs, by TMA or padded copies
    assert plan["route"] == ("mma.sync" if cg != 64 else
                             "wgmma" if p % 8 == 0 else "padded")
    assert plan["scatter"] == ("half-warp" if cg % 4 == 0 else "warp")
    if plan["route"] == "padded":   # each element of the copies once
        assert plan["padded"].shape == (b * (o + g * kcg), -(-p // 8) * 8)
        assert bool((plan["padded"] == 1).all())
    # each dcols element (image·group, pixel, column of the group) once
    assert _cells_cover_once(plan["dcols"], p, kcg)
    assert plan["dcols"][0].shape[0] == b * g
    if plan["route"] != "mma.sync":   # a block's columns lie in one group
        for n0, n1 in plan["dcols_spans"]:
            assert n0 // kcg == (n1 - 1) // kcg, (n0, n1)
    # each partial element once per (image, chunk); the chunks cover P
    splits = -(-p // deform_conv.DW2_CHUNK)
    assert plan["partial"][0].shape[0] == b * splits
    assert _cells_cover_once(plan["partial"], o, g * kcg)
    edges = [0]
    for k0, k1, starts in plan["chunks"]:
        assert k0 == edges[-1] and k1 > k0
        assert k1 - k0 <= deform_conv.DW2_CHUNK
        depth = (deform_conv.MMA_DEPTH if plan["route"] == "mma.sync"
                 else deform_conv.WGMMA_DEPTH)
        assert starts == list(range(k0, k1, depth))
        edges.append(k1)
    assert edges[-1] == p and len(edges) == splits + 1
    # each scatter item (image·group, pixel, tap) once
    assert plan["items"].shape == (b * g, p, k)
    assert bool((plan["items"] == 1).all())
