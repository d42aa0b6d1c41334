"""CPU mirrors of how the port's kernels cut their work, checked against
the rules they must keep (no card needed):

- K6 (``csrc/mask_assembly.cu``) fills every 32-pixel segment of a
  detection's flattened mask plane with zeros, with no dot, unless its
  warp-uniform cull (``mask_assembly.segment_hits``) says the box holds a
  pixel of it: the cull must select exactly the segments that hold a
  pixel inside the box by CropSplit's float rule (``_quadrant_bounds``).
- K1 (``csrc/deform_im2col.cu``) transposes x in 32x32 tiles, gathers a
  (pixel, channel) tile per tap and writes it out in rows: with ragged
  channels and pixel counts, each element must be written exactly once
  (``deform_sample.im2col_schedule``). In bf16 (Cg % 8 == 0) at every
  FeatureAlign level the presets run and at ragged shapes: each x element
  loaded once and each x_rows element stored once by the transpose, whose
  permuted channels reach the right tile rows; each tile element written
  once a tap, each (image·group, tap, pixel tile) cell once by the grid's
  tap groups, and within a cell each pixel in the map once (a TMA box that
  stays in its tap's rows and is clipped at P, or register stores); two
  16-byte items a thread at Cg = 64 with no bank conflicts.
- K2 (``csrc/deform_col2im.cu``) in bf16 routes its two GEMMs by shape to
  the TMA-fed wgmma kernels (on row-padded copies where P % 8 != 0) or the
  mma.sync ones, splits dW2 into
  2048-pixel partials and scatters by half-warp or warp: at every
  FeatureAlign level the presets run, each dcols element and each partial
  element is written once, the chunks cover P, each (image·group, pixel,
  tap) is scattered once, and no wgmma dcols block straddles a group
  (``deform_conv.col2im_schedule``).
- K5 and K5c (``csrc/deform_rows.cu``) in bf16 and f32: each element of
  sampled written once and of dsampled read once, each position read and
  each d position written once; in bf16 with Cg % 4 == 0 (8-byte lanes of
  4 channels) each item's share of a reduction or store instruction is
  one contiguous run, a warp's positions one coalesced load, and at
  Cg = 128 no lane of an item idles (``deform_sample.rows_schedule``).
- K4a and K4b (``csrc/gn_relu.cu``) in bf16: at every GroupNorm shape the
  presets make, one pass, a cluster of CTAs per (image, group) that loads
  each element once and stores each once within the register budget the
  source states; a slab past that budget takes the two-pass kernels
  (``gn_relu.gn_schedule``).
"""

import numpy as np
import pytest
import torch

from sipmask_tpu_torch.ops import (deform_conv, deform_sample, gn_relu,
                                   mask_assembly)


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


@pytest.mark.parametrize("b,g,cg,h,w", [
    (b, 4, 64, h, w) for h, w, b in K2_LEVELS] + [
    (1, 2, 24, 17, 15),    # Cg = 24: 3 vectors a row (no CG), odd P
    (2, 1, 8, 13, 16),     # Cg = 8: one vector a row, TMA
    (1, 1, 256, 9, 7),     # Cg = 256: the largest box, 4 rounds a tap
    (1, 4, 64, 1, 1),      # one pixel
    (1, 4, 5, 13, 9),      # Cg = 5: the scalar kernels
    (1, 1, 264, 5, 6),     # Cg > 256: the scalar kernels
])
def test_deform_im2col_bf16_schedule_writes_each_element_once(b, g, cg, h,
                                                              w):
    k, p = 9, h * w
    plan = deform_sample.im2col_schedule(b, g, cg, k, p, p, torch.bfloat16)
    if cg % 8 or cg > deform_sample.BF16_MAX_CG:
        assert plan["route"] == "scalar"
        for name in ("x_rows", "tile", "cols"):
            assert bool((plan[name] == 1).all()), name
        return
    assert (plan["route"], plan["store"]) == (
        ("tma", 0) if p % 8 == 0 else
        ("registers", 4 if p % 4 == 0 else 2 if p % 2 == 0 else 1))
    tr = plan["transpose"]
    assert tr["load_elems"] == (8 if p % 8 == 0 else 1)
    assert tr["loads"].shape == (cg, p) and bool((tr["loads"] == 1).all())
    assert tr["x_rows"].shape == (p, cg) and bool((tr["x_rows"] == 1).all())
    assert torch.equal(torch.sort(tr["channel"]).values, torch.arange(cg))
    # one tap's tile: each element once, each row the channel it stands for
    assert bool((plan["tile"] == 1).all())
    assert torch.equal(plan["tile_channel"], torch.arange(cg))
    # every (image·group, tap) row block and pixel tile once; the taps of a
    # level whose blocks fill the card in one block, else spread over at
    # most FILL_BLOCKS
    tiles = -(-p // deform_sample.BF16_PIX)
    assert plan["cells"].shape == (b * g * k, tiles)
    assert bool((plan["cells"] == 1).all())
    blocks = tiles * b * g
    n_blocks = blocks * plan["grid"][2]
    if blocks >= deform_sample.FILL_BLOCKS:
        assert plan["taps"] == k
    else:
        assert n_blocks < deform_sample.FILL_BLOCKS + blocks
    # within a cell, each pixel in the map once, none past P
    for width, written in plan["in_tile"].items():
        assert bool((written[:, :width] == 1).all()), width
        assert int(written[:, width:].sum()) == 0, width


@pytest.mark.parametrize("b,g,cg,h,w", [
    (b, 4, 64, h, w) for h, w, b in K2_LEVELS if h * w % 8 == 0] + [
    (2, 1, 8, 13, 16), (1, 2, 24, 16, 9)])
def test_deform_im2col_bf16_boxes_stay_in_their_tap_and_p(b, g, cg, h, w):
    """The TMA route's boxes: each one tap's Cg rows of cols, 64 pixels
    from a tile's first, clipped at P; together each (row block, pixel
    tile) once."""
    k, p = 9, h * w
    plan = deform_sample.im2col_schedule(b, g, cg, k, p, p, torch.bfloat16)
    assert plan["route"] == "tma"
    row0, rows, x0, width = plan["boxes"].unbind(-1)
    assert bool((rows == cg).all()) and bool((row0 % cg == 0).all())
    npx = deform_sample.BF16_PIX
    assert bool((x0 % npx == 0).all()) and bool((x0 < p).all())
    assert bool((width == (p - x0).clamp(max=npx)).all())
    assert bool((x0 + width <= p).all())
    tiles = -(-p // npx)
    cover = torch.bincount(row0 // cg * tiles + x0 // npx,
                           minlength=b * g * k * tiles)
    assert cover.numel() == b * g * k * tiles and bool((cover == 1).all())


@pytest.mark.parametrize("b,h,w", [(4, 100, 168), (4, 25, 42), (4, 7, 11),
                                   (8, 68, 68), (4, 12, 21)])
def test_deform_im2col_bf16_two_items_a_thread_at_cg_64(b, h, w):
    """At FeatureAlign's Cg = 64 a tap is one round in which every thread
    gathers two 16-byte items (a pixel pair's vector), and the tile's
    shared-memory accesses (the gather's 4-byte stores, the transpose's
    stores and 2-byte reads) take one wavefront each."""
    plan = deform_sample.im2col_schedule(b, 4, 64, 9, h * w, h * w,
                                         torch.bfloat16)
    assert plan["items"].shape == (1, 256)
    assert bool((plan["items"] == 2).all())
    assert plan["store_ways"] == 1
    assert plan["transpose"]["store_ways"] == 1
    assert plan["transpose"]["read_ways"] == 1


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


# SipMask++'s DCN conv2 of each R101 stage (Cg, h, w), serving at 544x544
# and training at 576x576, then ragged small maps
ROWS_SHAPES = ([(128, 68, 68), (256, 34, 34), (512, 17, 17), (128, 72, 72),
                (256, 36, 36), (512, 18, 18)]
               + [(cg, 7, 5) for cg in (6, 12, 36, 64, 128, 256, 512)])


def _one_run_each(group, off, step):
    """Whether, in each instruction (a row of ``group`` / ``off``), the
    lanes of each group (an item or a row; -1 idle) touch distinct offsets
    that form one contiguous run of ``step``-byte pieces."""
    for g, o in zip(group.split(4096), off.split(4096)):
        same = (g[:, :, None] == g[:, None, :]) & (g >= 0)[:, :, None]
        big = torch.iinfo(o.dtype).max
        lo = torch.where(same, o[:, None, :], big).amin(-1)
        hi = torch.where(same, o[:, None, :], -1).amax(-1)
        count = same.sum(-1)
        clash = same & (o[:, :, None] == o[:, None, :])
        live = g >= 0
        if not (bool((clash.sum(-1)[live] == 1).all()) and bool(
                ((hi - lo)[live] == ((count - 1) * step)[live]).all())):
            return False
    return True


@pytest.mark.parametrize("blocks", [None, 7], ids=["grid", "7blocks"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("cg,h,w", ROWS_SHAPES)
def test_deform_rows_schedule_touches_each_element_once(cg, h, w, dtype,
                                                        blocks):
    """Each sampled element written once, each dsampled element read once,
    each position read and each d position written once, on the full grid
    and on a grid of 7 blocks whose warps loop (bf16 vector path)."""
    n, k, p = 2, 9, h * w
    plan = deform_sample.rows_schedule(n, p, k, cg, dtype, blocks)
    fwd, bwd = plan["forward"], plan["backward"]
    vec = cg % 4 == 0
    bf16 = dtype == torch.bfloat16
    assert fwd["channels"] == bwd["channels"] == (4 if vec else 1)
    assert fwd["load_bytes"] == fwd["channels"] * (2 if bf16 else 4)
    assert fwd["written"].shape == bwd["read"].shape == (n, p, k, cg)
    assert bool((fwd["written"] == 1).all())
    assert bool((bwd["read"] == 1).all())
    assert bwd["dpyx"].shape == (n, k, p)
    assert bool((bwd["dpyx"] == 1).all())
    # every item's position is read: on the bf16 vector path once, a
    # block's tap by tap into shared memory, each load instruction's lanes
    # one run of consecutive pixels a tap; else by every lane of its warp
    pos = fwd["positions"]
    assert torch.equal(torch.unique(pos[pos >= 0]), torch.arange(n * p * k))
    assert fwd["order"] == bwd["order"] == "n, p, tap"
    if bf16 and vec:
        assert fwd["items"] == deform_sample.ROWS_FWD_ITEMS
        assert bool((torch.bincount(pos[pos >= 0]) == 1).all())
        assert _one_run_each(torch.where(pos >= 0, pos // p, -1), pos, 1)
    else:
        assert fwd["lanes"] == bwd["lanes"] == 32 and fwd["items"] == 1
        assert bool((pos == pos[:, :1]).all())


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("cg,h,w", [s for s in ROWS_SHAPES
                                    if s[0] % 4 == 0])
def test_deform_rows_vector_instructions_are_contiguous_runs(cg, h, w,
                                                             dtype):
    """On the vector path each item's lanes in a reduction instruction
    (one a corner) reduce into one contiguous run of its corner's dX row
    (float4s), and each item's lanes in a store instruction write one
    contiguous run of sampled (bf16: 8 bytes a lane, f32: 16)."""
    n, k, p = 2, 9, h * w
    plan = deform_sample.rows_schedule(n, p, k, cg, dtype)
    red_item, red_off = plan["backward"]["reductions"]
    assert _one_run_each(red_item.reshape(-1, 32), red_off.reshape(-1, 32),
                         16)
    stores = plan["forward"]["stores"]
    esize = 2 if dtype == torch.bfloat16 else 4
    row = torch.where(stores >= 0, stores // (cg * esize), -1)
    assert _one_run_each(row, stores, 4 * esize)


@pytest.mark.parametrize("h,w", [(68, 68), (72, 72), (7, 5)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
def test_deform_rows_schedule_idles_no_lane_at_cg_128(h, w, dtype):
    """At Cg = 128 (SipMask++'s layer2) no lane of a K5 or K5c item goes
    without channels in any instruction: in bf16 lanes of four channels,
    K5 8 of them in four passes, K5c a half-warp in two; in f32 a warp of
    16-byte lanes in one; at Cg = 36 the lanes of bf16 do not divide the
    row."""
    plan = deform_sample.rows_schedule(2, h * w, 9, 128, dtype)
    fwd, bwd = plan["forward"], plan["backward"]
    bf16 = dtype == torch.bfloat16
    assert (fwd["lanes"], bwd["lanes"]) == ((8, 16) if bf16 else (32, 32))
    assert fwd["idle_lanes"] == bwd["idle_lanes"] == 0
    for busy in (fwd["stores"] >= 0, bwd["reductions"][0] >= 0):
        assert int(busy.sum()) == 2 * h * w * 9 * 128 // 4
    if bf16:
        plan = deform_sample.rows_schedule(2, h * w, 9, 36, dtype)
        assert plan["forward"]["idle_lanes"] > 0
        assert plan["backward"]["idle_lanes"] > 0


# The GroupNorm shapes the presets make (batch, h, w), 256 channels in 32
# groups: the 800x1344 levels (the flagship, X101 at its multi-scale sizes
# up to 800x1333, the fork, the test driver; batch 4, a request 1),
# HRFPN's floor-pooled levels, the GN real-time preset at 544 (serving)
# and 576 (training), batch 8, VIS at 384x640 (training 4, a frame 1) and
# its multi-scale bucket 480x960
GN_SHAPES = (
    [(4, h, w) for h, w in ((100, 168), (50, 84), (25, 42), (13, 21),
                            (7, 11), (168, 100), (84, 50), (42, 25),
                            (21, 13), (11, 7), (12, 21), (6, 10))]
    + [(1, 100, 168), (1, 7, 11)]
    + [(8, h, w) for h, w in ((68, 68), (34, 34), (17, 17), (9, 9), (5, 5),
                              (72, 72), (36, 36), (18, 18))]
    + [(4, h, w) for h, w in ((48, 80), (24, 40), (12, 20), (6, 10),
                              (3, 5), (60, 120), (30, 60), (15, 30),
                              (8, 15), (4, 8))]
    + [(1, 48, 80)])


def _once(offsets, nbytes, vector_bytes):
    """Whether the byte offsets (-1 none) of whole vectors hit every vector
    of an nbytes tensor once."""
    live = offsets[offsets >= 0]
    if not bool((live % vector_bytes == 0).all()):
        return False
    counts = torch.bincount(live // vector_bytes,
                            minlength=nbytes // vector_bytes)
    return counts.numel() == nbytes // vector_bytes and bool(
        (counts == 1).all())


@pytest.mark.parametrize("direction", ["forward", "backward"])
@pytest.mark.parametrize("b,h,w", GN_SHAPES)
def test_gn_schedule_one_pass_loads_and_stores_each_element_once(
        b, h, w, direction):
    """The bf16 K4a and K4b at every preset GroupNorm shape take the
    one-pass cluster kernel, load each element of every slab once (x; and
    dy backward, at the same offsets) and store each once, within the
    budget the source states: a cluster of at most 8 CTAs, at most 1024
    (forward) or 512 (backward) threads a CTA in whole warps, at most 8
    vectors of 16 bytes a thread of each tensor held, 128 KB a CTA (the
    forward's registers, the backward's staged shared memory), and at
    least 256 CTAs a call where a cluster of 8 does not cap them."""
    plan = gn_relu.gn_schedule(b, 256, h * w, 32)[direction]
    assert plan["path"] == "one-pass"
    k, t = plan["cluster"], plan["threads"]
    assert k in (1, 2, 4, 8) and plan["ctas"] == b * 32 * k
    assert t % 32 == 0 and t <= (512 if direction == "backward" else 1024)
    assert plan["vector_bytes"] == 16
    assert plan["elements_a_thread"] <= gn_relu.ONE_HELD * 8
    assert plan["held_bytes"] <= 128 * 1024
    assert plan["ctas"] >= 256 or k == 8
    assert plan["loads"].shape == (plan["ctas"], t, gn_relu.ONE_HELD)
    nbytes = b * 256 * h * w * 2
    assert _once(plan["loads"], nbytes, 16)
    assert _once(plan["stores"], nbytes, 16)
    # each CTA's share is one contiguous run inside its own slab
    slab_bytes = 8 * h * w * 2
    for cta in range(0, plan["ctas"], max(1, plan["ctas"] // 7)):
        live = plan["loads"][cta][plan["loads"][cta] >= 0]
        assert int(live.max()) - int(live.min()) == 16 * (live.numel() - 1)
        assert int(live.min()) // slab_bytes == int(live.max()) // slab_bytes
        assert int(live.min()) // slab_bytes == cta // k


@pytest.mark.parametrize("b,c,hw,groups,forward,backward", [
    (1, 32, 256 * 272, 4, "two-pass", "two-pass"),   # 557056 elements
    (1, 32, 40000, 4, "one-pass", "two-pass"),       # 320000: past 262144
    (2, 256, 16800, 32, "one-pass", "one-pass"),
    (1, 1024, 64, 8, "two-pass", "two-pass"),        # Cg = 128
])
def test_gn_schedule_past_capacity_takes_two_passes(b, c, hw, groups,
                                                    forward, backward):
    """A slab past what a cluster holds (8 CTAs of 1024 threads forward,
    512 backward, 8 vectors a thread) or with more than 64 channels a
    group takes the two-pass kernels; f32 always does."""
    plan = gn_relu.gn_schedule(b, c, hw, groups)
    assert (plan["forward"]["path"], plan["backward"]["path"]) == (
        forward, backward)
    f32 = gn_relu.gn_schedule(b, c, hw, groups, torch.float32)
    assert f32["forward"]["path"] == f32["backward"]["path"] == "two-pass"


@pytest.mark.parametrize("slab,ptrs,vec", [
    (134400, 0, 8), (134400, 8, 4), (8 * 1050, 2, 1), (4 * 77, 0, 4),
    (2 * 35, 0, 1)])
def test_gn_one_pass_vectors_follow_slab_and_alignment(slab, ptrs, vec):
    """16-byte vectors where the slab is a multiple of 8 elements and the
    pointers 16-byte aligned, 8-byte ones at 4 and 8, else elements; the
    plan then covers the slab's vectors with its CTAs' shares."""
    assert gn_relu._one_vec(slab, ptrs) == vec
    one, k, t, per = gn_relu._one_plan(slab // vec, 128, 8, False)
    assert one and k * per >= slab // vec > (k - 1) * per
    assert t * gn_relu.ONE_HELD >= per and 128 * k >= 256
