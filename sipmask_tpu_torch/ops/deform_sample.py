"""Deformable bilinear sampling: kernels K1 (im2col, kc-major) and K5 (rows,
p-major) with K5's backward K5c, and their plain versions.

K1 is the counterpart of ``sipmask_tpu/ops/pallas/deform_gather.py``'s
kc-major forward (``sample_bilinear_rows_t`` and the TPU kernels behind it)
together with the position math of
``sipmask_tpu/ops/deform_conv.py:_sample_positions``. On a CUDA tensor
:func:`deform_im2col` launches ``csrc/deform_im2col.cu``; on a CPU tensor it
runs :func:`deform_im2col_plain`. Forward only: its backward is kernel K2 in
``deform_conv.py``.

K5 is the counterpart of ``deform_gather.sample_bilinear_rows``: the same
sampling emitted p-major, (N, P, K, Cg) with N = B*G, from channels-last
feature rows, so the (K*Cg) row of each output pixel feeds one matmul. One
kernel, ``csrc/deform_rows.cu``, replaces the TPU's separable and banded
forward kernels (``_sample_pallas_sep``, ``_sample_pallas``) and its dense
tiers; its backward :func:`deform_rows_backward` replaces
``_sample_pallas_bwd`` (K5c). :func:`deform_rows_plain` is ``sample_ref``.

Layouts (f32; K1 and K5 also take a bf16 x, with f32 offsets or
positions, and give bf16 cols or samples, as the JAX package's
compute_dtype="bfloat16" graph samples; K5c then takes a bf16 dsampled and
gives a bf16 dx and f32 d positions):
  K1: x        (B, C, H, W); deformable group g owns channels g*Cg .. (g+1)*Cg-1.
      offsets  (B, G*K*2, Ho, Wo) in the CUDA layout: channel g*2K + 2*(i*kw+j)
               holds dy and the next one dx, for tap (i, j) of group g.
      cols     (B, G*K*Cg, Ho*Wo); row g*K*Cg + (i*kw+j)*Cg + c.
  K5: x_rows   (N, H*W, Cg) channels-last rows, N = B*G (b-major).
      pyx      (N, K, P, 2) absolute (py, px) per tap and output pixel.
      sampled  (N, P, K, Cg).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from . import native

# (x, offsets) dtypes K1's and K5's plain versions take (K5: x_rows and
# pyx); the kernels take the first and the last
_K1_DTYPES = ((torch.float32, torch.float32), (torch.float64, torch.float64),
              (torch.bfloat16, torch.float32))


def out_size(h: int, w: int, kh: int, kw: int, stride: int, padding: int,
             dilation: int) -> Tuple[int, int]:
    ho = (h + 2 * padding - dilation * (kh - 1) - 1) // stride + 1
    wo = (w + 2 * padding - dilation * (kw - 1) - 1) // stride + 1
    return ho, wo


def _check(x, offsets, kh, kw, stride, padding, dilation, deform_groups):
    if x.dim() != 4 or offsets.dim() != 4:
        raise ValueError(f"x and offsets must be NCHW, got {tuple(x.shape)} "
                         f"and {tuple(offsets.shape)}")
    b, c, h, w = x.shape
    g, k = deform_groups, kh * kw
    if c % g:
        raise ValueError(f"{c} channels do not split into {g} groups")
    ho, wo = out_size(h, w, kh, kw, stride, padding, dilation)
    if tuple(offsets.shape) != (b, g * k * 2, ho, wo):
        raise ValueError(f"offsets {tuple(offsets.shape)} != "
                         f"{(b, g * k * 2, ho, wo)}")
    if (x.dtype, offsets.dtype) not in _K1_DTYPES:
        raise TypeError(f"x and offsets float32, float64 (the plain "
                        f"versions), or x bfloat16 with float32 offsets, got "
                        f"{x.dtype} and {offsets.dtype}")
    if x.device != offsets.device:
        raise ValueError(f"x on {x.device}, offsets on {offsets.device}")
    return b, c, h, w, g, k, ho, wo


def sample_positions(offsets, kh: int, kw: int, stride: int, padding: int,
                     dilation: int, deform_groups: int):
    """Absolute sampling positions: (py, px), each (B, G, K, Ho*Wo), in the
    offsets' float type.

    p = (ho*stride - pad + i*dilation + dy, wo*stride - pad + j*dilation + dx).
    """
    b, _, ho, wo = offsets.shape
    g, k = deform_groups, kh * kw
    off = offsets.reshape(b, g, k, 2, ho * wo)
    dev, dt = offsets.device, offsets.dtype
    base_y = (torch.arange(ho, device=dev) * stride - padding).to(dt)
    base_x = (torch.arange(wo, device=dev) * stride - padding).to(dt)
    tap_y = (torch.arange(kh, device=dev) * dilation).to(dt)
    tap_x = (torch.arange(kw, device=dev) * dilation).to(dt)
    ty = tap_y[:, None].expand(kh, kw).reshape(k)
    tx = tap_x[None, :].expand(kh, kw).reshape(k)
    by = (base_y[None, :, None] + ty[:, None, None]).expand(k, ho, wo)
    bx = (base_x[None, None, :] + tx[:, None, None]).expand(k, ho, wo)
    py = by.reshape(k, ho * wo) + off[:, :, :, 0]
    px = bx.reshape(k, ho * wo) + off[:, :, :, 1]
    return py, px


def deform_im2col_plain(x, offsets, kernel_size=(3, 3), stride: int = 1,
                        padding: int = 1, dilation: int = 1,
                        deform_groups: int = 1):
    """Plain PyTorch K1: four gathers, each corner zero outside the map.

    Same arithmetic, in the same order, as ``deform_gather.sample_ref``. A
    bf16 x is sampled in f32 and each value rounded once to bf16, as the
    kernel does.
    """
    kh, kw = kernel_size
    b, c, h, w, g, k, ho, wo = _check(x, offsets, kh, kw, stride, padding,
                                      dilation, deform_groups)
    if x.dtype == torch.bfloat16:
        return deform_im2col_plain(x.float(), offsets, kernel_size, stride,
                                   padding, dilation, deform_groups
                                   ).to(torch.bfloat16)
    cg, p = c // g, ho * wo
    py, px = sample_positions(offsets, kh, kw, stride, padding, dilation, g)
    y0, x0 = torch.floor(py), torch.floor(px)
    xg = x.reshape(b, g, cg, h * w)
    out = 0.0
    for dy in (0, 1):
        for dx in (0, 1):
            yy, xx = y0 + dy, x0 + dx
            wgt = ((py - y0 if dy else 1.0 - (py - y0)) *
                   (px - x0 if dx else 1.0 - (px - x0)))
            inb = (yy >= 0) & (yy <= h - 1) & (xx >= 0) & (xx <= w - 1)
            qi = (yy.clamp(0, h - 1) * w + xx.clamp(0, w - 1)).long()
            v = torch.gather(xg, 3, qi.reshape(b, g, 1, k * p)
                             .expand(b, g, cg, k * p))
            out = out + v.reshape(b, g, cg, k, p) * (
                wgt * inb).reshape(b, g, 1, k, p)
    return out.permute(0, 1, 3, 2, 4).reshape(b, g * k * cg, p)


IM2COL_TILE = 32     # output pixels a K1 gather block (kTile)
TRANSPOSE_TILE = 32  # K1's transpose tile, channels x pixels (kT)
# the bf16 design (csrc/deform_im2col.cu, Cg % 8 == 0, Cg <= 256)
BF16_PIX = 64        # output pixels a gather block, pixels a transpose block
BF16_MAX_CG = 256    # a TMA box's rows at most (kMaxCg)
FILL_BLOCKS = 16 * 132   # gather blocks that keep an H100 busy (kFillBlocks)
K1_THREADS = 256


def im2col_bf16_route(cg: int, p: int, aligned: bool = True) -> int:
    """How a bf16 K1 call stores cols, as the C entry picks it by shape and
    alignment: 0 (the TMA engine, P % 8 == 0), the width of the register
    stores (4, 2, 1 elements: the widest P's alignment allows), or -1 (the
    scalar kernels: Cg % 8 != 0, Cg > 256 or a pointer not 16-byte
    aligned)."""
    if cg % 8 or cg > BF16_MAX_CG or not aligned:
        return -1
    return 0 if p % 8 == 0 else 4 if p % 4 == 0 else 2 if p % 2 == 0 else 1


def im2col_bf16_taps(k: int, p: int, bgs: int) -> int:
    """Taps a bf16 gather block takes: all K where the (pixel tile,
    image·group) blocks are FILL_BLOCKS or more, else as few as spread the
    taps over up to FILL_BLOCKS blocks (``gather_bf16_taps``)."""
    blocks = -(-p // BF16_PIX) * bgs
    groups = min(k, max(1, -(-FILL_BLOCKS // blocks)))
    return -(-k // groups)


def _swz(off):
    """The byte offset of a tile swizzled as the TMA engine's 128-byte
    swizzle lays out a box (``swz``): the 16-byte chunk XOR the row % 8."""
    return off ^ (((off >> 7) & 7) << 4)


def _bank_ways(addr, nbytes):
    """Most shared-memory wavefronts one warp access takes: ``addr`` (...,
    32) byte offsets of the lanes (-1: idle) of accesses of ``nbytes``;
    16-byte accesses go 8 lanes a phase, 8-byte ones 16, the rest 32. Per
    phase: the most distinct 4-byte words that fall in one of 32 banks."""
    lanes = {16: 8, 8: 16}.get(nbytes, 32)
    addr = addr.reshape(-1, lanes)
    words = max(1, nbytes // 4)
    w = (addr // 4)[..., None] + torch.arange(words)      # (phases, l, w)
    w = torch.where((addr >= 0)[..., None], w, -1).reshape(addr.shape[0], -1)
    worst = 0
    for row in w:
        row = torch.unique(row[row >= 0])
        if row.numel():
            worst = max(worst, int(torch.bincount(row % 32).max()))
    return worst


def _im2col_tiles_schedule(b, g, cg, k, p, hw, vec):
    """The schedule of the f32 design (and bf16's scalar route, vec 1)."""
    def span(n, size):
        return -(-n // size)
    bgs = b * g
    # the transpose: block (pixel tile, channel tile); thread (ty, tx) walks
    # rows r = ty, ty + 8, ...: pixel p0 + r, channel c0 + tx
    pt, ct = torch.meshgrid(torch.arange(span(hw, TRANSPOSE_TILE)),
                            torch.arange(span(cg, TRANSPOSE_TILE)),
                            indexing="ij")
    r = torch.arange(TRANSPOSE_TILE)
    pix = (pt[..., None, None] * TRANSPOSE_TILE + r[:, None]).expand(
        *pt.shape, TRANSPOSE_TILE, TRANSPOSE_TILE)
    chan = (ct[..., None, None] * TRANSPOSE_TILE + r[None, :]).expand_as(pix)
    keep = (pix < hw) & (chan < cg)
    x_rows = torch.bincount(pix[keep] * cg + chan[keep], minlength=hw * cg)
    x_rows = x_rows.reshape(1, hw, cg).expand(bgs, hw, cg)
    # the gather of one tap, in rounds of kIt = 2 items a thread: item
    # i = (r * 2 + u) * 256 + thread -> pixel i // cv, vector i % cv
    cv = cg // vec
    items = IM2COL_TILE * cv
    rounds = span(items, 2 * 256)
    i = ((torch.arange(rounds)[:, None, None] * 2
          + torch.arange(2)[:, None]) * 256 + torch.arange(256)).reshape(-1)
    i = i[i < items]
    j, v = i // cv, i % cv
    tile = torch.bincount((j[:, None] * cg + v[:, None] * vec
                           + torch.arange(vec)).reshape(-1),
                          minlength=IM2COL_TILE * cg).reshape(
                              IM2COL_TILE, cg)
    tiles = span(p, IM2COL_TILE)
    tile = tile.expand(bgs, tiles, k, IM2COL_TILE, cg)
    # the write-out of one tap: item i -> channel row i // lanes, pixels
    # from (i % lanes) * vout, where the first lies in the map
    vout = 4 if p % 4 == 0 else 1
    lanes = IM2COL_TILE // vout
    i = torch.arange(cg * lanes)
    c, j = i // lanes, (i % lanes) * vout
    first = torch.arange(tiles)[:, None] * IM2COL_TILE + j   # (tiles, items)
    pix = (first[..., None] + torch.arange(vout)).expand(tiles, cg * lanes,
                                                         vout)
    chan = c[None, :, None].expand_as(pix)
    keep = (first < p)[..., None].expand_as(pix)
    per_tap = torch.bincount(chan[keep] * p + pix[keep], minlength=cg * p)
    cols = per_tap.reshape(1, 1, cg, p).expand(b, g * k, cg, p).reshape(
        b, g * k * cg, p)
    return x_rows, tile, cols


def _im2col_bf16_schedule(b, g, cg, k, p, hw):
    """The bf16 plan of :func:`im2col_schedule`."""
    store = im2col_bf16_route(cg, p)
    if store < 0:
        x_rows, tile, cols = _im2col_tiles_schedule(b, g, cg, k, p, hw, 1)
        return {"route": "scalar", "x_rows": x_rows, "tile": tile,
                "cols": cols}
    bgs, cv, npx, nt = b * g, cg // 8, BF16_PIX, K1_THREADS
    plan = {"route": "tma" if store == 0 else "registers", "store": store}
    # the transpose: block (pixel tile, image·group); loads of vin elements
    # of channel row c; stores of 16 bytes,
    # thread i -> pixel i // cv, vector i % cv, its word e the tile rows
    # 2e*cv + v and (2e + 1)*cv + v
    vin = 8 if hw % 8 == 0 else 1
    per = npx // vin
    i = torch.arange(cg * per)
    c, q = i // per, (i % per) * vin
    p0 = torch.arange(-(-hw // npx))[:, None] * npx
    pix = p0 + q                                          # (tiles, loads)
    live = pix < hw
    elems = (c * hw)[None, :, None] + pix[..., None] + torch.arange(vin)
    plan["transpose"] = {
        "load_elems": vin,
        "loads": torch.bincount(elems[live].reshape(-1),
                                minlength=cg * hw).reshape(cg, hw),
        "store_ways": _bank_ways(
            _swz(c * 2 * npx + 2 * q)[: (len(i) // 32) * 32].reshape(-1, 32),
            2 * vin)}
    i = torch.arange(npx * cv)
    px, v = i // cv, i % cv
    pos = (8 * v)[:, None] + torch.arange(8)                 # (items, 8)
    rows = (torch.arange(8) * cv)[None, :] + v[:, None]      # tile rows read
    pix = p0[:, :, None] + px[None, :, None]                 # (tiles, i, 1)
    live = (pix < hw).expand(-1, -1, 8)
    written = (pix * cg + pos[None]).expand_as(live)
    plan["transpose"]["x_rows"] = torch.bincount(
        written[live], minlength=hw * cg).reshape(hw, cg)
    channel = torch.empty(cg, dtype=torch.long)
    channel[pos.reshape(-1)] = rows.reshape(-1)
    plan["transpose"]["channel"] = channel
    reads = _swz(rows * 2 * npx + 2 * px[:, None])           # (items, 8)
    n32 = (npx * cv // 32) * 32
    plan["transpose"]["read_ways"] = max(
        _bank_ways(reads[:n32, e].reshape(-1, 32), 2) for e in range(8))
    # the gather of one tap: item i = r * 256 + thread -> pixels 2 (i // cv)
    # and the next, vector v = i % cv (x_rows positions 8v..8v+7), whose
    # element e goes to tile row e*cv + v
    items = (npx // 2) * cv
    rounds = -(-items // nt)
    i = torch.arange(rounds * nt).reshape(rounds, nt)
    plan["items"] = torch.where(i < items, 2, 0)   # 16-byte items a round
    i = torch.arange(items)
    j, v = 2 * (i // cv), i % cv
    trow = (torch.arange(8) * cv)[None, :] + v[:, None]      # (items, 8)
    cells = (trow * npx + j[:, None])[..., None] + torch.arange(2)
    plan["tile"] = torch.bincount(cells.reshape(-1),
                                  minlength=cg * npx).reshape(cg, npx)
    tile_channel = torch.empty(cg, dtype=torch.long)
    tile_channel[trow.reshape(-1)] = channel[
        ((8 * v)[:, None] + torch.arange(8)).reshape(-1)]
    plan["tile_channel"] = tile_channel
    offs = _swz(trow * 2 * npx + 2 * j[:, None])             # (items, 8)
    n32 = (items // 32) * 32
    plan["store_ways"] = max(_bank_ways(offs[:n32, e].reshape(-1, 32), 4)
                             for e in range(8))
    # the grid: (pixel tile, image·group, tap group); each block's taps
    tiles = -(-p // npx)
    tpb = im2col_bf16_taps(k, p, bgs)
    plan["taps"] = tpb
    plan["grid"] = (tiles, bgs, -(-k // tpb))
    x, y, z = torch.meshgrid(torch.arange(tiles), torch.arange(bgs),
                             torch.arange(-(-k // tpb)), indexing="ij")
    t = z[..., None] * tpb + torch.arange(tpb)
    x, y = x[..., None].expand_as(t), y[..., None].expand_as(t)
    ok = t < k
    plan["cells"] = torch.bincount(((y * k + t) * tiles + x)[ok],
                                   minlength=bgs * k * tiles).reshape(
                                       bgs * k, tiles)
    # a cell's stores: the TMA box of (cg rows, 64 pixels) clipped at P, or
    # the register stores (thread i -> row i // lanes, pixels from
    # (i % lanes) * store) where the first lies in the map
    widths = sorted({min(npx, p - x0) for x0 in (0, (tiles - 1) * npx)})
    plan["in_tile"] = {}
    for width in widths:
        if store == 0:
            written = torch.zeros(cg, npx, dtype=torch.long)
            written[:, :width] = 1
        else:
            lanes = npx // store
            i = torch.arange(cg * lanes)
            c, j = i // lanes, (i % lanes) * store
            keep = j < width
            cells = (c * npx + j)[keep][:, None] + torch.arange(store)
            written = torch.bincount(cells.reshape(-1),
                                     minlength=cg * npx).reshape(cg, npx)
        plan["in_tile"][width] = written
    if store == 0:
        x = x[ok]
        plan["boxes"] = torch.stack([(y[ok] * k + t[ok]) * cg,
                                     torch.full_like(x, cg), x * npx,
                                     (p - x * npx).clamp(max=npx)], -1)
    return plan


def im2col_schedule(b: int, g: int, cg: int, k: int, p: int, hw: int,
                    dtype=torch.float32):
    """K1's tile schedule in plain PyTorch (for the tests): how
    ``csrc/deform_im2col.cu`` cuts the work.

    f32: how many times the kernels write each element, (x_rows (B*G, hw,
    Cg), tile (B*G, tiles, K, kTile, Cg), cols (B, G*K*Cg, P)) int64
    counts: the transpose's 32x32 tiles, the gather's (pixel, channel) tile
    of each tap (16-byte vectors where Cg % 4 == 0, in rounds of two items
    a thread), and the write-out of each tap's rows (4 pixels a thread
    where P % 4 == 0). Pixels past P in the last tile are gathered as zeros
    and written nowhere.

    bfloat16: a dict. ``route``: "tma", "registers" (``store``: elements a
    store) or "scalar" (then ``x_rows``, ``tile`` and ``cols`` as above,
    with scalar gathers). On the bf16 design, ``transpose``: its loads'
    counts over one image·group's x (Cg, hw) (``load_elems`` a load) and
    its 16-byte stores' over x_rows (hw, Cg), the channel each row position
    holds, and the most wavefronts of a warp's shared-memory access in
    each phase (``store_ways``, ``read_ways``); ``items``: (rounds, 256)
    16-byte items each thread gathers in each round of a tap; ``tile``:
    the (Cg, 64) tile's writes in one tap, ``tile_channel`` the channel
    that reaches each tile row, ``store_ways``; ``taps`` a block and the
    ``grid``; ``cells``: (B*G*K, tiles) writes of each (image·group, tap)
    row block and pixel tile; ``in_tile``: {width: (Cg, 64) writes within
    a cell of that many pixels}; ``boxes`` (TMA): (n, 4) [first row, rows,
    first pixel, pixels written] of each store."""
    if dtype == torch.bfloat16:
        return _im2col_bf16_schedule(b, g, cg, k, p, hw)
    return _im2col_tiles_schedule(b, g, cg, k, p, hw,
                                  4 if cg % 4 == 0 else 1)


def _lib():
    lib = native.load("deform_im2col")
    if lib.deform_im2col_f32.argtypes is None:
        lib.deform_im2col_smem_bytes.restype = ctypes.c_int
        lib.deform_im2col_smem_bytes.argtypes = [ctypes.c_int] * 3
        for fn in (lib.deform_im2col_f32, lib.deform_im2col_bf16):
            fn.restype = ctypes.c_int
            fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 13 + [
                ctypes.c_void_p]
    return lib


@functools.lru_cache(maxsize=None)
def _smem_bytes(k: int, cg: int, bf16: bool) -> int:
    """Shared memory of a K1 gather block, from the C entry (once a
    shape)."""
    return _lib().deform_im2col_smem_bytes(k, cg, int(bf16))


def deform_im2col(x, offsets, kernel_size=(3, 3), stride: int = 1,
                  padding: int = 1, dilation: int = 1,
                  deform_groups: int = 1):
    """Deformable im2col: (x, offsets) -> cols, layouts in the module note.

    CPU tensors take :func:`deform_im2col_plain`; CUDA tensors launch the
    K1 kernels (contiguous; f32, or a bf16 x with f32 offsets, which gives
    bf16 cols: a transpose of x into channels-last rows, a scratch the size
    of x, then the gather; two device kernels a call) and raise on anything
    they do not take. f32 calls count in ``launches``, bf16 calls in
    ``bf16_launches``. The kernels record no gradient, so on CUDA the call
    also raises when one is wanted: the deformable convolution
    differentiates through ``deform_conv.deform_conv2d``, whose backward is
    kernel K2.
    """
    if x.device.type == "cpu":
        return deform_im2col_plain(x, offsets, kernel_size, stride, padding,
                                   dilation, deform_groups)
    if x.device.type != "cuda":
        raise ValueError(f"no K1 kernel for device {x.device}")
    if torch.is_grad_enabled() and (x.requires_grad or
                                    offsets.requires_grad):
        raise RuntimeError("deform_im2col records no gradient on CUDA: "
                           "differentiate through deform_conv.deform_conv2d")
    kh, kw = kernel_size
    b, c, h, w, g, k, ho, wo = _check(x, offsets, kh, kw, stride, padding,
                                      dilation, deform_groups)
    if offsets.dtype != torch.float32:
        raise TypeError(f"the K1 kernels take float32 or bfloat16 x with "
                        f"float32 offsets, got {x.dtype} and "
                        f"{offsets.dtype}")
    bf16 = x.dtype == torch.bfloat16
    if not (x.is_contiguous() and offsets.is_contiguous()):
        raise ValueError("x and offsets must be contiguous")
    cg = c // g
    if b * g > 65535 or -(-cg // TRANSPOSE_TILE) > 65535 or h * w >= 2 ** 31:
        raise ValueError(f"grid too large for B*G={b * g}, Cg={cg}, "
                         f"{h}x{w}")
    lib = _lib()
    if _smem_bytes(k, cg, bf16) > 227 * 1024:
        raise ValueError(f"{k} taps of {cg} channels exceed the kernel's "
                         f"shared memory")
    cols = torch.empty((b, g * k * cg, ho * wo), device=x.device,
                       dtype=x.dtype)
    if cols.numel() == 0:
        return cols
    x_rows = torch.empty((b * g, h * w, cg), device=x.device, dtype=x.dtype)
    # 16-byte gathers: 4 f32 or 8 bf16 channels a vector
    vec = int(cg % (8 if bf16 else 4) == 0)
    launch = lib.deform_im2col_bf16 if bf16 else lib.deform_im2col_f32
    with native.device_guard(x.device):
        code = launch(
            x.data_ptr(), offsets.data_ptr(), x_rows.data_ptr(),
            cols.data_ptr(), b, c, h, w, g, ho, wo, kh, kw, stride, padding,
            dilation, vec, native.stream_ptr(x.device))
    native.check_launch(lib, "deform_im2col", code)
    if bf16:
        deform_im2col.bf16_launches += 1
    else:
        deform_im2col.launches += 1
    return cols


deform_im2col.launches = 0
deform_im2col.bf16_launches = 0


# ------------------------------------------------- K5: p-major row sampling

def positions(offsets, kh: int, kw: int, stride: int, padding: int,
              dilation: int, deform_groups: int):
    """Offsets in the CUDA layout (B, G*K*2, Ho, Wo) -> ``pyx``
    (B*G, K, Ho*Wo, 2), as ``deform_conv._sample_positions`` builds it."""
    b = offsets.shape[0]
    py, px = sample_positions(offsets, kh, kw, stride, padding, dilation,
                              deform_groups)
    g, k, p = py.shape[1:]
    return torch.stack([py, px], -1).reshape(b * g, k, p, 2)


def _check_rows(x_rows, pyx, h: int, w: int):
    if x_rows.dim() != 3 or pyx.dim() != 4 or pyx.shape[-1] != 2:
        raise ValueError(f"x_rows must be (N, Q, Cg) and pyx (N, K, P, 2), "
                         f"got {tuple(x_rows.shape)} and {tuple(pyx.shape)}")
    n, q, cg = x_rows.shape
    if q != h * w or pyx.shape[0] != n:
        raise ValueError(f"x_rows {tuple(x_rows.shape)} and pyx "
                         f"{tuple(pyx.shape)} do not fit a {h}x{w} map")
    if (x_rows.dtype, pyx.dtype) not in _K1_DTYPES:
        raise TypeError(f"x_rows and pyx float32, float64 (the plain "
                        f"versions), or x_rows bfloat16 with float32 pyx, "
                        f"got {x_rows.dtype} and {pyx.dtype}")
    if x_rows.device != pyx.device:
        raise ValueError(f"x_rows on {x_rows.device}, pyx on {pyx.device}")
    return n, cg, pyx.shape[1], pyx.shape[2]


def deform_rows_plain(x_rows, pyx, h: int, w: int):
    """Plain PyTorch K5: ``deform_gather.sample_ref``, four gathers, each
    corner zero outside the map; differentiable by autograd (``floor`` has
    no gradient, which gives the one-sided position derivative).
    Returns (N, P, K, Cg), contiguous. A bf16 x_rows (f32 pyx) is sampled
    in f32 and each value rounded once to bf16, as the kernel does; its
    autograd then gives :func:`deform_rows_backward_plain`'s bf16
    arithmetic."""
    n, cg, k, p = _check_rows(x_rows, pyx, h, w)
    if x_rows.dtype == torch.bfloat16:
        return deform_rows_plain(x_rows.float(), pyx, h, w).to(
            torch.bfloat16)
    py, px = pyx[..., 0], pyx[..., 1]                       # (N, K, P)
    y0, x0 = torch.floor(py), torch.floor(px)
    out = 0.0
    for dy in (0, 1):
        for dx in (0, 1):
            yy, xx = y0 + dy, x0 + dx
            wgt = ((py - y0 if dy else 1.0 - (py - y0)) *
                   (px - x0 if dx else 1.0 - (px - x0)))
            inb = (yy >= 0) & (yy <= h - 1) & (xx >= 0) & (xx <= w - 1)
            qi = (yy.clamp(0, h - 1) * w + xx.clamp(0, w - 1)).long()
            v = torch.gather(x_rows, 1, qi.reshape(n, k * p, 1)
                             .expand(n, k * p, cg))
            out = out + v.reshape(n, k, p, cg) * (wgt * inb)[..., None]
    return out.permute(0, 2, 1, 3).contiguous()


def deform_rows_backward_plain(x_rows, pyx, dsampled, h: int, w: int):
    """Plain PyTorch K5c: (dx_rows, dpyx) of :func:`deform_rows_plain` for
    the cotangent ``dsampled`` (N, P, K, Cg), by autograd. bf16 x_rows and
    dsampled (f32 pyx): the f32 sampling of their upcasts differentiated in
    f32, dx summed in f32 and rounded once to bf16, dpyx f32."""
    if x_rows.dtype == torch.bfloat16:
        dx, dpyx = deform_rows_backward_plain(x_rows.float(), pyx,
                                              dsampled.float(), h, w)
        return dx.to(torch.bfloat16), dpyx
    with torch.enable_grad():
        xs, pp = (t.detach().requires_grad_(True) for t in (x_rows, pyx))
        out = deform_rows_plain(xs, pp, h, w)
        return torch.autograd.grad(out, (xs, pp), dsampled)


ROWS_THREADS = 256    # threads a K5 / K5c block (kThreads)
ROWS_FWD_ITEMS = 1    # rounds of items a lane group of the bf16 K5 has in
                      # flight (kFwdItems)
ROWS_FWD_PIXELS = 16  # output pixels of a bf16 K5 block, at most
ROWS_FWD_BLOCKS = 16 * 132   # ... halved while its grid is smaller


def rows_lanes(cg: int, backward: bool = False) -> int:
    """Lanes of an item of the bf16 K5 (``backward``: K5c) on the vector
    path, Cg % 4 == 0 (``fwd_bf16_lanes``, ``kBwdLanes``): K5 8, 16
    or 32 by Cg (a lane takes 16 channels in four passes from Cg = 128
    up), K5c a half-warp."""
    if backward:
        return 16
    return 32 if cg >= 512 else 16 if cg >= 256 else 8


def rows_pixels(n: int, p: int) -> int:
    """Output pixels a bf16 K5 block takes with all their taps
    (``fwd_pixels``): ROWS_FWD_PIXELS, halved while the grid would hold
    fewer than ROWS_FWD_BLOCKS blocks."""
    pixels = ROWS_FWD_PIXELS
    while pixels > 1 and n * -(-p // pixels) < ROWS_FWD_BLOCKS:
        pixels //= 2
    return pixels


def rows_schedule(n: int, p: int, k: int, cg: int, dtype=torch.bfloat16,
                  blocks=None):
    """How ``csrc/deform_rows.cu`` cuts a K5 and a K5c call with N = n,
    P = p, K = k and Cg = cg in ``dtype`` (bf16 or f32; pointers aligned
    for vectors), in plain PyTorch (for the tests). The bf16 K5c on the
    vector path (Cg % 4 == 0) loops over its items on a grid of at most
    the blocks the card holds at once: ``blocks`` sets that grid (default:
    a block for every ROWS_THREADS lanes of items, one round each).
    Returns a dict with "forward" and "backward", each with ``lanes`` an
    item, ``items`` a lane group has in flight, ``channels`` a lane,
    ``load_bytes`` (a lane's load of x), ``order`` of the items,
    ``idle_lanes`` (lane-instructions of a live item with no channel to
    take), and:

    - forward: ``pixels`` a block (bf16 vector path); ``positions``
      (instructions, 32), the position (pyx's (n, tap, p) index) each lane
      of each load instruction reads, -1 none; ``stores`` (instructions,
      32), the byte offset into sampled of each lane's store, -1 none;
      ``written``, write counts of sampled (N, P, K, Cg);
    - backward: ``reductions``, (item, byte offset in the corner's f32 dX
      row) of each lane of each reduction instruction (warps, rounds,
      passes, 32), -1 idle, one instruction a corner; ``read``, read
      counts of dsampled (N, P, K, Cg); ``dpyx``, write counts of d
      positions (N, K, P).

    The bf16 vector path: 8-byte lanes of 4 channels, :func:`rows_lanes`
    lanes an item; the forward's block takes :func:`rows_pixels` output
    pixels of one image with their K taps, loads their positions tap by
    tap, and its lane groups take its items ROWS_FWD_ITEMS at a time. Else
    (f32, or Cg % 4 != 0): a warp an item in (n, p, tap) order, 16-byte
    f32 vectors or one channel a lane, one item a warp."""
    def span(a, b):
        return -(-a // b)
    bf16 = dtype == torch.bfloat16
    esize = 2 if bf16 else 4
    vec = cg % 4 == 0
    loop = bf16 and vec
    ch = 4 if vec else 1
    cv = cg // ch
    n_items = n * p * k
    lane = torch.arange(32)

    def pyx_index(item):   # (n, p, tap) order -> pyx's (n, tap, p) index
        return (item // (p * k) * k + item % k) * p + item // k % p

    # ---- forward
    pixels = None
    if loop:
        lanes, items = rows_lanes(cg), ROWS_FWD_ITEMS
        pixels = rows_pixels(n, p)
        groups = ROWS_THREADS // lanes
        tiles = span(p, pixels)
        blk = torch.arange(n * tiles)
        nn, p0 = blk // tiles, blk % tiles * pixels
        npix = torch.clamp(p - p0, max=pixels)
        # the positions, thread i of K * pixels: tap i // pixels, pixel
        # p0 + i % pixels
        i = torch.arange(span(k * pixels, ROWS_THREADS) * ROWS_THREADS)
        tap, px = i // pixels, i % pixels
        pos = (nn[:, None] * k + tap) * p + p0[:, None] + px
        positions = torch.where((i < k * pixels) & (px < npix[:, None]),
                                pos, -1).reshape(-1, 32)
        # round r, slot s: lane group g takes tile item g + (r * items +
        # s) * groups
        thread = torch.arange(ROWS_THREADS)
        rounds = span(pixels * k, groups * items)
        tile_item = (thread // lanes + groups * (
            torch.arange(rounds)[:, None, None] * items
            + torch.arange(items)[:, None]))       # (rounds, items, 256)
        live = tile_item < (npix * k)[:, None, None, None]   # (b, r, s, 256)
        row = (nn * p + p0)[:, None, None, None] * k + tile_item
        v = thread % lanes + lanes * torch.arange(span(cv, lanes))[:, None]
        live, row = live[:, :, :, None], row[:, :, :, None]  # (.., passes)
    else:   # a warp an item: every lane loads the item's position
        lanes, items = 32, 1
        item = torch.arange(span(n_items, 8) * 8)[:, None]
        positions = torch.where(item < n_items, pyx_index(item), -1
                                ).expand(-1, 32)
        live, row = item < n_items, item
        v = lane + 32 * torch.arange(span(cv, 32))[:, None, None]
    ok = live & (v < cv)
    stores = torch.where(ok, (row * cg + v * ch) * esize, -1).reshape(-1, 32)
    first_el = stores[stores >= 0] // esize
    written = torch.bincount((first_el[:, None] + torch.arange(ch)).reshape(
        -1), minlength=n_items * cg).reshape(n, p, k, cg)
    forward = {"lanes": lanes, "items": items, "pixels": pixels,
               "channels": ch, "load_bytes": ch * esize,
               "order": "n, p, tap", "positions": positions,
               "stores": stores, "written": written,
               "idle_lanes": int((live & ~ok).sum())}

    # ---- backward: lanes an item in (n, p, tap) order; lane group g of
    # G takes items g, g + G, ...
    lanes = rows_lanes(cg, backward=True) if loop else 32
    grid = span(n_items * lanes, ROWS_THREADS)
    if loop and blocks is not None:
        grid = min(grid, blocks)
    groups = grid * ROWS_THREADS // lanes
    rounds = span(n_items, groups)
    thread = torch.arange(grid * ROWS_THREADS).reshape(-1, 1, 32)
    item = thread // lanes + groups * torch.arange(rounds)[:, None]
    sub = (thread % lanes).expand_as(item)            # (warps, rounds, 32)
    v = sub[:, :, None] + lanes * torch.arange(span(cv, lanes))[:, None]
    live = (item < n_items)[:, :, None]
    ok = live & (v < cv)                              # (w, r, passes, 32)
    red_item = torch.where(ok, item[:, :, None].expand_as(v), -1)
    red_off = torch.where(ok, v * ch * 4, -1)
    el = (red_item * cg + v * ch)[ok]
    read = torch.bincount((el[:, None] + torch.arange(ch)).reshape(-1),
                          minlength=n_items * cg).reshape(n, p, k, cg)
    leader = (sub == 0) & (item < n_items)
    dpyx = torch.bincount(pyx_index(item[leader]), minlength=n_items
                          ).reshape(n, k, p)
    backward = {"lanes": lanes, "items": 1, "channels": ch,
                "load_bytes": ch * esize, "order": "n, p, tap", "reductions": (red_item, red_off),
                "read": read, "dpyx": dpyx,
                "idle_lanes": int((live & ~ok).sum())}
    return {"forward": forward, "backward": backward}


def _rows_lib():
    lib = native.load("deform_rows")
    if lib.deform_rows_fwd_f32.argtypes is None:
        for fn, n_ptr in ((lib.deform_rows_fwd_f32, 3),
                          (lib.deform_rows_fwd_bf16, 3),
                          (lib.deform_rows_bwd_f32, 5),
                          (lib.deform_rows_bwd_bf16, 6)):
            fn.restype = ctypes.c_int
            fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * 7 + [
                ctypes.c_void_p]
    return lib


def _rows_launch_args(x_rows, pyx, tensors):
    """Checks of the CUDA path (``tensors``: x_rows, pyx and, backward,
    dsampled); returns (bf16, vec): whether the bf16 kernels run, and
    whether they take vectors of 4 channels (Cg % 4 == 0; f32: 16-byte
    vectors, every pointer 16-byte aligned; bf16: 8-byte lanes, every
    pointer 8-byte aligned)."""
    if x_rows.device.type != "cuda":
        raise ValueError(f"no K5 kernel for device {x_rows.device}")
    bf16 = x_rows.dtype == torch.bfloat16
    if x_rows.dtype not in (torch.float32, torch.bfloat16) or \
            pyx.dtype != torch.float32 or \
            any(t.dtype != x_rows.dtype for t in tensors[2:]):
        raise TypeError(f"the K5 kernels take float32 or bfloat16 x_rows "
                        f"(and dsampled) with float32 pyx, got "
                        f"{[t.dtype for t in tensors]}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("x_rows, pyx and dsampled must be contiguous")
    align = 8 if bf16 else 16
    return bf16, int(x_rows.shape[2] % 4 == 0 and all(
        t.data_ptr() % align == 0 for t in tensors))


def deform_rows(x_rows, pyx, h: int, w: int):
    """K5: bilinear sampling of ``x_rows`` (N, h*w, Cg) at ``pyx``
    (N, K, P, 2) -> (N, P, K, Cg), the layout of
    ``deform_gather.sample_bilinear_rows``.

    CPU tensors take :func:`deform_rows_plain`; CUDA tensors launch
    ``csrc/deform_rows.cu`` (contiguous; f32, or a bf16 x_rows with f32
    pyx, which gives bf16 samples) and raise on anything it does not take.
    f32 calls count in ``launches``, bf16 calls in ``bf16_launches``. The
    kernel records no gradient, so on CUDA it also raises when one is
    wanted: differentiate through ``deform_conv.deform_conv2d_rows``, whose
    backward is K5c.
    """
    if x_rows.device.type == "cpu":
        return deform_rows_plain(x_rows, pyx, h, w)
    n, cg, k, p = _check_rows(x_rows, pyx, h, w)
    if torch.is_grad_enabled() and (x_rows.requires_grad or
                                    pyx.requires_grad):
        raise RuntimeError("deform_rows records no gradient on CUDA: "
                           "differentiate through "
                           "deform_conv.deform_conv2d_rows")
    bf16, vec = _rows_launch_args(x_rows, pyx, (x_rows, pyx))
    out = torch.empty((n, p, k, cg), device=x_rows.device,
                      dtype=x_rows.dtype)
    if out.numel() == 0:
        return out
    lib = _rows_lib()
    launch = lib.deform_rows_fwd_bf16 if bf16 else lib.deform_rows_fwd_f32
    with native.device_guard(x_rows.device):
        code = launch(x_rows.data_ptr(), pyx.data_ptr(), out.data_ptr(), n,
                      h, w, cg, k, p, vec, native.stream_ptr(x_rows.device))
    native.check_launch(lib, "deform_rows", code)
    if bf16:
        deform_rows.bf16_launches += 1
    else:
        deform_rows.launches += 1
    return out


deform_rows.launches = 0
deform_rows.bf16_launches = 0


def deform_rows_backward(x_rows, pyx, dsampled, h: int, w: int):
    """K5c: (dx_rows (N, h*w, Cg), dpyx (N, K, P, 2)) of :func:`deform_rows`
    for the cotangent ``dsampled`` (N, P, K, Cg). The position derivative is
    the one-sided floor rule of ``deform_gather._dtent``. CPU tensors take
    :func:`deform_rows_backward_plain`; CUDA tensors zero dx and launch the
    kernel: dpyx gives the same bits on every call, dx's sums change order
    (atomics). bf16 x_rows and dsampled (f32 pyx): dx is summed into an f32
    scratch, which the C entry zeroes, and rounded once to bf16 by its last
    kernel (three device operations a call); dpyx is f32. f32 calls count
    in ``launches``, bf16 calls in ``bf16_launches``."""
    if x_rows.device.type == "cpu":
        return deform_rows_backward_plain(x_rows, pyx, dsampled, h, w)
    n, cg, k, p = _check_rows(x_rows, pyx, h, w)
    if tuple(dsampled.shape) != (n, p, k, cg) or \
            dsampled.device != x_rows.device:
        raise ValueError(f"dsampled {tuple(dsampled.shape)} on "
                         f"{dsampled.device} does not fit {(n, p, k, cg)} "
                         f"on {x_rows.device}")
    bf16, vec = _rows_launch_args(x_rows, pyx, (x_rows, pyx, dsampled))
    if bf16:   # the C entry zeroes the scratch
        dx32 = torch.empty_like(x_rows, dtype=torch.float32)
        dx = torch.empty_like(x_rows)
    else:
        dx = dx32 = torch.zeros_like(x_rows)
    dpyx = torch.empty_like(pyx)
    if dsampled.numel() == 0:
        return dx.zero_(), dpyx.zero_()
    lib = _rows_lib()
    with native.device_guard(x_rows.device):
        stream = native.stream_ptr(x_rows.device)
        if bf16:
            code = lib.deform_rows_bwd_bf16(
                x_rows.data_ptr(), pyx.data_ptr(), dsampled.data_ptr(),
                dx32.data_ptr(), dx.data_ptr(), dpyx.data_ptr(), n, h, w,
                cg, k, p, vec, stream)
        else:
            code = lib.deform_rows_bwd_f32(
                x_rows.data_ptr(), pyx.data_ptr(), dsampled.data_ptr(),
                dx.data_ptr(), dpyx.data_ptr(), n, h, w, cg, k, p, vec,
                stream)
    native.check_launch(lib, "deform_rows", code)
    if bf16:
        deform_rows_backward.bf16_launches += 1
    else:
        deform_rows_backward.launches += 1
    return dx, dpyx


deform_rows_backward.launches = 0
deform_rows_backward.bf16_launches = 0
