"""RoI feature extraction ops, the port of ``sipmask_tpu/ops/roi.py`` (NCHW):
RoIAlign, RoIPool, grid sampling, the masked conv, CARAFE and deformable
PS-RoI pooling with its two packs. None of them is on a SipMask path (they
serve two-stage heads); they complete the reference's op surface. The JAX
package computes them in XLA, so plain PyTorch is their counterpart here and
autograd gives the backward.

RoIs are (R, 5) ``[batch_idx, x1, y1, x2, y2]`` in input coordinates.
Features are (B, C, H, W); outputs are (R, C, out, out).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

# the JAX package's "no pixel" fill of RoIPool (finfo(float32).min / 4)
_NEG = torch.finfo(torch.float32).min / 4


def _channels_last_rows(feats):
    """(B, C, H, W) -> (B*H*W, C): one row of channels a pixel."""
    return feats.permute(0, 2, 3, 1).reshape(-1, feats.shape[1])


def _bilinear(rows, bidx, py, px, h: int, w: int):
    """Bilinear samples of the (B*H*W, C) pixel rows at (py, px), broadcast
    with the batch index ``bidx``: a corner counts only where it lies in
    [0, h-1] x [0, w-1], else it gives 0 (it is not clamped)."""
    y0, x0 = torch.floor(py), torch.floor(px)
    out = 0.0
    for dy in (0, 1):
        for dx in (0, 1):
            yy, xx = y0 + dy, x0 + dx
            wgt = ((py - y0 if dy else 1.0 - (py - y0)) *
                   (px - x0 if dx else 1.0 - (px - x0)))
            inb = (yy >= 0) & (yy <= h - 1) & (xx >= 0) & (xx <= w - 1)
            yi = yy.clamp(0, h - 1).long()
            xi = xx.clamp(0, w - 1).long()
            out = out + rows[(bidx * h + yi) * w + xi] * (wgt * inb)[..., None]
    return out


def roi_align(feats, rois, out_size: int, spatial_scale: float,
              sample_num: int = 2, aligned: bool = False):
    """RoIAlign with ``sample_num``^2 points a bin, at
    ``(i + (j + 0.5) / sample_num) * bin`` from the RoI's corner. mmdet v1's
    ``aligned=False`` takes no half-pixel shift and clamps the RoI's size to
    at least 1."""
    _, c, h, w = feats.shape
    off = 0.5 if aligned else 0.0
    x1, y1, x2, y2 = (rois[:, i] * spatial_scale - off for i in range(1, 5))
    rw, rh = x2 - x1, y2 - y1
    if not aligned:
        rw, rh = rw.clamp(min=1.0), rh.clamp(min=1.0)
    s = sample_num
    grid = (torch.arange(out_size, device=rois.device)[:, None] +
            (torch.arange(s, device=rois.device)[None, :] + 0.5) / s
            ).reshape(-1)                                   # (out*s,)
    ys = y1[:, None] + grid[None, :] * (rh / out_size)[:, None]
    xs = x1[:, None] + grid[None, :] * (rw / out_size)[:, None]
    bidx = rois[:, 0].long()[:, None, None]
    pts = _bilinear(_channels_last_rows(feats), bidx, ys[:, :, None],
                    xs[:, None, :], h, w)                   # (R, oy*s, ox*s, C)
    pts = pts.reshape(-1, out_size, s, out_size, s, c).mean((2, 4))
    return pts.permute(0, 3, 1, 2)


def roi_pool(feats, rois, out_size: int, spatial_scale: float):
    """RoIPool: the max over each bin of the RoI rounded half-to-even to the
    feature grid, 0 in an empty bin. Bins are exclusive: pixel row y falls
    in bin ``floor((y - y1) / bin_h * out)`` (columns alike).

    The max is taken as the JAX package takes it, in two stages: over the
    rows of each bin row, column by column, then over the columns of each
    bin. Each stage splits a gradient evenly among its ties, so a tied
    gradient follows JAX's (for the bin [[1, 1], [1, 0]]:
    [[0.25, 0.5], [0.25, 0]]). Each stage reduces the pixels of its own bins
    (``index_reduce`` with amax, whose backward splits among ties): the work
    and memory are the RoIs' pixels, not (out, H, W) a RoI. Two host reads
    a call size them (the RoIs' pixel and column counts)."""
    b, c, h, w = feats.shape
    dev = feats.device
    r = rois.shape[0]
    x1, y1, x2, y2 = (torch.round(rois[:, i] * spatial_scale)
                      for i in range(1, 5))
    rw = (x2 - x1 + 1).clamp(min=1.0)
    rh = (y2 - y1 + 1).clamp(min=1.0)
    # each RoI's pixel rectangle on the map: rows [r0, r0 + nr)
    r0 = y1.clamp(0, h).long()
    nr = ((y1 + rh).clamp(0, h).long() - r0).clamp(min=0)
    c0 = x1.clamp(0, w).long()
    nc = ((x1 + rw).clamp(0, w).long() - c0).clamp(min=0)
    area = nr * nc
    n_pairs = int(area.sum())
    roi = torch.repeat_interleave(torch.arange(r, device=dev), area,
                                  output_size=n_pairs)
    first = torch.cumsum(area, 0) - area
    local = torch.arange(n_pairs, device=dev) - first[roi]
    ry, rx = local // nc[roi], local % nc[roi]
    y, x = r0[roi] + ry, c0[roi] + rx

    def bins(pos, start, size):
        """JAX's bin of each pixel, -1 outside the RoI."""
        p = pos.float()
        bi = torch.floor((p - start) / size * out_size)
        ok = (p >= start) & (bi < out_size) & (bi >= 0)
        return torch.where(ok, bi, -1).long()
    by = bins(y, y1[roi], rh[roi])
    bx_col = bins(c0[:, None] + torch.arange(w, device=dev), x1[:, None],
                  rw[:, None])                              # (R, W)
    # stage 1: (RoI, column of its rectangle, bin row) <- max over rows;
    # rows outside every bin go to the spare last slot
    col_first = torch.cumsum(nc, 0) - nc
    n_cols = int(nc.sum())
    slot = (col_first[roi] + rx) * out_size + by
    slot = torch.where(by >= 0, slot, n_cols * out_size)
    src = _channels_last_rows(feats)[(rois[:, 0].long()[roi] * h + y) * w + x]
    fill = torch.full((n_cols * out_size + 1, c), _NEG, dtype=feats.dtype,
                      device=dev)
    my = fill.index_reduce(0, slot, src, "amax")[:-1]
    # stage 2: (RoI, bin row, bin column) <- max over the bin's columns
    s_roi = torch.repeat_interleave(torch.arange(r, device=dev), nc,
                                    output_size=n_cols)
    s_col = torch.arange(n_cols, device=dev) - col_first[s_roi]
    bx = bx_col[s_roi, s_col]                               # (n_cols,)
    i = torch.arange(out_size, device=dev)
    cell = (s_roi[:, None] * out_size + i) * out_size + bx[:, None]
    cell = torch.where(bx[:, None] >= 0, cell, r * out_size * out_size)
    fill = torch.full((r * out_size * out_size + 1, c), _NEG,
                      dtype=feats.dtype, device=dev)
    out = fill.index_reduce(0, cell.reshape(-1), my, "amax")[:-1]
    out = torch.where(out > _NEG / 2, out, torch.zeros_like(out))
    return out.reshape(r, out_size, out_size, c).permute(0, 3, 1, 2)


def grid_sample(feats, grid, align_corners: bool = True):
    """Bilinear sampling with zero padding (the reference's vendored
    grid_sampler) at ``grid`` (B, Ho, Wo, 2), normalized (x, y) in [-1, 1]:
    ``F.grid_sample`` computes exactly the JAX function."""
    return F.grid_sample(feats, grid, mode="bilinear", padding_mode="zeros",
                         align_corners=align_corners)


def masked_conv2d(x, mask, weight, bias=None, padding: int = 1):
    """MaskedConv2d: the conv where ``mask`` (B, H, W) > 0, 0 elsewhere
    (the dense conv times the mask)."""
    out = F.conv2d(x, weight, bias, padding=padding)
    return out * (mask > 0).to(out.dtype)[:, None]


def carafe(x, kernels, up_factor: int = 2, k_up: int = 5):
    """CARAFE upsampling: output pixel (y, x) of (B, C, H*up, W*up) is the
    sum of its parent pixel's k_up x k_up neighbourhood (zero padded)
    weighted by its (already normalized) kernel, ``kernels`` (B, k_up^2,
    H*up, W*up). The neighbourhoods are unfolded once a source pixel and
    contracted against the up x up kernels of its children."""
    b, c, h, w = x.shape
    r = k_up // 2
    patches = F.unfold(F.pad(x, (r, k_up - 1 - r, r, k_up - 1 - r)), k_up)
    patches = patches.view(b, c, k_up * k_up, h, w)
    ker = kernels.reshape(b, k_up * k_up, h, up_factor, w, up_factor)
    out = torch.einsum("bckhw,bkhuwv->bchuwv", patches, ker)
    return out.reshape(b, c, h * up_factor, w * up_factor)


def _sample_cells(xs, ys, h: int, w: int):
    """deform_roi_pool's samples at (ys, xs): which count (inside
    [-0.5, size - 0.5]), the floor and ceil corners of their coordinates
    clamped to the map, and the fractions past the floor corners."""
    valid = (xs >= -0.5) & (xs <= w - 0.5) & (ys >= -0.5) & (ys <= h - 0.5)
    xc, yc = xs.clamp(0.0, w - 1.0), ys.clamp(0.0, h - 1.0)
    x0, x1 = torch.floor(xc), torch.ceil(xc)
    y0, y1 = torch.floor(yc), torch.ceil(yc)
    return valid, x0, x1, y0, y1, xc - x0, yc - y0


def deform_roi_pool(feats, rois, trans, out_size: int, spatial_scale: float,
                    out_channels: int, no_trans: bool, group_size: int = 1,
                    part_size: Optional[int] = None,
                    sample_per_part: int = 4, trans_std: float = 0.0):
    """Deformable PS-RoI pooling: output (R, out_channels, P, P), P =
    ``out_size``. Cell (d, ph, pw) averages a ``sample_per_part``^2
    bilinear grid in its bin of the RoI (rounded with floor(x + 0.5), the
    corners shifted by -0.5 and +1.0, its size at least 0.1), the bin moved
    by the offset ``trans * trans_std * roi_size`` of its part, and reads
    the position-sensitive channel ``(d*G + gh)*G + gw``. ``trans`` is
    (R, num_classes*2, part, part), class and {x, y} interleaved on axis 1;
    channel block ``d // (out_channels / num_classes)`` takes its class's
    offsets. Samples outside [-0.5, size - 0.5] are skipped and the mean is
    over the samples counted; the coordinates are clamped to the map and
    interpolated between their floor and ceil pixels."""
    if part_size is None:
        part_size = out_size
    bsz, c, h, w = feats.shape
    p, s, d, g = out_size, sample_per_part, out_channels, group_size
    dev = feats.device
    r = rois.shape[0]
    if no_trans:
        ncls = 1
        trans = torch.zeros(r, 2, part_size, part_size, dtype=feats.dtype,
                            device=dev)
    else:
        ncls = trans.shape[1] // 2
    each = d // ncls

    def c_round(v):   # C's round() for these coordinates
        return torch.floor(v + 0.5)
    start_w = c_round(rois[:, 1]) * spatial_scale - 0.5
    start_h = c_round(rois[:, 2]) * spatial_scale - 0.5
    end_w = (c_round(rois[:, 3]) + 1.0) * spatial_scale - 0.5
    end_h = (c_round(rois[:, 4]) + 1.0) * spatial_scale - 0.5
    roi_w = (end_w - start_w).clamp(min=0.1)
    roi_h = (end_h - start_h).clamp(min=0.1)

    # index arithmetic in f32 whatever the dtype, as the JAX package does
    cells = torch.arange(p, device=dev)
    cf = cells.float()
    part = torch.floor(cf / p * part_size).long()
    gh = torch.floor(cf * g / p).clamp(0, g - 1).long()
    tr = trans.reshape(r, ncls, 2, part_size, part_size)
    tr = tr[:, :, :, part[:, None], part[None, :]] * trans_std  # (R,K,2,P,P)
    tx, ty = tr[:, :, 0], tr[:, :, 1]

    def col(v):       # (R,) -> broadcast over (R, K, P, P, S, S)
        return v[:, None, None, None, None, None]
    bin_w, bin_h = roi_w / p, roi_h / p
    sub_w, sub_h = bin_w / s, bin_h / s
    samp = torch.arange(s, device=dev)
    wstart = (cells[None, None, None, :] * bin_w[:, None, None, None]
              + start_w[:, None, None, None] + tx * roi_w[:, None, None, None])
    hstart = (cells[None, None, :, None] * bin_h[:, None, None, None]
              + start_h[:, None, None, None] + ty * roi_h[:, None, None, None])
    xs = wstart[..., None, None] + samp[None, :] * col(sub_w)
    ys = hstart[..., None, None] + samp[:, None] * col(sub_h)
    valid, x0, x1, y0, y1, dx, dy = _sample_cells(xs, ys, h, w)
    # rows of `each` channels: (b, y, x, gh, gw, class); the channel of
    # output d = k*each + e is ((k*each + e)*G + gh)*G + gw
    table = (feats.view(bsz, ncls, each, g, g, h, w)
             .permute(0, 5, 6, 3, 4, 1, 2).reshape(-1, each))
    group = (gh[:, None] * g + gh[None, :])                 # (P, P)
    k = torch.arange(ncls, device=dev)[:, None, None]
    base = (col(rois[:, 0].long()) * h)                      # (R,1,1,1,1,1)
    gk = (group[None, :, :] * ncls + k)[None, :, :, :, None, None]

    def at(yy, xx):
        pix = (base + yy.long()) * w + xx.long()
        return table[pix * (g * g * ncls) + gk]             # (R,K,P,P,S,S,E)
    val = (((1 - dx) * (1 - dy))[..., None] * at(y0, x0)
           + ((1 - dx) * dy)[..., None] * at(y1, x0)
           + (dx * (1 - dy))[..., None] * at(y0, x1)
           + (dx * dy)[..., None] * at(y1, x1))
    val = val * valid[..., None]
    cnt = valid.sum((-1, -2))[..., None]                    # (R,K,P,P,1)
    out = torch.where(cnt > 0, val.sum((4, 5)) / cnt.clamp(min=1),
                      torch.zeros((), dtype=val.dtype, device=dev))
    return out.permute(0, 1, 4, 2, 3).reshape(r, d, p, p)


def _lecun_normal_(weight, generator):
    """flax's lecun_normal: truncated normal on [-2, 2] std units, scaled
    so that the variance is 1 / fan_in."""
    std = math.sqrt(1.0 / weight.shape[1]) / .87962566103423978
    nn.init.trunc_normal_(weight, 0.0, std, -2 * std, 2 * std,
                          generator=generator)


def _fc_stack(n_in: int, hidden: int, n_out: int, n_layers: int, last):
    """mmdet's offset / mask FC stack: Linear, ReLU, ..., Linear, ``last``."""
    layers = []
    for i in range(n_layers):
        end = i == n_layers - 1
        layers.append(nn.Linear(n_in if i == 0 else hidden,
                                n_out if end else hidden))
        if not end:
            layers.append(nn.ReLU())
        elif last is not None:
            layers.append(last)
    return nn.Sequential(*layers)


def init_fc_stack(stack: nn.Sequential, generator: torch.Generator):
    """The JAX packs' init: LeCun-normal hidden layers, a zero last layer
    (no offset and a 0.5 mask to start), zero biases."""
    linears = [m for m in stack if isinstance(m, nn.Linear)]
    with torch.no_grad():
        for i, m in enumerate(linears):
            if i < len(linears) - 1:
                _lecun_normal_(m.weight, generator)
            else:
                m.weight.zero_()
            m.bias.zero_()


class DeformRoIPoolingPack(nn.Module):
    """mmdet's DeformRoIPoolingPack: a no-offset PS-RoI pool, flattened in
    (D, P, P) order, feeds ``offset_fc``, which predicts one (x, y) offset
    a cell; the deformable pool then runs with those offsets.
    Call: (feats (B, C, H, W), rois (R, 5)) -> (R, out_channels, P, P)."""

    def __init__(self, spatial_scale: float, out_size: int,
                 out_channels: int, no_trans: bool = False,
                 group_size: int = 1, sample_per_part: int = 4,
                 trans_std: float = 0.0, num_offset_fcs: int = 3,
                 deform_fc_channels: int = 1024):
        super().__init__()
        self.spatial_scale, self.out_size = spatial_scale, out_size
        self.out_channels, self.no_trans = out_channels, no_trans
        self.group_size, self.sample_per_part = group_size, sample_per_part
        self.trans_std = trans_std
        if not no_trans:
            self.offset_fc = _fc_stack(out_size * out_size * out_channels,
                                       deform_fc_channels,
                                       out_size * out_size * 2,
                                       num_offset_fcs, None)

    def pool(self, feats, rois, trans):
        return deform_roi_pool(
            feats, rois, trans, self.out_size, self.spatial_scale,
            self.out_channels, trans is None, group_size=self.group_size,
            sample_per_part=self.sample_per_part, trans_std=self.trans_std)

    def offsets(self, feats, rois):
        """The no-offset pool flattened, and the offsets (R, 2, P, P)."""
        flat = self.pool(feats, rois, None).flatten(1)
        p = self.out_size
        return flat, self.offset_fc(flat).view(-1, 2, p, p)

    def forward(self, feats, rois):
        if self.no_trans:
            return self.pool(feats, rois, None)
        _, trans = self.offsets(feats, rois)
        return self.pool(feats, rois, trans)


class ModulatedDeformRoIPoolingPack(DeformRoIPoolingPack):
    """mmdet's ModulatedDeformRoIPoolingPack: the pack above times a
    per-cell sigmoid mask that ``mask_fc`` predicts from the same
    flattened no-offset pool."""

    def __init__(self, spatial_scale: float, out_size: int,
                 out_channels: int, no_trans: bool = False,
                 group_size: int = 1, sample_per_part: int = 4,
                 trans_std: float = 0.0, num_offset_fcs: int = 3,
                 num_mask_fcs: int = 2, deform_fc_channels: int = 1024):
        super().__init__(spatial_scale, out_size, out_channels, no_trans,
                         group_size, sample_per_part, trans_std,
                         num_offset_fcs, deform_fc_channels)
        if not no_trans:
            self.mask_fc = _fc_stack(out_size * out_size * out_channels,
                                     deform_fc_channels, out_size * out_size,
                                     num_mask_fcs, nn.Sigmoid())

    def forward(self, feats, rois):
        if self.no_trans:
            return self.pool(feats, rois, None)
        flat, trans = self.offsets(feats, rois)
        p = self.out_size
        mask = self.mask_fc(flat).view(-1, 1, p, p)
        return self.pool(feats, rois, trans) * mask
