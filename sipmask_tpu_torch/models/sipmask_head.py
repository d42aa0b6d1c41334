"""SipMask head (NCHW), the port of ``sipmask_tpu/models/sipmask_head.py``:
FCOS towers, FeatureAlign, the SP coefficient branch, the basis-mask branch,
SipMask-VIS's track branch and SipMask++'s mask rescoring.

The JAX package's ``RescoringHead`` (a module of its own in flax) lives on
the head here, as :meth:`SipMaskHead.rescore`, because the reference keeps
its layers under the head's mmdet names (``bbox_head.convs_scoring.{i}.conv``,
``bbox_head.mask_scoring``).

Output dict (NCHW; ``models.loss.flatten_outputs`` turns the level lists
into the JAX package's NHWC-flattened order):
  cls_scores:   list of (B, C, h_l, w_l) logits
  bbox_preds:   list of (B, 4, h_l, w_l), already multiplied by the stride
  centernesses: list of (B, 1, h_l, w_l) logits
  cof_preds:    list of (B, 4*nb, h_l, w_l) SP coefficients
  feat_masks:   (B, nb, H/2, W/2) basis masks on the stride-2 grid
  track_feats:  (B, 512, H/8, W/8) embeddings, when ``cfg.track``
  track_feats_ref: the same for the reference frame (VIS training)
"""

from __future__ import annotations

import torch
from torch import nn

from ..ops import deform_conv as dc_ops
from .layers import ConvModule, GroupNorm32, Scale, resize_bilinear


class FeatureAlign(nn.Module):
    """Deformable 3x3 conv driven by the box regression (reference
    sipmask_head.py:21-55): offsets from a 1x1 conv on the 4-channel box
    prediction, 4 deformable groups, then GN+ReLU (ReLU alone without a
    norm)."""

    def __init__(self, channels: int, deform_groups: int = 4,
                 with_norm: bool = True):
        super().__init__()
        self.deform_groups = deform_groups
        self.conv_offset = nn.Conv2d(4, deform_groups * 18, 1, bias=False)
        # used through deform_conv2d, never called as a plain conv
        self.conv_adaption = nn.Conv2d(channels, channels, 3, padding=1,
                                       bias=False)
        self.norm = (GroupNorm32(channels, 32, 1e-5, act=True)
                     if with_norm else None)

    def forward(self, x, shape):
        offsets = self.conv_offset(shape.detach())
        x = dc_ops.deform_conv2d(x, offsets, self.conv_adaption.weight,
                                 padding=1, deform_groups=self.deform_groups)
        return self.norm(x) if self.norm is not None else torch.relu(x)


class SipMaskHead(nn.Module):
    def __init__(self, cfg):
        """cfg: a ``HeadConfig`` (``sipmask_tpu_torch.config``)."""
        super().__init__()
        c = self.cfg = cfg
        feat = c.feat_channels
        self.cls_convs = nn.ModuleList(
            ConvModule(c.in_channels if i == 0 else feat, feat, 3,
                       norm=c.norm) for i in range(c.stacked_convs - 1))
        self.reg_convs = nn.ModuleList(
            ConvModule(c.in_channels if i == 0 else feat, feat, 3,
                       norm=c.norm) for i in range(c.stacked_convs))
        self.fcos_cls = nn.Conv2d(feat, c.num_classes, 3, padding=1)
        self.fcos_reg = nn.Conv2d(feat, 4, 3, padding=1)
        self.fcos_centerness = nn.Conv2d(feat, 1, 3, padding=1)
        self.sip_cof = nn.Conv2d(feat, c.num_bases * 4, 3, padding=1)
        self.feat_align = FeatureAlign(feat, 4, with_norm=c.norm is not None)
        self.scales = nn.ModuleList(Scale(1.0) for _ in c.strides)
        self.sip_mask_lat0 = nn.Conv2d(feat * 3, 512, 1)
        self.sip_mask_lat = nn.Conv2d(512, c.num_bases, 3, padding=1)
        if c.track:
            # SipMask-VIS: its own tower on the FPN levels 0-2, then a 1x1
            # from the three levels' 3*feat channels to 512
            self.track_convs = nn.ModuleList(
                ConvModule(c.in_channels if i == 0 else feat, feat, 3,
                           norm=c.norm) for i in range(c.stacked_convs - 1))
            tower = feat if c.stacked_convs > 1 else c.in_channels
            self.sipmask_track = nn.Conv2d(tower * 3, 512, 1)
        if c.rescoring:
            # six stride-2 3x3 VALID convs 1->16->16->16->32->64->128 (ReLU),
            # a 1x1 to the classes (ReLU), a global max (reference
            # sipmask_head.py:200-219)
            chans = (1, 16, 16, 16, 32, 64, 128)
            self.convs_scoring = nn.ModuleList(
                ConvModule(chans[i], chans[i + 1], 3, stride=2, padding=0)
                for i in range(6))
            self.mask_scoring = nn.Conv2d(128, c.num_classes, 1)

    def forward(self, feats, feats_ref=None):
        """feats: the 5 FPN levels, each (B, C, h_l, w_l); feats_ref: the
        reference frame's levels (VIS training), which go through the track
        branch only."""
        cls_scores, bbox_preds, centernesses, cof_preds = [], [], [], []
        basis_feats = []
        frames = [feats] if feats_ref is None else [feats, feats_ref]
        track_ins = [[] for _ in frames] if self.cfg.track else []
        h0, w0 = feats[0].shape[2:]
        for lvl, (x, stride) in enumerate(zip(feats, self.cfg.strides)):
            cls_feat, reg_feat = x, x
            for conv in self.cls_convs:
                cls_feat = conv(cls_feat)
            for conv in self.reg_convs:
                reg_feat = conv(reg_feat)
            bbox_pred = self.scales[lvl](self.fcos_reg(reg_feat))
            cls_feat = self.feat_align(cls_feat, bbox_pred)
            cls_scores.append(self.fcos_cls(cls_feat))
            centernesses.append(self.fcos_centerness(reg_feat))
            bbox_preds.append(bbox_pred.float() * stride)
            cof_preds.append(self.sip_cof(cls_feat))
            if lvl < 3:
                basis_feats.append(reg_feat if lvl == 0 else
                                   resize_bilinear(reg_feat, h0, w0))
                # the track tower on levels 0-2 of each frame, resized to
                # level 0 (the reference's VIS head)
                for ins, fr in zip(track_ins, frames):
                    t = fr[lvl]
                    for conv in self.track_convs:
                        t = conv(t)
                    ins.append(t if lvl == 0 else
                               resize_bilinear(t, h0, w0))
        # basis branch: concat P3-P5 reg feats, 1x1 -> 512, relu, 3x3 -> nb,
        # relu, upsample x4 to the stride-2 grid
        fm = torch.cat(basis_feats, 1)
        fm = torch.relu(self.sip_mask_lat(torch.relu(self.sip_mask_lat0(fm))))
        feat_masks = resize_bilinear(fm, h0 * 4, w0 * 4)
        out = dict(cls_scores=cls_scores, bbox_preds=bbox_preds,
                   centernesses=centernesses, cof_preds=cof_preds,
                   feat_masks=feat_masks)
        # track branch: the three levels concatenated, 1x1 to 512
        for key, ins in zip(("track_feats", "track_feats_ref"), track_ins):
            out[key] = self.sipmask_track(torch.cat(ins, 1))
        return out

    def rescore(self, masks):
        """SipMask++ mask rescoring: masks (N, 1, h, w), detached assembled
        masks with h, w >= 127 -> (N, num_classes) predicted mask IoU."""
        x = masks.to(self.mask_scoring.weight.dtype)
        for conv in self.convs_scoring:
            x = conv(x)
        return torch.relu(self.mask_scoring(x)).amax((2, 3))
