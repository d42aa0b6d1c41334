"""SipMask detector: backbone -> neck -> head, the port of
``sipmask_tpu/models/detector.py`` for the ResNet + FPN models, SipMask++
(DCN stages, rescoring) and SipMask-VIS (the track branch, a reference
frame in training) included. ``compute_dtype`` "float32" or "bfloat16"
runs every one of them (bf16 with f32 parameters, at the JAX package's cast
points); ResNeXt groups and HRNet are not ported in either."""

from __future__ import annotations

import torch
from torch import nn

from .fpn import FPN
from .hrnet import HRFPN, HRNET_WIDTHS, HRNet
from .resnet import ResNet
from .sipmask_head import SipMaskHead


class SipMask(nn.Module):
    def __init__(self, cfg):
        """cfg: a ``ModelConfig`` (``sipmask_tpu_torch.config``)."""
        super().__init__()
        b, f = cfg.backbone, cfg.fpn
        if cfg.compute_dtype not in ("float32", "bfloat16"):
            raise NotImplementedError(
                f"compute_dtype {cfg.compute_dtype!r}: the port runs float32 "
                "and bfloat16")
        self.cfg = cfg
        dtype = getattr(torch, cfg.compute_dtype)
        if b.type == "hrnet":
            self.backbone = HRNet(b.hrnet_width, b.frozen_stages, dtype)
            in_channels = HRNET_WIDTHS[b.hrnet_width]
        else:
            self.backbone = ResNet(b.depth, b.out_indices, b.frozen_stages,
                                   b.stage_with_dcn, b.dcn_deform_groups,
                                   b.groups, b.base_width, b.style, dtype)
            in_channels = f.in_channels
        if f.type == "hrfpn":
            self.neck = HRFPN(in_channels, f.out_channels, f.num_outs, dtype)
        else:
            self.neck = FPN(in_channels, f.out_channels, f.start_level,
                            f.num_outs, f.add_extra_convs,
                            f.extra_convs_on_inputs,
                            f.relu_before_extra_convs, dtype)
        self.bbox_head = SipMaskHead(cfg.head, dtype)

    def extract_feats(self, images):
        return self.neck(self.backbone(images))

    def forward(self, images, images_ref=None):
        """images: (B, 3, H, W) normalized; returns the head output dict.
        images_ref: SipMask-VIS training's reference frames, through the
        backbone and neck with gradient (the match loss trains them too)
        and then the track branch (``track_feats_ref``)."""
        feats_ref = (self.extract_feats(images_ref)
                     if images_ref is not None else None)
        return self.bbox_head(self.extract_feats(images), feats_ref)

    def rescore(self, masks):
        """SipMask++: masks (N, 1, h, w) -> (N, C) predicted mask IoU."""
        return self.bbox_head.rescore(masks)


def build_model(cfg) -> SipMask:
    return SipMask(cfg)
