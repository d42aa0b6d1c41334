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
from .resnet import ResNet
from .sipmask_head import SipMaskHead


class SipMask(nn.Module):
    def __init__(self, cfg):
        """cfg: a ``ModelConfig`` (``sipmask_tpu_torch.config``)."""
        super().__init__()
        b, f = cfg.backbone, cfg.fpn
        if (b.type != "resnet" or b.style != "caffe" or b.groups != 1
                or f.type != "fpn" or not f.add_extra_convs
                or f.extra_convs_on_inputs or not f.relu_before_extra_convs
                or cfg.compute_dtype not in ("float32", "bfloat16")):
            raise NotImplementedError(
                "the port runs float32 or bfloat16 caffe-ResNet + FPN (extra "
                "levels from P5) models without ResNeXt groups")
        self.cfg = cfg
        dtype = getattr(torch, cfg.compute_dtype)
        self.backbone = ResNet(b.depth, b.out_indices, b.frozen_stages,
                               b.stage_with_dcn, b.dcn_deform_groups, dtype)
        self.neck = FPN(f.in_channels, f.out_channels, f.start_level,
                        f.num_outs, dtype)
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
