"""SipMask detector: backbone -> neck -> head, the port of
``sipmask_tpu/models/detector.py`` for the ResNet + FPN image models."""

from __future__ import annotations

from torch import nn

from .fpn import FPN
from .resnet import ResNet
from .sipmask_head import SipMaskHead


class SipMask(nn.Module):
    def __init__(self, cfg):
        """cfg: the JAX package's ``ModelConfig``."""
        super().__init__()
        b, f = cfg.backbone, cfg.fpn
        if (b.type != "resnet" or b.style != "caffe" or b.groups != 1
                or any(b.stage_with_dcn) or f.type != "fpn"
                or not f.add_extra_convs or f.extra_convs_on_inputs
                or not f.relu_before_extra_convs or cfg.head.track
                or cfg.head.rescoring or cfg.compute_dtype != "float32"):
            raise NotImplementedError(
                "the port runs float32 caffe-ResNet + FPN (extra levels from "
                "P5) image models without DCN stages, ResNeXt groups, "
                "tracking or rescoring")
        self.cfg = cfg
        self.backbone = ResNet(b.depth, b.out_indices, b.frozen_stages)
        self.neck = FPN(f.in_channels, f.out_channels, f.start_level,
                        f.num_outs)
        self.bbox_head = SipMaskHead(cfg.head)

    def forward(self, images):
        """images: (B, 3, H, W) normalized; returns the head output dict."""
        return self.bbox_head(self.neck(self.backbone(images)))


def build_model(cfg) -> SipMask:
    return SipMask(cfg)
