"""The SipMask detector in plain PyTorch (NCHW, float32): a caffe-style
ResNet-50/101 whose frozen BatchNorms are applied after each conv, with
SipMask++'s deformable conv2 in every third block of the DCN stages; the
FPN P3-P7; the SipMask head with its FCOS towers, FeatureAlign, the SP
coefficients, the basis masks and SipMask++'s mask rescoring.

``cfg`` is the ``model`` object of a configuration file of the benchmark
(``port_bench/configs/*.json``). Module and parameter names follow
mmdetection's, which the program's state dicts use too, so one dict of
weights loads into both.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from . import ops

BLOCKS = {50: (3, 4, 6, 3), 101: (3, 4, 23, 3)}


class FrozenBN(nn.Module):
    def __init__(self, n: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        for name, fill in (("weight", 1.0), ("bias", 0.0),
                           ("running_mean", 0.0), ("running_var", 1.0)):
            self.register_buffer(name, torch.full((n,), fill))

    def forward(self, x):
        scale = self.weight * torch.rsqrt(self.running_var + self.eps)
        shift = self.bias - self.running_mean * scale
        return x * scale[:, None, None] + shift[:, None, None]


class DeformConvPack(nn.Module):
    """3x3 deformable conv v1 whose offsets come from its own 3x3 conv."""

    def __init__(self, cin: int, cout: int, stride: int = 1):
        super().__init__()
        self.stride = stride
        self.weight = nn.Parameter(torch.empty(cout, cin, 3, 3))
        self.conv_offset = nn.Conv2d(cin, 18, 3, stride, 1)

    def forward(self, x):
        return ops.deform_conv(x, self.conv_offset(x), self.weight,
                               self.stride, 1, "rows")


class Bottleneck(nn.Module):
    def __init__(self, cin: int, planes: int, stride: int, downsample: bool,
                 dcn: bool):
        super().__init__()
        # caffe style: the stride sits on the first 1x1 conv
        self.conv1 = nn.Conv2d(cin, planes, 1, stride, bias=False)
        self.bn1 = FrozenBN(planes)
        self.conv2 = (DeformConvPack(planes, planes) if dcn else
                      nn.Conv2d(planes, planes, 3, 1, 1, bias=False))
        self.bn2 = FrozenBN(planes)
        self.conv3 = nn.Conv2d(planes, planes * 4, 1, bias=False)
        self.bn3 = FrozenBN(planes * 4)
        self.downsample = (nn.Sequential(
            nn.Conv2d(cin, planes * 4, 1, stride, bias=False),
            FrozenBN(planes * 4)) if downsample else None)

    def forward(self, x):
        out = torch.relu(self.bn1(self.conv1(x)))
        out = torch.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        idt = x if self.downsample is None else self.downsample(x)
        return torch.relu(out + idt)


class ResNet(nn.Module):
    def __init__(self, depth: int, dcn_stages, frozen_stages: int):
        super().__init__()
        self.frozen_stages = frozen_stages
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = FrozenBN(64)
        cin = 64
        for s, n in enumerate(BLOCKS[depth]):
            planes = 64 * 2 ** s
            self.add_module(f"layer{s + 1}", nn.Sequential(*[
                Bottleneck(cin if b == 0 else planes * 4, planes,
                           1 if s == 0 or b else 2, b == 0,
                           bool(dcn_stages[s]) and b % 3 == 0)
                for b in range(n)]))
            cin = planes * 4
        for m in [self.conv1] + [getattr(self, f"layer{i + 1}")
                                 for i in range(frozen_stages)]:
            m.requires_grad_(False)

    def stem(self, x):
        return F.max_pool2d(torch.relu(self.bn1(self.conv1(x))), 3, 2, 1)

    def forward(self, x):
        x = self.stem(x)
        outs = []
        for s in range(4):
            x = getattr(self, f"layer{s + 1}")(x)
            if s < self.frozen_stages:
                x = x.detach()
            outs.append(x)
        return outs


class ConvModule(nn.Module):
    """conv, then GroupNorm(32) and ReLU, or ReLU alone, or nothing."""

    def __init__(self, cin, cout, k=3, stride=1, padding=None, norm=None,
                 act=True):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, k, stride,
                              k // 2 if padding is None else padding,
                              bias=norm is None)
        self.gn = nn.GroupNorm(32, cout) if norm == "gn" else None
        self.act = act

    def forward(self, x):
        x = self.conv(x)
        if self.gn is not None:
            return ops.gn_relu(x, self.gn.weight, self.gn.bias, 32, 1e-5,
                               self.act)
        return torch.relu(x) if self.act else x


class FPN(nn.Module):
    def __init__(self, c):
        super().__init__()
        used = c["in_channels"][c["start_level"]:]
        out = c["out_channels"]
        self.start_level = c["start_level"]
        self.relu_before_extra = c["relu_before_extra_convs"]
        self.lateral_convs = nn.ModuleList(
            ConvModule(ci, out, 1, act=False) for ci in used)
        self.fpn_convs = nn.ModuleList(
            ConvModule(out, out, 3, stride=1 if i < len(used) else 2,
                       act=False) for i in range(c["num_outs"]))

    def forward(self, inputs):
        used = inputs[self.start_level:]
        lat = [m(x) for m, x in zip(self.lateral_convs, used)]
        for i in range(len(lat) - 1, 0, -1):
            lat[i - 1] = lat[i - 1] + F.interpolate(
                lat[i], size=lat[i - 1].shape[2:], mode="nearest")
        outs = [self.fpn_convs[i](lat[i]) for i in range(len(lat))]
        src = outs[-1]
        for i in range(len(lat), len(self.fpn_convs)):
            if i > len(lat) and self.relu_before_extra:
                src = torch.relu(src)
            src = self.fpn_convs[i](src)
            outs.append(src)
        return outs


class Scale(nn.Module):
    def __init__(self):
        super().__init__()
        self.scale = nn.Parameter(torch.tensor(1.0))

    def forward(self, x):
        return x * self.scale


class FeatureAlign(nn.Module):
    """The head's deformable 3x3 conv (4 groups) whose offsets come from a
    1x1 conv of the detached box prediction; then GN and ReLU, or ReLU."""

    def __init__(self, ch: int, norm):
        super().__init__()
        self.conv_offset = nn.Conv2d(4, 4 * 18, 1, bias=False)
        self.conv_adaption = nn.Conv2d(ch, ch, 3, padding=1, bias=False)
        self.norm = nn.GroupNorm(32, ch) if norm == "gn" else None

    def forward(self, x, shape):
        x = ops.deform_conv(x, self.conv_offset(shape.detach()),
                            self.conv_adaption.weight, 1, 4, "im2col")
        if self.norm is None:
            return torch.relu(x)
        return ops.gn_relu(x, self.norm.weight, self.norm.bias)


class Head(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.c = c
        feat, norm = c["feat_channels"], c["norm"]
        self.cls_convs = nn.ModuleList(
            ConvModule(c["in_channels"] if i == 0 else feat, feat, norm=norm)
            for i in range(c["stacked_convs"] - 1))
        self.reg_convs = nn.ModuleList(
            ConvModule(c["in_channels"] if i == 0 else feat, feat, norm=norm)
            for i in range(c["stacked_convs"]))
        self.fcos_cls = nn.Conv2d(feat, c["num_classes"], 3, padding=1)
        self.fcos_reg = nn.Conv2d(feat, 4, 3, padding=1)
        self.fcos_centerness = nn.Conv2d(feat, 1, 3, padding=1)
        self.sip_cof = nn.Conv2d(feat, c["num_bases"] * 4, 3, padding=1)
        self.feat_align = FeatureAlign(feat, norm)
        self.scales = nn.ModuleList(Scale() for _ in c["strides"])
        self.sip_mask_lat0 = nn.Conv2d(feat * 3, 512, 1)
        self.sip_mask_lat = nn.Conv2d(512, c["num_bases"], 3, padding=1)
        if c["rescoring"]:
            ch = (1, 16, 16, 16, 32, 64, 128)
            self.convs_scoring = nn.ModuleList(
                ConvModule(ch[i], ch[i + 1], 3, stride=2, padding=0)
                for i in range(6))
            self.mask_scoring = nn.Conv2d(128, c["num_classes"], 1)

    def forward(self, feats):
        out = {k: [] for k in ("cls_scores", "bbox_preds", "centernesses",
                               "cof_preds")}
        basis = []
        h0, w0 = feats[0].shape[2:]
        for lvl, (x, stride) in enumerate(zip(feats, self.c["strides"])):
            cls_feat, reg_feat = x, x
            for m in self.cls_convs:
                cls_feat = m(cls_feat)
            for m in self.reg_convs:
                reg_feat = m(reg_feat)
            box = self.scales[lvl](self.fcos_reg(reg_feat))
            cls_feat = self.feat_align(cls_feat, box)
            out["cls_scores"].append(self.fcos_cls(cls_feat))
            out["centernesses"].append(self.fcos_centerness(reg_feat))
            out["bbox_preds"].append(box * stride)
            out["cof_preds"].append(self.sip_cof(cls_feat))
            if lvl < 3:
                basis.append(reg_feat if lvl == 0 else F.interpolate(
                    reg_feat, size=(h0, w0), mode="bilinear",
                    align_corners=False))
        fm = torch.relu(self.sip_mask_lat(torch.relu(
            self.sip_mask_lat0(torch.cat(basis, 1)))))
        out["feat_masks"] = F.interpolate(fm, size=(h0 * 4, w0 * 4),
                                          mode="bilinear",
                                          align_corners=False)
        return out

    def rescore(self, masks):
        """(N, 1, h, w) assembled masks -> (N, classes) predicted mask IoU:
        six stride-2 valid 3x3 convs with ReLU, a 1x1 conv, ReLU, the
        global max."""
        x = masks
        for m in self.convs_scoring:
            x = m(x)
        return torch.relu(self.mask_scoring(x)).amax((2, 3))


class SipMask(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        b = cfg["backbone"]
        self.cfg = cfg
        self.backbone = ResNet(b["depth"], b["stage_with_dcn"],
                               b["frozen_stages"])
        self.neck = FPN(cfg["fpn"])
        self.bbox_head = Head(cfg["head"])

    def forward(self, images):
        return self.bbox_head(self.neck(self.backbone(images)))


def build(cfg, device="meta") -> SipMask:
    """The reference model with uninitialised weights on ``device``; give
    it weights with ``load_state_dict``."""
    with torch.device("meta"):
        model = SipMask(cfg)
    return model if str(device) == "meta" else model.to_empty(device=device)
