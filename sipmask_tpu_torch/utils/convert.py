"""The weight bridge between the JAX package and the port, and the port's
initialisation.

``params_from_jax`` is the counterpart of
``sipmask_tpu/utils/torch_convert.py:flax_to_torch_names`` without flax:
the port's modules carry the reference's mmdet ``state_dict`` names, so the
JAX trees map onto them with the same rules (a DCN block's
``layer{s}_{b}/conv2/{kernel,conv_offset}`` becomes
``layer{s}.{b}.conv2.{weight,conv_offset}``, SipMask-VIS's
``head/track_convs_{i}/(conv|gn)`` becomes ``bbox_head.track_convs.{i}``,
SipMask++'s ``rescoring/*`` lands on the head as
``convs_scoring.{i}.conv`` and ``mask_scoring``, and HRNet's and HRFPN's
names become mmdet's, the ones ``torch_convert._hrnet_backbone`` and its
HRFPN section read: ``stem_conv{1,2}`` -> ``conv{1,2}``,
``t{s}_conv{i}`` -> ``transition{s-1}.{i}.0``, ``t{s}_new{i}`` ->
``transition{s-1}.{i}.0.0``, ``stage{s}_m{m}/branch{i}_block{b}`` ->
``stage{s}.{m}.branches.{i}.{b}``, ``fuse/up_{j}_{i}_conv`` ->
``fuse_layers.{i}.{j}.0``, ``fuse/down_{j}_{i}_{k}_conv`` ->
``fuse_layers.{i}.{j}.{k}.0`` (their BNs ``.1``), ``neck/reduction`` ->
``neck.reduction_conv.conv``, ``neck/fpn_conv{i}`` ->
``neck.fpn_convs.{i}.conv``). The trees of the modules outside the presets
map onto mmdet's names too, alone or under a parent: SSD-VGG's
``conv{s}_{c}``, ``fc6`` and ``fc7`` -> ``features.{i}`` (the VGG
Sequential's indices), ``extra{i}`` -> ``extra.{i}``, ``l2norm`` ->
``l2_norm``; BFP's ``refine`` -> ``refine.conv`` and its NonLocal2D's
``refine/{g,theta,phi,conv_out}`` -> ``refine.*.conv``; the deformable
RoI-pooling packs' ``Dense_{k}`` -> ``offset_fc.{2k}``, then (k >= 3, the
default three offset FCs) ``mask_fc.{2(k-3)}``.
"""

from __future__ import annotations

import math
import re
from collections import OrderedDict

import numpy as np
import torch
from torch import nn

from ..models.bfp import BFP, NonLocal2D
from ..models.layers import FrozenBatchNorm2d, GroupNorm32, Scale
from ..models.resnet import DeformConvPack
from ..models.ssd_vgg import SSDVGG
from ..ops.roi import DeformRoIPoolingPack, init_fc_stack

# SSD-VGG: the index in ``features`` of each stage's first conv
_VGG_STAGE_START = (0, 5, 10, 17, 24)
_VGG_FC = {"6": 31, "7": 33}
_OFFSET_FCS = 3   # the packs' default depth of the offset stack


def _flatten(tree, prefix=()):
    for k, v in tree.items():
        if hasattr(v, "items"):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _jax_path_to_torch(name: str) -> str:
    """``torch_convert._flax_path_to_torch``'s rules."""
    n = name
    n = re.sub(r"^backbone/layer(\d)_(\d+)/", r"backbone.layer\1.\2.", n)
    n = re.sub(r"^backbone/stem_(conv|bn)(\d)/", r"backbone.\1\2.", n)
    n = re.sub(r"^backbone/t(\d)_(conv|bn)(\d)/",
               lambda m: f"backbone.transition{int(m[1]) - 1}.{m[3]}."
               f"{0 if m[2] == 'conv' else 1}.", n)
    n = re.sub(r"^backbone/t(\d)_new(bn)?(\d)/",
               lambda m: f"backbone.transition{int(m[1]) - 1}.{m[3]}.0."
               f"{1 if m[2] else 0}.", n)
    n = re.sub(r"^backbone/stage(\d)_m(\d+)/branch(\d)_block(\d+)/",
               r"backbone.stage\1.\2.branches.\3.\4.", n)
    n = re.sub(r"^backbone/stage(\d)_m(\d+)/fuse/up_(\d)_(\d)_(conv|bn)/",
               lambda m: f"backbone.stage{m[1]}.{m[2]}.fuse_layers.{m[4]}."
               f"{m[3]}.{0 if m[5] == 'conv' else 1}.", n)
    n = re.sub(r"^backbone/stage(\d)_m(\d+)/fuse/down_(\d)_(\d)_(\d)_"
               r"(conv|bn)/",
               lambda m: f"backbone.stage{m[1]}.{m[2]}.fuse_layers.{m[4]}."
               f"{m[3]}.{m[5]}.{0 if m[6] == 'conv' else 1}.", n)
    n = n.replace("neck/reduction/", "neck.reduction_conv.conv.")
    n = re.sub(r"^neck/fpn_conv(\d)/", r"neck.fpn_convs.\1.conv.", n)
    n = n.replace("downsample_conv/kernel", "downsample.0.weight")
    n = n.replace("downsample_bn/", "downsample.1/")
    n = re.sub(r"^neck/lateral_(\d)/", r"neck.lateral_convs.\1.conv.", n)
    n = re.sub(r"^neck/fpn_(\d)/", r"neck.fpn_convs.\1.conv.", n)
    n = re.sub(r"^head/(cls|reg|track)_convs_(\d)/(conv|gn)/",
               r"bbox_head.\1_convs.\2.\3.", n)
    n = re.sub(r"^head/scale_(\d)/scale", r"bbox_head.scales.\1.scale", n)
    n = n.replace("head/feat_align/conv_offset/",
                  "bbox_head.feat_align.conv_offset.")
    n = n.replace("head/feat_align/norm/", "bbox_head.feat_align.norm.")
    n = n.replace("head/feat_align/kernel",
                  "bbox_head.feat_align.conv_adaption.weight")
    n = re.sub(r"^rescoring/convs_scoring_(\d)/",
               r"bbox_head.convs_scoring.\1.conv.", n)
    n = n.replace("rescoring/mask_scoring/", "bbox_head.mask_scoring.")
    n = re.sub(r"(^|/)conv(\d)_(\d)/", lambda m: f"{m[1]}features."
               f"{_VGG_STAGE_START[int(m[2]) - 1] + 2 * (int(m[3]) - 1)}.", n)
    n = re.sub(r"(^|/)fc([67])/", lambda m: f"{m[1]}features.{_VGG_FC[m[2]]}.",
               n)
    n = re.sub(r"(^|/)extra(\d+)/", r"\1extra.\2.", n)
    n = re.sub(r"(^|/)l2norm/", r"\1l2_norm.", n)
    n = re.sub(r"(^|/)refine/(g|theta|phi|conv_out)/", r"\1refine.\2.conv.",
               n)
    n = re.sub(r"(^|/)refine/(kernel|bias)$", r"\1refine.conv.\2", n)
    n = re.sub(r"(^|/)Dense_(\d+)/",
               lambda m: m[1] + (f"offset_fc.{2 * int(m[2])}."
                                 if int(m[2]) < _OFFSET_FCS else
                                 f"mask_fc.{2 * (int(m[2]) - _OFFSET_FCS)}."),
               n)
    n = re.sub(r"^head/", "bbox_head.", n)
    n = re.sub(r"^backbone/", "backbone.", n)
    n = n.replace("/", ".").replace(".kernel", ".weight")
    n = n.replace("gn.scale", "gn.weight").replace("norm.scale",
                                                   "norm.weight")
    return (n.replace(".gamma", ".weight").replace(".beta", ".bias")
            .replace(".mean", ".running_mean").replace(".var", ".running_var"))


def params_from_jax(params, constants,
                    dtype=np.float32) -> "OrderedDict[str, torch.Tensor]":
    """JAX ``params`` and frozen-BN ``constants`` trees (nested dicts of
    arrays) -> a ``state_dict`` of the port's module (``SipMask``, or one of
    the modules named in the module note) in ``dtype``. Conv kernels go
    from HWIO to OIHW, Dense kernels from (in, out) to Linear's (out, in).
    A pack's first FC of each stack reads the first pooling flattened: in
    (P, P, D) order in JAX (NHWC), in mmdet's (D, P, P) order in the port;
    its input columns are permuted to match."""
    sd = OrderedDict()
    for tree in (params, constants):
        for path, v in _flatten(tree):
            v = np.asarray(v, dtype=dtype)
            if path[-1] == "kernel" and v.ndim == 4:
                v = v.transpose(3, 2, 0, 1)
            elif path[-1] == "kernel" and v.ndim == 2:
                v = v.T
            sd[_jax_path_to_torch("/".join(path))] = torch.from_numpy(
                v.copy())
    for k in [k for k in sd if k.endswith(("offset_fc.0.weight",
                                          "mask_fc.0.weight"))]:
        parent = re.sub(r"(offset|mask)_fc\.0\.weight$", "", k)
        last = f"{parent}offset_fc.{2 * _OFFSET_FCS - 2}.bias"
        p = math.isqrt(sd[last].numel() // 2)           # 2 P^2 offsets
        w = sd[k]
        sd[k] = (w.view(w.shape[0], p, p, -1).permute(0, 3, 1, 2)
                 .reshape(w.shape[0], -1).contiguous())
    return sd


def grads_from_jax(grads,
                   dtype=np.float32) -> "OrderedDict[str, torch.Tensor]":
    """A JAX gradient tree (shaped like ``params``) -> {port parameter
    name: gradient} in ``dtype``, by the same names and layouts as the
    weights (conv kernels HWIO -> OIHW)."""
    return params_from_jax(grads, {}, dtype)


def _kaiming(w, gen: torch.Generator):
    """kaiming normal, fan_out, as mmcv's kaiming_init."""
    o, _, kh, kw = w.shape
    w.normal_(0.0, math.sqrt(2.0 / (o * kh * kw)), generator=gen)


def _xavier_uniform(conv: nn.Conv2d, gen: torch.Generator):
    o, i, kh, kw = conv.weight.shape
    bound = math.sqrt(6.0 / ((i + o) * kh * kw))
    conv.weight.uniform_(-bound, bound, generator=gen)


def _conv_init(name: str, conv: nn.Conv2d, gen: torch.Generator,
               track: bool = False, hrfpn: bool = False):
    """The reference's init per conv (``layers.conv_init`` specs); ``track``:
    the SipMask-VIS head, whose ``sip_cof`` draws with std 0.01; ``hrfpn``:
    an HRFPN neck, kaiming like the backbone."""
    w = conv.weight
    o, i, kh, kw = w.shape
    with torch.no_grad():
        if name.endswith("conv_offset"):   # FeatureAlign's and DCN's
            w.zero_()
        elif (name.startswith("backbone.") or ".convs_scoring." in name
              or hrfpn and name.startswith("neck.")):
            _kaiming(w, gen)
        elif name.startswith("neck."):
            _xavier_uniform(conv, gen)
        else:
            std = {"sip_cof": 0.01 if track else 0.001,
                   "mask_scoring": 0.001}.get(name.rsplit(".", 1)[-1], 0.01)
            w.normal_(0.0, std, generator=gen)
        if conv.bias is not None:
            conv.bias.zero_()
            if name.endswith("fcos_cls"):   # focal prior, p = 0.01
                conv.bias.fill_(-math.log((1 - 0.01) / 0.01))


def _init_library_module(m: nn.Module, gen: torch.Generator):
    """The JAX package's init of the modules outside the presets, zero
    biases throughout: SSD-VGG kaiming fan_out for VGG, xavier-uniform for
    the extras and a constant 20 for L2Norm; BFP xavier-uniform for the
    refine conv; NonLocal2D normal(0.01) for g, theta and phi and a zero
    conv_out; the packs' FC stacks (``ops.roi.init_fc_stack``)."""
    if isinstance(m, DeformRoIPoolingPack):
        for stack in (getattr(m, "offset_fc", None),
                      getattr(m, "mask_fc", None)):
            if stack is not None:
                init_fc_stack(stack, gen)
        return
    for name, conv in m.named_modules():
        if not isinstance(conv, nn.Conv2d):
            continue
        role = name.split(".")[-2]      # NonLocal2D's "g", "theta", ...
        if isinstance(m, SSDVGG) and role == "features":
            _kaiming(conv.weight, gen)
        elif role in ("g", "theta", "phi"):
            conv.weight.normal_(0.0, 0.01, generator=gen)
        elif role == "conv_out":
            conv.weight.zero_()
        else:                 # SSD-VGG's extras, BFP's refine conv
            _xavier_uniform(conv, gen)
        conv.bias.zero_()
    if isinstance(m, SSDVGG):
        m.l2_norm.weight.fill_(20.0)


def init_weights(model: nn.Module, generator: torch.Generator) -> None:
    """Random weights with the reference's schemes: kaiming fan_out for the
    backbone (DCN weights included), an HRFPN neck and the rescoring convs,
    xavier-uniform for the FPN, normal(0.01) for the head, SipMask-VIS's track branch
    included (0.001 for ``mask_scoring``, and for ``sip_cof`` unless the
    head tracks), the focal prior bias on ``fcos_cls``, zero
    ``conv_offset`` weights and biases, identity frozen BN and GroupNorm,
    unit scales; SSD-VGG, BFP, NonLocal2D and the deformable RoI-pooling
    packs, wherever they sit, as :func:`_init_library_module` says.
    Draws from ``generator`` in module order, so a seed fixes the weights
    on any device."""
    names = [n for n, _ in model.named_modules()]
    track = any(n.endswith("sipmask_track") for n in names)
    hrfpn = "neck.reduction_conv" in names
    library = (SSDVGG, BFP, NonLocal2D, DeformRoIPoolingPack)
    done = []             # prefixes of the library modules initialised
    with torch.no_grad():
        for name, m in model.named_modules():
            if any(name.startswith(p) for p in done):
                continue
            if isinstance(m, library):
                _init_library_module(m, generator)
                done.append(f"{name}." if name else "")
            elif isinstance(m, nn.Conv2d):
                _conv_init(name, m, generator, track, hrfpn)
            elif isinstance(m, DeformConvPack):
                _kaiming(m.weight, generator)
            elif isinstance(m, GroupNorm32):
                m.weight.fill_(1.0)
                m.bias.zero_()
            elif isinstance(m, Scale):
                m.scale.fill_(1.0)
            elif isinstance(m, FrozenBatchNorm2d):
                m.weight.fill_(1.0)
                m.bias.zero_()
                m.running_mean.zero_()
                m.running_var.fill_(1.0)
