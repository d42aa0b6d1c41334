"""The inputs of a run, made from ``--seed`` on the device: the weights
(in a few large draws of a ``torch.Generator`` on the card), their bumps
and the frozen-BN calibration, and the traffic's pools of batches.

The same seed gives the same weights and batches; both the program and
the reference get them.

Traffic: the seed changes what is drawn, never how much work there is.
Instance counts and object areas are fixed sets taken from their
distributions' quantiles, which the seed only shuffles over the images;
positions, shapes, labels and pixels are drawn from it.
"""

from __future__ import annotations

import math
from collections import OrderedDict

import numpy as np
import torch
import torch.nn.functional as F

from .reference import model as ref_model


def _gen(seed: int, device, salt: int):
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1000003 + salt) % (2 ** 63 - 1))
    return g


# --------------------------------------------------------------- weights

def _init_rule(name: str, shape, cfg):
    """(kind, scale): 'normal' with std, 'uniform' with bound, or 'fill'
    with a value, for one tensor of the state dict: mmcv's inits of the
    reference (kaiming fan_out in the backbone and the rescoring convs,
    xavier-uniform in the FPN, normal 0.01 in the head, 0.001 for the SP
    coefficients and the rescoring classifier), identity frozen BN and
    GroupNorm, unit scales; then the bumps (see :func:`make_weights`)."""
    head = cfg["model"]["head"]
    leaf = name.rsplit(".", 1)[-1]
    if name.startswith("backbone.") and (".bn" in name
                                         or "downsample.1" in name):
        return "fill", 0.0 if leaf in ("bias", "running_mean") else 1.0
    if leaf == "scale" or ".gn." in name or ".norm." in name:
        return "fill", 1.0 if leaf in ("weight", "scale") else 0.0
    if "conv_offset" in name:
        if name.startswith("bbox_head.feat_align"):
            return "normal", 0.5                       # bump: real offsets
        if leaf == "weight":                           # a DCN block's
            return "normal", 0.25 / math.sqrt(shape[1] * shape[2] * shape[3])
        return "normal", 0.5
    if leaf == "bias":
        if name == "bbox_head.fcos_cls.bias":
            return "fill", None                       # set per path
        if name == "bbox_head.fcos_reg.bias":
            return "fill", 2.0
        if name == "bbox_head.mask_scoring.bias":
            return "fill", 0.2
        return "fill", 0.0
    if name.startswith("backbone.") or ".convs_scoring." in name:
        return "normal", ref_model_std(shape)
    if name.startswith("neck."):
        o, i, kh, kw = shape
        return "uniform", math.sqrt(6.0 / ((i + o) * kh * kw))
    if name == "bbox_head.mask_scoring.weight":
        return "normal", 0.1                           # bump
    if name == "bbox_head.sip_cof.weight" and not head.get("track"):
        return "normal", 0.001
    return "normal", 0.01


def ref_model_std(shape):
    o, _, kh, kw = shape
    return math.sqrt(2.0 / (o * kh * kw))


def make_weights(cfg, seed: int, device, serving: bool):
    """The state dict of the configuration's model, on ``device``, from
    ``seed``: every normal leaf from one draw and every uniform leaf from
    another, in the reference's state-dict order.

    Bumps, so that a random model detects: FeatureAlign's offset conv gets
    weights of std 0.5 (at its zero init the deformable conv is a plain
    one); each DCN block's offset conv std 0.25/sqrt(fan_in) with biases
    of std 0.5 (offsets of about half a pixel); the box regression bias 2;
    the class bias -2.5 (-1 in fast-NMS serving, whose threshold applies
    to score x centerness; elsewhere the configuration's ``weights.cls_bias``
    where it gives one); the rescoring classifier std 0.1, bias 0.2."""
    shapes = OrderedDict((k, tuple(v.shape)) for k, v in
                         ref_model.build(cfg["model"]).state_dict().items())
    rules = {k: _init_rule(k, s, cfg) for k, s in shapes.items()}
    out = OrderedDict()
    for kind, salt in (("normal", 1), ("uniform", 2)):
        names = [k for k, (r, _) in rules.items() if r == kind]
        total = sum(math.prod(shapes[k]) for k in names)
        g = _gen(seed, device, salt)
        flat = (torch.randn(total, generator=g, device=device)
                if kind == "normal" else
                torch.rand(total, generator=g, device=device) * 2 - 1)
        at = 0
        for k in names:
            n = math.prod(shapes[k])
            out[k] = flat[at:at + n].view(shapes[k]) * rules[k][1]
            at += n
    head = cfg["model"]["head"]
    fast = head["ssd_flag"] or cfg["model"]["test"]["use_fast_nms"]
    for k, (kind, v) in rules.items():
        if kind == "fill":
            if v is None:
                v = (-1.0 if (serving and fast) else
                     cfg["weights"].get("cls_bias", -2.5))
            out[k] = torch.full(shapes[k], float(v), device=device)
    return OrderedDict((k, out[k]) for k in shapes)


@torch.no_grad()
def calibrate_bn(weights, cfg, images):
    """Fit every frozen BatchNorm of the backbone in ``weights`` to the
    statistics of its conv's output on ``images`` (all of a pool's),
    block by block, as a
    pretrained backbone's BN would standardise them; each channel's
    variance gets the layer's mean variance added, so that a channel with
    almost no spread is not scaled up by orders of magnitude."""
    net = ref_model.build(cfg["model"], images.device)
    net.load_state_dict(weights)
    bb = net.backbone

    def fit(bn, raw):
        bn.weight.fill_(1.0)
        bn.bias.zero_()
        bn.running_mean.copy_(raw.mean((0, 2, 3)))
        var = raw.var((0, 2, 3), unbiased=False)
        bn.running_var.copy_(var + var.mean())
        return bn(raw)

    x = F.max_pool2d(torch.relu(fit(bb.bn1, bb.conv1(images))), 3, 2, 1)
    for s in range(4):
        for blk in getattr(bb, f"layer{s + 1}"):
            out = torch.relu(fit(blk.bn1, blk.conv1(x)))
            out = torch.relu(fit(blk.bn2, blk.conv2(out)))
            out = fit(blk.bn3, blk.conv3(out))
            if blk.downsample is not None:
                x = fit(blk.downsample[1], blk.downsample[0](x))
            x = torch.relu(out + x)
    sd = net.state_dict()
    for k in weights:
        if k.startswith("backbone.") and ("bn" in k or "downsample.1" in k):
            weights[k] = sd[k].detach().clone()
    del net


def weights_for(cfg, seed: int, device, serving: bool, calib_images):
    w = make_weights(cfg, seed, device, serving)
    if cfg["weights"]["calibrate_bn"]:
        calibrate_bn(w, cfg, calib_images)
    return w


def digest(weights) -> float:
    """One number that changes with any weight: a float64 sum of each
    tensor times its position."""
    return float(sum((i + 1) * v.double().sum() for i, v in
                     enumerate(weights.values())))


# --------------------------------------------------------------- traffic

def count_set(n: int, mean: float, cap: int):
    """``n`` instance counts from a geometric distribution on 1, 2, ...
    with ``mean`` (heavy-tailed as COCO's), capped at ``cap``: the
    distribution's quantiles at (i + 0.5) / n, then the largest ones moved
    by one until the counts sum to round(mean * n)."""
    p = 1.0 / mean
    q = (np.arange(n) + 0.5) / n
    counts = np.ceil(np.log1p(-q) / np.log1p(-p)).clip(1, cap).astype(int)
    want = int(round(mean * n))
    order = np.argsort(-counts, kind="stable")
    i = 0
    while counts.sum() != want:
        j = order[i % n]
        step = 1 if counts.sum() < want else -1
        if 1 <= counts[j] + step <= cap:
            counts[j] += step
        i += 1
    return counts


def area_set(n: int, split, bounds):
    """``n`` object areas (original-image pixels): per area class its share
    of ``n`` (largest remainders) at log-spaced quantiles of its range."""
    w = np.asarray(split, np.float64) / sum(split)
    k = np.floor(w * n).astype(int)
    for j in np.argsort(-(w * n - k))[:n - k.sum()]:
        k[j] += 1
    out = []
    for kc, (lo, hi) in zip(k, bounds):
        t = (np.arange(kc) + 0.5) / max(kc, 1)
        out.append(np.exp(np.log(lo) + t * (np.log(hi) - np.log(lo))))
    return np.concatenate(out)


def _instances(traffic, n_images, seed):
    """Per image the instance count and the areas, shuffled by the seed."""
    inst = traffic["instances"]
    rng = np.random.RandomState(seed % (2 ** 32))
    counts = count_set(n_images, inst["mean"], inst["cap"])
    rng.shuffle(counts)
    areas = area_set(int(counts.sum()), inst["area_split"],
                     inst["area_bounds"])
    rng.shuffle(areas)
    per = np.split(areas, np.cumsum(counts)[:-1])
    return counts, per


def _boxes(areas_px, h, w, g, device):
    """xyxy boxes of the given areas (image pixels) at uniform centres,
    aspect ratios log-uniform in [1/3, 3], clipped to the image."""
    a = torch.as_tensor(areas_px, dtype=torch.float32, device=device)
    n = a.shape[0]
    u = torch.rand((n, 3), generator=g, device=device)
    ratio = torch.exp((u[:, 0] * 2 - 1) * math.log(3.0))   # h / w
    bw = torch.sqrt(a / ratio).clamp(2.0, w - 1.0)
    bh = (a / bw).clamp(2.0, h - 1.0)
    cx = bw / 2 + u[:, 1] * (w - 1 - bw)
    cy = bh / 2 + u[:, 2] * (h - 1 - bh)
    return torch.stack([cx - bw / 2, cy - bh / 2, cx + bw / 2, cy + bh / 2], 1)


def _ellipses(boxes, h, w, stride):
    """(N, h/stride, w/stride) uint8: each box's inscribed ellipse, sampled
    at the centres of the stride's cells."""
    ys = (torch.arange(h // stride, device=boxes.device) + 0.5) * stride
    xs = (torch.arange(w // stride, device=boxes.device) + 0.5) * stride
    cx = (boxes[:, 0] + boxes[:, 2])[:, None, None] / 2
    cy = (boxes[:, 1] + boxes[:, 3])[:, None, None] / 2
    rx = ((boxes[:, 2] - boxes[:, 0]) / 2).clamp(min=0.5)[:, None, None]
    ry = ((boxes[:, 3] - boxes[:, 1]) / 2).clamp(min=0.5)[:, None, None]
    d = (((xs[None, None, :] - cx) / rx) ** 2
         + ((ys[None, :, None] - cy) / ry) ** 2)
    return (d <= 1.0).to(torch.uint8)


def _canvas(b, h, w, g, device, lo_scale, hi_scale):
    """(b, 3, h, w) smooth random images: coarse noise upsampled plus fine
    noise."""
    coarse = torch.randn((b, 3, max(h // 32, 1), max(w // 32, 1)),
                         generator=g, device=device) * lo_scale
    img = F.interpolate(coarse, size=(h, w), mode="bilinear",
                        align_corners=False)
    fine = torch.randn((b, 3, h, w), generator=g, device=device)
    return img + fine * hi_scale


def train_pool(traffic, cfg, seed: int, device):
    """``traffic['pool']`` training batches on ``device``: images (B, 3, H, W)
    normalised, gt_bboxes (B, G, 4), gt_labels (B, G) (0 pads), gt_masks
    (B, G, H/2, W/2) uint8, img_shapes and scale_factors."""
    b, (h, w) = traffic["batch"], traffic["size"]
    pool, gmax = traffic["pool"], cfg["data"]["max_gts"]
    counts, areas = _instances(traffic, pool * b, seed)
    # COCO's areas are of its originals; the canvas holds one at this scale
    scale = (h * w) / float(np.prod(traffic["instances"]["original_size"]))
    g = _gen(seed, device, 3)
    batches = []
    for i in range(pool):
        boxes = torch.zeros((b, gmax, 4), device=device)
        labels = torch.zeros((b, gmax), dtype=torch.int64, device=device)
        masks = torch.zeros((b, gmax, h // 2, w // 2), dtype=torch.uint8,
                            device=device)
        img = _canvas(b, h, w, g, device, 40.0, 8.0)
        for j in range(b):
            n = int(counts[i * b + j])
            bx = _boxes(areas[i * b + j] * scale, h, w, g, device)
            boxes[j, :n] = bx
            labels[j, :n] = torch.randint(
                1, cfg["model"]["head"]["num_classes"] + 1, (n,),
                generator=g, device=device)
            masks[j, :n] = _ellipses(bx, h, w, 2)
            colour = torch.randn((n, 3), generator=g, device=device) * 50
            full = masks[j, :n].repeat_interleave(2, 1).repeat_interleave(2, 2)
            img[j] += torch.einsum("nhw,nc->chw", full.float(), colour)
        batches.append(dict(
            images=img.contiguous(), gt_bboxes=boxes, gt_labels=labels,
            gt_masks=masks,
            img_shapes=torch.tensor([[h, w]] * b, dtype=torch.float32,
                                    device=device),
            scale_factors=torch.ones((b, 4), device=device)))
    return batches


def serve_originals(traffic, seed: int, device):
    """``traffic['pool']`` x ``traffic['batch']`` BGR uint8 images (numpy,
    H x W x 3) at the traffic's original sizes, each batch holding the
    whole size list in an order drawn from the seed: smooth noise with
    filled ellipses of the traffic's instance counts and areas."""
    b, pool = traffic["batch"], traffic["pool"]
    sizes = [tuple(s) for s in traffic["original_sizes"]]
    if len(sizes) != b:
        raise ValueError(f"{len(sizes)} original sizes for batches of {b}")
    counts, areas = _instances(traffic, pool * b, seed)
    rng = np.random.RandomState((seed + 7) % (2 ** 32))
    g = _gen(seed, device, 4)
    order = np.concatenate([rng.permutation(b) for _ in range(pool)])
    out = []
    for i in range(pool * b):
        h, w = sizes[order[i]]
        img = _canvas(1, h, w, g, device, 30.0, 6.0)[0] + 110.0
        n = int(counts[i])
        bx = _boxes(areas[i], h, w, g, device)
        m = _ellipses(bx, h, w, 1).float()
        colour = torch.rand((n, 3), generator=g, device=device) * 255 - 110
        img = img + torch.einsum("nhw,nc->chw", m, colour) * (
            1.0 / m.sum(0).clamp(min=1.0))
        out.append(img.clamp(0, 255).to(torch.uint8).permute(1, 2, 0)
                   .cpu().numpy())
    return [out[i * b:(i + 1) * b] for i in range(pool)]
