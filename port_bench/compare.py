"""The numbers that decide ``correct``: gaps between what the timed path
produced and what the plain reference computes from the same inputs."""

from __future__ import annotations

import statistics

import torch


def loss_gap(prog, ref):
    """The worst relative gap of a step's summed loss over the steps."""
    return max(abs(p - r) / max(abs(r), 1e-12) for p, r in zip(prog, ref))


def median_gap(prog, ref, leaves):
    """The median over the leaves of the gap :func:`norm_gap` takes the
    worst of."""
    med = statistics.median(ref[n] for n in leaves)
    return statistics.median(abs(prog[n] - ref[n]) / max(ref[n], med, 1e-30)
                             for n in leaves)


def counted(ref_grad_norms):
    """The leaves compared: those whose gradient in the reference is at
    least a thousandth of the median leaf's. Below that a leaf's gradient
    is nought to rounding (a bias under a softmax or a normalisation) and
    its update is round-off."""
    med = statistics.median(ref_grad_norms.values())
    return [n for n, v in ref_grad_norms.items() if v >= 1e-3 * med]


def norm_gap(prog, ref, leaves):
    """(worst gap, its leaf): per leaf |norm_prog - norm_ref| over the
    larger of the leaf's reference norm and the median leaf's."""
    med = statistics.median(ref[n] for n in leaves)
    return max(((abs(prog[n] - ref[n]) / max(ref[n], med, 1e-30), n)
                for n in leaves), key=lambda t: t[0])


def norms(tensors):
    """{name: L2 norm} in one read from the device."""
    names = list(tensors)
    if not names:
        return {}
    vals = torch.stack([tensors[n].detach().double().norm()
                        for n in names]).tolist()
    return dict(zip(names, vals))


def head_gap(prog, ref):
    """(worst gap, its output): per head output tensor (each level of
    each list, and the basis masks) max |prog - ref| / max |ref|."""
    worst = (0.0, "")
    for key, r in ref.items():
        p = prog[key]
        pairs = zip(p, r) if isinstance(r, (list, tuple)) else [(p, r)]
        for lvl, (a, b) in enumerate(pairs):
            a, b = a.float(), b.float()
            g = float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))
            if g > worst[0] or not g == g:
                worst = (g if g == g else float("inf"), f"{key}[{lvl}]")
    return worst


def decode_gap(prog, ref):
    """(worst gap, what): the detections must match one for one (valid and
    labels exactly; otherwise the gap is 1); then the largest of the boxes'
    gap relative to the largest box coordinate, and the absolute gaps of
    the scores, mask probabilities and mask scores."""
    if not torch.equal(prog["valid"].bool(), ref["valid"].bool()):
        return 1.0, "valid detections differ"
    v = ref["valid"].bool()
    if not torch.equal(prog["labels"][v].long(), ref["labels"][v].long()):
        return 1.0, "labels differ"
    if not v.any():
        return 1.0, "no detection"
    gaps = {
        "boxes": float((prog["boxes"][v] - ref["boxes"][v]).abs().max()
                       / ref["boxes"][v].abs().max().clamp(min=1.0)),
        "scores": float((prog["scores"][v] - ref["scores"][v]).abs().max()),
        "masks": float((prog["masks"][v].float() - ref["masks"][v]).abs()
                       .max()),
    }
    if "mask_scores" in ref:
        gaps["mask_scores"] = float(
            (prog["mask_scores"][v] - ref["mask_scores"][v]).abs().max())
    k = max(gaps, key=lambda n: gaps[n])
    return gaps[k], k
