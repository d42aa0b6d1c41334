"""The reference's training steps: forward, the summed losses, backward,
and SGD with momentum (v = m v + g + wd p; p -= lr v), in which the
parameters named ``*.bias`` take ``bias_lr_mult`` x the rate and
``bias_decay_mult`` x the decay, after mmcv's warm-up ('constant' or
'linear'). ``optim`` is the ``train.optim`` object of a configuration
file."""

from __future__ import annotations

import torch

from .loss import losses


def lr_at(optim, step: int) -> float:
    if step >= optim["warmup_iters"]:
        return optim["lr"]
    ratio = optim["warmup_ratio"]
    if optim["warmup"] == "constant":
        return optim["lr"] * ratio
    return optim["lr"] * (1 - (1 - step / optim["warmup_iters"]) * (1 - ratio))


def leaf_rates(model, optim):
    """{name: (lr multiplier, weight decay)} of every trained leaf."""
    return {n: ((optim["bias_lr_mult"], optim["weight_decay"]
                 * optim["bias_decay_mult"]) if n.endswith(".bias")
                else (1.0, optim["weight_decay"]))
            for n, p in model.named_parameters() if p.requires_grad}


def run_steps(model, batches, cfg, first_step: int = 0):
    """Train ``model`` in place on ``batches`` in turn, one step each, from
    the global step ``first_step``. Returns (the summed loss of each step
    as a float, {leaf: its first step's gradient}, {leaf: its change over
    all the steps}, {loss: its value at the first step})."""
    optim = cfg["train"]["optim"]
    head = cfg["model"]["head"]
    rates = leaf_rates(model, optim)
    params = dict(model.named_parameters())
    start = {n: params[n].detach().clone() for n in rates}
    bufs, first, totals, parts = {}, None, [], None
    rescore = model.bbox_head.rescore if head["rescoring"] else None
    for i, batch in enumerate(batches):
        model.zero_grad(set_to_none=True)
        out = model(batch["images"])
        ls = losses(out, batch, head, cfg["train"]["max_pos"], rescore)
        total = sum(ls.values())
        total.backward()
        totals.append(float(total.detach()))
        if parts is None:
            parts = {k: float(v.detach()) for k, v in ls.items()}
        del out, ls, total
        if first is None:
            first = {n: (torch.zeros_like(params[n]) if params[n].grad is None
                         else params[n].grad.detach().clone()) for n in rates}
        lr = lr_at(optim, first_step + i)
        with torch.no_grad():
            for n, (mult, wd) in rates.items():
                p = params[n]
                if p.grad is None:     # SGD leaves a leaf without one
                    continue
                d = p.grad + wd * p
                bufs[n] = (d if n not in bufs
                           else optim["momentum"] * bufs[n] + d)
                p -= lr * mult * bufs[n]
        model.zero_grad(set_to_none=True)
    change = {n: params[n].detach() - start[n] for n in rates}
    return totals, first, change, parts
