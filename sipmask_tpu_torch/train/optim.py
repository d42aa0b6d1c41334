"""Optimizer and LR schedule, the port of ``sipmask_tpu/train/optim.py``.

SGD with momentum 0.9 and weight decay 1e-4, torch-SGD semantics
(v = m*v + (g + wd*p); p -= lr*v), and mmcv's paramwise options: parameters
named ``*.bias`` take ``bias_lr_mult`` x the lr and ``bias_decay_mult`` x the
decay. Frozen parameters (``requires_grad`` False: a ResNet's stem and first
``frozen_stages`` stages; HRNet's stage 1 but not its stem, as the JAX
package's labels have it) are in no group. The schedule is mmcv's
warmup ('constant' or 'linear') then x0.1 at each epoch milestone; the
caller sets every group's lr from it before each step
(:func:`set_lr`). With ``grad_clip`` set, :func:`clip_gradients` scales the
gradients by one global factor before the update.
"""

from __future__ import annotations

import torch


def lr_schedule(cfg, steps_per_epoch: int):
    """The learning rate as a function of the global step (0-based).

    cfg: an ``OptimConfig`` (``sipmask_tpu_torch.config``)."""
    milestones = [e * steps_per_epoch for e in cfg.lr_steps]

    def sched(step: int) -> float:
        base = cfg.lr * 0.1 ** sum(step >= m for m in milestones)
        if step >= cfg.warmup_iters:
            return base
        if cfg.warmup == "constant":
            return cfg.lr * cfg.warmup_ratio
        if cfg.warmup == "linear":
            k = (1 - step / cfg.warmup_iters) * (1 - cfg.warmup_ratio)
            return cfg.lr * (1 - k)
        return base

    return sched


def make_optimizer(cfg, model) -> torch.optim.SGD:
    """``torch.optim.SGD`` over the trainable parameters of ``model`` in two
    groups, 'default' and 'bias', each with its ``lr_mult``."""
    groups = {"default": [], "bias": []}
    for name, p in model.named_parameters():
        if p.requires_grad:
            groups["bias" if name.endswith(".bias") else "default"].append(p)
    mults = {"default": (1.0, 1.0),
             "bias": (cfg.bias_lr_mult, cfg.bias_decay_mult)}
    return torch.optim.SGD(
        [dict(params=ps, name=n, lr_mult=mults[n][0],
              lr=cfg.lr * mults[n][0],
              weight_decay=cfg.weight_decay * mults[n][1])
         for n, ps in groups.items() if ps],
        lr=cfg.lr, momentum=cfg.momentum)


def set_lr(optimizer: torch.optim.Optimizer, lr: float) -> None:
    """Give every group ``lr`` times its ``lr_mult``."""
    for group in optimizer.param_groups:
        group["lr"] = lr * group["lr_mult"]


def clip_gradients(optimizer: torch.optim.Optimizer, max_norm: float) -> None:
    """Scale every gradient of ``optimizer``'s parameters by
    min(1, max_norm / (norm + 1e-6)), with norm their global L2 norm in f32
    (the JAX package's ``grad_clip``). Reads nothing back to the host."""
    grads = [p.grad for g in optimizer.param_groups for p in g["params"]
             if p.grad is not None]
    norm = torch.stack([g.float().square().sum() for g in grads]).sum().sqrt()
    scale = torch.clamp(max_norm / (norm + 1e-6), max=1.0)
    for g in grads:
        g.mul_(scale)
