"""Model FLOPs of one step or one batch, counted over the plain reference
on the ``meta`` device at the cell's shapes: ``FlopCounterMode`` counts
the convolutions and matrix products (two FLOPs a multiply-add), forward
and, for training, backward. The deformable taps' bilinear weights and
all elementwise work are not counted, so a share of the peak made from
this count is a lower bound.

The same pass records the shapes of the calls that the program hands to
its kernels K1-K6 (``reference.ops.CALLS``), which ``roofline.py``
prices.
"""

from __future__ import annotations

import torch
from torch.utils.flop_counter import FlopCounterMode

from .reference import decode as ref_decode
from .reference import loss as ref_loss
from .reference import model as ref_model
from .reference import ops


def _meta_batch(cfg, traffic):
    b, (h, w) = traffic["batch"], traffic["size"]
    g = cfg["data"]["max_gts"]
    m = dict(device="meta")
    return dict(images=torch.empty((b, 3, h, w), **m),
                gt_bboxes=torch.empty((b, g, 4), **m),
                gt_labels=torch.empty((b, g), dtype=torch.int64, **m),
                gt_masks=torch.empty((b, g, h // 2, w // 2), dtype=torch.uint8,
                                     **m),
                img_shapes=torch.empty((b, 2), **m),
                scale_factors=torch.empty((b, 4), **m))


def counted(fn) -> int:
    """FLOPs of ``fn()``'s convolutions and matrix products."""
    with FlopCounterMode(display=False) as fc:
        fn()
    return fc.get_total_flops()


def count(cfg, traffic, training: bool):
    """(FLOPs of one step (training) or one served batch, the kernel-shaped
    calls [(name, shapes), ...] of its forward)."""
    net = ref_model.build(cfg["model"])
    head = cfg["model"]["head"]
    batch = _meta_batch(cfg, traffic)
    rescore = net.bbox_head.rescore if head["rescoring"] else None

    def step():
        out = net(batch["images"])
        sum(ref_loss.losses(out, batch, head, cfg["train"]["max_pos"],
                            rescore).values()).backward()

    @torch.no_grad()
    def serve():
        out = net(batch["images"])
        ref_decode.decode(out, batch["img_shapes"], batch["scale_factors"],
                          head, cfg["model"]["test"], rescore)

    calls = []
    token = ops.CALLS.set(calls)
    try:
        return counted(step if training else serve), calls
    finally:
        ops.CALLS.reset(token)
