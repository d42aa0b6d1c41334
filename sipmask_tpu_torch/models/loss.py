"""The part of ``sipmask_tpu/models/loss.py`` that inference uses."""

from __future__ import annotations

import torch


def _flat(levels):
    """NCHW levels -> (B, sum h*w, C), each level flattened in (h, w) order
    as the JAX package's NHWC reshape does, so point indices line up."""
    return torch.cat([x.permute(0, 2, 3, 1).reshape(x.shape[0], -1,
                                                    x.shape[1])
                      for x in levels], 1)


def flatten_outputs(outputs):
    """Head output dict -> level-major flat (cls (B, P, C), box (B, P, 4),
    ctr (B, P), cof (B, P, 4*nb))."""
    return (_flat(outputs["cls_scores"]), _flat(outputs["bbox_preds"]),
            _flat(outputs["centernesses"])[..., 0],
            _flat(outputs["cof_preds"]))
