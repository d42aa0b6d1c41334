"""Ops of the port: CUDA kernel wrappers with their plain versions,
and plain PyTorch ops; the NMS family (hard, soft, multiclass and fast
NMS) and the RoI ops are exported here, as the JAX package's ``ops``
exports them."""

from .nms import fast_nms, hard_nms, multiclass_nms_idx, soft_nms
from .roi import (carafe, deform_roi_pool, grid_sample, masked_conv2d,
                  roi_align, roi_pool)

__all__ = ["carafe", "deform_roi_pool", "fast_nms", "grid_sample",
           "hard_nms", "masked_conv2d", "multiclass_nms_idx", "roi_align",
           "roi_pool", "soft_nms"]
