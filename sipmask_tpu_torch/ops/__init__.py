"""Ops of the port: CUDA kernel wrappers with their plain versions,
and plain PyTorch ops; the NMS family (hard, soft, multiclass and fast
NMS) is exported here, as the JAX package's ``ops`` exports it."""

from .nms import fast_nms, hard_nms, multiclass_nms_idx, soft_nms

__all__ = ["fast_nms", "hard_nms", "multiclass_nms_idx", "soft_nms"]
