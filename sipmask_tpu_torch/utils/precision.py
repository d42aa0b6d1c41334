"""The port's f32 on CUDA: the JAX package's f32 graph and the reference
compute convolutions and matrix products in full f32, where PyTorch's
default lets cuDNN take TF32 (10-bit mantissa) products."""

from __future__ import annotations

import torch


def no_tf32() -> None:
    """Turn TF32 off for cuDNN's convolutions and for CUDA matrix products
    (the flags act on CUDA only). Every CLI of the port calls it first."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
