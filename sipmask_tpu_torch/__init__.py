"""sipmask_tpu_torch: the PyTorch + CUDA port of sipmask_tpu for NVIDIA
Hopper GPUs.

It mirrors the JAX package's layout (``apis``, ``core``, ``models``, ``ops``,
``utils``) and reuses its dependency-free ``sipmask_tpu.config``; it never
imports JAX, flax or cv2. The kernels the JAX package wrote in Pallas for the
TPU are CUDA C++ sources under ``csrc/``, built with nvcc at first use; each
has a plain PyTorch version beside it, which runs on CPU tensors.
"""

__version__ = "0.1.0"
