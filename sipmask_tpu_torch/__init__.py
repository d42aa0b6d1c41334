"""sipmask_tpu_torch: the PyTorch + CUDA port of sipmask_tpu for NVIDIA
Hopper GPUs.

It mirrors the JAX package's layout (``apis``, ``core``, ``models``, ``ops``,
``utils``) and keeps its own copy of the presets, ``config.py``, held equal to
the JAX package's by ``tests/test_torch_ops.py``'s
``test_port_presets_equal_the_jax_packages``; it never imports JAX, flax, cv2
or any module of ``sipmask_tpu``. The kernels the JAX package wrote in Pallas
for the TPU are CUDA C++ sources under ``csrc/``, built with nvcc at first
use; each has a plain PyTorch version beside it, which runs on CPU tensors.
"""

__version__ = "0.1.0"
