"""Ops of the port: CUDA kernel wrappers with their plain versions,
and plain PyTorch ops."""
