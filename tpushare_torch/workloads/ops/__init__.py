"""Attention operators of the port: CUDA kernel wrappers, their plain
PyTorch twins, and the kernel registry that picks between them."""
