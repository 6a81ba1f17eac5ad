"""PyTorch / CUDA port of the tpushare workload payloads.

``tpushare_torch.workloads`` mirrors ``tpushare.workloads`` module for
module: the transformer, the KV-cache decode loop and its ring cache, the
slot and block-paged serving engines, training, and the payload CLIs. Plain tensor code is
PyTorch; every attention kernel the reference runs as Pallas on a TPU is
a CUDA kernel written for Hopper (``workloads/kernels/``), with a plain
PyTorch twin beside it for CPU tensors.

The package imports ``torch`` and never ``jax`` nor any ``tpushare``
module: what it needs from the reference (constants, the page allocator)
it keeps as its own copy.
"""
