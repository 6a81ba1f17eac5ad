"""The device side of the port: the CUDA backend the unchanged daemon
advertises (``backend``, ``device``, ``native``, ``kernel_stats``: NVML
over ``ctypes``, importing neither ``torch`` nor ``jax``) and the
workload-plane test doubles (``fake``)."""
