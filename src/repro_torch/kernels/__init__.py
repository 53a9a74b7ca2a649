"""Hand-written GPU kernels of the port, one package per TPU kernel of
``repro.kernels``.  Each has a plain torch version beside it (the CPU
path and the kernel's yardstick of correctness) and a launch counter.
CUDA sources live in ``repro_torch/csrc/`` and are built by ``_build``
at first use."""
