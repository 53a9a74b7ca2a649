"""repro_torch — the HPL performance-prediction simulator in PyTorch.

A port of ``repro`` (the JAX package beside it, which stays the
reference) to PyTorch and CUDA.  The layout mirrors ``repro``: every
module's counterpart sits under the same path.  The package imports
``torch`` and never ``jax``, and nothing of ``repro``.

Every public entry point takes ``device=`` and defaults to ``"cuda"``;
without a card it raises ``RuntimeError`` unless the caller passes
``device="cpu"``::

    from repro_torch.platforms import get_platform
    from repro_torch.workloads import get_workload

    get_workload("hpl").predict(get_platform("frontera"))   # on the GPU
    get_workload("hpl").predict(get_platform("bdw-local"), device="cpu")
"""
