"""PyTorch port of ``repro`` for NVIDIA Hopper (H100).

Mirrors the JAX package's module layout: ``api``/``core``/``runtime`` are the
framework-neutral middleware (kept as this package's own copy), ``configs``
and ``models`` hold the model zoo on torch tensors, ``kernels`` the
hand-written CUDA kernels with their plain PyTorch versions, and ``launch``
the entry points.  They run on ``cuda`` unless the caller passes
``device="cpu"``.
"""
