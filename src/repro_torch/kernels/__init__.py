"""Hand-written Hopper kernels for the framework's compute hot-spots.

Each kernel mirrors the JAX package's layout (``repro/kernels/<name>/``):

* ``csrc/`` -- the CUDA C++ source, built for ``sm_90a`` with ``nvcc`` at
  first use (``kernel.py`` builds and binds it through ``ctypes``);
* ``ops.py`` -- the public wrapper with the JAX wrapper's contract: CPU
  tensors take the plain version, CUDA tensors launch the kernel or raise;
* ``ref.py`` -- the plain PyTorch version of the JAX oracle.

Ported so far: ``flash_attention``.  ``ssd_scan`` and ``fingerprint`` wait
for later slices.
"""
