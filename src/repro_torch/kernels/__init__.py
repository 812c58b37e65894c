"""Hand-written Hopper kernels for the framework's compute hot-spots.

Each kernel mirrors the JAX package's layout (``repro/kernels/<name>/``):

* ``csrc/`` -- the CUDA C++ source, built for ``sm_90a`` with ``nvcc`` at
  first use (``kernel.py`` builds it through ``_nvcc.py`` and binds it
  through ``ctypes``);
* ``ops.py`` -- the public wrapper with the JAX wrapper's contract: CPU
  tensors take the plain version, CUDA tensors launch the kernel or raise;
* ``ref.py`` -- the plain PyTorch version of the JAX oracle.

Ported: flash_attention, ssd_scan and fingerprint -- every kernel of the
JAX package.
"""
