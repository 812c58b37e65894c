"""Build a kernel's CUDA source into a shared library with a plain C interface.

Each kernel's ``kernel.py`` compiles its ``csrc/*.cu`` with ``nvcc`` for
``sm_90a`` at first use and loads the result with ``ctypes``.  The library
lands in the kernel's ``build/`` directory, named by a hash of the source and
the flags, so an edited source is rebuilt and a built one is reused.  A
failed build raises: there is no fallback for CUDA tensors.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
from pathlib import Path

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def nvcc(what: str) -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(f"nvcc not found: the {what} kernel is built from csrc/ at first use")


def refuse_stand_ins(what: str, *tensors) -> None:
    """A wrapper's first check: a ``DTensor``, or a fake tensor off the CPU,
    never reaches the plain version or the launcher.  (A meta tensor is
    refused by each launcher's own device check, before the build.)"""
    from torch._subclasses.fake_tensor import FakeTensor
    from torch.distributed.tensor import DTensor

    for t in tensors:
        if isinstance(t, DTensor):
            raise TypeError(f"{what}: a DTensor input; the kernel runs on one card's "
                            "tensors (call it on local shards, or run the model with "
                            "attention_impl='reference')")
        if isinstance(t, FakeTensor) and t.device.type != "cpu":
            raise TypeError(f"{what}: a fake {t.device.type} tensor has no memory to "
                            "launch the kernel on")


def compile_library(source: Path, build_dir: Path, name: str) -> tuple[Path, str]:
    """Returns the library's path and the ``ptxas`` report of this build
    (empty when the library was already built)."""
    tag = hashlib.sha256(source.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    out = build_dir / f"lib{name}_{tag}.so"
    if out.exists():
        return out, ""
    compiler = nvcc(name.replace("_", "-"))
    build_dir.mkdir(parents=True, exist_ok=True)
    tmp = build_dir / f".{out.name}.{os.getpid()}.tmp"
    cmd = [compiler, *NVCC_FLAGS, "-o", str(tmp), str(source)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}): {' '.join(cmd)}\n{res.stderr}")
    os.replace(tmp, out)  # atomic: a concurrent build never loads a partial file
    return out, res.stderr
