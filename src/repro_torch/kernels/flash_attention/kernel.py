"""Build, bind and launch the Hopper flash-attention kernel.

The kernel is CUDA C++ (``csrc/flash_attention.cu``) compiled for ``sm_90a``
by ``nvcc`` into a shared library with a plain C interface at first use,
then loaded with ``ctypes``.  The library lands in ``build/`` beside this
file, named by a hash of the source and flags, so an edited source is
rebuilt and a built one is reused.  A failed build raises: there is no
fallback for CUDA tensors.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

_HERE = Path(__file__).resolve().parent
SOURCE = _HERE / "csrc" / "flash_attention.cu"
BUILD_DIR = _HERE / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
HEAD_DIMS = (16, 32, 64, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
#: ``ptxas`` report (registers, shared memory, spills) of the last build
build_log = ""


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the flash-attention kernel is built from csrc/ at first use")


def build() -> Path:
    """Compile the kernel library unless this source is already built."""
    global build_log
    tag = hashlib.sha256(SOURCE.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"libflash_attention_{tag}.so"
    if out.exists():
        return out
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f".{out.name}.{os.getpid()}.tmp"
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}): {' '.join(cmd)}\n{res.stderr}")
    os.replace(tmp, out)  # atomic: a concurrent build never loads a partial file
    build_log = res.stderr
    return out


def _library() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
            lib.repro_fa_fwd.argtypes = (
                [vp] * 4 + [i32] * 7 + [i64] * 12 + [ctypes.c_float, i32, vp]
            )
            lib.repro_fa_fwd.restype = i32
            lib.repro_fa_error_string.argtypes = [i32]
            lib.repro_fa_error_string.restype = ctypes.c_char_p
            _lib = lib
    return _lib


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError(f"{name} must be a CUDA tensor on {q.device}, got {t.device}")
        if t.dtype not in _DTYPES or t.dtype != q.dtype:
            raise TypeError(f"{name}: dtype {t.dtype} (need float32 or bfloat16, one for all)")
        if t.dim() != 4 or t.stride(3) != 1:
            raise ValueError(f"{name} must be 4-d with a dense head dim, got {tuple(t.shape)}")
    B, H, Sq, hd = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != hd:
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head dim {hd} not in {HEAD_DIMS}")


def flash_attention_fwd(
    q: torch.Tensor,   # (B, H, Sq, hd)
    k: torch.Tensor,   # (B, KV, Skv, hd)
    v: torch.Tensor,   # (B, KV, Skv, hd)
    *,
    causal: bool,
    scale: float,
) -> torch.Tensor:
    """Launch the kernel on PyTorch's current stream; returns (B, H, Sq, hd)."""
    _check(q, k, v)
    B, H, Sq, hd = q.shape
    KV, Skv = k.shape[1], k.shape[2]
    out = torch.empty((B, H, Sq, hd), dtype=q.dtype, device=q.device)
    lib = _library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.repro_fa_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            _DTYPES[q.dtype], B, H, KV, Sq, Skv, hd,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
            float(scale), int(causal), stream,
        )
    if err != 0:
        msg = lib.repro_fa_error_string(err).decode()
        raise RuntimeError(f"flash-attention launch failed: {msg} ({err})")
    return out
