"""Build, bind and launch the Hopper flash-attention kernel.

The kernel is CUDA C++ (``csrc/flash_attention.cu``) compiled for ``sm_90a``
by ``nvcc`` into a shared library with a plain C interface at first use
(``kernels/_nvcc.py``), then loaded with ``ctypes``.  bfloat16 runs on the
wgmma + TMA kernel, float32 on the scalar one.  A failed build raises: there
is no fallback for CUDA tensors.
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path

import torch

from repro_torch.kernels._nvcc import NVCC_FLAGS, compile_library  # noqa: F401

_HERE = Path(__file__).resolve().parent
SOURCE = _HERE / "csrc" / "flash_attention.cu"
BUILD_DIR = _HERE / "build"
HEAD_DIMS = (16, 32, 64, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
#: ``ptxas`` report (registers, shared memory, spills) of the last build
build_log = ""


def build() -> Path:
    """Compile the kernel library unless this source is already built."""
    global build_log
    out, log = compile_library(SOURCE, BUILD_DIR, "flash_attention")
    build_log = log or build_log
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


def tma_ready(t: torch.Tensor) -> bool:
    """Whether TMA can read ``t`` where it lies: a 16-byte-aligned base and,
    for each of the first three dims longer than 1, a positive stride of a
    multiple of 16 bytes (the head dim is dense)."""
    el = t.element_size()
    return t.data_ptr() % 16 == 0 and all(
        s > 0 and s * el % 16 == 0 for s, n in zip(t.stride()[:3], t.shape[:3]) if n > 1
    )


def kernel_inputs(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> tuple:
    """q, k and v as the kernel reads them.  The bfloat16 kernel loads
    through TMA, so an input that breaks TMA's alignment is copied to a
    contiguous tensor; strided views that keep it (the model's permuted q,
    transposed k and v) pass as they are.  float32 inputs always pass."""
    if q.dtype != torch.bfloat16:
        return q, k, v
    return tuple(t if tma_ready(t) else t.clone(memory_format=torch.contiguous_format)
                 for t in (q, k, v))


def kernel_args(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                out: torch.Tensor) -> tuple:
    """The arguments of ``repro_fa_fwd`` between the pointers and the scale:
    the dtype code, B, H, KV, Sq, Skv, hd, then the element strides of the
    batch, head and sequence dims of q, k, v and out.  A dim of length 1 is
    never stepped over; its stride is given as hd, which TMA accepts."""
    B, H, Sq, hd = q.shape
    KV, Skv = k.shape[1], k.shape[2]
    strides = [s if n > 1 else hd
               for t in (q, k, v, out) for s, n in zip(t.stride()[:3], t.shape[:3])]
    return (_DTYPES[q.dtype], B, H, KV, Sq, Skv, hd, *strides)


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
    q, k, v = kernel_inputs(q, k, v)
    B, H, Sq, hd = q.shape
    out = torch.empty((B, H, Sq, hd), dtype=q.dtype, device=q.device)
    lib = _library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.repro_fa_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            *kernel_args(q, k, v, out), float(scale), int(causal), stream,
        )
    if err != 0:
        msg = lib.repro_fa_error_string(err).decode()
        raise RuntimeError(f"flash-attention launch failed: {msg} ({err})")
    return out
