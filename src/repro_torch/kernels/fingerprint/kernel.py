"""Build, bind and launch the Hopper tensor-fingerprint kernel.

The kernel is CUDA C++ (``csrc/fingerprint.cu``) compiled for ``sm_90a`` by
``nvcc`` into a shared library with a plain C interface at first use
(``kernels/_nvcc.py``), then loaded with ``ctypes``.  A failed build raises:
there is no fallback for CUDA tensors.
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path

import torch

from repro_torch.kernels._nvcc import compile_library

_HERE = Path(__file__).resolve().parent
SOURCE = _HERE / "csrc" / "fingerprint.cu"
BUILD_DIR = _HERE / "build"
LANES = 1024  # kLanes in fingerprint.cu: uint32 words of a 4096-byte block

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
#: ``ptxas`` report (registers, shared memory, spills) of the last build
build_log = ""


def build() -> Path:
    """Compile the kernel library unless this source is already built."""
    global build_log
    out, log = compile_library(SOURCE, BUILD_DIR, "fingerprint")
    build_log = log or build_log
    return out


def _library() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            vp = ctypes.c_void_p
            lib.repro_fingerprint.argtypes = [vp, ctypes.c_longlong, vp, vp, vp]
            lib.repro_fingerprint.restype = ctypes.c_int
            lib.repro_fingerprint_error_string.argtypes = [ctypes.c_int]
            lib.repro_fingerprint_error_string.restype = ctypes.c_char_p
            _lib = lib
    return _lib


def fingerprint_fwd(data: torch.Tensor) -> torch.Tensor:
    """Launch the kernel on PyTorch's current stream.

    ``data`` is a dense 1-D uint8 CUDA tensor of at least one byte, at any
    address: the kernel masks the ragged tail and reads a view that starts
    off a 4-byte boundary as it lies.  Returns the (2,) uint32 token on
    ``data``'s device.
    """
    if data.device.type != "cuda":
        raise ValueError(f"data must be a CUDA tensor, got {data.device}")
    if data.dtype != torch.uint8 or data.dim() != 1 or data.stride(0) != 1:
        raise ValueError(f"data must be dense 1-D uint8, got {data.dtype} "
                         f"{tuple(data.shape)} stride {data.stride()}")
    if data.numel() == 0:
        raise ValueError("data must hold at least one byte")
    acc = torch.empty(LANES, dtype=torch.int32, device=data.device)
    out = torch.empty(2, dtype=torch.int32, device=data.device)
    lib = _library()
    with torch.cuda.device(data.device):
        stream = torch.cuda.current_stream(data.device).cuda_stream
        err = lib.repro_fingerprint(data.data_ptr(), data.numel(), acc.data_ptr(),
                                    out.data_ptr(), stream)
    if err != 0:
        msg = lib.repro_fingerprint_error_string(err).decode()
        raise RuntimeError(f"fingerprint launch failed: {msg} ({err})")
    return out.view(torch.uint32)
