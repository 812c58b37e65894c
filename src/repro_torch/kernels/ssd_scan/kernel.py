"""Build, bind and launch the Hopper SSD chunked-scan kernel.

The kernel is CUDA C++ (``csrc/ssd_scan.cu``) compiled for ``sm_90a`` by
``nvcc`` into a shared library with a plain C interface at first use
(``kernels/_nvcc.py``), then loaded with ``ctypes``.  A failed build raises:
there is no fallback for CUDA tensors.

The kernel is chosen by dtype (``kernel_route``): bfloat16 runs on the
tensor-core kernel, float32 on the scalar one.  The tensor-core kernel loads
with 16-byte ``cp.async`` when every row of x, b and c starts on a 16-byte
boundary (the model's views do), else element by element; the C side
refuses a 16-byte load it cannot make, so nothing is rerouted there.
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path

import torch

from repro_torch.kernels._nvcc import compile_library

_HERE = Path(__file__).resolve().parent
SOURCE = _HERE / "csrc" / "ssd_scan.cu"
BUILD_DIR = _HERE / "build"
MAX_CHUNK = 128  # kMaxQ in ssd_scan.cu
MAX_STATE = 128  # kMaxN
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
#: ``ptxas`` report (registers, shared memory, spills) of the last build
build_log = ""


def build() -> Path:
    """Compile the kernel library unless this source is already built."""
    global build_log
    out, log = compile_library(SOURCE, BUILD_DIR, "ssd_scan")
    build_log = log or build_log
    return out


def _library() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
            lib.repro_ssd_scan.argtypes = [vp] * 7 + [i32] * 8 + [i64] * 15 + [vp]
            lib.repro_ssd_scan.restype = i32
            lib.repro_ssd_error_string.argtypes = [i32]
            lib.repro_ssd_error_string.restype = ctypes.c_char_p
            _lib = lib
    return _lib


def _check(x, a, b, c, s0, chunk: int) -> None:
    for name, t in (("x", x), ("a", a), ("b", b), ("c", c), ("s0", s0)):
        if t.device.type != "cuda" or t.device != x.device:
            raise ValueError(f"{name} must be a CUDA tensor on {x.device}, got {t.device}")
    for name, t in (("x", x), ("b", b), ("c", c)):
        if t.dtype not in _DTYPES or t.dtype != x.dtype:
            raise TypeError(f"{name}: dtype {t.dtype} (need float32 or bfloat16, one for all)")
        if t.dim() != 4 or t.stride(3) != 1:
            raise ValueError(f"{name} must be 4-d with a dense last dim, got {tuple(t.shape)}")
    if a.dtype != torch.float32 or s0.dtype != torch.float32:
        raise TypeError(f"a and s0 must be float32, got {a.dtype} and {s0.dtype}")
    B, S, H, P = x.shape
    N = b.shape[3]
    if a.shape != (B, S, H) or b.shape != (B, S, H, N) or c.shape != b.shape:
        raise ValueError(f"shapes x {tuple(x.shape)}, a {tuple(a.shape)}, "
                         f"b {tuple(b.shape)}, c {tuple(c.shape)}")
    if s0.shape != (B * H, P, N) or not s0.is_contiguous():
        raise ValueError(f"s0 must be dense (B*H, P, N) = {(B * H, P, N)}, got {tuple(s0.shape)}")
    if not 0 < N <= MAX_STATE or not 0 < chunk <= MAX_CHUNK:
        raise ValueError(f"state width {N} and chunk {chunk} must be in 1..{MAX_STATE}")


def rows_aligned(t: torch.Tensor) -> bool:
    """Whether 16-byte ``cp.async`` can read every row (last dim) of a bf16
    (B, S, H, n) tensor: a 16-byte-aligned base, strides of multiples of 8
    elements and n a multiple of 8 (a head stride of 0 is one)."""
    return (t.data_ptr() % 16 == 0 and t.shape[3] % 8 == 0
            and all(st % 8 == 0 for st in t.stride()[:3]))


def kernel_route(x: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> tuple[str, str]:
    """(kernel, loads) for these inputs: ("tensor-core", "cp.async16" or
    "elementwise") for bfloat16, ("scalar", "elementwise") for float32."""
    if x.dtype == torch.float32:
        return "scalar", "elementwise"
    aligned = all(rows_aligned(t) for t in (x, b, c))
    return "tensor-core", "cp.async16" if aligned else "elementwise"


def kernel_args(x, a, b, c, y, chunk: int) -> tuple:
    """The arguments of ``repro_ssd_scan`` between the pointers and the
    stream: dtype code, load mode, B, S, H, P, N, chunk, then the element
    strides of the batch, sequence and head dims of x, a, b, c and y."""
    B, S, H, P = x.shape
    load_mode = 1 if kernel_route(x, b, c)[1] == "cp.async16" else 0
    return (_DTYPES[x.dtype], load_mode, B, S, H, P, b.shape[3], chunk,
            *x.stride()[:3], *a.stride(), *b.stride()[:3], *c.stride()[:3], *y.stride()[:3])


def ssd_scan_fwd(
    x: torch.Tensor,    # (B, S, H, P)
    a: torch.Tensor,    # (B, S, H) float32
    b: torch.Tensor,    # (B, S, H, N)
    c: torch.Tensor,    # (B, S, H, N)
    s0: torch.Tensor,   # (B*H, P, N) float32, dense
    *,
    chunk: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the kernel on PyTorch's current stream.

    Returns y (B, S, H, P) in x's dtype and the final state (B*H, P, N) in
    float32.  Inputs are read through their strides (the last dim dense).
    """
    _check(x, a, b, c, s0, chunk)
    B, S, H, P = x.shape
    N = b.shape[3]
    y = torch.empty((B, S, H, P), dtype=x.dtype, device=x.device)
    s_out = torch.empty_like(s0)
    lib = _library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.repro_ssd_scan(
            x.data_ptr(), a.data_ptr(), b.data_ptr(), c.data_ptr(), s0.data_ptr(),
            y.data_ptr(), s_out.data_ptr(), *kernel_args(x, a, b, c, y, chunk), stream,
        )
    if err != 0:
        msg = lib.repro_ssd_error_string(err).decode()
        raise RuntimeError(f"ssd-scan launch failed: {msg} ({err})")
    return y, s_out
