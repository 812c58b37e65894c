"""Build, bind and launch the Hopper flash-attention kernel.

The kernel is CUDA C++ (``csrc/flash_attention.cu``) compiled for ``sm_90a``
by ``nvcc`` into a shared library with a plain C interface at first use
(``kernels/_nvcc.py``), then loaded with ``ctypes``.  bfloat16 and float16
run on the wgmma + TMA kernel, float32 on the scalar one, each at the head
dims of ``HEAD_DIMS``; a head dim over ``HEAD_DIMS[-1]`` runs on the wide
kernel (``fa_fwd_wide``) in every dtype, at its own width.  A causal call
may give a sliding window (each query sees its last ``window`` keys); the
16-bit kernel then runs as ``fa_fwd_band``, which loads only the tiles
inside the band.
``check_contract`` and ``kernel_route`` are the launcher's contract as pure
functions of shapes, dtypes and strides; a head dim up to 256 without an
instance is padded by the wrapper (``ops.py``).  A failed build raises:
there is no fallback for CUDA tensors.
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
#: head dims with an instance of each kernel (``by_head_dim`` in the source)
HEAD_DIMS = (16, 32, 64, 80, 96, 128, 256)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_KERNELS = {torch.float32: "fa_fwd_f32", torch.bfloat16: "fa_fwd_tc<bf16>",
            torch.float16: "fa_fwd_tc<f16>"}
_WIDE = {torch.float32: "fa_fwd_wide<f32>", torch.bfloat16: "fa_fwd_wide<bf16>",
         torch.float16: "fa_fwd_wide<f16>"}

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
            lib.repro_fa_fwd_window.argtypes = (
                [vp] * 4 + [i32] * 7 + [i64] * 12 + [ctypes.c_float, i32, i32, vp]
            )
            lib.repro_fa_fwd_window.restype = i32
            lib.repro_fa_error_string.argtypes = [i32]
            lib.repro_fa_error_string.restype = ctypes.c_char_p
            _lib = lib
    return _lib


def kernel_route(hd: int, dtype: torch.dtype) -> tuple[str, int, bool]:
    """(kernel, head dim it launches at, whether the wrapper zero-pads the
    head dim up to it) for a call at head dim ``hd``: up to 256 the dtype
    picks the kernel and the least instance of at least ``hd`` its width;
    over 256 (wgmma's widest N) the wide kernel runs at ``hd`` itself."""
    if dtype not in _DTYPES:
        raise TypeError(f"dtype {dtype} (need float32, bfloat16 or float16)")
    if hd <= 0:
        raise ValueError(f"head dim {hd}: need at least 1")
    if hd > HEAD_DIMS[-1]:
        return _WIDE[dtype], hd, False
    width = next(d for d in HEAD_DIMS if d >= hd)
    return _KERNELS[dtype], width, width != hd


def check_contract(shapes, dtypes, last_strides) -> None:
    """What the launcher takes, from the shapes, dtypes and last-dim strides
    of q, k and v: one dtype of ``_DTYPES`` for all, 4-d with a dense head
    dim, k and v alike, the batch and head dim shared, and a head dim with
    an instance (``HEAD_DIMS``) or over ``HEAD_DIMS[-1]`` (the wide kernel).
    Raises on anything else."""
    (qs, ks, vs), dt = shapes, dtypes[0]
    for name, shape, dtype, last in zip("qkv", shapes, dtypes, last_strides):
        if dtype not in _DTYPES or dtype != dt:
            raise TypeError(f"{name}: dtype {dtype} (need float32, bfloat16 or float16, "
                            "one for all)")
        if len(shape) != 4 or last != 1:
            raise ValueError(f"{name} must be 4-d with a dense head dim, got {tuple(shape)}")
    B, H, Sq, hd = qs
    if tuple(ks) != tuple(vs) or ks[0] != B or ks[3] != hd:
        raise ValueError(f"shapes q {tuple(qs)}, k {tuple(ks)}, v {tuple(vs)}")
    if hd not in HEAD_DIMS and hd <= HEAD_DIMS[-1]:
        raise ValueError(f"head dim {hd}: neither in {HEAD_DIMS} nor over {HEAD_DIMS[-1]}")


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError(f"{name} must be a CUDA tensor on {q.device}, got {t.device}")
    check_contract([t.shape for t in (q, k, v)], [t.dtype for t in (q, k, v)],
                   [t.stride(-1) if t.dim() else 1 for t in (q, k, v)])


def tma_ready(t: torch.Tensor) -> bool:
    """Whether TMA can read ``t`` where it lies: a 16-byte-aligned base and,
    for each of the first three dims longer than 1, a positive stride of a
    multiple of 16 bytes (the head dim is dense)."""
    el = t.element_size()
    return t.data_ptr() % 16 == 0 and all(
        s > 0 and s * el % 16 == 0 for s, n in zip(t.stride()[:3], t.shape[:3]) if n > 1
    )


def kernel_inputs(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> tuple:
    """q, k and v as the kernel reads them.  The 16-bit kernel loads
    through TMA, so an input that breaks TMA's alignment is copied to a
    contiguous tensor; strided views that keep it (the model's permuted q,
    transposed k and v) pass as they are.  float32 inputs, and any input of
    the wide kernel (element by element loads), always pass."""
    if q.dtype == torch.float32 or q.shape[-1] > HEAD_DIMS[-1]:
        return q, k, v
    return tuple(t if tma_ready(t) else t.clone(memory_format=torch.contiguous_format)
                 for t in (q, k, v))


def kernel_args(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                out: torch.Tensor) -> tuple:
    """The arguments of ``repro_fa_fwd_window`` between the pointers and the scale:
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
    window: int = 0,
) -> torch.Tensor:
    """Launch the kernel on PyTorch's current stream; returns (B, H, Sq, hd).
    ``window`` > 0 (a causal call only) masks keys ``window`` or more
    positions before the query."""
    _check(q, k, v)
    q, k, v = kernel_inputs(q, k, v)
    B, H, Sq, hd = q.shape
    out = torch.empty((B, H, Sq, hd), dtype=q.dtype, device=q.device)
    lib = _library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.repro_fa_fwd_window(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            *kernel_args(q, k, v, out), float(scale), int(causal), int(window), stream,
        )
    if err != 0:
        msg = lib.repro_fa_error_string(err).decode()
        raise RuntimeError(f"flash-attention launch failed: {msg} ({err})")
    return out
