"""Build, bind and launch the Hopper tensor-fingerprint kernel.

The kernel is CUDA C++ (``csrc/fingerprint.cu``) compiled for ``sm_90a`` by
``nvcc`` into a shared library with a plain C interface at first use
(``kernels/_nvcc.py``), then loaded with ``ctypes``.  A failed build raises:
there is no fallback for CUDA tensors.

The kernel has two routes, chosen here by the input's address (``route``):
a 16-byte-aligned input is read by TMA into a ring of stages in shared
memory (``tma_geometry`` gives the map, the boxes and the ring); any other
input is read in place through a register ring.  The C side refuses an input its route cannot
take, so neither route ever stands in for the other.
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
BLOCK_BYTES = 4 * LANES
ROUTES = {"tma": 0, "ring": 1}
TMA_ALIGN = 16  # bytes: TMA's alignment of a global address
MAX_SMEM = 227 * 1024  # kMaxSmem: dynamic shared memory a CTA may use
# The TMA route's stages and ring: lanes of a CTA (the box's inner dim: 8,
# 16 or 32), blocks a stage (a multiple of 64 up to 256, or of 256: one box
# a 256 blocks) and stages in flight.  ``bench.compare_layouts`` on the H100:
# the depth changes nothing from 2 stages up (the chains set the pace), but
# each stage costs the chain warp a few hundred cycles, so tall stages win;
# 8 lanes x 2048 blocks x 3 stages was the fastest layout.
TMA_LANES = 8
TMA_ROWS = 2048
TMA_STAGES = 3

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
            i32 = ctypes.c_int
            lib.repro_fingerprint.argtypes = [vp, ctypes.c_longlong, i32, i32, i32, i32, vp, vp, vp]
            lib.repro_fingerprint.restype = ctypes.c_int
            lib.repro_fingerprint_error_string.argtypes = [ctypes.c_int]
            lib.repro_fingerprint_error_string.restype = ctypes.c_char_p
            _lib = lib
    return _lib


def route(data: torch.Tensor) -> str:
    """The kernel route for a byte tensor: "tma" when its first byte is
    16-byte aligned (every leaf of a parameter tree), else "ring"."""
    return "tma" if data.data_ptr() % TMA_ALIGN == 0 else "ring"


def tma_geometry(n: int, *, lanes: int = TMA_LANES, rows: int = TMA_ROWS,
                 stages: int = TMA_STAGES) -> dict:
    """What the TMA route builds for ``n`` bytes: the 2-d map over the whole
    blocks (dims innermost first, in uint32 words; the row stride in bytes),
    the box (a stage of ``rows`` blocks is one or more boxes), the ring and
    the launch.  An input of less than one block loads no box, but its map
    still has one row."""
    stage_bytes = 4 * lanes * rows
    smem_bytes = stages * stage_bytes + 16 * stages + 1024
    if (lanes not in (8, 16, 32) or rows < 64 or rows % 64 or (rows > 256 and rows % 256)
            or stages < 1 or smem_bytes > MAX_SMEM):
        raise ValueError(f"box {lanes} x {rows} with {stages} stages: lanes 8, 16 or 32, rows "
                         "a multiple of 64 up to 256 or of 256 (boxes of 256 rows), at least "
                         f"one stage, at most {MAX_SMEM} B of shared memory")
    return {
        "dims": (LANES, max(n // BLOCK_BYTES, 1)),
        "strides": (BLOCK_BYTES,),
        "box": (lanes, min(rows, 256)),
        "boxes_a_stage": -(-rows // 256),
        "stages": stages,
        "stage_bytes": stage_bytes,
        "smem_bytes": smem_bytes,
        "grid": LANES // lanes,
        "stages_filled": -(-(n // BLOCK_BYTES) // rows),
    }


def fingerprint_fwd(data: torch.Tensor, *, lanes: int = TMA_LANES, rows: int = TMA_ROWS,
                    stages: int = TMA_STAGES) -> torch.Tensor:
    """Launch the kernel on PyTorch's current stream.

    ``data`` is a dense 1-D uint8 CUDA tensor of at least one byte, at any
    address: the kernel masks the ragged tail and reads a view that starts
    off a 16-byte boundary in place, on the register-ring route.  ``lanes``,
    ``rows`` and ``stages`` shape the TMA route's stages and ring.  Returns
    the (2,) uint32 token on ``data``'s device.
    """
    if data.device.type != "cuda":
        raise ValueError(f"data must be a CUDA tensor, got {data.device}")
    if data.dtype != torch.uint8 or data.dim() != 1 or data.stride(0) != 1:
        raise ValueError(f"data must be dense 1-D uint8, got {data.dtype} "
                         f"{tuple(data.shape)} stride {data.stride()}")
    if data.numel() == 0:
        raise ValueError("data must hold at least one byte")
    tma_geometry(data.numel(), lanes=lanes, rows=rows, stages=stages)  # checks the box
    acc = torch.empty(LANES, dtype=torch.int32, device=data.device)
    out = torch.empty(2, dtype=torch.int32, device=data.device)
    lib = _library()
    with torch.cuda.device(data.device):
        stream = torch.cuda.current_stream(data.device).cuda_stream
        err = lib.repro_fingerprint(data.data_ptr(), data.numel(), ROUTES[route(data)], lanes,
                                    rows, stages, acc.data_ptr(), out.data_ptr(), stream)
    if err != 0:
        msg = lib.repro_fingerprint_error_string(err).decode()
        raise RuntimeError(f"fingerprint launch failed: {msg} ({err})")
    return out.view(torch.uint32)
