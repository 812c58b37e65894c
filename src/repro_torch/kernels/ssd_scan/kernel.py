"""Build, bind and launch the Hopper SSD chunked-scan kernel.

The kernel is CUDA C++ (``csrc/ssd_scan.cu``) compiled for ``sm_90a`` by
``nvcc`` into a shared library with a plain C interface at first use
(``kernels/_nvcc.py``), then loaded with ``ctypes``.  A failed build raises:
there is no fallback for CUDA tensors.

The kernel is chosen by dtype (``kernel_route``): bfloat16 runs on the
tensor-core kernel, float32 and float16 on the scalar one (float16 widened
to f32 as it is staged).  The tensor-core kernel loads with 16-byte
``cp.async`` when every row of x, b and c starts on a 16-byte boundary (the
model's views do), else element by element; the C side refuses a 16-byte
load it cannot make, so nothing is rerouted there.  A chunk over 128 rows
runs as sub-chunks (``sub_chunks``) and a state over 128 columns as tiles
over the grid whose partial y a second kernel adds (``state_tiles``), so
neither has a limit of its own beyond the grid's extents;
``check_contract`` is the launcher's contract as a pure function.
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
SUB_CHUNK = 128  # kSubQ: rows a kernel stages
TILE_N = 128     # kTileN: state columns of a CTA
P_TILE = 64      # kPT: P columns of a CTA
MAX_GRID_YZ = 65535  # CUDA's limit on gridDim.y (P tiles) and gridDim.z (state tiles)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}

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
            lib.repro_ssd_scan.argtypes = [vp] * 8 + [i32] * 8 + [i64] * 15 + [vp]
            lib.repro_ssd_scan.restype = i32
            lib.repro_ssd_error_string.argtypes = [i32]
            lib.repro_ssd_error_string.restype = ctypes.c_char_p
            _lib = lib
    return _lib


def sub_chunks(chunk: int) -> tuple[int, int]:
    """(sub-chunks, rows of each) a chunk of ``chunk`` rows runs as: one of
    its own length up to SUB_CHUNK, else ceil(chunk / SUB_CHUNK) of equal
    length (``n_sub`` and ``Qs`` in ``repro_ssd_scan``)."""
    n = -(-chunk // SUB_CHUNK)
    return n, -(-chunk // n)


def state_tiles(N: int) -> int:
    """CTAs a stream's state of width N is split over (blockIdx.z); past one,
    the partial y go to an f32 workspace and a second kernel adds them."""
    return -(-N // TILE_N)


def check_contract(shapes, dtypes, last_strides, s0_contiguous: bool, chunk: int) -> None:
    """What the launcher takes, from the shapes, dtypes and last-dim strides
    of x, a, b, c and s0: x, b and c of one dtype of ``_DTYPES``, 4-d with a
    dense last dim; a and s0 float32; a (B, S, H), b and c (B, S, H, N), s0
    dense (B*H, P, N); N and the chunk at least 1, and the P and state tiles
    within the grid's extents.  Raises on anything else."""
    (xs, as_, bs, cs, ss), (xd, ad, bd, cd, sd) = shapes, dtypes
    for name, shape, dtype, last in zip("xbc", (xs, bs, cs), (xd, bd, cd),
                                        (last_strides[0], *last_strides[2:4])):
        if dtype not in _DTYPES or dtype != xd:
            raise TypeError(f"{name}: dtype {dtype} (need float32, bfloat16 or float16, "
                            "one for all)")
        if len(shape) != 4 or last != 1:
            raise ValueError(f"{name} must be 4-d with a dense last dim, got {tuple(shape)}")
    if ad != torch.float32 or sd != torch.float32:
        raise TypeError(f"a and s0 must be float32, got {ad} and {sd}")
    B, S, H, P = xs
    N = bs[3]
    if tuple(as_) != (B, S, H) or tuple(bs) != (B, S, H, N) or tuple(cs) != tuple(bs):
        raise ValueError(f"shapes x {tuple(xs)}, a {tuple(as_)}, b {tuple(bs)}, c {tuple(cs)}")
    if tuple(ss) != (B * H, P, N) or not s0_contiguous:
        raise ValueError(f"s0 must be dense (B*H, P, N) = {(B * H, P, N)}, got {tuple(ss)}")
    if N <= 0 or chunk <= 0:
        raise ValueError(f"state width {N} and chunk {chunk} must be at least 1")
    if state_tiles(N) > MAX_GRID_YZ or -(-P // P_TILE) > MAX_GRID_YZ:
        raise ValueError(f"state width {N} and P {P}: {state_tiles(N)} state tiles of {TILE_N} "
                         f"and {-(-P // P_TILE)} P tiles of {P_TILE}, over the grid's extent "
                         f"of {MAX_GRID_YZ}")


def _check(x, a, b, c, s0, chunk: int) -> None:
    for name, t in (("x", x), ("a", a), ("b", b), ("c", c), ("s0", s0)):
        if t.device.type != "cuda" or t.device != x.device:
            raise ValueError(f"{name} must be a CUDA tensor on {x.device}, got {t.device}")
    ts = (x, a, b, c, s0)
    check_contract([t.shape for t in ts], [t.dtype for t in ts],
                   [t.stride(-1) if t.dim() else 1 for t in ts], s0.is_contiguous(), chunk)


def rows_aligned(t: torch.Tensor) -> bool:
    """Whether 16-byte ``cp.async`` can read every row (last dim) of a bf16
    (B, S, H, n) tensor: a 16-byte-aligned base, strides of multiples of 8
    elements and n a multiple of 8 (a head stride of 0 is one)."""
    return (t.data_ptr() % 16 == 0 and t.shape[3] % 8 == 0
            and all(st % 8 == 0 for st in t.stride()[:3]))


def kernel_route(x: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> tuple[str, str]:
    """(kernel, loads) for these inputs: ("tensor-core", "cp.async16" or
    "elementwise") for bfloat16, ("scalar", "elementwise") for float32 and
    float16."""
    if x.dtype != torch.bfloat16:
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
    A state wider than TILE_N also launches the tile sum, into y from an f32
    workspace of the tiles' partial y.
    """
    _check(x, a, b, c, s0, chunk)
    B, S, H, P = x.shape
    N = b.shape[3]
    y = torch.empty((B, S, H, P), dtype=x.dtype, device=x.device)
    s_out = torch.empty_like(s0)
    tiles = state_tiles(N)
    work = (torch.empty((tiles, B, S, H, P), dtype=torch.float32, device=x.device)
            if tiles > 1 and y.numel() else None)
    lib = _library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.repro_ssd_scan(
            x.data_ptr(), a.data_ptr(), b.data_ptr(), c.data_ptr(), s0.data_ptr(),
            y.data_ptr(), None if work is None else work.data_ptr(), s_out.data_ptr(),
            *kernel_args(x, a, b, c, y, chunk), stream,
        )
    if err != 0:
        msg = lib.repro_ssd_error_string(err).decode()
        raise RuntimeError(f"ssd-scan launch failed: {msg} ({err})")
    return y, s_out
