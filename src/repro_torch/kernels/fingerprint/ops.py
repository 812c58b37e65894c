"""Public wrapper for the tensor-fingerprint kernel: any tensor in, a 64-bit
content token out.

Keeps the JAX wrapper's contract (``repro/kernels/fingerprint/ops.py``): the
bytes of the array in row-major order, zero-padded to whole 4096-byte
blocks, give a (2,) uint32 token, and ``fingerprint_token`` formats it as 16
hex digits.  The JAX package runs with 64-bit types off, so ``jnp.asarray``
narrows float64, int64 and uint64 to their 32-bit types before hashing; this
wrapper narrows the same way (so 64-bit inputs that agree after narrowing
share a token).  Bool and complex inputs raise ``TypeError``, as
``bitcast_convert_type`` does in JAX, and an empty input raises, as the JAX
wrapper does.

CPU tensors take the plain version (``ref.fingerprint_ref``); CUDA tensors
launch the hand-written kernel, or the call raises.  The kernel masks the
ragged tail itself, so nothing is padded or copied: a dense tensor is read
in place, at any byte offset, and only a non-dense one is first made dense.
"""

from __future__ import annotations

from typing import Any

import torch

from repro_torch.bridge import to_tensor
from repro_torch.kernels._nvcc import refuse_stand_ins
from repro_torch.kernels.fingerprint.kernel import fingerprint_fwd
from repro_torch.kernels.fingerprint.ref import MASK, fingerprint_ref
from repro_torch.runtime import trace

#: the tracer's counter of kernel launches
LAUNCHES = "fingerprint.launch"

# what ``jnp.asarray`` makes of 64-bit inputs with 64-bit types off
NARROW = {torch.float64: torch.float32, torch.int64: torch.int32, torch.uint64: torch.uint32}


def as_bytes(x: torch.Tensor) -> torch.Tensor:
    """x's bytes as a 1-D uint8 tensor, in row-major order after narrowing;
    a view of x when x is dense and not narrowed."""
    if x.dtype == torch.bool or x.is_complex():
        raise TypeError(f"cannot fingerprint {x.dtype} values (as in JAX, only "
                        "numeric non-complex types are bit-cast)")
    flat = x.to(NARROW.get(x.dtype, x.dtype)).contiguous().reshape(-1)
    return flat if flat.dtype == torch.uint8 else flat.view(torch.uint8)


def fingerprint(x: torch.Tensor) -> torch.Tensor:
    """Content fingerprint of any tensor. Returns (2,) uint32 on x's device."""
    refuse_stand_ins("fingerprint", x)
    data = as_bytes(x)
    if data.numel() == 0:
        raise ValueError("cannot fingerprint an empty tensor")
    if data.device.type == "cpu":
        return fingerprint_ref(data)
    out = fingerprint_fwd(data)
    trace.count(LAUNCHES)
    return out


def _device(device: Any) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to fingerprint on the CPU")
    return dev


def fingerprint_token(x: Any, *, device: Any = None) -> str:
    """Hex token for store and scheduler keys.

    A tensor is hashed where it lies; anything else (an ndarray, or a proxy
    of one) is first made a tensor on ``device``, by default ``"cuda"``.
    """
    if not isinstance(x, torch.Tensor):
        x = to_tensor(x, device=_device(device))
    return format_token(fingerprint(x))


def format_token(h: torch.Tensor) -> str:
    """A (2,) uint32 fingerprint as 16 hex digits."""
    a, b = h.cpu().view(torch.int32).tolist()
    return f"{a & MASK:08x}{b & MASK:08x}"
