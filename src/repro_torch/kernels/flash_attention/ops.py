"""Public wrapper for the flash-attention kernel.

Keeps the JAX wrapper's contract (``repro/kernels/flash_attention/ops.py``):
layout (B, H, S, hd) for q and (B, KV, S, hd) for k and v, ``H % KV == 0``,
and ``scale = hd**-0.5`` by default.  CPU tensors take the plain version
(``ref.attention_ref``); CUDA tensors launch the hand-written kernel, which
masks ragged lengths itself (no padding), or the call raises.  The kernel
has instances at the head dims of ``kernel.HEAD_DIMS``; another head dim up
to 256 is zero-padded to the next instance (zero columns add nothing to
q . k, and the padded output columns, zero, are sliced off), with the scale
still the true ``hd**-0.5``, and counted in the ``PADS`` counter; a head dim over
256 launches the wide kernel at its own width, unpadded.  The kernel has no
backward (neither has the Pallas kernel: no ``custom_vjp``), so a CUDA call
with an input that needs gradients raises rather than return a result with
no ``grad_fn``.  Each launch adds 1 to the tracer's ``LAUNCHES`` counter
(``repro_torch.runtime.trace``).

``window`` > 0, beyond the JAX wrapper's contract, is a causal sliding
window: a query sees the keys fewer than ``window`` positions before it, as
``models/attention.py::chunked_attention`` masks them.  It needs ``causal``;
a launch with one also adds 1 to ``WINDOWS``.
"""

from __future__ import annotations

import torch

from repro_torch.kernels._nvcc import refuse_stand_ins
from repro_torch.kernels.flash_attention.kernel import flash_attention_fwd, kernel_route
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.runtime import trace

#: the tracer's counter of kernel launches
LAUNCHES = "flash_attention.launch"
#: the tracer's counter of launches whose q, k and v the wrapper copied to pad the head dim
PADS = "flash_attention.pad"
#: the tracer's counter of launches with a sliding window
WINDOWS = "flash_attention.window"


def flash_attention_gqa(
    q: torch.Tensor,   # (B, H, Sq, hd)
    k: torch.Tensor,   # (B, KV, Skv, hd)
    v: torch.Tensor,   # (B, KV, Skv, hd)
    *,
    causal: bool = True,
    scale: float | None = None,
    window: int = 0,
    block_q: int = 128,
    block_k: int = 128,
) -> torch.Tensor:
    """Flash attention with grouped-query heads. Returns (B, H, Sq, hd).

    ``block_q``/``block_k`` are accepted for the JAX signature; the CUDA
    kernel's tiles are fixed at compile time and the plain version has none.
    """
    refuse_stand_ins("flash_attention_gqa", q, k, v)
    B, H, Sq, hd = q.shape
    KV = k.shape[1]
    if H % KV != 0:
        raise ValueError(f"H={H} not a multiple of KV={KV}")
    if window < 0 or (window > 0 and not causal):
        raise ValueError(f"window={window}: a sliding window is a causal call's, at least 1")
    if scale is None:
        scale = hd**-0.5
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal=causal, scale=scale, window=window)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError(
            "flash_attention_gqa: the CUDA kernel has no backward; an input "
            "requires grad (train with attention_impl='reference')"
        )
    if q.numel() == 0:
        return torch.empty_like(q)
    _, width, padded = kernel_route(hd, q.dtype)
    if padded:
        q, k, v = (torch.nn.functional.pad(t, (0, width - hd)) for t in (q, k, v))
    out = flash_attention_fwd(q, k, v, causal=causal, scale=scale, window=window)
    trace.count(LAUNCHES)
    if window:
        trace.count(WINDOWS)
    if padded:
        trace.count(PADS)
        return out[..., :hd]
    return out
