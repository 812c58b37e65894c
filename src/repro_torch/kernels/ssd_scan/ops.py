"""Public wrapper for the SSD chunked-scan kernel.

Keeps the JAX wrapper's contract (``repro/kernels/ssd_scan/ops.py``): the
model layout (B, S, H, ...) in and out, the chunk clamped to
``min(chunk, max(8, next_pow2(S)))``, a zero initial state by default, y in
x's dtype and the final state (B, H, P, N) in float32.  CPU tensors take the
plain version (``ref.ssd_scan_ref`` on the (B*H, S, ...) flattening); CUDA
tensors launch the hand-written kernel, or the call raises.  The kernel reads
x, a, b and c through their strides, so the model's head-broadcast views of
b and c (head stride 0) are not copied, and it masks the ragged tail of S
itself, where the JAX wrapper pads with (inert) zeros.  On CUDA, x, b and c
need a dense last dim and one dtype of float32, bfloat16 and float16; any
chunk and state width run (as sub-chunks of 128 rows and state tiles of 128
columns).  The kernel has no backward
(neither has the Pallas kernel), so a CUDA call with an input that needs
gradients raises rather than return a result with no ``grad_fn``.
"""

from __future__ import annotations

import torch

from repro_torch.kernels._nvcc import refuse_stand_ins
from repro_torch.kernels.ssd_scan.kernel import ssd_scan_fwd, state_tiles
from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref
from repro_torch.runtime import trace

#: the tracer's counter of kernel launches
LAUNCHES = "ssd_scan.launch"
#: the tracer's counter of the tile sums that follow the kernel at a state over 128 wide
TILE_SUMS = "ssd_scan.tile_sum"


def ssd_scan(
    x: torch.Tensor,    # (B, S, H, P)   pre-multiplied by dt
    a: torch.Tensor,    # (B, S, H)      log-decay per step (negative)
    b: torch.Tensor,    # (B, S, H, N)
    c: torch.Tensor,    # (B, S, H, N)
    initial_state: torch.Tensor | None = None,  # (B, H, P, N)
    *,
    chunk: int = 128,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (y (B,S,H,P), final_state (B,H,P,N) float32)."""
    refuse_stand_ins("ssd_scan", x, a, b, c, initial_state)
    B, S, H, P = x.shape
    N = b.shape[-1]
    Q = min(chunk, max(8, 1 << (S - 1).bit_length()))
    s0 = (
        initial_state.reshape(B * H, P, N).float()
        if initial_state is not None
        else torch.zeros((B * H, P, N), dtype=torch.float32, device=x.device)
    )
    if x.device.type != "cpu" and torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in (x, a, b, c, initial_state)
    ):
        raise RuntimeError(
            "ssd_scan: the CUDA kernel has no backward; an input requires grad "
            "(train with attention_impl='reference')"
        )
    if x.device.type == "cpu":
        flat = lambda t: t.transpose(1, 2).reshape(B * H, S, *t.shape[3:])  # noqa: E731
        y, s_final = ssd_scan_ref(flat(x), flat(a), flat(b), flat(c), s0)
        y = y.reshape(B, H, S, P).transpose(1, 2)
    else:
        y, s_final = ssd_scan_fwd(x, a.float(), b, c, s0.contiguous(), chunk=Q)
        trace.count(LAUNCHES)
        if state_tiles(N) > 1 and S > 0:
            trace.count(TILE_SUMS)
    return y, s_final.reshape(B, H, P, N)
