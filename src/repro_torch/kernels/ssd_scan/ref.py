"""Plain PyTorch version of the SSD scan: the sequential O(S) recurrence.

Counterpart of ``repro/kernels/ssd_scan/ref.py::ssd_scan_ref``:

    state_t = exp(a_t) * state_{t-1} + x_t b_t^T        (outer product, (P,N))
    y_t     = state_t c_t                               ((P,))

in float32 (float64 for float64 inputs), with y returned in x's dtype.  It
is the oracle the chunked kernel is held to.
"""

from __future__ import annotations

import torch


def ssd_scan_ref(
    x: torch.Tensor,    # (BH, S, P)
    a: torch.Tensor,    # (BH, S)
    b: torch.Tensor,    # (BH, S, N)
    c: torch.Tensor,    # (BH, S, N)
    s0: torch.Tensor,   # (BH, P, N)
) -> tuple[torch.Tensor, torch.Tensor]:
    wide = torch.promote_types(x.dtype, torch.float32)
    xf, af, bf, cf = (t.to(wide) for t in (x, a, b, c))
    state = s0.to(wide).clone()
    ys = []
    for t in range(x.shape[1]):
        state = state * torch.exp(af[:, t])[:, None, None] + xf[:, t, :, None] * bf[:, t, None, :]
        ys.append(torch.einsum("bpn,bn->bp", state, cf[:, t]))
    y = torch.stack(ys, dim=1) if ys else xf.new_zeros(x.shape)
    return y.to(x.dtype), state
