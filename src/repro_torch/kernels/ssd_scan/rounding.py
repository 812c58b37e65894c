"""Which roundings the bf16 SSD kernel can afford: a study in plain PyTorch.

    python -m repro_torch.kernels.ssd_scan.rounding [--seeds 4] [--device cpu] [--state N]

The tensor-core kernel (``csrc/ssd_scan.cu``) feeds bf16 operands to its
products.  Three of them are values it computes itself and must round: the
masked product P = (C B^T) o L before P X, the f32 state S before C S^T,
and X o decay before the state update.  This script repeats the kernel's
chunked arithmetic in f32 with each of those roundings on or off (a bf16
rounding, or a bf16 hi + lo split that keeps about 16 bits), at
mamba2-130m's serving prefill shape with the inputs of ``chip_smoke``'s SSD
check (scaled as the JAX kernel sweep scales them), and counts the elements
of y past the check's limit, |y - y_ref| <= 3e-2 + 3e-2 |y_ref|, against the
sequential f32 recurrence (``ref.ssd_scan_ref``), y rounded to bf16 as the
kernel stores it.  It prints one line a seed and configuration.  ``--state``
sets N (the kernel splits X o decay too past 128 columns).
"""

from __future__ import annotations

import argparse
import sys

import torch

from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref

SHAPE = (4, 1024, 24, 64, 128)  # B, S, H, P, N: mamba2-130m's serving prefill
CHUNK = 128
TOL = 3e-2


def _bf16(t: torch.Tensor) -> torch.Tensor:
    return t.bfloat16().float()


def _hilo(t: torch.Tensor) -> torch.Tensor:
    hi = _bf16(t)
    return hi + _bf16(t - hi)


def _exact(t: torch.Tensor) -> torch.Tensor:
    return t


# name: the treatment of (P, S, X o decay)
CONFIGS = {
    "all bf16": (_bf16, _bf16, _bf16),
    "S hi/lo": (_bf16, _hilo, _bf16),
    "P hi/lo": (_hilo, _bf16, _bf16),
    "P and S hi/lo (the kernel)": (_hilo, _hilo, _bf16),
    "P, S and X o decay hi/lo (the kernel past 128 columns)": (_hilo, _hilo, _hilo),
    "exact": (_exact, _exact, _exact),
}


def chunked(x, a, b, c, s0, round_p, round_s, round_xd, chunk: int = CHUNK, round_y=_bf16):
    """The kernel's chunked form in f32 on (B, S, H, ...) inputs, with the
    given treatment of its three rounded operands; y rounded to bf16 (by
    ``round_y``: ``_exact`` keeps f32)."""
    xf, af, bf, cf = (t.float().transpose(1, 2) for t in (x, a, b, c))  # (B, H, S, ...)
    state = s0.float().clone()
    S = x.shape[1]
    mask = torch.tril(torch.ones(chunk, chunk, dtype=torch.bool, device=x.device))
    ys = []
    for k in range(0, S, chunk):
        sl = slice(k, k + chunk)
        xq, aq, bq, cq = xf[:, :, sl], af[:, :, sl], bf[:, :, sl], cf[:, :, sl]
        A = torch.cumsum(aq, -1)
        L = torch.exp((A[..., :, None] - A[..., None, :]).masked_fill(~mask, float("-inf")))
        p = round_p(cq @ bq.transpose(-1, -2) * L)
        y_off = torch.exp(A)[..., None] * (cq @ round_s(state).transpose(-1, -2))
        decay = torch.exp(A[..., -1:] - A)
        state = (state * torch.exp(A[..., -1])[..., None, None]
                 + round_xd(xq * decay[..., None]).transpose(-1, -2) @ bq)
        ys.append(p @ xq + y_off)
    return round_y(torch.cat(ys, 2).transpose(1, 2)), state


def inputs(seed: int, device, N: int = SHAPE[4]):
    """mamba2-130m's prefill inputs, B and C one group broadcast over heads."""
    B, S, H, P, _ = SHAPE
    g = torch.Generator(device=device).manual_seed(seed)
    rn = lambda *s: torch.randn(s, generator=g, device=device)  # noqa: E731
    x = (rn(B, S, H, P) * 0.5).bfloat16()
    a = (-rn(B, S, H).abs() * 0.3).bfloat16()
    b = (rn(B, S, 1, N) * 0.5).bfloat16().expand(B, S, H, N)
    c = (rn(B, S, 1, N) * 0.5).bfloat16().expand(B, S, H, N)
    return x, a, b, c, rn(B, H, P, N) * 0.2


def study(seeds: int = 4, device: str = "cpu", N: int = SHAPE[4]) -> list[dict]:
    B, S, H, P, _ = SHAPE
    rows = []
    for seed in range(seeds):
        x, a, b, c, s0 = inputs(seed, device, N)
        flat = lambda t: t.transpose(1, 2).reshape(B * H, S, *t.shape[3:])  # noqa: E731
        y_ref, s_ref = ssd_scan_ref(flat(x), flat(a), flat(b), flat(c), s0.reshape(B * H, P, N))
        y_ref = y_ref.reshape(B, H, S, P).transpose(1, 2).float()
        limit = TOL + TOL * y_ref.abs()
        s_limit = TOL + TOL * s_ref.abs()
        for name, rounding in CONFIGS.items():
            y, state = chunked(x, a, b, c, s0, *rounding)
            err = (y - y_ref).abs()
            s_err = (state.reshape(B * H, P, N) - s_ref).abs()
            rows.append({"seed": seed, "config": name, "violations": int((err > limit).sum()),
                         "worst": (err / limit).max().item(),
                         "state_worst": (s_err / s_limit).max().item()})
            r = rows[-1]
            print(f"[rounding] seed {seed} {name}: y elements past the limit {r['violations']}, "
                  f"worst error / limit {r['worst']:.3f}, state worst error / limit "
                  f"{r['state_worst']:.4f}", flush=True)
    return rows


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, default=4)
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--state", type=int, default=SHAPE[4], help="state width N")
    args = ap.parse_args(argv)
    rows = study(args.seeds, args.device, args.state)
    for name in CONFIGS:
        mine = [r for r in rows if r["config"] == name]
        print(f"[rounding] {name}: {sum(r['violations'] for r in mine)} elements past the limit "
              f"over {args.seeds} seeds, worst error / limit {max(r['worst'] for r in mine):.3f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
