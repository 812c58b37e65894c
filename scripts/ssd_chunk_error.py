"""How far the SSD scan's float32 forms lie from a float64 run, on the CPU.

    JAX_PLATFORMS=cpu PYTHONPATH=src python scripts/ssd_chunk_error.py

Three yardsticks for K2 at a chunk of 512, each printed as the max abs
error over y and the final state and the relative L2 error of y:

1. the JAX package's ``ssd_scan`` (Pallas, interpret mode) at chunk 512
   against itself at chunk 128 and against a float64 sequential recurrence,
   at a ragged S = 600 (states of 16 and 320 columns);
2. the port's plain version (``ssd_ops.ssd_scan`` on CPU tensors, the
   sequential recurrence) at chunk 512 against chunk 128: it has no chunks;
3. at mamba2-130m's serving prefill cut to batch 1 (1024 steps, 24 heads,
   P = 64, N = 128, B and C broadcast over heads, the inputs scaled as
   ``chip_smoke`` scales them), the sequential recurrence in float32 and the
   chunked form in float32 (``rounding.chunked``, no rounding: the
   arithmetic the kernel runs) at chunks 128 and 512, each against the
   float64 recurrence.  The CUDA kernel runs a chunk of 512 as four
   sub-chunks of 128.
"""

from __future__ import annotations

import numpy as np
import torch

torch.set_num_threads(4)


def _errors(y, s, y64, s64) -> str:
    dy = (y.double() - y64).abs().max().item()
    ds = (s.double() - s64).abs().max().item()
    l2 = ((y.double() - y64).norm() / y64.norm()).item()
    return f"max abs {max(dy, ds):.4e} (y {dy:.4e}, state {ds:.4e}) | y rel L2 {l2:.4e}"


def reference_chunks() -> None:
    import jax.numpy as jnp

    from repro.kernels.ssd_scan.ops import ssd_scan as jax_scan
    from repro_torch.kernels.ssd_scan import ops as ssd_ops

    for N in (16, 320):
        B, S, H, P = 1, 600, 2, 16
        rng = np.random.default_rng(8)
        arrs = [rng.normal(size=(B, S, H, P)) * 0.5, -np.abs(rng.normal(size=(B, S, H))) * 0.3,
                rng.normal(size=(B, S, H, N)) * 0.5, rng.normal(size=(B, S, H, N)) * 0.5,
                rng.normal(size=(B, H, P, N)) * 0.2]
        f32 = [v.astype(np.float32) for v in arrs]  # every run reads these values
        y64, s64 = ssd_ops.ssd_scan(*(torch.from_numpy(v).double() for v in f32), chunk=128)
        t32 = [torch.from_numpy(v) for v in f32]
        j32 = [jnp.asarray(v) for v in f32]
        out = {ch: [torch.from_numpy(np.asarray(r)) for r in jax_scan(*j32, chunk=ch)]
               for ch in (128, 512)}
        shape = (B, S, H, P, N)
        print(f"[jax] {shape} chunk 512 vs chunk 128: "
              f"{_errors(*out[512], out[128][0].double(), out[128][1].double())}")
        for ch in (128, 512):
            print(f"[jax] {shape} chunk {ch} vs float64: {_errors(*out[ch], y64, s64)}")
        plain = {ch: ssd_ops.ssd_scan(*t32, chunk=ch) for ch in (128, 512)}
        same = all(torch.equal(a, b) for a, b in zip(plain[128], plain[512]))
        print(f"[port plain] {shape} chunk 512 equal to chunk 128 bit for bit: {same}; "
              f"vs float64: {_errors(*plain[512], y64, s64)}")


def model_shape() -> None:
    from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref
    from repro_torch.kernels.ssd_scan.rounding import CONFIGS, chunked

    B, S, H, P, N = 1, 1024, 24, 64, 128
    g = torch.Generator().manual_seed(0)
    rn = lambda *s: torch.randn(s, generator=g)  # noqa: E731
    x, a = rn(B, S, H, P) * 0.5, -rn(B, S, H).abs() * 0.3
    conv = rn(B, S, 2 * N) * 0.5
    b, c = (conv[:, :, None, i * N:(i + 1) * N].expand(B, S, H, N) for i in (0, 1))
    s0 = rn(B, H, P, N) * 0.2

    def seq(dtype):
        flat = lambda t: t.to(dtype).transpose(1, 2).reshape(B * H, S, *t.shape[3:])  # noqa: E731
        y, s = ssd_scan_ref(flat(x), flat(a), flat(b), flat(c), s0.to(dtype).reshape(B * H, P, N))
        return y.reshape(B, H, S, P).transpose(1, 2), s.reshape(B, H, P, N)

    y64, s64 = seq(torch.float64)
    shape = (B, S, H, P, N)
    seq32 = seq(torch.float32)
    print(f"[plain] {shape} sequential float32 vs float64: {_errors(*seq32, y64, s64)}")
    exact = CONFIGS["exact"]
    for ch in (128, 512):
        got = chunked(x, a, b, c, s0, *exact, chunk=ch, round_y=exact[0])
        print(f"[plain] {shape} chunked float32 at chunk {ch} vs float64: "
              f"{_errors(*got, y64, s64)}")


if __name__ == "__main__":
    reference_chunks()
    model_shape()
