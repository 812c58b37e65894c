"""Compare the fingerprint kernel's TMA box layouts and ring depths on the card.

    python -m repro_torch.kernels.fingerprint.bench [--mib 3096] [--out FILE]

Fingerprints one buffer of random bytes (by default the size of
qwen2.5-3b's f32 (36, 2048, 11008) MLP stack) with every layout of
``VARIANTS``, each timed with CUDA events over a few calls, and the
register-ring route on a view 4 bytes off the buffer's start.  Every
layout must give the default layout's token.  Prints one line a layout,
the card's name and power limit, and writes the table as JSON to ``--out``
when given.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

import torch

from repro_torch.kernels.fingerprint import kernel

# (lanes a CTA, blocks a stage, stages in flight): 32 SMs of one 128-byte
# column each, against 64 and 128 SMs of narrower columns, at several depths,
# with stages of one box (up to 256 blocks) or of several
VARIANTS = [
    (32, 256, 2), (32, 256, 4), (32, 128, 8), (32, 512, 2), (32, 512, 3), (32, 1024, 1),
    (16, 256, 4), (16, 1024, 3), (8, 256, 8), (8, 1024, 6), (8, 2048, 3),
]
MLP_STACK_BYTES = 36 * 2048 * 11008 * 4


def _time_ms(fn, iters: int) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _sm_clock_hz() -> float:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60)
    return float(res.stdout.strip().splitlines()[0]) * 1e6


def compare_layouts(nbytes: int = MLP_STACK_BYTES, iters: int = 5) -> list[dict]:
    """Time every layout of ``VARIANTS`` and the ring route on one buffer."""
    if not torch.cuda.is_available():
        raise RuntimeError("the layout comparison needs a CUDA device")
    data = torch.randint(0, 256, (nbytes + 16,), dtype=torch.uint8, device="cuda",
                         generator=torch.Generator(device="cuda").manual_seed(0))
    aligned = data[:nbytes]
    want = kernel.fingerprint_fwd(aligned).tolist()
    blocks = -(-nbytes // kernel.BLOCK_BYTES)
    clock = _sm_clock_hz()
    rows = []
    for lanes, box_rows, stages in VARIANTS:
        kw = {"lanes": lanes, "rows": box_rows, "stages": stages}
        if kernel.fingerprint_fwd(aligned, **kw).tolist() != want:
            raise RuntimeError(f"layout {kw} gives another token")
        ms = _time_ms(lambda: kernel.fingerprint_fwd(aligned, **kw), iters)
        geo = kernel.tma_geometry(nbytes, **kw)
        rows.append({"route": "tma", **kw, "ctas": geo["grid"],
                     "in_flight_bytes": geo["grid"] * stages * geo["stage_bytes"], "ms": ms})
    ring_view = data[4:4 + nbytes]
    assert kernel.route(ring_view) == "ring"
    rows.append({"route": "ring", "lanes": 32, "rows": None, "stages": None, "ctas": 32,
                 "in_flight_bytes": 1024 * 64 * 4,
                 "ms": _time_ms(lambda: kernel.fingerprint_fwd(ring_view), iters)})
    for r in rows:
        r["gb_s"] = nbytes / r["ms"] / 1e6
        r["cycles_per_step"] = r["ms"] * 1e-3 * clock / blocks
    return rows


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mib", type=float, default=MLP_STACK_BYTES / 2**20)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    nbytes = int(args.mib * 2**20)
    rows = compare_layouts(nbytes)
    for r in rows:
        print(f"[fp-bench] {r['route']} lanes {r['lanes']} rows {r['rows']} stages {r['stages']} "
              f"({r['ctas']} CTAs, {r['in_flight_bytes']:,} B in flight): {r['ms']:.4f} ms, "
              f"{r['gb_s']:.1f} GB/s, {r['cycles_per_step']:.2f} cycles a chain step")
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"[fp-bench] {nbytes:,} B on {gpu}")
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"bytes": nbytes, "gpu": gpu, "layouts": rows}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
