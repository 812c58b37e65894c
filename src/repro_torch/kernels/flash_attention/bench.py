"""Time the flash-attention kernel against another version of its source on the card.

    python -m repro_torch.kernels.flash_attention.bench --against OTHER.cu [--dtype float16]
        [--window 1024]

Builds ``csrc/flash_attention.cu`` and OTHER.cu (the source at another
commit, e.g. ``git show REV:src/repro_torch/kernels/flash_attention/csrc/
flash_attention.cu > OTHER.cu``, or a copy with one line changed), which must
keep its C interface: ``repro_fa_fwd_window``, or in a source from before the
window ``repro_fa_fwd``, the same call without it.  At each prefill of ``PREFILLS``,
on q, k and v as the model's strided views, both must give the same output
bit for bit, and both are timed card only (the card sleeps while the calls
are enqueued) in turns: other, this, this, other, other, this; a shape the
other source refuses (a head dim it has no instance for) is timed on this
one alone.  With ``--window W`` the shapes are ``WINDOWED`` instead, at the
window W; a source from before the window runs its causal call there (what
the layer would cost on it), which is timed but not compared.  Prints one line a shape and
the card's name and power limit; writes the table as JSON to ``--out`` when
given.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

from repro_torch.kernels._nvcc import compile_library
from repro_torch.kernels.flash_attention import kernel

# (B, H, KV, S, hd, causal): the models' serving prefills (qwen2.5-3b,
# hymba-1.5b, kimi-k2, whisper-tiny's encoder and decoder prompt,
# phi4-mini-3.8b, internvl2-2b, starcoder2-15b, granite-20b) and Gemma-2-2B's
# at hd 256
PREFILLS = {
    "qwen2.5-3b": (4, 16, 2, 1024, 128, True),
    "hymba-1.5b": (4, 25, 5, 2048, 64, True),
    "kimi-k2": (4, 64, 8, 1024, 128, True),
    "whisper-tiny encoder": (4, 6, 6, 1500, 64, False),
    "whisper-tiny decoder": (4, 6, 6, 224, 64, True),
    "phi4-mini-3.8b": (4, 24, 8, 1024, 128, True),
    "internvl2-2b": (4, 16, 8, 1024, 128, True),
    "starcoder2-15b": (4, 48, 4, 1024, 128, True),
    "granite-20b": (4, 48, 1, 1024, 128, True),
    "gemma-2-2b hd 256": (4, 8, 4, 1024, 256, True),
}
# (B, H, KV, S, hd): hymba-1.5b's windowed prefill as its benchmark cell runs
# it (chip_smoke.FA_WINDOW), causal, timed at ``--window``
WINDOWED = {"hymba-1.5b windowed": (8, 25, 5, 4096, 64)}
ORDER = ("other", "this", "this", "other", "other", "this")


def _takes_window(lib: ctypes.CDLL) -> bool:
    return hasattr(lib, "repro_fa_fwd_window")


def _load(path: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    args = [vp] * 4 + [i32] * 7 + [i64] * 12 + [ctypes.c_float, i32]
    fn = lib.repro_fa_fwd_window if _takes_window(lib) else lib.repro_fa_fwd
    fn.argtypes = args + ([i32, vp] if _takes_window(lib) else [vp])
    fn.restype = i32
    return lib


def _call(lib: ctypes.CDLL, q, k, v, causal: bool, window: int = 0) -> torch.Tensor:
    """One launch (a library without the window's entry point takes none)."""
    out = torch.empty_like(q)
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            *kernel.kernel_args(q, k, v, out), q.shape[-1] ** -0.5, int(causal))
    stream = torch.cuda.current_stream().cuda_stream
    err = (lib.repro_fa_fwd_window(*args, window, stream) if _takes_window(lib)
           else lib.repro_fa_fwd(*args, stream))
    if err != 0:
        raise RuntimeError(f"flash-attention launch failed ({err})")
    return out


def _card_ms(fn, iters: int) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(50_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def compare(other: Path, dtype: torch.dtype = torch.bfloat16, iters: int = 50,
            window: int = 0) -> list[dict]:
    """Both builds at every prefill (with ``window``, every shape of
    ``WINDOWED`` at it): equal outputs, card-only ms in turns."""
    if not torch.cuda.is_available():
        raise RuntimeError("the comparison needs a CUDA device")
    build = kernel.BUILD_DIR / "against"
    libs = {"this": _load(kernel.build()),
            "other": _load(compile_library(other, build, "fa_other")[0])}
    # the other source's window: this one's where it has the entry point
    windows = {side: window if _takes_window(lib) else 0 for side, lib in libs.items()}
    shapes = ({name: (*dims, True) for name, dims in WINDOWED.items()} if window
              else PREFILLS)
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for name, (B, H, KV, S, hd, causal) in shapes.items():
        randn = lambda *s: torch.randn(s, generator=gen, device="cuda").to(dtype)  # noqa: E731
        q = randn(B, S, KV, H // KV, hd).permute(0, 2, 3, 1, 4).reshape(B, H, S, hd)
        k, v = randn(B, S, KV, hd).transpose(1, 2), randn(B, S, KV, hd).transpose(1, 2)
        call = {side: lambda side=side: _call(libs[side], q, k, v, causal, windows[side])
                for side in libs}
        mine = call["this"]()
        try:
            theirs = call["other"]()
        except RuntimeError:
            theirs = None  # no instance in the other source
        # compared only where both ran the same call
        equal = (torch.equal(mine, theirs) if theirs is not None and windows["other"] == window
                 else None)
        ms = {"this": [], "other": []}
        for side in ORDER:
            if side == "this" or theirs is not None:
                ms[side].append(_card_ms(call[side], iters))
        rows.append({"shape": name, "dims": (B, H, KV, S, hd, causal), "window": windows,
                     "equal": equal, **ms})
        rounded = {side: [round(t, 4) for t in ts] for side, ts in ms.items()}
        print(f"{name} {(B, H, KV, S, hd, causal)} window this {windows['this']} other "
              f"{windows['other']}: equal bit for bit {equal} | card-only ms "
              f"other {rounded['other']} this {rounded['this']}", flush=True)
    return rows


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--against", type=Path, required=True, help="the other flash_attention.cu")
    ap.add_argument("--dtype", choices=("bfloat16", "float16"), default="bfloat16")
    ap.add_argument("--window", type=int, default=0,
                    help="time the windowed prefills (WINDOWED) at this window instead")
    ap.add_argument("--out", type=Path, help="write the table as JSON here")
    args = ap.parse_args(argv)
    rows = compare(args.against, getattr(torch, args.dtype), window=args.window)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    print(card)
    if args.out:
        args.out.write_text(json.dumps({"card": card, "dtype": args.dtype, "rows": rows}, indent=1))
    return 0 if all(r["equal"] is not False for r in rows) else 1


if __name__ == "__main__":
    sys.exit(main())
