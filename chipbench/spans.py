"""The program's own spans, as the per-layer metrics read them.

``repro_torch.runtime.trace`` records spans while the traced run's profiler
is on.  A reader takes the tracer module the run has already loaded: a
program without it records none, and its metrics are left out of the line.
Only the spans that lie inside the window count, ``[t_first, t_last]``:
the spans' ``perf_counter_ns`` stamps are compared with the window's
``perf_counter`` seconds directly.  The device trace is met on the Unix
clock, through the tracer's own offset (``to_unix_ns``).
"""

from __future__ import annotations

import sys
from typing import Any

import numpy as np

#: the program's tracer, by module name
TRACER = "repro_torch.runtime.trace"
#: host runtime calls that put work on the device's queue (name prefixes)
ENQUEUE_CALLS = ("cudaLaunchKernel", "cuLaunchKernel", "cudaMemcpyAsync", "cudaMemsetAsync")


def tracer() -> Any:
    """The tracer module the run loaded, or None."""
    return sys.modules.get(TRACER)


def in_window(run: Any, name: str | None = None) -> list[Any]:
    """The window's spans (of ``name`` only), in the order they ended."""
    mod = tracer()
    if mod is None:
        return []
    t0, t1 = int(run.window.t_first * 1e9), int(run.window.t_last * 1e9)
    return [s for s in mod.spans(name) if t0 <= s.t0 and s.t1 <= t1]


def prefills(run: Any) -> list[tuple[Any, int, list[Any]]]:
    """Each ``prefill`` span in the window with the rows its batch held and
    the spans it encloses; a prefill no batch of the run holds is left out."""
    mod = tracer()
    if mod is None:
        return []
    spans = mod.spans()
    t0, t1 = int(run.window.t_first * 1e9), int(run.window.t_last * 1e9)
    roots = {s.id: s for s in spans if s.name == "prefill" and t0 <= s.t0 and s.t1 <= t1}
    parent = {s.id: s.parent for s in spans}
    under: dict[int, list[Any]] = {i: [] for i in roots}
    for s in spans:
        p = s.parent
        while p is not None and p not in roots:
            p = parent.get(p)
        if p is not None:
            under[p].append(s)
    out = []
    for i, root in roots.items():
        rows = _rows(run, root)
        if rows:
            out.append((root, rows, under[i]))
    return out


def _rows(run: Any, span: Any) -> int:
    """The rows of the batch whose prefill the span lies in (0: none)."""
    t = span.t0 / 1e9
    for b in run.batches:
        if b.t_prefill <= t <= b.t_prefilled:
            return b.rows
    return 0


def device_ms(spans: list[Any]) -> float | None:
    """The spans' summed device time; None if any lacks it (a CPU run)."""
    total = 0.0
    for s in spans:
        ms = s.device_ms()
        if ms is None:
            return None
        total += ms
    return total


def enqueue_calls_in(trace: Any, spans: list[Any]) -> int | None:
    """Runtime calls of the device trace that enqueue work and start inside
    one of the spans; None where the trace has no such call at all."""
    names = np.asarray(trace.call_names, dtype=object)
    keep = np.fromiter((str(n).startswith(ENQUEUE_CALLS) for n in names), dtype=bool,
                       count=len(names))
    if not keep.any():
        return None
    starts = np.sort(trace.call_start[keep])
    to_unix = tracer().to_unix_ns
    a = np.array([to_unix(s.t0) for s in spans], dtype=np.int64)
    b = np.array([to_unix(s.t1) for s in spans], dtype=np.int64)
    return int((np.searchsorted(starts, b, side="left")
                - np.searchsorted(starts, a, side="left")).sum())
