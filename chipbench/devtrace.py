"""The device trace of a ``--trace 1`` run, read from ``torch.profiler``.

The profiler records CUDA activity only (kernels, copies, sets and the
runtime calls that launched them), which keeps a window of hundreds of
thousands of launches cheap to read: the raw Kineto events are read once
into arrays, never built into the profiler's event tree.  Times are
nanoseconds on the profiler's clock, which is the Unix clock
(``time.time_ns``); the harness's spans are moved onto it by one offset.
"""

from __future__ import annotations

import dataclasses
from collections import defaultdict
from typing import Any

import numpy as np


@dataclasses.dataclass
class DeviceTrace:
    op_names: list[str]
    op_start: np.ndarray      # int64 ns
    op_end: np.ndarray
    call_names: list[str]     # host runtime calls (cudaLaunchKernel, ...)
    call_start: np.ndarray
    call_end: np.ndarray
    t0: int                   # the traced window, ns
    t1: int

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e9

    def busy(self) -> tuple[np.ndarray, np.ndarray]:
        """The union of the device's op intervals inside the window."""
        s = np.clip(self.op_start, self.t0, self.t1)
        e = np.clip(self.op_end, self.t0, self.t1)
        keep = e > s
        s, e = s[keep], e[keep]
        if not len(s):
            return s, e
        order = np.argsort(s, kind="stable")
        s, e = s[order], np.maximum.accumulate(e[order])
        new = np.ones(len(s), dtype=bool)
        new[1:] = s[1:] > e[:-1]
        starts = s[new]
        ends = np.maximum.reduceat(e, np.flatnonzero(new))
        return starts, ends

    def share_inside(self, spans: list[tuple[int, int]]) -> float | None:
        """Share of the device's busy time inside the host's ``spans``: near
        1 where the two clocks agree and the batches hold all the work."""
        s, e = self.busy()
        total = float((e - s).sum())
        if total <= 0 or not spans:
            return None
        starts = np.array([a for a, _ in spans], dtype=np.int64)
        ends = np.array([b for _, b in spans], dtype=np.int64)
        return float(_overlap(s, e, starts, ends).sum()) / total

    def busy_s(self) -> float:
        s, e = self.busy()
        return float((e - s).sum()) / 1e9

    def op_seconds(self, match: tuple[str, ...]) -> float:
        """Device seconds of the ops whose name contains any of ``match``,
        inside the window."""
        s = np.clip(self.op_start, self.t0, self.t1)
        e = np.clip(self.op_end, self.t0, self.t1)
        total = 0
        for i, name in enumerate(self.op_names):
            if any(m in name for m in match):
                total += max(0, int(e[i] - s[i]))
        return total / 1e9

    def top_ops(self, n: int = 10) -> list[list[Any]]:
        by_name: dict[str, int] = defaultdict(int)
        dur = np.clip(self.op_end, self.t0, self.t1) - np.clip(self.op_start, self.t0, self.t1)
        for name, d in zip(self.op_names, dur.tolist()):
            if d > 0:
                by_name[_short(name)] += d
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:n]
        return [[name, ns / 1e9] for name, ns in top]

    def idle_gaps(self, phases: list[tuple[str, int, int]], n: int = 10) -> list[list[Any]]:
        """The device's idle time inside the window, by the host's phase at
        the gap and the runtime call the host was in (or none), longest
        first.  ``phases``: (name, start ns, end ns), sorted; time outside
        them is ``between_batches``."""
        s, e = self.busy()
        g0 = np.concatenate([[self.t0], e])
        g1 = np.concatenate([s, [self.t1]])
        keep = g1 > g0
        g0, g1 = g0[keep], g1[keep]
        if not len(g0):
            return []
        mid = (g0 + g1) // 2
        labels = np.array([p[0] for p in phases] + ["between_batches"])
        if phases:
            p_start = np.array([p[1] for p in phases], dtype=np.int64)
            p_end = np.array([p[2] for p in phases], dtype=np.int64)
            k = np.searchsorted(p_start, mid, side="right") - 1
            kk = np.clip(k, 0, None)
            inside = (k >= 0) & (mid < p_end[kk])
            phase_names = labels[np.where(inside, kk, len(phases))]
        else:
            phase_names = np.full(len(mid), "between_batches")
        out: dict[str, float] = defaultdict(float)
        in_calls = np.zeros(len(g0), dtype=np.float64)
        call_names = np.asarray(self.call_names)
        for call in sorted(set(self.call_names)):
            sel = call_names == call
            ov = _overlap(g0, g1, self.call_start[sel], self.call_end[sel])
            in_calls += ov
            for ph in np.unique(phase_names):
                t = float(ov[phase_names == ph].sum())
                if t > 0:
                    out[f"{ph}: {call}"] += t / 1e9
        rest = np.clip((g1 - g0) - in_calls, 0, None)
        for ph in np.unique(phase_names):
            t = float(rest[phase_names == ph].sum())
            if t > 0:
                out[f"{ph}: host (no CUDA call)"] += t / 1e9
        top = sorted(out.items(), key=lambda kv: -kv[1])[:n]
        return [[name, sec] for name, sec in top]


def _short(name: str, n: int = 96) -> str:
    return name if len(name) <= n else name[:n]


def _covered(t: np.ndarray, starts: np.ndarray, ends: np.ndarray, cum: np.ndarray) -> np.ndarray:
    """Time of the (disjoint, sorted) intervals before each t."""
    k = np.searchsorted(starts, t, side="right") - 1
    kk = np.clip(k, 0, None)
    part = np.clip(np.minimum(t, ends[kk]) - starts[kk], 0, None)
    return np.where(k >= 0, cum[kk] + part, 0)


def _overlap(g0, g1, starts, ends) -> np.ndarray:
    """Per gap [g0, g1), its overlap with the union of [starts, ends)."""
    if not len(starts):
        return np.zeros(len(g0))
    order = np.argsort(starts, kind="stable")
    s, e = starts[order], np.maximum.accumulate(ends[order])
    new = np.ones(len(s), dtype=bool)
    new[1:] = s[1:] > e[:-1]
    us = s[new]
    ue = np.maximum.reduceat(e, np.flatnonzero(new))
    cum = np.concatenate([[0], np.cumsum(ue - us)[:-1]])
    return (_covered(g1, us, ue, cum) - _covered(g0, us, ue, cum)).astype(np.float64)


def collect(prof: Any, t0_ns: int, t1_ns: int) -> DeviceTrace:
    """Read the finished profiler's raw events (``prof`` is a stopped
    ``torch.profiler.profile``)."""
    from torch.autograd import DeviceType

    results = prof.profiler.kineto_results
    op_names, op_s, op_e, call_names, call_s, call_e = [], [], [], [], [], []
    for ev in results.events():
        start = ev.start_ns() if hasattr(ev, "start_ns") else ev.start_us() * 1000
        dur = ev.duration_ns() if hasattr(ev, "duration_ns") else ev.duration_us() * 1000
        name = ev.name()
        if ev.device_type() == DeviceType.CUDA:
            op_names.append(name)
            op_s.append(start)
            op_e.append(start + dur)
        elif name.startswith(("cuda", "cu")):
            call_names.append(name)
            call_s.append(start)
            call_e.append(start + dur)
    i64 = lambda xs: np.asarray(xs, dtype=np.int64)  # noqa: E731
    return DeviceTrace(op_names, i64(op_s), i64(op_e), call_names, i64(call_s), i64(call_e),
                       int(t0_ns), int(t1_ns))
