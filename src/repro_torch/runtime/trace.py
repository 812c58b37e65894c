"""Spans and counters of the port, on the clock of ``torch.profiler``.

A span is one timed region of the program: a name, start and end on
``time.perf_counter_ns()``, its own id, the id of the span that encloses it
on the same thread, the thread, and a few attributes.  A span opened with
``device=True`` also records a ``torch.cuda.Event`` pair on the current
stream (none while the stream is capturing a graph), and the spans it
encloses do too unless they say otherwise; their device time is read after
the work, never by a synchronize inside it.  A span opened with
``cpu=True`` also records the thread's CPU time (``time.thread_time_ns``)
at entry and exit, read inside its host interval, so that a short span's
CPU time does not exceed its host time by the reads themselves.

Spans record only while a ``torch.profiler`` session is active, or between
``enable()`` and ``disable()``; otherwise ``span`` returns one shared object
that does nothing, after a flag check.  Counters (``count``) are always on.

Recorded spans are kept in memory, at most ``cap`` of them; later ones are
dropped and counted.  ``summary()`` sums them by name; ``export_chrome(path)``
writes them as Chrome-trace JSON on the Unix clock (``to_unix_ns``), which
is the clock of the profiler's device trace, so that a span can be laid over
the device's ops and the runtime calls that launched them.

The process's tracer is ``TRACER``; the module's functions are its methods.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import threading
import time
from collections import defaultdict
from typing import Any, Iterator

import torch

# ``_profiler._is_profiler_enabled`` says whether a ``torch.profiler`` session
# is active in this process.  It is process-wide; the C++ check
# ``torch._C._autograd._profiler_enabled()`` reads the calling thread's state
# only, which a thread started before the session (a server's batcher) never
# sees.
from torch.autograd import profiler as _profiler

#: spans a tracer keeps by default
CAP = 1 << 19
#: perf_counter_ns() + UNIX_OFFSET_NS is time.time_ns(), the profiler's clock
UNIX_OFFSET_NS = time.time_ns() - time.perf_counter_ns()


def to_unix_ns(t_ns: int) -> int:
    """A ``perf_counter_ns`` stamp on the Unix clock."""
    return t_ns + UNIX_OFFSET_NS


class Span:
    """One recorded region; made by :meth:`Tracer.span` and used as a
    context manager, or finished at once by :meth:`Tracer.add`."""

    __slots__ = ("tracer", "name", "id", "parent", "thread", "attrs", "device", "cpu",
                 "t0", "t1", "cpu0", "cpu1", "_events")

    def __init__(self, tracer: "Tracer", name: str, device: bool | None, cpu: bool,
                 attrs: dict[str, Any]):
        self.tracer = tracer
        self.name = name
        self.id = next(tracer._ids)
        self.parent: int | None = None
        self.attrs = attrs
        self.device = device
        self.cpu = cpu
        self.cpu0 = self.cpu1 = self._events = None

    def __enter__(self) -> "Span":
        local = self.tracer._local
        stack = local.stack
        self.thread = local.ident
        if stack:
            top = stack[-1]
            self.parent = top.id
            if self.device is None:
                self.device = top.device
        elif self.device is None:
            self.device = False
        if self.device and torch.cuda.is_initialized() \
                and not torch.cuda.is_current_stream_capturing():
            start = torch.cuda.Event(enable_timing=True)
            start.record()
            self._events = [start, None]
        stack.append(self)
        self.t0 = time.perf_counter_ns()
        if self.cpu:
            self.cpu0 = time.thread_time_ns()
        return self

    def __exit__(self, *exc: Any) -> None:
        if self.cpu:
            self.cpu1 = time.thread_time_ns()
        self.t1 = time.perf_counter_ns()
        if self._events is not None and not torch.cuda.is_current_stream_capturing():
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            self._events[1] = end
        self.tracer._local.stack.pop()
        self.tracer._keep(self)

    @property
    def host_ms(self) -> float:
        return (self.t1 - self.t0) / 1e6

    @property
    def cpu_ms(self) -> float | None:
        """The thread's CPU time inside the span (``cpu=True`` spans)."""
        if self.cpu0 is None or self.cpu1 is None:
            return None
        return (self.cpu1 - self.cpu0) / 1e6

    def device_ms(self) -> float | None:
        """Device time between the span's two events; None without them.
        Waits for the end event: call it after the work, not inside it."""
        ev = self._events
        if ev is None or ev[1] is None:
            return None
        ev[1].synchronize()
        return ev[0].elapsed_time(ev[1])

    def __repr__(self) -> str:
        return (f"Span({self.name!r}, id={self.id}, parent={self.parent}, "
                f"host_ms={self.host_ms:.3f}, attrs={self.attrs})")


class _Local(threading.local):
    """A thread's open spans and its ident."""

    def __init__(self) -> None:
        self.stack: list[Span] = []
        self.ident = threading.get_ident()


class _Off:
    """What ``span`` returns while nothing records: one shared object."""

    __slots__ = ()

    def __enter__(self) -> None:
        return None

    def __exit__(self, *exc: Any) -> None:
        return None


_OFF = _Off()


class Tracer:
    def __init__(self, cap: int = CAP):
        self.cap = int(cap)
        self.dropped = 0
        self._spans: list[Span] = []
        self._forced = 0
        self._ids = itertools.count(1)
        self._local = _Local()
        self._counts: dict[str, int] = {}
        self._lock = threading.Lock()

    # -- recording -------------------------------------------------------------

    def recording(self) -> bool:
        return self._forced > 0 or _profiler._is_profiler_enabled

    def enable(self) -> None:
        """Record spans whether or not a profiler session is active (until
        as many ``disable()`` calls)."""
        with self._lock:
            self._forced += 1

    def disable(self) -> None:
        with self._lock:
            self._forced = max(0, self._forced - 1)

    @contextlib.contextmanager
    def enabled(self) -> Iterator["Tracer"]:
        self.enable()
        try:
            yield self
        finally:
            self.disable()

    def span(self, name: str, *, device: bool | None = None, cpu: bool = False,
             **attrs: Any) -> Span | _Off:
        """A context manager that records the region it encloses while the
        tracer records; ``device=None`` takes the enclosing span's choice."""
        if not (self._forced or _profiler._is_profiler_enabled):
            return _OFF
        return Span(self, name, device, cpu, attrs)

    def add(self, name: str, t0_ns: int, t1_ns: int, **attrs: Any) -> None:
        """Record a finished span from two ``perf_counter_ns`` stamps (a
        region that starts on one thread and ends on another); it has no
        parent."""
        if not (self._forced or _profiler._is_profiler_enabled):
            return
        s = Span(self, name, False, False, attrs)
        s.thread, s.t0, s.t1 = self._local.ident, t0_ns, t1_ns
        self._keep(s)

    def _keep(self, s: Span) -> None:
        # under the interpreter lock: a race at the cap keeps a span or two
        # more, never loses one below it
        if len(self._spans) < self.cap:
            self._spans.append(s)
        else:
            self.dropped += 1

    def spans(self, name: str | None = None) -> list[Span]:
        """The kept spans in the order they ended (those of ``name`` only)."""
        with self._lock:
            kept = list(self._spans)
        return kept if name is None else [s for s in kept if s.name == name]

    # -- counters --------------------------------------------------------------

    def count(self, name: str, n: int = 1) -> None:
        with self._lock:
            self._counts[name] = self._counts.get(name, 0) + n

    def counter(self, name: str) -> int:
        return self._counts.get(name, 0)

    def counts(self) -> dict[str, int]:
        with self._lock:
            return dict(self._counts)

    def reset_counts(self, *names: str) -> None:
        """Set the named counters to 0 (every counter without names)."""
        with self._lock:
            if not names:
                self._counts.clear()
            for name in names:
                self._counts.pop(name, None)

    # -- reading ---------------------------------------------------------------

    def summary(self, spans: list[Span] | None = None) -> dict[str, dict[str, Any]]:
        """Per span name: its count, host ms, self ms (each span's duration
        less what its children cover), device ms and CPU ms (None where no
        span of the name recorded them)."""
        spans = self.spans() if spans is None else spans
        covered: dict[int, int] = defaultdict(int)
        for s in spans:
            if s.parent is not None:
                covered[s.parent] += s.t1 - s.t0
        out: dict[str, dict[str, Any]] = {}
        for s in spans:
            row = out.setdefault(s.name, {"count": 0, "host_ms": 0.0, "self_ms": 0.0,
                                          "device_ms": None, "cpu_ms": None})
            d = s.t1 - s.t0
            row["count"] += 1
            row["host_ms"] += d / 1e6
            row["self_ms"] += max(0, d - covered[s.id]) / 1e6
            for key, value in (("device_ms", s.device_ms()), ("cpu_ms", s.cpu_ms)):
                if value is not None:
                    row[key] = (row[key] or 0.0) + value
        return out

    def export_chrome(self, path: str, spans: list[Span] | None = None) -> None:
        """Chrome-trace JSON (complete events, microseconds on the Unix
        clock); a span's attributes, ids, device and CPU ms go in its args."""
        spans = self.spans() if spans is None else spans
        pid = os.getpid()
        events: list[dict[str, Any]] = [
            {"name": "thread_name", "ph": "M", "pid": pid, "tid": t.ident,
             "args": {"name": t.name}} for t in threading.enumerate()]
        for s in spans:
            args = dict(s.attrs, id=s.id, parent=s.parent)
            dev, cpu = s.device_ms(), s.cpu_ms
            if dev is not None:
                args["device_ms"] = dev
            if cpu is not None:
                args["cpu_ms"] = cpu
            events.append({"name": s.name, "ph": "X", "pid": pid, "tid": s.thread,
                           "ts": to_unix_ns(s.t0) / 1e3, "dur": (s.t1 - s.t0) / 1e3,
                           "args": args})
        with open(path, "w") as f:
            json.dump({"traceEvents": events, "displayTimeUnit": "ms",
                       "otherData": {"counts": self.counts(), "dropped": self.dropped}},
                      f, default=str)


TRACER = Tracer()

recording = TRACER.recording
enable = TRACER.enable
disable = TRACER.disable
enabled = TRACER.enabled
span = TRACER.span
add = TRACER.add
spans = TRACER.spans
count = TRACER.count
counter = TRACER.counter
counts = TRACER.counts
reset_counts = TRACER.reset_counts
summary = TRACER.summary
export_chrome = TRACER.export_chrome
