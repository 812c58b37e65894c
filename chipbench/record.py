"""What a finished run hands the metric readers."""

from __future__ import annotations

import dataclasses
from collections import defaultdict, deque
from types import ModuleType
from typing import Any

import numpy as np

from chipbench.adapter import Batch
from chipbench.devtrace import DeviceTrace
from chipbench.loadgen import Request, Traffic, Window


@dataclasses.dataclass
class Run:
    workload: str
    model: dict[str, Any]        # the configuration file's "model"
    dtype: str                   # the served dtype
    traffic: Traffic
    window: Window
    batches: list[Batch]         # every batch the server ran in the window
    setup_s: float
    peak_bytes: int
    trace: DeviceTrace | None = None
    family: ModuleType | None = None   # families/<model["family"]>.py

    @property
    def requests(self) -> list[Request]:
        return self.window.requests

    @property
    def done(self) -> list[Request]:
        return [r for r in self.window.requests if r.ok]

    @property
    def window_s(self) -> float:
        """From the first send to the last reply."""
        return self.window.t_last - self.window.t_first

    def batch_of(self) -> dict[int, Batch]:
        """Each request's batch, matched by its prompt's content (first
        batch first among equal prompts)."""
        queue: dict[bytes, deque] = defaultdict(deque)
        for b in self.batches:
            for c in b.contents:
                queue[c].append(b)
        out = {}
        for r in self.window.requests:
            if queue[r.content]:
                out[r.index] = queue[r.content].popleft()
        return out


def percentile(values: list[float], q: float) -> float | None:
    return float(np.percentile(np.asarray(values, dtype=np.float64), q)) if values else None


def latency_p95_ms(run: Run) -> float | None:
    """The 95th percentile over every request sent in the window."""
    return percentile([r.latency_ms for r in run.done], 95)
