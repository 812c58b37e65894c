"""Worker-side dependency prefetch: overlap fetch with compute.

The paper's pass-by-reference claim is that data resolution decouples
from task dispatch.  Until now our workers resolved dependencies
*synchronously at task start*, so executor threads stalled on the wire
exactly where deferred resolution should let fetch overlap compute.
Two pieces fix that:

``SingleFlight``
    A per-key fetch deduplicator.  N concurrent resolvers of the same
    key (eight queued tasks sharing one broadcast dep, or an executor
    racing the prefetcher) collapse onto one wire transfer: the first
    caller leads and actually fetches, the rest block on the flight and
    share its result (or its exception).  The flight is removed from
    the table *before* followers wake, so a retry after a failed flight
    starts a fresh fetch rather than re-observing the stale error.

``Prefetcher``
    A small background pool owned by each worker.  Whenever the local
    ready queue is non-empty it walks the first ``depth`` queued task
    payloads and resolves their not-yet-cached dependencies through the
    worker's normal ``_fetch_remote`` chain (shm -> peer -> store), via
    the shared ``SingleFlight`` table so it never duplicates an
    executor's fetch.  Pressure-safe by construction: under a memory
    budget it only issues a fetch when the blob's advertised size still
    fits strictly below the worker's pause threshold -- prefetch yields
    to pressure, it never creates it.  Fetches it leads are marked on
    the worker so executor-side cache hits count as ``prefetch_hits``
    and bytes prefetched for tasks that never run here (stolen or
    cancelled) count as ``prefetch_wasted_bytes``.
"""

from __future__ import annotations

import threading
from typing import Any, Callable

__all__ = ["SingleFlight", "Prefetcher"]


class _Flight:
    __slots__ = ("event", "result", "exc", "origin")

    def __init__(self, origin: str):
        self.event = threading.Event()
        self.result: Any = None
        self.exc: BaseException | None = None
        self.origin = origin


class SingleFlight:
    """Per-key fetch dedup: concurrent same-key calls share one fetch.

    ``run(key, fn, origin=...)`` returns ``(result, led, leader_origin)``
    where ``led`` says whether *this* call performed the fetch and
    ``leader_origin`` is the origin tag of whoever did (so an executor
    joining a prefetch-led flight can be counted as a prefetch hit).
    A failed flight re-raises the leader's exception in every follower.
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._flights: dict[str, _Flight] = {}

    def run(
        self, key: str, fn: Callable[[], Any], *, origin: str = "task"
    ) -> tuple[Any, bool, str]:
        with self._lock:
            flight = self._flights.get(key)
            if flight is not None:
                leader = False
            else:
                flight = _Flight(origin)
                self._flights[key] = flight
                leader = True
        if not leader:
            flight.event.wait()
            if flight.exc is not None:
                raise flight.exc
            return flight.result, False, flight.origin
        try:
            flight.result = fn()
            return flight.result, True, origin
        except BaseException as exc:
            flight.exc = exc
            raise
        finally:
            # Deregister *before* waking followers: a caller that retries
            # after this flight failed must start a fresh fetch, not join
            # the dead one.
            with self._lock:
                self._flights.pop(key, None)
            flight.event.set()

    def inflight(self) -> int:
        with self._lock:
            return len(self._flights)


class Prefetcher:
    """Background dependency resolver for queued-but-not-running tasks.

    Reads the worker's local ready queue under its queue lock, picks the
    first not-inline / not-cached / not-already-requested dependency
    among the first ``depth`` queued payloads, and pulls it through the
    worker's ``_fetch_remote`` chain inside the shared single-flight
    table.  Stops issuing (and counts ``throttled``) whenever the
    worker is paused or the blob would push managed bytes to the pause
    threshold.
    """

    def __init__(self, worker: Any, *, depth: int, flights: SingleFlight):
        self.worker = worker
        self.depth = max(1, depth)
        self.flights = flights
        self._stop = threading.Event()
        self._lock = threading.Lock()
        #: Keys a prefetch thread is currently working on -- scan skips
        #: them so the pool doesn't converge on one hot dep.
        self._requested: set[str] = set()
        self.issued = 0
        self.bytes_fetched = 0
        self.throttled = 0
        self.errors = 0
        self._threads: list[threading.Thread] = []

    def start(self) -> "Prefetcher":
        for i in range(min(2, self.depth)):
            t = threading.Thread(
                target=self._loop,
                daemon=True,
                name=f"{self.worker.worker_id}-prefetch-{i}",
            )
            t.start()
            self._threads.append(t)
        return self

    def stop(self) -> None:
        self._stop.set()
        with self.worker._pcv:
            self.worker._pcv.notify_all()

    def snapshot(self) -> dict[str, int]:
        with self._lock:
            return {
                "prefetch_issued": self.issued,
                "prefetch_bytes": self.bytes_fetched,
                "prefetch_throttled": self.throttled,
                "prefetch_errors": self.errors,
            }

    # -- internals ----------------------------------------------------------

    def _next_job(self) -> tuple[str, dict[str, Any], int] | None:
        """Pick the next prefetchable dependency, or None.

        Claims the key in ``_requested`` before returning so concurrent
        pool threads pick distinct deps.
        """
        w = self.worker
        paused = w.state == "paused"
        with w._pcv:
            queued = list(w._pending)[: self.depth]
        if not queued:
            return None
        for payload in queued:
            dep_info = payload.get("dep_info") or {}
            inline_deps = payload.get("inline_deps") or {}
            for dep in payload.get("deps") or ():
                if inline_deps.get(dep) is not None or dep in w.cache:
                    continue
                with self._lock:
                    if dep in self._requested:
                        continue
                info = dep_info.get(dep) or {}
                nbytes = int(info.get("nbytes") or 0)
                if w.memory_limit is not None:
                    # Strict pressure guard: only fetch blobs of known size
                    # that leave managed bytes *below* the pause threshold.
                    # Prefetch yields to pressure; it never triggers it.
                    if (
                        paused
                        or nbytes <= 0
                        or w.managed_bytes() + nbytes >= w._pause_bytes
                    ):
                        with self._lock:
                            self.throttled += 1
                        continue
                with self._lock:
                    if dep in self._requested:
                        continue
                    self._requested.add(dep)
                return dep, info, nbytes
        return None

    def _loop(self) -> None:
        w = self.worker
        while not self._stop.is_set():
            job = self._next_job()
            if job is None:
                with w._pcv:
                    if not self._stop.is_set():
                        w._pcv.wait(timeout=0.1)
                continue
            key, info, nbytes = job
            try:
                _, led, _ = self.flights.run(
                    key,
                    lambda: w._fetch_remote(key, info),
                    origin="prefetch",
                )
                if led:
                    with self._lock:
                        self.issued += 1
                        self.bytes_fetched += max(0, nbytes)
                    w._mark_prefetched(key, nbytes)
            except Exception:
                # The executor path retries and reports the authoritative
                # MissingDependencyError; a failed prefetch is just a miss.
                with self._lock:
                    self.errors += 1
            finally:
                with self._lock:
                    self._requested.discard(key)
