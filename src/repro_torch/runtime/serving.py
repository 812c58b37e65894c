"""Continuous-batching model serving on top of the streaming data plane.

A :class:`ModelServer` turns a single batched forward function into a
request/response service: requests land in a bounded admission queue, a
batcher thread drains them into dynamic batches (up to ``max_batch_size``
requests, waiting at most ``max_wait_ms`` from the *first* queued request
-- the vLLM-style window: full batches fire immediately under load, lone
requests pay at most the window), and one ``model_fn(list_of_payloads)``
call serves the whole batch.  This is the serving counterpart of the
paper's batched-submission story: amortize fixed per-call overhead
(dispatch, kernel launch, transfer) across many logical requests.

Admission control is load *shedding*, not queueing-to-death: when the
bounded queue is full, ``submit`` raises :class:`ServerOverloaded`
immediately and the rejection is counted -- saturated servers keep their
latency distribution bounded instead of growing an unbounded backlog.

Per-request latency (queue wait and total) is recorded and surfaced via
``stats()`` as p50/p99, which is what ``benchmarks/serving.py`` reports
for the batched-vs-unbatched comparison.

``attach(consumer, producer)`` pumps a request stream through the server
and emits responses to a reply stream, so the whole service composes out
of the :mod:`repro_torch.runtime.stream` primitives: request payloads ride the
store tiers, only events touch the broker, and the server node is the
sole place where bytes are actually materialized for the forward pass.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from concurrent.futures import Future
from typing import Any, Callable, Sequence

from repro_torch.runtime.stream import EndOfStream, StreamClosed

_LAT_WINDOW = 4096  # per-request latency samples kept for percentiles


class ServerOverloaded(RuntimeError):
    """Admission queue full: the request was shed, not enqueued."""


def _percentile(samples: Sequence[float], q: float) -> float:
    if not samples:
        return 0.0
    xs = sorted(samples)
    idx = min(len(xs) - 1, max(0, round(q * (len(xs) - 1))))
    return xs[idx]


class _Request:
    __slots__ = ("payload", "metadata", "future", "t_submit", "t_start")

    def __init__(self, payload: Any, metadata: dict[str, Any]):
        self.payload = payload
        self.metadata = metadata
        self.future: Future = Future()
        self.t_submit = time.monotonic()
        self.t_start = 0.0


class ModelServer:
    """Dynamic batcher + bounded admission queue around ``model_fn``.

    ``model_fn`` takes a list of request payloads and returns a sequence
    of per-request results (same length, same order).  The batcher thread
    starts on construction and runs until :meth:`close`.
    """

    def __init__(
        self,
        model_fn: Callable[[list[Any]], Sequence[Any]],
        *,
        max_batch_size: int = 8,
        max_wait_ms: float = 2.0,
        queue_depth: int = 128,
    ):
        if max_batch_size < 1:
            raise ValueError("max_batch_size must be >= 1")
        if queue_depth < 1:
            raise ValueError("queue_depth must be >= 1")
        self.model_fn = model_fn
        self.max_batch_size = int(max_batch_size)
        self.max_wait_ms = float(max_wait_ms)
        self.queue_depth = int(queue_depth)

        self._queue: deque[_Request] = deque()
        self._cond = threading.Condition()
        self._closed = False

        self._requests = 0
        self._rejected = 0
        self._batches = 0
        self._batched_requests = 0
        self._queue_ms: deque[float] = deque(maxlen=_LAT_WINDOW)
        self._total_ms: deque[float] = deque(maxlen=_LAT_WINDOW)

        self._pumps: list[threading.Thread] = []
        self._batcher = threading.Thread(
            target=self._run, daemon=True, name="model-server-batcher"
        )
        self._batcher.start()

    # -- admission -----------------------------------------------------------

    def submit(self, payload: Any, metadata: dict[str, Any] | None = None) -> Future:
        """Admit one request; the Future resolves to its model output.

        Raises :class:`ServerOverloaded` (and counts the shed) when the
        admission queue is at ``queue_depth`` -- the caller decides
        whether to retry, back off, or surface the rejection.
        """
        req = _Request(payload, dict(metadata or {}))
        with self._cond:
            if self._closed:
                raise StreamClosed("model server closed")
            if len(self._queue) >= self.queue_depth:
                self._rejected += 1
                raise ServerOverloaded(
                    f"admission queue full ({self.queue_depth} pending)"
                )
            self._requests += 1
            self._queue.append(req)
            self._cond.notify()
        return req.future

    # -- the batching loop ---------------------------------------------------

    def _take_batch(self) -> list[_Request] | None:
        """Block for the first request, then fill the batch for up to
        ``max_wait_ms`` more; None only at close."""
        window = self.max_wait_ms / 1000.0
        with self._cond:
            while not self._queue and not self._closed:
                self._cond.wait(0.1)
            if not self._queue:
                return None  # closed and drained
            deadline = self._queue[0].t_submit + window
            now = time.monotonic()
            while (
                len(self._queue) < self.max_batch_size
                and not self._closed
                and now < deadline
            ):
                self._cond.wait(deadline - now)
                now = time.monotonic()
            batch = []
            while self._queue and len(batch) < self.max_batch_size:
                batch.append(self._queue.popleft())
            self._cond.notify_all()
            return batch

    def _run(self) -> None:
        while True:
            batch = self._take_batch()
            if batch is None:
                return
            t0 = time.monotonic()
            for req in batch:
                req.t_start = t0
            try:
                outputs = self.model_fn([r.payload for r in batch])
            except BaseException as exc:  # noqa: BLE001 - fail the whole batch
                for req in batch:
                    req.future.set_exception(exc)
                self._count_batch(batch, failed=True)
                continue
            t1 = time.monotonic()
            if len(outputs) != len(batch):
                exc = RuntimeError(
                    f"model_fn returned {len(outputs)} outputs for a "
                    f"batch of {len(batch)}"
                )
                for req in batch:
                    req.future.set_exception(exc)
                self._count_batch(batch, failed=True)
                continue
            for req, out in zip(batch, outputs):
                req.future.set_result(out)
            self._count_batch(batch, t_done=t1)

    def _count_batch(
        self, batch: list[_Request], *, failed: bool = False, t_done: float = 0.0
    ) -> None:
        """Record a processed batch -- only after its futures resolved.

        Done callbacks (stream reply emits) run inline inside
        ``set_result``/``set_exception``, so once ``flush()`` sees these
        counters the replies are already out.  Failed batches count toward
        drain progress but contribute no latency samples.
        """
        with self._cond:
            self._batches += 1
            self._batched_requests += len(batch)
            if not failed:
                for req in batch:
                    self._queue_ms.append((req.t_start - req.t_submit) * 1000.0)
                    self._total_ms.append((t_done - req.t_submit) * 1000.0)

    # -- stream pumping ------------------------------------------------------

    def attach(self, consumer: Any, producer: Any | None = None) -> threading.Thread:
        """Serve a request stream: pump ``consumer`` through the batcher.

        Each consumed item is submitted with its stream metadata; when a
        reply ``producer`` is given, every response (result, shed notice,
        or failure) is sent there with ``{"key": <request key>}`` plus a
        ``status`` of ``ok`` / ``rejected`` / ``error``.  End-of-stream on
        the request side flushes in-flight batches and closes the reply
        stream.  Returns the (daemon) pump thread; ``close()`` joins it.
        """

        def _emit(key: str, status: str, value: Any) -> None:
            if producer is None:
                return
            try:
                producer.send(value, metadata={"key": key, "status": status})
            except (StreamClosed, TimeoutError):
                pass  # reply stream gone: the request side is shutting down

        def _pump() -> None:
            try:
                for item in consumer:
                    try:
                        fut = self.submit(item.value, metadata=item.metadata)
                    except ServerOverloaded as exc:
                        _emit(item.key, "rejected", str(exc))
                        continue
                    except StreamClosed:
                        break
                    fut.add_done_callback(
                        lambda f, key=item.key: _emit(key, "error", str(f.exception()))
                        if f.exception() is not None
                        else _emit(key, "ok", f.result())
                    )
            except StreamClosed:
                pass
            finally:
                self.flush()
                if producer is not None:
                    producer.close()

        t = threading.Thread(target=_pump, daemon=True, name="model-server-pump")
        self._pumps.append(t)
        t.start()
        return t

    # -- telemetry / lifecycle -----------------------------------------------

    def stats(self) -> dict[str, float]:
        with self._cond:
            queue_ms = list(self._queue_ms)
            total_ms = list(self._total_ms)
            batches = self._batches
            served = self._batched_requests
            return {
                "requests": self._requests,
                "served": served,
                "rejected": self._rejected,
                "batches": batches,
                "pending": len(self._queue),
                "mean_batch": (served / batches) if batches else 0.0,
                "queue_p50_ms": _percentile(queue_ms, 0.50),
                "queue_p99_ms": _percentile(queue_ms, 0.99),
                "latency_p50_ms": _percentile(total_ms, 0.50),
                "latency_p99_ms": _percentile(total_ms, 0.99),
            }

    def flush(self, timeout: float = 30.0) -> None:
        """Block until every admitted request has been batched and run."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            with self._cond:
                if not self._queue:
                    break
            time.sleep(0.005)
        # The in-flight batch (already popped) finishes inside _run; wait
        # until every *admitted* request has been batched.  Both counters
        # count admitted requests only -- sheds increment ``_rejected``,
        # never ``_requests``, so they must not appear on either side of
        # this comparison (a shed would otherwise let flush() return while
        # the final batch is still inside model_fn, and the pump would
        # close the reply stream under in-flight responses).
        while time.monotonic() < deadline:
            with self._cond:
                if self._batched_requests >= self._requests:
                    return
            time.sleep(0.005)

    def close(self, timeout: float = 10.0) -> None:
        """Drain admitted requests, then stop the batcher; idempotent."""
        with self._cond:
            if self._closed:
                return
            self._closed = True
            self._cond.notify_all()
        self._batcher.join(timeout=timeout)
        for t in self._pumps:
            t.join(timeout=timeout)
        # Whatever never ran (batcher died mid-drain) must not hang callers.
        with self._cond:
            leftover = list(self._queue)
            self._queue.clear()
        for req in leftover:
            if not req.future.done():
                req.future.set_exception(StreamClosed("model server closed"))

    def __enter__(self) -> "ModelServer":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.close()
