"""Workers: task execution peers on the peer-to-peer data plane.

Thread workers (default on this 1-core container) speak a metadata-only
protocol with the scheduler; result bytes never ride on scheduler
messages (beyond the inline threshold).  Each worker:

* keeps every serialized result in a byte-bounded cache -- a memory-only
  ``BlobCache`` LRU, or (with a memory budget configured) a tiered
  ``SpillCache`` that demotes cold blobs to disk instead of dropping
  them,
* publishes results >= ``inline_result_max`` into the shared cluster
  store (``ResultStore``) and reports only ``(key, ref, nbytes)``,
* resolves dependencies itself: local cache -> direct peer fetch
  (``PeerTransfer``, chunked so a transfer never doubles peak memory) ->
  shared store -- the scheduler only supplied the ``(ref, nbytes,
  locations)`` metadata,
* pipelines dispatch through a **local ready queue**: one control-plane
  pump thread drains the mailbox (``RUN_BATCH`` enqueues many tasks at
  once) while ``nthreads`` executor threads pull from the queue -- so a
  batch of N tasks costs one scheduler message, not N round-trips,
* accounts its own memory: ``managed_bytes`` = hot-cache bytes +
  in-flight task bytes (dependency blobs being resolved and results
  being serialized).  Above ``pause_fraction`` of the budget the worker
  self-transitions to ``paused`` -- executor threads stop pulling from
  the local ready queue and the cache sheds (demotes) down to
  ``target_fraction`` -- and resumes once pressure clears.  Transitions
  push an immediate heartbeat so the scheduler's pressure-aware dispatch
  reacts within one loop pass, not one heartbeat period.

Heartbeats carry ``(managed_bytes, spilled_bytes, state)`` telemetry plus
the set of spilled keys, which feeds the scheduler's spill-aware locality
(dependents prefer holders whose copy is still hot).

Work stealing is confirm-based at this end: ``STEAL`` removes the
requested keys *still in the local queue* under the queue lock and acks
exactly those -- a task an executor thread has already claimed is never
given back, which is what makes stealing double-run-proof.

Function payloads are pickled by reference when possible; non-picklable
callables (lambdas/closures) fall back to a process-local registry token,
valid for thread workers only -- mirroring Dask's requirement that remote
tasks be picklable.
"""

from __future__ import annotations

import os
import pickle
import queue
import threading
import time
import traceback
from collections import deque
from typing import Any

from repro_torch.core.compress import TransferLedger, TransferPolicy
from repro_torch.core.serialize import FrameBundle, deserialize, serialize
from repro_torch.runtime import messages as M
from repro_torch.runtime.graph import substitute_refs
from repro_torch.runtime.prefetch import Prefetcher, SingleFlight
from repro_torch.runtime.scheduler import Mailbox, Scheduler
from repro_torch.runtime.transfer import BlobCache, MissingDependencyError, SpillCache

# Registry for non-picklable callables (thread mode only).
_LOCAL_FUNCS: dict[str, Any] = {}
_LOCAL_FUNCS_LOCK = threading.Lock()

#: Bounded retry for dependency fetches: covers the tiny race between a
#: dependent's dispatch and the publish landing in a slow store backend.
_FETCH_RETRIES = 3
_FETCH_RETRY_SLEEP = 0.02

#: Default concurrent dependency fetches for fan-in tasks: each remote
#: dep is an independent peer-wire/store round trip, so overlapping a few
#: of them hides per-peer latency.  Bounded -- a 512-way fan-in must not
#: open 512 sockets at once (the per-peer connection pool caps each peer
#: anyway).  Overridable via ``TransferSpec.fetch_concurrency``.
_FETCH_CONCURRENCY = 4

#: Defaults for the overlap-and-spread knobs when no TransferSpec config
#: reaches the worker (mirrors ``api.config.TransferSpec``).
_PREFETCH_DEPTH = 2
_MAX_PEER_FANOUT = 4

#: Cap on the spilled-key list a heartbeat carries: locality hints are
#: advisory, so a pathological spill set must not bloat the control plane.
_HEARTBEAT_SPILLED_MAX = 512

#: Cap on the cached-key list a heartbeat carries for replica-holder
#: registration: advisory like the spill hints, same bound.
_HEARTBEAT_CACHED_MAX = 512


def dumps_function(fn: Any) -> bytes:
    try:
        return b"P" + pickle.dumps(fn, protocol=5)
    except Exception:
        token = f"localfn-{id(fn)}-{time.monotonic_ns()}"
        with _LOCAL_FUNCS_LOCK:
            _LOCAL_FUNCS[token] = fn
        return b"L" + token.encode()


#: Deserialized-function memo: a graph/map fans one function out to
#: hundreds of tasks, so unpickling it once per *blob* (not once per task)
#: removes a per-task cost.  Bounded; eviction is FIFO.  The lock guards
#: the eviction iterator against concurrent executor-thread resizes.
_FN_CACHE: dict[bytes, Any] = {}
_FN_CACHE_MAX = 512
_FN_CACHE_LOCK = threading.Lock()


def loads_function(blob: bytes) -> Any:
    with _FN_CACHE_LOCK:
        fn = _FN_CACHE.get(blob)
    if fn is not None:
        return fn
    tag, body = blob[:1], blob[1:]
    if tag == b"P":
        fn = pickle.loads(body)
    else:
        token = body.decode()
        with _LOCAL_FUNCS_LOCK:
            fn = _LOCAL_FUNCS.get(token)
        if fn is None:
            raise RuntimeError(
                "non-picklable function reached a process worker; use module-level "
                "functions for process/multi-node execution"
            )
    with _FN_CACHE_LOCK:
        if len(_FN_CACHE) >= _FN_CACHE_MAX:
            _FN_CACHE.pop(next(iter(_FN_CACHE)), None)
        _FN_CACHE[blob] = fn
    return fn


class ThreadWorker:
    """In-process worker thread speaking the byte protocol.

    ``memory`` (a plain dict, the wire form of ``api.config.MemorySpec``)
    switches the cache to the tiered :class:`SpillCache` and enables the
    pause/shed pressure loop:

    * ``limit_bytes`` -- the managed-memory budget (also the hot-tier cap),
    * ``spill_dir``   -- disk-tier directory (a private tempdir if unset),
    * ``pause_fraction`` / ``target_fraction`` -- pause above, resume below.
    """

    def __init__(
        self,
        worker_id: str,
        scheduler: Scheduler,
        nthreads: int = 1,
        *,
        result_store: Any = None,  # transfer.ResultStore | None
        transfers: Any = None,  # transfer.PeerTransfer | None
        cache_bytes: int = 256 * 1024 * 1024,
        memory: dict[str, Any] | None = None,
        transfer: Any = None,  # TransferSpec wire dict | TransferPolicy | None
        ledger: TransferLedger | None = None,
    ):
        self.worker_id = worker_id
        self.scheduler = scheduler
        self.mailbox = Mailbox(worker_id)
        self.results = result_store
        self.transfers = transfers
        #: Compression policy for this worker's byte paths (store
        #: publishes/fetches; the comm link has its own copy) and the
        #: per-link-class wire ledger its heartbeats carry.  Process
        #: workers pass the ledger shared with their TCP comm so one
        #: snapshot covers both the store and the wire.
        self.transfer_policy = TransferPolicy.from_config(transfer)
        self.ledger = ledger if ledger is not None else TransferLedger()
        # Overlap-and-spread knobs (TransferSpec wire dict, when present).
        tcfg = transfer if isinstance(transfer, dict) else {}
        self._fetch_concurrency = max(
            1, int(tcfg.get("fetch_concurrency") or _FETCH_CONCURRENCY)
        )
        _pd = tcfg.get("prefetch_depth")
        self._prefetch_depth = _PREFETCH_DEPTH if _pd is None else max(0, int(_pd))
        self._max_peer_fanout = max(
            1, int(tcfg.get("max_peer_fanout") or _MAX_PEER_FANOUT)
        )
        if memory is not None:
            limit = int(memory.get("limit_bytes", cache_bytes))
            spill_dir = memory.get("spill_dir")
            if spill_dir is not None:
                spill_dir = os.path.join(spill_dir, worker_id)
            self.cache: BlobCache = SpillCache(
                limit,
                spill_dir=spill_dir,
                compress=self.transfer_policy.spill_compression,
            )
            self.memory_limit: int | None = limit
            self._pause_bytes = int(limit * float(memory.get("pause_fraction", 0.85)))
            self._target_bytes = int(limit * float(memory.get("target_fraction", 0.6)))
        else:
            self.cache = BlobCache(cache_bytes)  # key -> serialized result
            self.memory_limit = None
            self._pause_bytes = self._target_bytes = 0
        self.nthreads = nthreads
        self.state = "running"  # running | paused
        self.refetch_count = 0  # dependency fetches that fell back to the store
        self.zero_copy_hits = 0  # deps attached by ref on the shm fast path
        self.peer_wire_hits = 0  # deps fetched from a peer's data server
        #: Single-flight fetch table shared by executor threads and the
        #: prefetcher: N concurrent resolvers of one key dial the wire once.
        self._flights = SingleFlight()
        #: Keys the prefetcher resolved ahead of execution (key -> nbytes).
        #: Consumed (-> prefetch_hits) when an executor uses the dep;
        #: drained to prefetch_wasted_bytes when the task leaves unrun.
        self._prefetched: dict[str, int] = {}
        self._pf_lock = threading.Lock()
        self.prefetch_hits = 0
        self.prefetch_wasted_bytes = 0
        self.prefetcher: Prefetcher | None = None
        #: Queue-to-start wait: enqueue -> compute start (after deps are
        #: resolved), cumulative so callers can diff across phases.
        self._queue_wait_ms_total = 0.0
        self._queue_wait_count = 0
        #: Peer data plane (process clusters): a DataServer serving this
        #: worker's cache to peers and a pooled PeerWireClient for fetching
        #: from theirs.  Assigned by ``proc.start_comm_worker`` *before*
        #: ``start()`` so registration carries the data address; None on
        #: thread workers (they share the in-proc PeerTransfer mesh).
        self.data_server: Any = None  # dataserver.DataServer | None
        self.peer_wire: Any = None  # dataserver.PeerWireClient | None
        self._inflight_bytes = 0
        self._mem_lock = threading.Lock()
        self._stop = threading.Event()
        self._cancelled: set[str] = set()
        #: Per-task service time (dep fetch + execute + publish), a rolling
        #: window feeding the ``task_p50_ms``/``task_p99_ms`` stats fields.
        self._task_ms: deque[float] = deque(maxlen=1024)
        self._task_count = 0
        self._lat_lock = threading.Lock()
        #: Local ready queue: RUN_TASK/RUN_BATCH payloads awaiting an
        #: executor thread.  Guarded by ``_pcv``; STEAL removes from it.
        self._pending: deque[dict[str, Any]] = deque()
        self._pcv = threading.Condition()
        #: Completion outbox: TASK_DONE/TASK_FAILED reports coalesced by the
        #: flusher thread into one REPORT_BATCH per burst.
        self._outbox: list[tuple[str, dict[str, Any]]] = []
        self._ocv = threading.Condition()
        self._threads: list[threading.Thread] = []
        self._heartbeat_thread: threading.Thread | None = None

    # -- lifecycle ----------------------------------------------------------

    @property
    def data_address(self) -> str | None:
        """Connect string of this worker's peer data server, if any."""
        return self.data_server.address if self.data_server is not None else None

    def start(self) -> "ThreadWorker":
        # Registration is control-plane (passes the live mailbox handle),
        # so it is a direct call rather than a byte message.
        self.scheduler.register_worker(
            self.worker_id, self.mailbox, self.nthreads,
            data_address=self.data_address,
        )
        if self.transfers is not None:
            self.transfers.register(self.worker_id, self.cache)
        pump = threading.Thread(
            target=self._pump_loop, daemon=True, name=f"{self.worker_id}-pump"
        )
        pump.start()
        self._threads.append(pump)
        flusher = threading.Thread(
            target=self._flush_loop, daemon=True, name=f"{self.worker_id}-flush"
        )
        flusher.start()
        self._threads.append(flusher)
        for i in range(self.nthreads):
            t = threading.Thread(
                target=self._exec_loop, daemon=True, name=f"{self.worker_id}-{i}"
            )
            t.start()
            self._threads.append(t)
        self._heartbeat_thread = threading.Thread(
            target=self._heartbeat_loop, daemon=True
        )
        self._heartbeat_thread.start()
        if self._prefetch_depth > 0:
            self.prefetcher = Prefetcher(
                self, depth=self._prefetch_depth, flights=self._flights
            ).start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self.prefetcher is not None:
            self.prefetcher.stop()
        with self._pcv:
            self._pcv.notify_all()
        with self._ocv:
            self._ocv.notify_all()
        if self.transfers is not None:
            self.transfers.unregister(self.worker_id)
        if self.data_server is not None:
            # Wakes any peer blocked mid-fetch on one of our serving
            # connections with ChannelClosed (it falls back to the store).
            self.data_server.close()
        if self.peer_wire is not None:
            self.peer_wire.close()
        self.cache.close()

    def kill(self) -> None:
        """Simulate abrupt node failure: heartbeats stop and the worker's
        cached result bytes vanish with it (peers must fall back to the
        store or lineage recovery)."""
        self.stop()

    # -- memory accounting ----------------------------------------------------

    def managed_bytes(self) -> int:
        """Hot-tier cache bytes + in-flight task bytes.  The quantity the
        pause threshold and the scheduler's pressure-aware dispatch act on.

        The in-flight charge deliberately counts a running task's dep and
        result *blob sizes even though the same blobs sit in the cache*:
        during execution the deserialized live objects coexist with the
        serialized cache copies, and blob size is the cheap proxy for that
        live-object footprint -- so managed_bytes tracks real residency,
        not just the cache ledger."""
        with self._mem_lock:
            inflight = self._inflight_bytes
        return self.cache.nbytes + inflight

    def stats(self) -> dict[str, Any]:
        """Per-worker memory telemetry (the ``worker_stats()`` row)."""
        cache_stats = self.cache.stats()
        copy_stats = self.cache.copies.snapshot()
        with self._pcv:
            queued = len(self._pending)
        with self._lat_lock:
            lat = sorted(self._task_ms)
            task_count = self._task_count
            queue_wait_ms_total = self._queue_wait_ms_total
            queue_wait_count = self._queue_wait_count

        def _pct(q: float) -> float:
            if not lat:
                return 0.0
            return lat[min(len(lat) - 1, max(0, round(q * (len(lat) - 1))))]

        return {
            "state": self.state,
            "managed_bytes": self.managed_bytes(),
            "spilled_bytes": cache_stats["spilled_bytes"],
            "spilled_bytes_total": cache_stats["spilled_bytes_total"],
            "memory_limit": self.memory_limit,
            "queued": queued,
            "refetch_count": self.refetch_count,
            "zero_copy_hits": self.zero_copy_hits,
            # Peer data plane: deps resolved over the wire from a peer's
            # data server instead of a store round trip.
            "peer_wire_hits": self.peer_wire_hits,
            **(
                self.peer_wire.snapshot()
                if self.peer_wire is not None
                else {"peer_wire_fetches": 0, "peer_wire_bytes": 0}
            ),
            # Replica serving: what this worker's data server handed to
            # peers (the broadcast bench derives producer share from this).
            **(
                self.data_server.snapshot()
                if self.data_server is not None
                else {
                    "data_server_serves": 0,
                    "data_server_bytes": 0,
                    "data_server_busy_rejects": 0,
                }
            ),
            # Prefetch pipeline: deps resolved ahead of execution.
            "prefetch_hits": self.prefetch_hits,
            "prefetch_wasted_bytes": self.prefetch_wasted_bytes,
            **(
                self.prefetcher.snapshot()
                if self.prefetcher is not None
                else {
                    "prefetch_issued": 0,
                    "prefetch_bytes": 0,
                    "prefetch_throttled": 0,
                    "prefetch_errors": 0,
                }
            ),
            # Queue-to-start wait (enqueue -> compute start, cumulative):
            # the quantity prefetch overlap is meant to shrink.
            "queue_wait_ms_total": queue_wait_ms_total,
            "queue_wait_count": queue_wait_count,
            # Task-latency telemetry: per-task service time percentiles
            # over a rolling window (what benchmarks/serving.py compares
            # its request latencies against).
            "task_count": task_count,
            "task_p50_ms": _pct(0.50),
            "task_p99_ms": _pct(0.99),
            "dropped": cache_stats["dropped"],
            "spill_count": cache_stats["spill_count"],
            "restore_count": cache_stats["restore_count"],
            "mmap_restores": cache_stats["mmap_restores"],
            # Copy accounting: payload bytes this worker pulled through the
            # data plane vs bytes memcpy'd doing so (0 on the shm fast
            # path, exactly 1x on a chunked peer fetch).
            "bytes_moved": copy_stats["bytes_moved"],
            "bytes_copied": copy_stats["bytes_copied"],
            "copies_per_byte": copy_stats["copies_per_byte"],
            # Wire accounting: per-link-class logical vs wire bytes,
            # compression ratio, and codec time (see TransferLedger).
            "transfer_ledger": self.ledger.snapshot(),
        }

    def _note_inflight(self, delta: int) -> None:
        with self._mem_lock:
            self._inflight_bytes = max(0, self._inflight_bytes + delta)
        self._update_memory_state()

    def _update_memory_state(self) -> None:
        """Re-evaluate pause/resume after any change to managed bytes."""
        if self.memory_limit is None:
            return
        if self.state == "running" and self.managed_bytes() >= self._pause_bytes:
            self.state = "paused"
            # Shed the hot tier toward the resume target (demote-to-disk,
            # never discard); in-flight bytes drain as running tasks finish.
            shed = getattr(self.cache, "shed", None)
            if shed is not None:
                with self._mem_lock:
                    inflight = self._inflight_bytes
                shed(max(0, self._target_bytes - inflight))
            self._send_heartbeat()  # tell the scheduler *now*, not in 0.5 s
        # Re-checked (not elif) right after a pause: when shedding alone
        # clears the pressure, the worker resumes without waiting a beat --
        # the pause persists only while in-flight bytes keep managed high.
        if self.state == "paused" and self.managed_bytes() <= self._target_bytes:
            self.state = "running"
            with self._pcv:
                self._pcv.notify_all()  # executor threads may pull again
            self._send_heartbeat()

    # -- heartbeats (telemetry-bearing) ---------------------------------------

    def _send_heartbeat(self) -> None:
        spilled = self.cache.spilled_keys()
        if len(spilled) > _HEARTBEAT_SPILLED_MAX:
            spilled = spilled[:_HEARTBEAT_SPILLED_MAX]
        # Replica announcement: every servable cached key (hot or spilled)
        # makes this worker a candidate holder for fan-out spreading.
        cached = self.cache.servable_keys()
        if len(cached) > _HEARTBEAT_CACHED_MAX:
            cached = cached[:_HEARTBEAT_CACHED_MAX]
        copy_stats = self.cache.copies.snapshot()
        self._send(
            M.msg(
                M.HEARTBEAT,
                worker=self.worker_id,
                managed_bytes=self.managed_bytes(),
                spilled_bytes=self.cache.spilled_bytes,
                memory_limit=self.memory_limit,
                state=self.state,
                spilled_keys=spilled,
                cached_keys=cached,
                bytes_moved=copy_stats["bytes_moved"],
                bytes_copied=copy_stats["bytes_copied"],
                # Repeated every beat so a scheduler that lost and re-learned
                # this worker re-acquires the data address without a
                # re-registration round trip.
                data_address=self.data_address,
                # Full telemetry snapshot: for process workers the heartbeat
                # is the only channel worker_stats() can be served from.
                stats=self.stats(),
            )
        )

    def _heartbeat_loop(self) -> None:
        while not self._stop.is_set():
            # Periodic re-evaluation backstops the event-driven checks: a
            # paused worker with no task activity still resumes once its
            # in-flight bytes drain.
            self._update_memory_state()
            self._send_heartbeat()
            time.sleep(0.5)

    def _send(self, message: Any) -> None:
        if not self._stop.is_set():
            self.scheduler.inbox.put_msg(message)

    # -- completion reporting (coalesced) ------------------------------------

    def _report(self, tag: str, payload: dict[str, Any]) -> None:
        """Queue a TASK_DONE/TASK_FAILED report for the flusher.

        Reports from a completion burst (wide fan-outs finish thousands of
        tiny tasks per second) coalesce into one REPORT_BATCH message, so
        completion traffic stops scaling one-message-per-task.
        """
        with self._ocv:
            self._outbox.append((tag, payload))
            self._ocv.notify()

    def _flush_loop(self) -> None:
        while True:
            with self._ocv:
                while not self._outbox and not self._stop.is_set():
                    self._ocv.wait(timeout=0.2)
                if self._stop.is_set():
                    return
                # Brief coalescing window: a burst of completions lands in
                # one message; an isolated completion pays <= ~2 ms latency.
                self._ocv.wait(timeout=0.002)
                reports, self._outbox = self._outbox, []
            if len(reports) == 1:
                self._send(reports[0])
            else:
                self._send(
                    M.msg(M.REPORT_BATCH, worker=self.worker_id, reports=reports)
                )

    # -- control-plane pump + local ready queue ------------------------------

    def _pump_loop(self) -> None:
        while not self._stop.is_set():
            try:
                message = self.mailbox.get(timeout=0.2)
            except queue.Empty:
                continue
            try:
                self._handle(message)
            except Exception:
                traceback.print_exc()

    def _handle(self, message: tuple[str, dict[str, Any]]) -> None:
        tag, p = message
        if tag == M.RUN_TASK:
            self._enqueue([p])
        elif tag == M.RUN_BATCH:
            self._enqueue(p["tasks"])
        elif tag == M.STEAL:
            self._on_steal(p)
        elif tag == M.CANCEL:
            with self._pcv:
                self._cancelled.add(p["key"])
                self._discard_pending({p["key"]})
            if p.get("release"):
                self.cache.pop(p["key"])
        elif tag == M.PEER_GONE:
            # Scheduler push on worker loss: drop pooled connections to the
            # dead peer's data server so fetches fail fast to the store.
            if self.peer_wire is not None and p.get("address"):
                self.peer_wire.invalidate(p["address"])
        elif tag == M.STOP:
            self._stop.set()
            with self._pcv:
                self._pcv.notify_all()

    def _enqueue(self, tasks: list[dict[str, Any]]) -> None:
        now = time.monotonic()
        with self._pcv:
            for t in tasks:
                # A fresh dispatch supersedes any stale CANCEL from an
                # earlier speculative round -- otherwise a once-cancelled key
                # would be silently dropped forever on this worker.
                self._cancelled.discard(t["key"])
                t["_enq_t"] = now  # queue-to-start wait baseline
                self._pending.append(t)
            # Wakes executor threads *and* the prefetcher, which starts
            # resolving deps for the queued-but-not-running tail.
            self._pcv.notify_all()

    def _discard_pending(self, keys: set[str]) -> list[str]:
        """Remove matching unstarted tasks from the local queue (caller
        holds ``_pcv``); returns the removed keys."""
        removed_tasks = [t for t in self._pending if t["key"] in keys]
        if removed_tasks:
            self._pending = deque(
                t for t in self._pending if t["key"] not in keys
            )
            # Prefetched deps no remaining queued task needs were fetched
            # for nothing (stolen/cancelled before running) -- count the
            # bytes so the waste is inspectable.
            still_needed = {
                d for t in self._pending for d in (t.get("deps") or ())
            }
            with self._pf_lock:
                for t in removed_tasks:
                    for d in t.get("deps") or ():
                        if d in still_needed:
                            continue
                        nb = self._prefetched.pop(d, None)
                        if nb is not None:
                            self.prefetch_wasted_bytes += nb
        return [t["key"] for t in removed_tasks]

    def _on_steal(self, p: dict[str, Any]) -> None:
        requested = list(p.get("keys") or [])
        with self._pcv:
            # Atomic under the queue lock: a task is either still pending
            # (taken -- it will never start here) or already claimed by an
            # executor thread (kept -- it finishes here).  Exactly one side
            # runs it, which is what makes stealing double-run-proof.
            taken = self._discard_pending(set(requested))
        self._send(
            M.msg(
                M.STEAL_ACK,
                worker=self.worker_id,
                taken=taken,
                requested=requested,
            )
        )

    def _exec_loop(self) -> None:
        while True:
            with self._pcv:
                # A paused worker stops *pulling* -- tasks already claimed by
                # an executor thread run to completion (they are the pressure
                # that is draining), but nothing new starts until managed
                # bytes fall back below target_fraction.
                while (
                    not self._pending or self.state == "paused"
                ) and not self._stop.is_set():
                    self._pcv.wait(timeout=0.2)
                if self._stop.is_set():
                    return
                p = self._pending.popleft()
            try:
                self._run_task(p)
            except Exception:
                traceback.print_exc()

    # -- dependency resolution (data plane) ---------------------------------

    def _mark_prefetched(self, key: str, nbytes: int) -> None:
        """Record a prefetch-led fetch so its consumption (or waste) is
        attributable in stats."""
        with self._pf_lock:
            self._prefetched[key] = max(0, nbytes)

    def _consume_prefetch_mark(self, key: str) -> None:
        with self._pf_lock:
            if self._prefetched.pop(key, None) is not None:
                self.prefetch_hits += 1

    def _fetch_dep(self, key: str, info: dict[str, Any] | None, inline: bytes | None) -> Any:
        if inline is not None:
            return deserialize(inline)
        blob = self.cache.get(key)
        if blob is None:
            # Single-flight: concurrent resolvers of one key (several
            # queued tasks sharing a broadcast dep, or this executor
            # racing the prefetcher) collapse onto one wire transfer.
            blob, led, leader = self._flights.run(
                key, lambda: self._fetch_remote(key, info or {}), origin="task"
            )
            if not led and leader == "prefetch":
                self._consume_prefetch_mark(key)
        else:
            # Cache hit -- if the prefetcher staged it, that's the payoff.
            self._consume_prefetch_mark(key)
        # ``blob`` is a FrameBundle on every path; deserialize reconstructs
        # arrays directly over the received/mapped views -- no join.
        return deserialize(blob)

    def _fetch_remote(self, key: str, info: dict[str, Any]) -> FrameBundle:
        """Pull dependency bytes without touching the scheduler.

        Same-host shm fast path first: when the cluster store's bytes are
        attachable by ref with zero copies (shm connector), attach the
        published segment and hand ``deserialize`` the mapped view --
        skipping the chunked peer channel (and its assembly copy)
        entirely.  Otherwise: direct peer-to-peer (chunked; the producer
        serves frame-bounded views from whichever tier holds the blob) --
        the in-process cache mesh for thread workers, the peer *wire*
        (a holder's data server, via the pooled ``PeerWireClient``) for
        process workers -- then the shared store as the durable fallback.
        """
        ref = info.get("ref")
        locations = info.get("locations") or []
        nbytes = info.get("nbytes", -1)
        for attempt in range(_FETCH_RETRIES):
            if self.results is not None and ref is not None and self.results.zero_copy:
                bundle = self.results.fetch(
                    ref, nbytes, copies=self.cache.copies, ledger=self.ledger
                )
                if bundle is not None:
                    self.zero_copy_hits += 1
                    # Retain only what fits the hot tier: an attached view
                    # larger than the budget would be demoted wholesale to
                    # the spill disk (or counted dropped), and re-attaching
                    # the segment by ref costs nothing anyway.
                    if bundle.nbytes <= self.cache.max_bytes:
                        self.cache.put(key, bundle)
                    return bundle
            if self.transfers is not None:
                for loc in locations:
                    if loc == self.worker_id:
                        continue
                    bundle = self.transfers.fetch(
                        loc,
                        key,
                        sink=self.cache,
                        policy=self.transfer_policy,
                        ledger=self.ledger,
                    )
                    if bundle is not None:
                        return bundle
            if self.peer_wire is not None:
                # Replica-aware: the scheduler ships a bounded,
                # freshness-ordered holder list (newest first, origin
                # last); ``fetch_any`` spreads dials across it, falling
                # through on miss/abort/busy.  Legacy dict form (worker ->
                # address keyed off ``locations``) still accepted.
                peers = info.get("peers")
                if isinstance(peers, dict):
                    candidates = [
                        peers[loc]
                        for loc in locations
                        if loc != self.worker_id and peers.get(loc)
                    ]
                else:
                    candidates = [
                        addr
                        for wid, addr in (peers or [])
                        if addr and wid != self.worker_id
                    ]
                if candidates:
                    bundle = self.peer_wire.fetch_any(
                        candidates[: self._max_peer_fanout],
                        key,
                        sink=self.cache,
                    )
                    if bundle is not None:
                        self.peer_wire_hits += 1
                        return bundle
            if self.results is not None and ref is not None:
                bundle = self.results.fetch(
                    ref, nbytes, copies=self.cache.copies, ledger=self.ledger
                )
                if bundle is not None:
                    self.refetch_count += 1
                    self.cache.put(key, bundle)
                    return bundle
            if attempt + 1 < _FETCH_RETRIES:
                time.sleep(_FETCH_RETRY_SLEEP)
        raise MissingDependencyError([key])

    # -- task execution -----------------------------------------------------------

    def _resolve_deps(
        self,
        deps: list[str],
        dep_info: dict[str, Any],
        inline_deps: dict[str, Any],
    ) -> tuple[dict[str, Any], list[str], int]:
        """Resolve a task's dependencies; returns ``(values, missing,
        inflight_bytes)``.

        Fan-in tasks with several *remote* deps (not inline, not already
        cached) fetch them concurrently through a small thread pool: each
        fetch is an independent wire/store round trip -- often against a
        different holding peer -- so overlapping them hides per-peer
        latency.  Single-dep (and all-local) tasks keep the cheap
        sequential path.
        """
        dep_results: dict[str, Any] = {}
        missing: list[str] = []
        inflight = 0
        lock = threading.Lock()

        def resolve(d: str) -> None:
            nonlocal inflight
            try:
                val = self._fetch_dep(d, dep_info.get(d), inline_deps.get(d))
                nb = (dep_info.get(d) or {}).get("nbytes", 0)
                with lock:
                    dep_results[d] = val
                    if nb > 0:
                        inflight += nb
                if nb > 0:
                    self._note_inflight(nb)
            except MissingDependencyError as exc:
                with lock:
                    missing.extend(exc.keys)

        remote = [
            d for d in deps if inline_deps.get(d) is None and d not in self.cache
        ]
        if len(remote) > 1:
            pending = deque(remote)

            def drain() -> None:
                while True:
                    with lock:
                        if not pending:
                            return
                        d = pending.popleft()
                    resolve(d)

            fetchers = [
                threading.Thread(
                    target=drain, daemon=True, name=f"{self.worker_id}-fetch"
                )
                for _ in range(min(self._fetch_concurrency, len(remote)))
            ]
            for t in fetchers:
                t.start()
            for t in fetchers:
                t.join()
        done = set(dep_results) | set(missing)
        for d in deps:
            if d not in done:
                resolve(d)
                done.add(d)
        return dep_results, missing, inflight

    def _run_task(self, p: dict[str, Any]) -> None:
        key = p["key"]
        if key in self._cancelled:
            return
        inflight = 0
        t_start = time.monotonic()
        try:
            fn = loads_function(p["func"])
            raw_args = p["args"]
            # Graph tasks carry a structured arg spec (decoded with the batch
            # message); legacy per-task SUBMIT still pre-serializes.
            args_spec = (
                deserialize(raw_args)
                if isinstance(raw_args, (bytes, bytearray, memoryview))
                else raw_args
            )
            dep_info = p.get("dep_info", {})
            inline_deps = p.get("inline_deps", {})
            dep_results, missing, fetched = self._resolve_deps(
                p.get("deps", []), dep_info, inline_deps
            )
            inflight += fetched
            # Queue-to-start wait: enqueue until deps resolved and compute
            # can begin -- the latency prefetch overlap shrinks.
            enq_t = p.get("_enq_t")
            if enq_t is not None:
                wait_ms = (time.monotonic() - enq_t) * 1000.0
                with self._lat_lock:
                    self._queue_wait_ms_total += wait_ms
                    self._queue_wait_count += 1
            if missing:
                self._report(
                    M.TASK_FAILED,
                    {
                        "key": key,
                        "worker": self.worker_id,
                        "missing_deps": missing,
                        "error": f"dependency bytes unavailable: {missing}",
                    },
                )
                return
            args = substitute_refs(args_spec["args"], dep_results)
            kwargs = substitute_refs(args_spec["kwargs"], dep_results)
            result = fn(*list(args), **kwargs)
            # Frame-native result path: retain and publish the serialized
            # frames exactly as ``serialize`` emitted them (views over the
            # result's arrays) -- the bytes are never joined here.  They
            # are copied at most once downstream: the consumer-side
            # assembly of a chunked peer fetch, or zero times when a
            # dependent attaches the shm-published segment by ref.
            bundle = FrameBundle.of(serialize(result))
            nbytes = bundle.nbytes
            inflight += nbytes
            self._note_inflight(nbytes)
            self.cache.put(key, bundle)
            if nbytes <= self.scheduler.inline_result_max or self.results is None:
                # Tiny result: one inline blob rides the control plane (a
                # sub-threshold join, not data-plane traffic).
                inline, ref = bundle.to_bytes(), None
            else:
                # Publish-then-report: by the time the scheduler dispatches
                # any dependent, the bytes are already fetchable.
                inline, ref = None, self.results.publish(
                    key, bundle, policy=self.transfer_policy, ledger=self.ledger
                )
            self._report(
                M.TASK_DONE,
                {
                    "key": key,
                    "worker": self.worker_id,
                    "result": inline,
                    "ref": ref,
                    "nbytes": nbytes,
                    # Deps this worker now caches: the scheduler registers
                    # it as a replica holder so later consumers in a
                    # fan-out can fetch from here instead of the producer.
                    "cached_deps": [
                        d for d in p.get("deps", []) if d in self.cache
                    ],
                },
            )
        except Exception as exc:  # noqa: BLE001 - report any task failure
            self._report(
                M.TASK_FAILED,
                {
                    "key": key,
                    "worker": self.worker_id,
                    "error": f"{type(exc).__name__}: {exc}\n{traceback.format_exc()}",
                },
            )
        finally:
            with self._lat_lock:
                self._task_ms.append((time.monotonic() - t_start) * 1000.0)
                self._task_count += 1
            if inflight:
                self._note_inflight(-inflight)
            elif self.memory_limit is not None:
                self._update_memory_state()
