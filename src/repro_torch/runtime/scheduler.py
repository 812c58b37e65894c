"""Centralized scheduler: the Dask-Distributed analogue, metadata-only.

Hub-and-spoke for *control*: all peers (client, workers) push encoded
messages into the scheduler's mailbox; the scheduler pushes encoded
messages to per-peer mailboxes.  Everything crossing the hub is
byte-counted -- the instrument behind the paper's Fig 3/4 attribution.

Unlike stock Dask (and the previous revision of this file), the hub is a
pure control plane.  Workers publish results >= ``inline_result_max`` into
the cluster store and report only ``(key, ref, nbytes, location)``;
dependents and clients fetch the bytes themselves over the peer-to-peer
data plane (``runtime/transfer.py``).  The old ``NEED_DATA``/``SEND_DATA``/
``DATA`` forwarding path is deleted, so no result blob can cross the
scheduler mailbox by construction.

Production features (per the 1000+-node mandate):

* **Fault tolerance** -- worker heartbeats; lost workers' running tasks are
  rescheduled.  Lost *bytes* (all cache holders dead and the store entry
  gone) surface as ``TASK_FAILED(missing_deps=...)`` from the fetching
  worker, answered with lineage recovery: the upstream task is recomputed
  from its retained spec and the dependent re-queued.
* **Straggler mitigation** -- tasks running longer than
  ``speculation_factor x median`` get a speculative duplicate on another
  worker; first completion wins.  Duplicate publishes share a
  deterministic ref, and release funnels through a ``RefLedger``, so the
  store entry is evicted exactly once.
* **Elasticity** -- workers register/deregister at any time; queued work
  rebalances automatically because dispatch is pull-from-ready-queue.
* **Locality** -- ready tasks prefer the worker already holding the most
  dependency bytes (Dask's memory-aware placement).
* **Pure-function caching** -- task keys are content tokens; resubmission
  of a completed pure task returns the cached result without re-running.
* **Graph-native batching** -- a whole task graph arrives as one
  ``SUBMIT_GRAPH`` message, and each dispatch pass coalesces every task
  bound to the same worker into one ``RUN_BATCH``; workers pipeline the
  batch through a local ready queue, so per-task control traffic collapses
  to roughly one ``TASK_DONE`` per task.
* **Work stealing** -- dispatch over-assigns eagerly for pipelining; when
  the ready queue is empty and a worker has a free thread while another
  has unstarted backlog, the scheduler asks the loaded worker to give
  tasks back (``STEAL``), re-queuing only the ones the worker *confirms*
  it never started (``STEAL_ACK``) -- skewed fan-outs cannot strand
  capacity, and no task double-runs because of a steal.
* **Memory awareness** -- heartbeats carry ``(managed_bytes,
  spilled_bytes, state)`` telemetry.  A worker that reports itself
  ``paused`` (managed bytes above its pause threshold) receives no new
  work -- not from dispatch, stealing, or speculation -- until it resumes;
  dispatch weighs memory pressure into worker choice, charges each
  assignment its to-be-fetched dependency bytes against a per-worker
  ``max_outstanding_bytes`` backpressure cap, and prefers dependency
  holders whose cached copy is still hot over ones that spilled it.
"""

from __future__ import annotations

import queue
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any

from repro_torch.core.ownership import RefLedger
from repro_torch.runtime import messages as M
from repro_torch.runtime.comm import ByteCounter, decode_message, encode_message


class Mailbox:
    """Blob queue with byte accounting on both directions."""

    def __init__(self, name: str = ""):
        self.name = name
        self._q: queue.Queue[bytes] = queue.Queue()
        self.counter = ByteCounter()

    def put_msg(self, message: Any) -> int:
        blob = encode_message(message)
        self._q.put(blob)
        return len(blob)

    def put_blob(self, blob: bytes) -> None:
        self._q.put(blob)

    def get(self, timeout: float | None = None) -> Any:
        blob = self._q.get(timeout=timeout)
        self.counter.add_recv(len(blob))
        return decode_message(blob)

    def get_nowait(self) -> Any:
        blob = self._q.get_nowait()
        self.counter.add_recv(len(blob))
        return decode_message(blob)

    def empty(self) -> bool:
        return self._q.empty()


@dataclass
class TaskState:
    key: str
    func_blob: bytes
    #: Pre-serialized bytes (legacy SUBMIT) or a structured arg spec
    #: (SUBMIT_GRAPH) that rides each batch encode without a per-task pass.
    args_blob: Any
    deps: list[str]
    pure: bool = True
    state: str = "waiting"  # waiting|ready|running|done|error
    attempts: int = 0
    max_retries: int = 2
    recoveries: int = 0  # lineage-recovery re-queues (not the task's fault)
    workers: set[str] = field(default_factory=set)  # currently running on
    locations: set[str] = field(default_factory=set)  # workers caching result
    result_blob: bytes | None = None  # inline result (small)
    ref: str | None = None  # data-plane ref for published results
    nbytes: int = 0
    error: str | None = None
    submitted_at: float = 0.0
    started_at: float = 0.0
    finished_at: float = 0.0
    speculated: bool = False
    #: worker_id -> monotonic sequence stamped when the worker became a
    #: holder of this result.  Lowest seq = the original producer; higher
    #: = fresher replicas (their copy is hottest).  Orders the peer list
    #: ``_task_payload`` ships: newest replicas first, origin last.
    holder_seq: dict[str, int] = field(default_factory=dict)
    waiting_clients: list[str] = field(default_factory=list)
    dependents: set[str] = field(default_factory=set)
    #: Deps not yet done.  Maintained incrementally so a completion touches
    #: each dependent O(1) -- a 512-way fan-in must not rescan all 512 deps
    #: on every one of the 512 completions.
    waiting_on: set[str] = field(default_factory=set)


@dataclass
class WorkerState:
    worker_id: str
    mailbox: Any  # Mailbox or pipe-backed sender
    running: set[str] = field(default_factory=set)  # dispatched, not reported done
    #: scheduler's view of the worker's local ready queue, in assignment
    #: order -- the tail is the least likely to have started and is where
    #: work stealing takes from.
    queued: deque = field(default_factory=deque)
    has_data: set[str] = field(default_factory=set)
    #: keys whose cached copy the worker reported demoted to its disk tier
    #: (heartbeat telemetry) -- locality prefers holders still hot.
    spilled: set[str] = field(default_factory=set)
    last_heartbeat: float = field(default_factory=time.monotonic)
    nthreads: int = 1
    alive: bool = True
    total_done: int = 0
    #: memory telemetry from the worker's last heartbeat
    managed_bytes: int = 0
    spilled_bytes: int = 0
    memory_limit: int | None = None
    memory_state: str = "running"  # running | paused
    #: copy-accounting telemetry from the last heartbeat: payload bytes the
    #: worker pulled through the data plane vs bytes memcpy'd doing so
    #: (the zero-copy regression signal, surfaced in ``worker_stats()``).
    bytes_moved: int = 0
    bytes_copied: int = 0
    #: dependency bytes dispatched to (but not yet resolved by) this worker
    #: -- the backpressure quantity; maintained by _assign/_unassign so every
    #: removal path (done, failed, stolen, released, worker lost) decrements.
    outstanding_bytes: int = 0
    #: full worker.stats() snapshot from the last heartbeat -- the only view
    #: of a process worker's telemetry (no shared-memory object to ask).
    last_stats: dict[str, Any] | None = None
    #: connect string of the worker's peer data server (None when the
    #: worker serves no blobs, e.g. thread workers on the in-proc mesh).
    #: Shipped to dependents in ``_task_payload`` so they can fetch
    #: dependencies over the wire instead of round-tripping the store.
    data_address: str | None = None

    def occupancy(self) -> float:
        """Outstanding tasks per thread -- the dispatch balance metric."""
        return len(self.running) / max(self.nthreads, 1)

    def memory_pressure(self) -> float:
        """Managed bytes as a fraction of the worker's budget (0 when the
        worker runs without one) -- the dispatch tie-breaker weight."""
        if not self.memory_limit:
            return 0.0
        return min(2.0, self.managed_bytes / self.memory_limit)

    def unqueue(self, key: str) -> None:
        try:
            self.queued.remove(key)
        except ValueError:
            pass


#: Bound on the task-duration history feeding speculation's median.  The
#: median of the most recent window tracks workload shifts and keeps the
#: scheduler from leaking one float per task forever.
DURATION_WINDOW = 512

#: Lineage-recovery re-queues allowed per task before giving up.  Guards
#: against a store that keeps losing the same dependency bytes.
MAX_RECOVERIES = 3

#: Dependencies at least this large engage the fan-out admission gate:
#: dispatch defers a task when the dep already has ``holders x
#: max_peer_fanout`` distinct workers fetching it, so later consumers
#: land after early finishers became replicas and pull from *them*
#: instead of queueing on the producer.  Small deps never gate -- the
#: per-dep overhead would dwarf any serving contention.
GATE_MIN_BYTES = 8 * 1024 * 1024


class Scheduler:
    def __init__(
        self,
        *,
        heartbeat_timeout: float = 5.0,
        speculation_factor: float = 4.0,
        speculation_min: float = 1.0,
        inline_result_max: int = 64 * 1024,
        result_store: Any = None,
        max_outstanding_bytes: int = 128 * 1024 * 1024,
        max_peer_fanout: int = 4,
    ):
        self.inbox = Mailbox("scheduler")
        self.tasks: dict[str, TaskState] = {}
        self.workers: dict[str, WorkerState] = {}
        self.clients: dict[str, Any] = {}  # client_id -> Mailbox
        self.ready: list[str] = []
        self.heartbeat_timeout = heartbeat_timeout
        self.speculation_factor = speculation_factor
        self.speculation_min = speculation_min
        self.inline_result_max = inline_result_max
        self.result_store = result_store  # transfer.ResultStore | None
        #: Per-worker cap on dispatched-but-unresolved dependency bytes: a
        #: worker already owing this much fetch work gets no more
        #: byte-heavy tasks until some resolve (dispatch backpressure).
        self.max_outstanding_bytes = max_outstanding_bytes
        #: Per-holder concurrent-fetcher budget (TransferSpec knob): bounds
        #: both the peer list shipped in ``dep_info["peers"]`` and the
        #: fan-out admission gate's dispatch-time limit.
        self.max_peer_fanout = max(1, int(max_peer_fanout))
        self.ledger = RefLedger(self._evict_ref)
        self._stealing: set[str] = set()  # keys with a STEAL in flight
        #: Replica-freshness clock: bumped per holder registration, stamped
        #: into ``TaskState.holder_seq``.
        self._holder_seq = 0
        #: Fan-out gate state: dep key -> {worker_id: assigned-task count}
        #: for gate-sized deps the worker will have to fetch.  Distinct
        #: workers (not tasks) are what load a serving peer -- same-worker
        #: duplicates collapse onto one wire fetch via single-flight.
        self._fetching: dict[str, dict[str, int]] = {}
        #: (worker_id, task key) -> gate-sized dep keys charged at
        #: ``_assign``; drained by ``_unassign`` on every removal path.
        self._assigned_fetch_deps: dict[tuple[str, str], list[str]] = {}
        #: (worker_id, key) -> dep bytes charged at dispatch.  The single
        #: source of truth for outstanding_bytes decrements: every removal
        #: path funnels through _unassign, so no lineage-recovery or
        #: failure ordering can leak a charge.
        self._assigned_bytes: dict[tuple[str, str], int] = {}
        self._durations: deque[float] = deque(maxlen=DURATION_WINDOW)
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._lock = threading.Lock()

    def _evict_ref(self, ref: str) -> None:
        if self.result_store is not None:
            self.result_store.evict(ref)

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> "Scheduler":
        self._thread = threading.Thread(target=self._loop, daemon=True, name="scheduler")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        self.inbox.put_msg(M.msg(M.STOP))
        if self._thread is not None:
            self._thread.join(timeout=5)
        for ws in self.workers.values():
            self._send_worker(ws, M.msg(M.STOP))

    # -- control-plane registration (direct calls; data plane stays bytes) ----

    def _register_worker(
        self,
        worker_id: str,
        mailbox: Any,
        nthreads: int = 1,
        data_address: str | None = None,
    ) -> None:
        """Single registration path for both the direct call and M.REGISTER."""
        with self._lock:
            self.workers[worker_id] = WorkerState(
                worker_id, mailbox, nthreads=nthreads, data_address=data_address
            )

    def register_worker(
        self,
        worker_id: str,
        mailbox: Any,
        nthreads: int = 1,
        data_address: str | None = None,
    ) -> None:
        self._register_worker(worker_id, mailbox, nthreads, data_address)

    def register_client(self, client_id: str, mailbox: Any) -> None:
        with self._lock:
            self.clients[client_id] = mailbox

    def unregister_client(self, client_id: str) -> None:
        with self._lock:
            self.clients.pop(client_id, None)

    # -- messaging helpers ------------------------------------------------------

    def _send_worker(self, ws: WorkerState, message: Any) -> None:
        try:
            n = ws.mailbox.put_msg(message)
            self.inbox.counter.add_sent(n)
        except Exception:
            ws.alive = False

    def _send_client(self, client_id: str, message: Any) -> None:
        mb = self.clients.get(client_id)
        if mb is not None:
            n = mb.put_msg(message)
            self.inbox.counter.add_sent(n)

    # -- metrics -------------------------------------------------------------------

    def bytes_through(self) -> dict[str, int]:
        snap = self.inbox.counter.snapshot()
        return {
            "in_bytes": snap["recv_bytes"],
            "out_bytes": snap["sent_bytes"],
            "in_msgs": snap["recv_msgs"],
            "out_msgs": snap["sent_msgs"],
        }

    # -- main loop --------------------------------------------------------------------

    def _loop(self) -> None:
        last_tick = time.monotonic()
        while not self._stop.is_set():
            # Drain everything already queued before dispatching: a burst of
            # TASK_DONEs (or one SUBMIT_GRAPH) then yields a single dispatch
            # pass whose per-worker RUN_BATCH coalescing actually batches.
            try:
                self._handle(self.inbox.get(timeout=0.2))
                while True:
                    self._handle(self.inbox.get_nowait())
            except queue.Empty:
                pass
            except Exception:
                import traceback

                traceback.print_exc()
            now = time.monotonic()
            if now - last_tick > 0.5:
                self._tick(now)
                last_tick = now
            self._dispatch()

    def _handle(self, message: tuple[str, dict[str, Any]]) -> None:
        tag, p = message
        if tag == M.SUBMIT:
            self._on_submit(p)
        elif tag == M.SUBMIT_GRAPH:
            self._on_submit_graph(p)
        elif tag == M.REGISTER:
            # Wire registrations carry no mailbox handle -- the CommServer
            # binds the connection as the mailbox before this message would
            # ever reach the inbox, so only in-process REGISTERs land here.
            if p.get("mailbox") is not None:
                self._register_worker(
                    p["worker"],
                    p["mailbox"],
                    p.get("nthreads", 1),
                    p.get("data_address"),
                )
        elif tag == M.DEREGISTER:
            self._on_worker_lost(p["worker"], graceful=True)
        elif tag == M.HEARTBEAT:
            ws = self.workers.get(p["worker"])
            if ws is not None:
                ws.last_heartbeat = time.monotonic()
                # Memory telemetry rides every heartbeat: the scheduler's
                # pressure-aware dispatch runs off this view.
                ws.managed_bytes = p.get("managed_bytes", ws.managed_bytes)
                ws.spilled_bytes = p.get("spilled_bytes", ws.spilled_bytes)
                ws.memory_limit = p.get("memory_limit", ws.memory_limit)
                ws.memory_state = p.get("state", ws.memory_state) or "running"
                ws.bytes_moved = p.get("bytes_moved", ws.bytes_moved)
                ws.bytes_copied = p.get("bytes_copied", ws.bytes_copied)
                if "spilled_keys" in p:
                    ws.spilled = set(p["spilled_keys"] or [])
                if "stats" in p:
                    ws.last_stats = p["stats"]
                if p.get("data_address"):
                    ws.data_address = p["data_address"]
                # Replica registration: every servable cached key makes
                # this worker a fetch candidate for dependents.  Additive
                # only (a later eviction just means a clean peer miss ->
                # next replica / store fallback) and restricted to *done*
                # tasks so a heartbeat can never resurrect released or
                # recovering state.
                for key in p.get("cached_keys") or ():
                    ts = self.tasks.get(key)
                    if ts is not None and ts.state == "done":
                        self._add_holder(ts, ws)
        elif tag == M.TASK_DONE:
            self._on_task_done(p)
        elif tag == M.TASK_FAILED:
            self._on_task_failed(p)
        elif tag == M.REPORT_BATCH:
            # A worker's coalesced completion burst: unpack in order.
            for inner in p["reports"]:
                self._handle(inner)
        elif tag == M.STEAL_ACK:
            self._on_steal_ack(p)
        elif tag == M.RELEASE:
            self._on_release(p)
        elif tag == M.STOP:
            self._stop.set()

    # -- submission ------------------------------------------------------------

    def _on_submit(self, p: dict[str, Any]) -> None:
        self._admit_task(p, p["client"])

    def _on_submit_graph(self, p: dict[str, Any]) -> None:
        """Admit a whole task graph from ONE message.

        ``tasks`` arrive in topological order (the client-side graph inserts
        nodes before their dependents), so each node's in-graph deps are
        already in ``self.tasks`` when it is admitted.  Only keys in
        ``wants`` -- the ones the client holds futures for -- get a
        waiting-client entry; interior nodes complete silently, so a
        512-task fan-in costs one FINISHED, not 512.
        """
        client_id = p["client"]
        wants = set(p.get("wants") or [])
        for spec in p["tasks"]:
            self._admit_task(spec, client_id if spec["key"] in wants else None)

    def _admit_task(self, spec: dict[str, Any], client_id: str | None) -> None:
        key = spec["key"]
        ts = self.tasks.get(key)
        if ts is not None and spec.get("pure", True):
            # Pure-function cache hit: reuse finished/inflight computation.
            # (Also the duplicate-key-across-graphs path.)
            if ts.state == "error":
                if client_id is not None:
                    self._send_client(
                        client_id, M.msg(M.FAILED, key=key, error=ts.error or "")
                    )
                return
            if client_id is not None and client_id not in ts.waiting_clients:
                ts.waiting_clients.append(client_id)
            if ts.state == "done":
                self._notify_done(ts)
            return
        ts = TaskState(
            key=key,
            func_blob=spec["func"],
            args_blob=spec["args"],
            deps=list(spec.get("deps", [])),
            pure=spec.get("pure", True),
            max_retries=spec.get("retries", 2),
            submitted_at=time.monotonic(),
        )
        if client_id is not None:
            ts.waiting_clients.append(client_id)
        unknown = [d for d in ts.deps if d not in self.tasks]
        if unknown:
            # A dependency spec the scheduler no longer holds (released or
            # never submitted) can never be computed: fail fast, don't hang.
            ts.state = "error"
            ts.error = f"unknown or released dependencies: {unknown}"
            self.tasks[key] = ts
            if client_id is not None:
                self._send_client(client_id, M.msg(M.FAILED, key=key, error=ts.error))
            ts.waiting_clients.clear()
            return
        self.tasks[key] = ts
        for dep in ts.deps:
            self.tasks[dep].dependents.add(key)
        failed = [d for d in ts.deps if self.tasks[d].state == "error"]
        if failed:
            # The dep already errored before this submission, so no future
            # completion will ever cascade here: fail now, don't hang.
            self._fail_task(
                ts, f"dependency {failed[0]} failed: {self.tasks[failed[0]].error}"
            )
            return
        ts.waiting_on = {
            d for d in ts.deps if self.tasks[d].state != "done"
        }
        if not ts.waiting_on:
            ts.state = "ready"
            self.ready.append(key)

    # -- dispatch ----------------------------------------------------------------

    def _idle_workers(self) -> list[WorkerState]:
        return [
            ws
            for ws in self.workers.values()
            if ws.alive
            and len(ws.running) < ws.nthreads
            and ws.memory_state != "paused"  # paused workers take nothing new
        ]

    def _task_bytes(self, ts: TaskState, ws: WorkerState) -> int:
        """Dependency bytes this worker would have to *fetch* to run ``ts``
        (deps it already holds are free) -- the backpressure charge."""
        return sum(
            self.tasks[d].nbytes
            for d in ts.deps
            if d in self.tasks and d not in ws.has_data
        )

    def _pick_worker(self, ts: TaskState) -> WorkerState | None:
        """Least-loaded, least-pressured alive worker, locality first.

        Memory awareness, in order of severity:

        * a **paused** worker (managed bytes above its pause threshold) is
          skipped outright -- it is not pulling from its local queue, so
          dispatching to it just buries tasks;
        * a worker whose **outstanding dependency bytes** would exceed
          ``max_outstanding_bytes`` is skipped for byte-heavy tasks
          (dispatch backpressure): returning None keeps the task in the
          ready queue for a later pass instead of piling fetch work onto
          a loaded worker;
        * among the eligible, **memory pressure** (managed/limit) weighs
          into the load score, and **spill-aware locality** prefers the
          holder whose copy is still hot (a spilled copy is served from
          disk -- cheaper than a store refetch, dearer than memory).

        Load is ``running/nthreads`` (occupancy), not a raw count -- a
        4-thread worker with 2 outstanding tasks is *less* loaded than a
        1-thread worker with 1.  Dispatch intentionally over-assigns past
        ``nthreads``: workers pipeline extra tasks through a local ready
        queue, and work stealing repairs any imbalance that develops.
        """
        alive = [
            ws
            for ws in self.workers.values()
            if ws.alive and ws.memory_state != "paused"
        ]
        if not alive:
            return None
        if ts.deps:
            fetchable = [
                ws
                for ws in alive
                if ws.outstanding_bytes + self._task_bytes(ts, ws)
                <= self.max_outstanding_bytes
                or ws.outstanding_bytes == 0  # never starve a huge task forever
            ]
            if not fetchable:
                return None

            # Locality: prefer the worker holding the most dep results --
            # hot (memory-tier) copies count double a spilled one -- but
            # only within the same whole-tasks-per-thread load band.
            # If locality dominated outright, a steal-acked task whose deps
            # live on the loaded victim would bounce straight back to it
            # (steal ping-pong) and idle workers could never help drain a
            # dep-local backlog; bytes are fetchable from peers anyway.
            def score(ws: WorkerState) -> tuple[int, int, float]:
                held = sum(
                    (1 if d in ws.spilled else 2)
                    for d in ts.deps
                    if d in ws.has_data
                )
                return (int(ws.occupancy()), -held, ws.occupancy() + ws.memory_pressure())

            return min(fetchable, key=score)
        return min(
            alive,
            key=lambda ws: (ws.occupancy() + ws.memory_pressure(), -ws.total_done),
        )

    def _dispatch(self) -> None:
        if not self.ready:
            self._maybe_steal()
            return
        remaining: list[str] = []
        batches: dict[str, list[dict[str, Any]]] = {}
        for key in self.ready:
            ts = self.tasks.get(key)
            if ts is None or ts.state != "ready":
                continue
            ws = self._pick_worker(ts)
            if ws is None or self._gate_defers(ts, ws):
                remaining.append(key)
                continue
            self._assign(ts, ws)
            batches.setdefault(ws.worker_id, []).append(self._task_payload(ts))
        self.ready = remaining
        # Pipelined batched dispatch: every task bound to the same worker in
        # this pass rides ONE message; the worker's local queue pipelines
        # them across its threads without further scheduler round-trips.
        for worker_id, payloads in batches.items():
            ws = self.workers.get(worker_id)
            if ws is None:
                continue
            if len(payloads) == 1:
                self._send_worker(ws, (M.RUN_TASK, payloads[0]))
            else:
                self._send_worker(ws, M.msg(M.RUN_BATCH, tasks=payloads))
        self._maybe_steal()

    def _gate_deps(self, ts: TaskState, ws: WorkerState) -> list[str]:
        """Gate-sized deps ``ws`` would have to fetch to run ``ts``."""
        out = []
        for d in ts.deps:
            if d in ws.has_data:
                continue
            dts = self.tasks.get(d)
            if dts is not None and dts.nbytes >= GATE_MIN_BYTES:
                out.append(d)
        return out

    def _gate_defers(self, ts: TaskState, ws: WorkerState) -> bool:
        """Fan-out admission gate: defer dispatch when a heavy dep already
        has ``holders x max_peer_fanout`` distinct workers fetching it.

        Deferred tasks stay in the ready queue and are re-checked every
        loop pass; the limit rises as fetchers finish (``_unassign``
        drains the count) and early finishers register as new holders --
        so later consumers dispatch into a world with replicas to pull
        from.  Deadlock-free: an unfetched dep has an empty fetcher map,
        so the first fetcher is always admitted."""
        for d in self._gate_deps(ts, ws):
            fetchers = self._fetching.get(d)
            if not fetchers or ws.worker_id in fetchers:
                continue  # first fetcher, or this worker already dialing
            dts = self.tasks.get(d)
            holders = max(1, len(dts.locations)) if dts is not None else 1
            if len(fetchers) >= holders * self.max_peer_fanout:
                return True
        return False

    def _assign(self, ts: TaskState, ws: WorkerState) -> None:
        ts.state = "running"
        ts.started_at = time.monotonic()
        ts.workers.add(ws.worker_id)
        ws.running.add(ts.key)
        ws.queued.append(ts.key)
        charge = self._task_bytes(ts, ws)
        if charge:
            ws.outstanding_bytes += charge
            self._assigned_bytes[(ws.worker_id, ts.key)] = charge
        heavy = self._gate_deps(ts, ws)
        if heavy:
            self._assigned_fetch_deps[(ws.worker_id, ts.key)] = heavy
            for d in heavy:
                m = self._fetching.setdefault(d, {})
                m[ws.worker_id] = m.get(ws.worker_id, 0) + 1

    def _unassign(self, ws: WorkerState, key: str) -> None:
        """Remove ``key`` from a worker's load accounting: running set,
        queued view, and the outstanding-bytes charge.  The ONLY way an
        assignment is retired -- done, failed, stolen, released, cancelled
        duplicates, and lost workers all funnel through here, so
        outstanding_bytes can never leak across lineage recovery."""
        ws.running.discard(key)
        ws.unqueue(key)
        charge = self._assigned_bytes.pop((ws.worker_id, key), None)
        if charge:
            ws.outstanding_bytes = max(0, ws.outstanding_bytes - charge)
        heavy = self._assigned_fetch_deps.pop((ws.worker_id, key), None)
        if heavy:
            for d in heavy:
                m = self._fetching.get(d)
                if m is None:
                    continue
                count = m.get(ws.worker_id, 0) - 1
                if count > 0:
                    m[ws.worker_id] = count
                else:
                    m.pop(ws.worker_id, None)
                    if not m:
                        self._fetching.pop(d, None)

    def _task_payload(self, ts: TaskState) -> dict[str, Any]:
        # Dependency *metadata* only: inline blobs for tiny results, a
        # (ref, nbytes, locations) descriptor for everything published.
        inline_deps: dict[str, bytes] = {}
        dep_info: dict[str, dict[str, Any]] = {}
        for d in ts.deps:
            dts = self.tasks.get(d)
            if dts is None:
                continue
            if dts.result_blob is not None:
                inline_deps[d] = dts.result_blob
            else:
                locations = sorted(dts.locations)
                entry: dict[str, Any] = {
                    "ref": dts.ref,
                    "nbytes": dts.nbytes,
                    "locations": locations,
                }
                # Data addresses of alive holders: the dependent can fetch
                # straight from a peer's data server (cache -> shm ->
                # peer-wire -> store resolution order) instead of paying a
                # store round trip.  Metadata only -- a handful of connect
                # strings, never payload bytes.  Resolved against *current*
                # WorkerState at every (re)dispatch -- a payload built after
                # lineage recovery or a steal never names a dead producer.
                #
                # Ordered: freshest replicas first (their copy is hottest,
                # and preferring them spreads fan-out load off the
                # producer), the origin last as the most reliable fallback;
                # bounded at max_peer_fanout entries.
                holders = []
                for w in locations:
                    hws = self.workers.get(w)
                    if hws is not None and hws.alive and hws.data_address:
                        holders.append(
                            (dts.holder_seq.get(w, 0), w, hws.data_address)
                        )
                if holders:
                    holders.sort()
                    origin, replicas = holders[0], holders[1:]
                    ordered = list(reversed(replicas)) + [origin]
                    if len(ordered) > self.max_peer_fanout:
                        ordered = ordered[: self.max_peer_fanout - 1] + [origin]
                    entry["peers"] = [[w, a] for _, w, a in ordered]
                dep_info[d] = entry
        return {
            "key": ts.key,
            "func": ts.func_blob,
            "args": ts.args_blob,
            "deps": ts.deps,
            "dep_info": dep_info,
            "inline_deps": inline_deps,
        }

    def _run_on(self, ts: TaskState, ws: WorkerState) -> None:
        """Single-task dispatch (speculative duplicates)."""
        self._assign(ts, ws)
        self._send_worker(ws, (M.RUN_TASK, self._task_payload(ts)))

    # -- work stealing -----------------------------------------------------------

    def _maybe_steal(self) -> None:
        """Rebalance unstarted backlog toward workers with free threads.

        Two-phase and confirm-based: the victim replies STEAL_ACK naming
        exactly the keys it removed from its local queue *before* starting
        them; only those re-enter the ready queue.  A task the victim
        already began is simply not taken, so stealing can never make a
        task run twice.
        """
        hungry = [
            ws
            for ws in self.workers.values()
            if ws.alive
            and len(ws.running) < ws.nthreads
            and ws.memory_state != "paused"  # a paused worker must not pull
        ]
        if not hungry:
            return
        want = sum(ws.nthreads - len(ws.running) for ws in hungry)

        def stealable(ws: WorkerState) -> int:
            free = len([k for k in ws.queued if k not in self._stealing])
            return free - ws.nthreads  # keep the likely-running head

        victim = max(
            (ws for ws in self.workers.values() if ws.alive),
            key=stealable,
            default=None,
        )
        if victim is None or stealable(victim) <= 0:
            return
        backlog = stealable(victim)
        take = min(backlog, max(want, backlog // 2))
        keys: list[str] = []
        for k in reversed(victim.queued):  # tail = least likely started
            if len(keys) >= take:
                break
            if k in self._stealing:
                continue
            ts = self.tasks.get(k)
            if ts is None or ts.state != "running":
                continue
            keys.append(k)
        if not keys:
            return
        self._stealing.update(keys)
        self._send_worker(victim, M.msg(M.STEAL, keys=keys))

    def _on_steal_ack(self, p: dict[str, Any]) -> None:
        worker_id = p["worker"]
        taken = p.get("taken") or []
        for k in p.get("requested") or []:
            self._stealing.discard(k)
        ws = self.workers.get(worker_id)
        for k in taken:
            if ws is not None:
                self._unassign(ws, k)
            ts = self.tasks.get(k)
            if ts is None or ts.state != "running":
                continue
            ts.workers.discard(worker_id)
            if not ts.workers:  # no speculative copy still running elsewhere
                ts.state = "ready"
                self.ready.append(k)

    # -- completion ----------------------------------------------------------------

    def _add_holder(self, ts: TaskState, ws: WorkerState) -> None:
        """Register ``ws`` as a replica holder of ``ts``'s result bytes,
        stamping the freshness sequence on first registration.  Every
        holder-add path (completion, duplicate completion, cached-dep
        report, heartbeat announcement) funnels through here so the
        peer-list ordering in ``_task_payload`` stays consistent."""
        if ts.key not in ws.has_data:
            self._holder_seq += 1
            ts.holder_seq[ws.worker_id] = self._holder_seq
        ts.locations.add(ws.worker_id)
        ws.has_data.add(ts.key)

    def _on_task_done(self, p: dict[str, Any]) -> None:
        key, worker_id = p["key"], p["worker"]
        ref = p.get("ref")
        ts = self.tasks.get(key)
        ws = self.workers.get(worker_id)
        if ws is not None:
            self._unassign(ws, key)
            ws.total_done += 1
            # The completing worker fetched (and still caches) these deps:
            # register it as a replica holder so later consumers of a
            # fan-out pull from it instead of queueing on the producer.
            for d in p.get("cached_deps") or ():
                dts = self.tasks.get(d)
                if dts is not None and dts.state == "done":
                    self._add_holder(dts, ws)
        if ts is None or ts.state == "done":
            # Duplicate speculative completion (or completion after release).
            if ref is not None:
                if ts is not None and ref == ts.ref:
                    # Same deterministic ref: the duplicate overwrote the
                    # same entry; just record the extra holder.
                    if ws is not None:
                        self._add_holder(ts, ws)
                    else:
                        ts.locations.add(worker_id)
                else:
                    # Distinct ref (non-peer connector) or task already
                    # released: reclaim the orphan publish exactly once.
                    self.ledger.track(ref)
                    self.ledger.release(ref)
            return
        ts.state = "done"
        ts.finished_at = time.monotonic()
        ts.nbytes = p.get("nbytes", 0)
        self._durations.append(ts.finished_at - ts.started_at)
        if p.get("result") is not None:
            ts.result_blob = p["result"]
        if ref is not None:
            ts.ref = ref
            self.ledger.track(ref, ts.nbytes)
        if ws is not None:
            self._add_holder(ts, ws)
        else:
            ts.locations.add(worker_id)
        # cancel speculative duplicates
        for other_id in list(ts.workers):
            if other_id != worker_id:
                other = self.workers.get(other_id)
                if other is not None and key in other.running:
                    self._unassign(other, key)
                    self._send_worker(other, M.msg(M.CANCEL, key=key))
        self._notify_done(ts)
        for dep_key in ts.dependents:
            dts = self.tasks.get(dep_key)
            if dts is None:
                continue
            dts.waiting_on.discard(key)
            if dts.state == "waiting" and not dts.waiting_on:
                dts.state = "ready"
                self.ready.append(dep_key)

    def _notify_done(self, ts: TaskState) -> None:
        for client_id in ts.waiting_clients:
            self._send_client(
                client_id,
                M.msg(
                    M.FINISHED,
                    key=ts.key,
                    result=ts.result_blob,
                    ref=ts.ref,
                    nbytes=ts.nbytes,
                ),
            )
        ts.waiting_clients.clear()

    def _on_task_failed(self, p: dict[str, Any]) -> None:
        key, worker_id = p["key"], p["worker"]
        ts = self.tasks.get(key)
        ws = self.workers.get(worker_id)
        if ws is not None:
            self._unassign(ws, key)
        if ts is None or ts.state == "done":
            return
        missing = p.get("missing_deps") or []
        if missing:
            self._recover_lineage(ts, worker_id, missing)
            return
        ts.attempts += 1
        if ts.attempts <= ts.max_retries:
            ts.state = "ready"
            ts.workers.clear()
            self.ready.append(key)
            return
        self._fail_task(ts, p.get("error", "unknown error"))

    def _fail_task(self, ts: TaskState, error: str) -> None:
        """Mark a task failed, notify its clients, and cascade the failure
        to dependents that can now never run -- a recomputation that dies
        during lineage recovery must not leave its dependents (whose
        clients were already notified of the *first* completion) hanging."""
        ts.state = "error"
        ts.error = error
        for client_id in ts.waiting_clients:
            self._send_client(client_id, M.msg(M.FAILED, key=ts.key, error=error))
        ts.waiting_clients.clear()
        for dep_key in ts.dependents:
            dts = self.tasks.get(dep_key)
            if dts is not None and dts.state in ("waiting", "ready"):
                self._fail_task(dts, f"dependency {ts.key} failed: {error}")

    # -- lineage recovery -------------------------------------------------------

    def _recover_lineage(self, ts: TaskState, worker_id: str, missing: list[str]) -> None:
        """A worker could not fetch dependency bytes from any holder or the
        store: recompute the upstream tasks from their retained specs and
        re-queue the dependent.  Data loss is not the dependent's fault, so
        it costs a bounded ``recoveries`` budget, not a retry attempt."""
        ts.recoveries += 1
        ts.workers.discard(worker_id)
        recoverable = True
        for dep in missing:
            dts = self.tasks.get(dep)
            if dts is None or ts.recoveries > MAX_RECOVERIES:
                recoverable = False
                continue
            if dts.state == "done":
                # Invalidate the lost result; the ref entry (if any) will be
                # overwritten by the recomputation's publish.
                dts.state = "ready"
                dts.result_blob = None
                dts.workers.clear()
                for holder in dts.locations:
                    hws = self.workers.get(holder)
                    if hws is not None:
                        hws.has_data.discard(dep)
                dts.locations.clear()
                dts.holder_seq.clear()
                self.ready.append(dep)
                # Every still-waiting dependent must wait on it again.
                for dependent in dts.dependents:
                    other = self.tasks.get(dependent)
                    if other is not None and other.state == "waiting":
                        other.waiting_on.add(dep)
        if not recoverable:
            self._fail_task(ts, f"dependencies {missing} lost and unrecoverable")
            return
        ts.state = "waiting"  # re-queued by _on_task_done of the recomputed dep
        ts.waiting_on = {
            d for d in ts.deps
            if d in self.tasks and self.tasks[d].state != "done"
        }

    # -- release -----------------------------------------------------------

    def _on_release(self, p: dict[str, Any]) -> None:
        released = set(p["keys"])
        for key in released:
            ts = self.tasks.pop(key, None)
            if ts is None:
                continue
            if ts.ref is not None:
                # Exactly-once store eviction, no matter how many duplicate
                # publishes or repeated releases hit this ref.
                self.ledger.release(ts.ref)
            self._stealing.discard(key)
            for worker_id in ts.workers:
                # Still dispatched somewhere: drop it from that worker's
                # load accounting (running set, queue view, outstanding
                # bytes) so stale keys can't skew occupancy, backpressure,
                # or trigger futile steals.
                ws = self.workers.get(worker_id)
                if ws is not None:
                    self._unassign(ws, key)
            for worker_id in ts.locations:
                ws = self.workers.get(worker_id)
                if ws is not None:
                    ws.has_data.discard(key)
                    self._send_worker(ws, M.msg(M.CANCEL, key=key, release=True))
        # Purge released keys from the ready queue so they can never be
        # dispatched (and so the list does not grow unboundedly).
        if released:
            self.ready = [k for k in self.ready if k not in released]

    # -- periodic maintenance: heartbeats + speculation ---------------------------

    def _tick(self, now: float) -> None:
        for worker_id, ws in list(self.workers.items()):
            if ws.alive and now - ws.last_heartbeat > self.heartbeat_timeout:
                self._on_worker_lost(worker_id, graceful=False)
        self._speculate(now)

    def _on_worker_lost(self, worker_id: str, graceful: bool) -> None:
        ws = self.workers.get(worker_id)
        if ws is None:
            return
        ws.alive = False
        for key in list(ws.running):
            self._stealing.discard(key)  # any in-flight STEAL will never ack
            ts = self.tasks.get(key)
            if ts is not None and ts.state == "running":
                ts.workers.discard(worker_id)
                if not ts.workers:  # no speculative copy elsewhere
                    ts.attempts += 1
                    if ts.attempts <= ts.max_retries + 1:
                        ts.state = "ready"
                        self.ready.append(key)
                    else:
                        self._fail_task(ts, f"worker {worker_id} lost")
        for key in ws.has_data:
            ts = self.tasks.get(key)
            if ts is not None:
                # The worker's cached copy is gone; the store entry (ts.ref)
                # survives, so done tasks stay done -- only peer locality is
                # lost.  Bytes lost from the store too surface later as
                # missing_deps and go through lineage recovery.
                ts.locations.discard(worker_id)
        # Purge the dead worker's outstanding-bytes charges: its WorkerState
        # goes away, but the charge map must not accumulate ghosts.
        for wk in [wk for wk in self._assigned_bytes if wk[0] == worker_id]:
            del self._assigned_bytes[wk]
        # Same for the fan-out gate's fetcher counts: a dead fetcher must
        # not hold the admission gate closed.
        for wk in [wk for wk in self._assigned_fetch_deps if wk[0] == worker_id]:
            del self._assigned_fetch_deps[wk]
        for d in list(self._fetching):
            self._fetching[d].pop(worker_id, None)
            if not self._fetching[d]:
                del self._fetching[d]
        if ws.data_address:
            # Prompt peer-wire invalidation: every live worker drops its
            # pooled connections to the dead data server, so in-flight and
            # future fetches fail fast to the store instead of waiting out
            # a socket timeout on a vanished peer.
            gone = M.msg(M.PEER_GONE, worker=worker_id, address=ws.data_address)
            for other in self.workers.values():
                if other.alive and other.worker_id != worker_id:
                    self._send_worker(other, gone)
        del self.workers[worker_id]

    def _probably_started(self, ts: TaskState) -> bool:
        """Whether some assigned worker has plausibly *begun* this task.

        ``started_at`` is stamped at dispatch, but over-assigned tasks can
        sit unstarted in a worker's local queue for a long time -- that is
        queue wait, not straggling, and it is work stealing's job.  A key
        stays in the scheduler-side ``queued`` deque until TASK_DONE, so
        "within the first ``nthreads`` slots" approximates "running"; the
        scan is bounded to those slots (O(workers x nthreads) per
        candidate), never the whole backlog.
        """
        seen_assigned = False
        for worker_id in ts.workers:
            ws = self.workers.get(worker_id)
            if ws is None:
                continue
            seen_assigned = True
            for pos, key in enumerate(ws.queued):
                if pos >= ws.nthreads:
                    break
                if key == ts.key:
                    return True
        # No live assigned worker found: let the worker-lost path decide.
        return not seen_assigned

    def _speculate(self, now: float) -> None:
        if len(self._durations) < 3:
            return
        med = sorted(self._durations)[len(self._durations) // 2]
        threshold = max(self.speculation_min, self.speculation_factor * med)
        idle = self._idle_workers()
        if not idle:
            return
        for ts in self.tasks.values():
            if (
                ts.state == "running"
                and not ts.speculated
                and now - ts.started_at > threshold
                and self._probably_started(ts)
            ):
                candidates = [ws for ws in idle if ws.worker_id not in ts.workers]
                if not candidates:
                    continue
                ts.speculated = True
                self._run_on(ts, candidates[0])
                idle = self._idle_workers()
                if not idle:
                    return
