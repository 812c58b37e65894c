"""Client, ProxyClient, and LocalCluster.

``Client`` mirrors Dask Distributed's futures API (submit/map/gather).
``ProxyClient`` is the paper's drop-in replacement (Fig 2b): identical API,
but task inputs and outputs larger than ``ps_threshold`` are automatically
routed through a ProxyStore ``Store``, so the scheduler only ever moves
lightweight references.

Gather rides the peer-to-peer data plane: ``FINISHED`` carries either a
tiny inline blob or a ``(ref, nbytes)`` descriptor, and the client fetches
the bytes straight from the cluster store -- result blobs never pass
through the scheduler mailbox.
"""

from __future__ import annotations

import functools
import queue
import shutil
import tempfile
import threading
import time
import uuid
from concurrent.futures import Future
from typing import Any, Callable, Iterable, Sequence

from repro_torch.core.compress import TransferLedger
from repro_torch.core.executor import _proxy_result_task
from repro_torch.core.policy import Policy, SizePolicy
from repro_torch.core.proxy import is_proxy
from repro_torch.core.serialize import deserialize, serialize
from repro_torch.core.store import Store
from repro_torch.runtime import messages as M
from repro_torch.runtime.graph import FutureRef, GraphNode, TaskGraph, find_refs, tokenize
from repro_torch.runtime.scheduler import Mailbox, Scheduler
from repro_torch.runtime.transfer import PeerTransfer, ResultStore
from repro_torch.runtime.worker import ThreadWorker, dumps_function


class RuntimeFuture(Future):
    """concurrent.futures.Future plus the task key it tracks."""

    def __init__(self, key: str, client: "Client"):
        super().__init__()
        self.key = key
        self._client = client

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        return f"<RuntimeFuture {self.key} {self._state}>"


class Client:
    """Futures-based client for the runtime scheduler."""

    def __init__(self, cluster: "LocalCluster"):
        self.cluster = cluster
        self.scheduler = cluster.scheduler
        self.client_id = f"client-{uuid.uuid4().hex[:8]}"
        self.mailbox = Mailbox(self.client_id)
        self.scheduler.register_client(self.client_id, self.mailbox)
        self._results: ResultStore | None = getattr(cluster, "data_plane", None)
        self._futures: dict[str, list[RuntimeFuture]] = {}
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._pump = threading.Thread(target=self._pump_loop, daemon=True)
        self._pump.start()

    # -- submission -----------------------------------------------------------

    def submit(
        self,
        fn: Callable,
        /,
        *args: Any,
        pure: bool = True,
        retries: int = 2,
        **kwargs: Any,
    ) -> RuntimeFuture:
        args_spec, deps = self._encode_args(args, kwargs)
        if pure:
            # Tokenize the *converted* spec: futures hash by task key
            # (deterministic), everything else by content.
            key = tokenize(
                fn, args_spec["args"], sorted(args_spec["kwargs"].items(), key=repr)
            )
        else:
            key = f"task-{uuid.uuid4().hex}"
        future = RuntimeFuture(key, self)
        with self._lock:
            self._futures.setdefault(key, []).append(future)
        self.scheduler.inbox.put_msg(
            M.msg(
                M.SUBMIT,
                key=key,
                client=self.client_id,
                func=dumps_function(fn),
                args=serialize(args_spec).to_bytes(),
                deps=deps,
                pure=pure,
                retries=retries,
            )
        )
        return future

    def submit_graph(
        self, graph: TaskGraph, nodes: Sequence[GraphNode] | None = None
    ) -> list[RuntimeFuture]:
        """Submit a whole :class:`TaskGraph` as ONE scheduler message.

        Returns futures for ``nodes`` (default: the graph's outputs).
        Interior nodes run without any per-task client traffic: the
        scheduler sends FINISHED only for the keys futures were requested
        for, so an N-task fan-in costs one SUBMIT_GRAPH and one FINISHED
        instead of N SUBMITs and N FINISHEDs.
        """
        nodes = graph.outputs() if nodes is None else list(nodes)
        # Validate before registering any future: a bad node must not leave
        # earlier valid nodes with forever-pending futures.
        for node in nodes:
            if node.key not in graph:
                raise ValueError(f"node {node.key} is not part of this graph")
        futures: list[RuntimeFuture] = []
        with self._lock:
            for node in nodes:
                future = RuntimeFuture(node.key, self)
                self._futures.setdefault(node.key, []).append(future)
                futures.append(future)
        tasks = []
        fn_blobs: dict[int, bytes] = {}  # graphs reuse fns heavily (map!)
        for key, spec in graph.items():
            fn = spec["fn"]
            blob = fn_blobs.get(id(fn))
            if blob is None:
                blob = fn_blobs[id(fn)] = dumps_function(fn)
            args = [self._prepare_arg(a) for a in spec["args"]]
            kwargs = {k: self._prepare_arg(v) for k, v in spec["kwargs"].items()}
            tasks.append(
                {
                    "key": key,
                    "func": blob,
                    # Structured, not pre-serialized: the arg spec rides the
                    # single SUBMIT_GRAPH (and later RUN_BATCH) encode, so
                    # nothing pays a per-task serialize/deserialize pass.
                    "args": {"args": args, "kwargs": kwargs},
                    "deps": spec["deps"],
                    "pure": spec["pure"],
                    "retries": spec["retries"],
                }
            )
        self.scheduler.inbox.put_msg(
            M.msg(
                M.SUBMIT_GRAPH,
                client=self.client_id,
                tasks=tasks,
                wants=sorted({n.key for n in nodes}),
            )
        )
        return futures

    def _prepare_arg(self, obj: Any) -> Any:
        """Hook for subclasses to transform graph-node arguments at submit
        time (ProxyClient swaps large values for proxies)."""
        return obj

    def _encode_args(
        self, args: Sequence[Any], kwargs: dict[str, Any]
    ) -> tuple[dict[str, Any], list[str]]:
        deps: list[str] = []

        def conv(obj: Any) -> Any:
            if isinstance(obj, RuntimeFuture):
                deps.append(obj.key)
                return FutureRef(obj.key)
            if isinstance(obj, list):
                return [conv(x) for x in obj]
            if isinstance(obj, tuple):
                return tuple(conv(x) for x in obj)
            if isinstance(obj, dict):
                return {k: conv(v) for k, v in obj.items()}
            return obj

        spec = {
            "args": [conv(a) for a in args],
            "kwargs": {k: conv(v) for k, v in kwargs.items()},
        }
        return spec, sorted(set(deps))

    def map(self, fn: Callable, *iterables: Iterable, **kwargs: Any) -> list[RuntimeFuture]:
        """Batch the whole map into one graph submission (one message),
        instead of N per-task SUBMIT round-trips."""
        pure = kwargs.pop("pure", True)
        retries = kwargs.pop("retries", 2)
        graph = TaskGraph()
        # add_call keeps remaining user kwargs (even ones named `key`)
        # flowing to the function instead of colliding with task params.
        nodes = [
            graph.add_call(fn, args, kwargs, pure=pure, retries=retries)
            for args in zip(*iterables)
        ]
        if not nodes:
            return []
        return self.submit_graph(graph, nodes=nodes)

    def gather(self, futures: Sequence[RuntimeFuture]) -> list[Any]:
        return [f.result() for f in futures]

    def release(self, futures: Sequence[RuntimeFuture]) -> None:
        keys = [f.key for f in futures]
        with self._lock:
            for k in keys:
                self._futures.pop(k, None)
        self.scheduler.inbox.put_msg(M.msg(M.RELEASE, keys=keys, client=self.client_id))

    # -- result pump ------------------------------------------------------------

    def _pump_loop(self) -> None:
        while not self._stop.is_set():
            try:
                tag, p = self.mailbox.get(timeout=0.2)
            except queue.Empty:
                continue
            if tag == M.FINISHED:
                self._on_finished(p)
            elif tag == M.FAILED:
                self._on_failed(p)

    def _take_futures(self, table: dict, key: str) -> list[RuntimeFuture]:
        with self._lock:
            return table.pop(key, [])

    def _on_finished(self, p: dict[str, Any]) -> None:
        key = p["key"]
        futures = self._take_futures(self._futures, key)
        if not futures:
            return
        if p.get("result") is not None:
            self._resolve(futures, p["result"])
            return
        # Large result: fetch it from the data plane by reference -- the
        # scheduler only relayed (ref, nbytes).  The fetch is frame-native
        # (a FrameBundle view of the store's bytes: retained frames, an
        # mmap'd file, an attached shm segment) and ``deserialize``
        # reconstructs arrays directly over it -- gather never joins.
        ref = p.get("ref")
        if ref is None or self._results is None:
            for f in futures:
                if not f.done():
                    f.set_exception(
                        RuntimeError(f"result of {key} has no inline blob or ref")
                    )
            return
        blob = self._results.fetch(ref, p.get("nbytes", -1))
        if blob is None:
            for f in futures:
                if not f.done():
                    f.set_exception(
                        RuntimeError(f"result of {key} missing from cluster store")
                    )
            return
        self._resolve(futures, blob)

    def _resolve(self, futures: list[RuntimeFuture], blob: Any) -> None:
        result = deserialize(blob)
        for f in futures:
            if not f.done():
                f.set_result(result)

    def _on_failed(self, p: dict[str, Any]) -> None:
        for f in self._take_futures(self._futures, p["key"]):
            if not f.done():
                f.set_exception(RuntimeError(p.get("error", "task failed")))

    # -- lifecycle ------------------------------------------------------------------

    def close(self) -> None:
        self._stop.set()
        self.scheduler.unregister_client(self.client_id)

    def __enter__(self) -> "Client":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class ProxyClient(Client):
    """Drop-in Dask-style client with automatic pass-by-proxy (Fig 2b)."""

    def __init__(
        self,
        cluster: "LocalCluster",
        ps_store: Store,
        ps_threshold: int = 100_000,
        should_proxy: Policy | None = None,
        proxy_results: bool = True,
    ):
        super().__init__(cluster)
        self.store = ps_store
        self.should_proxy: Policy = should_proxy or SizePolicy(ps_threshold)
        self.proxy_results = proxy_results

    def _maybe_proxy(self, obj: Any) -> Any:
        if isinstance(obj, (RuntimeFuture, FutureRef)) or is_proxy(obj):
            return obj
        if isinstance(obj, (list, tuple, dict)) and find_refs(obj):
            return obj  # keep structures holding future refs intact
        if self.should_proxy(obj):
            return self.store.proxy(obj, evict=False)
        return obj

    def _prepare_arg(self, obj: Any) -> Any:
        # Graph-node args pass by proxy exactly like per-task submit args,
        # so a batched SUBMIT_GRAPH stays metadata-sized on the hub.
        return self._maybe_proxy(obj)

    def submit(self, fn: Callable, /, *args: Any, **kwargs: Any) -> RuntimeFuture:
        pure = kwargs.pop("pure", True)
        retries = kwargs.pop("retries", 2)
        args = tuple(self._maybe_proxy(a) for a in args)
        kwargs = {k: self._maybe_proxy(v) for k, v in kwargs.items()}
        if self.proxy_results:
            fn = functools.partial(
                _proxy_result_task,
                fn,
                self.store.config(),
                self.should_proxy,
                False,
            )
        return super().submit(fn, *args, pure=pure, retries=retries, **kwargs)


class LocalCluster:
    """Scheduler + N workers + a shared data plane in one process.

    The scheduler is a metadata-only control plane; every worker and
    client shares a cluster store namespace (``data_plane``) plus a
    direct worker-to-worker transfer mesh (``transfers``).  Supports
    elastic scaling (``add_worker``/``remove_worker``) and fault injection
    (``kill_worker``) for the fault-tolerance tests.

    ``memory`` (an ``api.MemorySpec`` or its wire dict) gives every worker
    a managed-memory budget: caches become tiered (spill-to-disk instead
    of drop), workers pause above the budget's pause threshold, and the
    scheduler's dispatch backpressure scales to the budget.
    ``worker_stats()`` surfaces the live per-worker telemetry.

    ``worker_kind="process"`` spawns each worker in its own interpreter
    connected over ``transport`` (tcp) -- CPU-bound graphs escape the GIL.
    Each process worker runs a data server so dependencies resolve
    cache -> shm attach (same host) -> direct peer wire fetch -> shared
    store (file connector by default), mirroring the thread backend's
    peer mesh over a real socket; ``TransferSpec(peer_transfer=...,
    pool_size=..., chunk_bytes=...)`` are the knobs.
    """

    def __init__(
        self,
        n_workers: int = 4,
        *,
        threads_per_worker: int = 1,
        heartbeat_timeout: float = 5.0,
        speculation_factor: float = 4.0,
        speculation_min: float = 1.0,
        store: Any = None,  # StoreConfig | config dict | None
        inline_result_max: int = 64 * 1024,
        worker_cache_bytes: int = 256 * 1024 * 1024,
        memory: Any = None,  # api.MemorySpec | wire dict | None
        transfer: Any = None,  # api.TransferSpec | wire dict | None
        worker_kind: str = "thread",  # thread | process
        transport: str | None = None,  # None | inproc | tcp
        serve: Any = None,  # api.ServeSpec | wire dict | None
    ):
        uid = uuid.uuid4().hex[:8]
        self._uid = uid
        if worker_kind not in ("thread", "process"):
            raise ValueError(f"worker_kind must be thread|process, got {worker_kind!r}")
        if worker_kind == "process":
            transport = transport or "tcp"
            if transport != "tcp":
                raise ValueError(
                    f"process workers require transport='tcp', got {transport!r}"
                )
        self.worker_kind = worker_kind
        self.transport = transport
        self._store_dir: str | None = None
        if store is None:
            if worker_kind == "process":
                # Memory-connector segments are process-local; the file
                # connector is the default cross-process store tier.
                self._store_dir = tempfile.mkdtemp(prefix=f"cluster-{uid}-")
                store_config = {
                    "name": f"cluster-{uid}",
                    "connector": {
                        "connector_type": "file",
                        "store_dir": self._store_dir,
                    },
                    "serializer": "default",
                    "cache_size": 0,
                }
            else:
                store_config = {
                    "name": f"cluster-{uid}",
                    "connector": {
                        "connector_type": "memory",
                        "segment": f"cluster-{uid}",
                    },
                    "serializer": "default",
                    "cache_size": 0,
                }
        elif hasattr(store, "to_dict"):  # api.StoreConfig without importing api
            store_config = store.to_dict()
        else:
            store_config = dict(store)
        if (
            worker_kind == "process"
            and store_config.get("connector", {}).get("connector_type") == "memory"
        ):
            raise ValueError(
                "the memory connector is process-local and cannot back "
                "process workers; use a file, shm, or kv store"
            )
        # TransferSpec travels as its wire dict (like MemorySpec) so the
        # runtime never imports api.  It configures compression on every
        # byte path: comm links, store publishes/fetches, and spill disks.
        if transfer is not None and hasattr(transfer, "to_dict"):
            transfer = transfer.to_dict()
        self.transfer_config = dict(transfer) if transfer is not None else None
        if self.transfer_config is not None:
            store_config = {**store_config, "transfer": self.transfer_config}
        self.data_plane = ResultStore(store_config)
        # Thread workers share this in-process cache mesh; process workers
        # get the wire equivalent (a per-worker DataServer + pooled
        # PeerWireClient, built in proc.start_comm_worker).  The mesh
        # object always exists so telemetry reads uniformly.  Both paths
        # move bytes in TransferSpec(chunk_bytes=...) pieces.
        chunk = (self.transfer_config or {}).get("chunk_bytes")
        self.transfers = PeerTransfer(**({"chunk_size": int(chunk)} if chunk else {}))
        self.worker_cache_bytes = worker_cache_bytes
        # MemorySpec travels as its wire dict so runtime never imports api.
        if memory is not None and hasattr(memory, "to_dict"):
            memory = memory.to_dict()
        self.memory_config = dict(memory) if memory is not None else None
        if self.memory_config is not None:
            # Backpressure cap scales with the budget: a worker owing half
            # its memory budget in un-fetched dependency bytes is loaded.
            # (Partial wire dicts default like the worker does.)
            limit = int(self.memory_config.get("limit_bytes", worker_cache_bytes))
            max_outstanding = max(1, limit // 2)
        else:
            max_outstanding = 128 * 1024 * 1024
        self.scheduler = Scheduler(
            heartbeat_timeout=heartbeat_timeout,
            speculation_factor=speculation_factor,
            speculation_min=speculation_min,
            inline_result_max=inline_result_max,
            result_store=self.data_plane,
            max_outstanding_bytes=max_outstanding,
            max_peer_fanout=int(
                (self.transfer_config or {}).get("max_peer_fanout") or 4
            ),
        ).start()
        self._server = None
        if transport is not None:
            from repro_torch.runtime.proc import CommServer

            address = (
                "tcp://127.0.0.1:0" if transport == "tcp" else f"inproc://cluster-{uid}"
            )
            self._server = CommServer(
                self.scheduler, address, transfer=self.transfer_config
            )
        # ServeSpec travels as its wire dict (like MemorySpec/TransferSpec)
        # so the runtime never imports api; Session.serve() reads the knobs.
        if serve is not None and hasattr(serve, "to_dict"):
            serve = serve.to_dict()
        self.serve_config = dict(serve) if serve is not None else None
        self._streams = None  # lazy StreamHub (see streams())
        self._streams_lock = threading.Lock()
        self._comms: dict[str, Any] = {}
        self.workers: dict[str, Any] = {}  # ThreadWorker | ProcessWorker
        for _ in range(n_workers):
            self.add_worker(threads_per_worker)

    def add_worker(self, nthreads: int = 1) -> str:
        worker_id = f"worker-{len(self.workers)}-{uuid.uuid4().hex[:6]}"
        if self.worker_kind == "process":
            from repro_torch.runtime.proc import ProcessWorker

            cfg = {
                "nthreads": nthreads,
                "store": self.data_plane.config(),
                "cache_bytes": self.worker_cache_bytes,
                "memory": self.memory_config,
                "transfer": self.transfer_config,
                "inline_result_max": self.scheduler.inline_result_max,
            }
            w = ProcessWorker(worker_id, self._server.address, cfg).start()
        elif self.transport is not None:
            # Thread workers over the wire: same threads, but every message
            # crosses a real transport -- the conformance configuration.
            from repro_torch.runtime.proc import start_comm_worker

            w, comm = start_comm_worker(
                self._server.address,
                worker_id,
                nthreads=nthreads,
                result_store=self.data_plane,
                transfers=self.transfers,
                cache_bytes=self.worker_cache_bytes,
                memory=self.memory_config,
                transfer=self.transfer_config,
                inline_result_max=self.scheduler.inline_result_max,
            )
            self._comms[worker_id] = comm
        else:
            w = ThreadWorker(
                worker_id,
                self.scheduler,
                nthreads=nthreads,
                result_store=self.data_plane,
                transfers=self.transfers,
                cache_bytes=self.worker_cache_bytes,
                memory=self.memory_config,
                transfer=self.transfer_config,
            ).start()
        self.workers[worker_id] = w
        return worker_id

    def wait_for_workers(self, n: int | None = None, timeout: float = 60.0) -> None:
        """Block until ``n`` (default: all spawned) workers have completed
        wire registration -- process workers register asynchronously."""
        n = len(self.workers) if n is None else n
        deadline = time.monotonic() + timeout
        while True:
            alive = sum(1 for ws in self.scheduler.workers.values() if ws.alive)
            if alive >= n:
                return
            if time.monotonic() >= deadline:
                raise TimeoutError(
                    f"only {alive}/{n} workers registered within {timeout}s"
                )
            time.sleep(0.02)

    def remove_worker(self, worker_id: str) -> None:
        w = self.workers.pop(worker_id, None)
        if w is not None:
            if not isinstance(w, ThreadWorker):
                # A process worker must be told over the wire; stop() alone
                # would wait out the join timeout and then escalate.
                ws = self.scheduler.workers.get(worker_id)
                if ws is not None:
                    try:
                        ws.mailbox.put_msg(M.msg(M.STOP))
                    except Exception:
                        pass
            w.stop()
            self._comms.pop(worker_id, None)
            self.scheduler.inbox.put_msg(M.msg(M.DEREGISTER, worker=worker_id))

    def kill_worker(self, worker_id: str) -> None:
        """Abrupt failure: no deregistration, heartbeats just stop."""
        w = self.workers.pop(worker_id, None)
        if w is not None:
            w.kill()
            self._comms.pop(worker_id, None)

    def get_client(self) -> Client:
        return Client(self)

    def streams(self):
        """The cluster's lazy :class:`~repro_torch.runtime.stream.StreamHub`.

        Thread clusters get an in-process broker; clusters with a wire
        transport get a :class:`BrokerServer` on a matching address, so
        stream events cross the same kind of link as control traffic.
        Payload bytes always ride ``data_plane`` -- the hub holds a handle,
        never a copy.
        """
        with self._streams_lock:
            if self._streams is None:
                from repro_torch.runtime.stream import StreamHub

                address = None
                if self.transport == "tcp":
                    address = "tcp://127.0.0.1:0"
                elif self.transport == "inproc":
                    address = f"inproc://stream-{self._uid}"
                self._streams = StreamHub(self.data_plane, address=address)
            return self._streams

    def worker_stats(self) -> dict[str, dict[str, Any]]:
        """Per-worker memory/telemetry view, one row per live worker:
        ``{running, managed_bytes, spilled_bytes, state, bytes_moved,
        bytes_copied, copies_per_byte, zero_copy_hits, ...}``.

        ``running`` is the scheduler's dispatched-not-done count; for
        in-process workers the memory and copy-accounting fields read the
        worker's live accounting directly (not the last heartbeat), so
        tests and dashboards see current state.  A process worker has no
        reachable object to ask, so its row is the full ``stats()``
        snapshot carried by its last heartbeat.
        """
        out: dict[str, dict[str, Any]] = {}
        for worker_id, w in self.workers.items():
            ws = self.scheduler.workers.get(worker_id)
            if hasattr(w, "stats"):
                row = w.stats()
            elif ws is not None and ws.last_stats is not None:
                row = dict(ws.last_stats)
            else:
                row = {}  # process worker that has not heartbeat yet
            row["running"] = len(ws.running) if ws is not None else 0
            row["outstanding_bytes"] = ws.outstanding_bytes if ws is not None else 0
            out[worker_id] = row
        return out

    def transfer_summary(self) -> dict[str, dict[str, Any]]:
        """Cluster-wide transfer ledger: per-link-class logical vs wire
        bytes, compression ratio, and codec throughput, merged across
        every worker's ``transfer_ledger`` row (live for thread workers,
        last-heartbeat for process workers)."""
        return TransferLedger.merge(
            row.get("transfer_ledger") or {} for row in self.worker_stats().values()
        )

    def close(self) -> None:
        # In-process workers stop directly; the scheduler's shutdown
        # broadcast below carries STOP over the wire to process workers.
        for w in list(self.workers.values()):
            if isinstance(w, ThreadWorker):
                w.stop()
        self.scheduler.stop()
        for w in list(self.workers.values()):
            if not isinstance(w, ThreadWorker):
                w.stop()
        self.workers.clear()
        for comm in list(self._comms.values()):
            comm.close()
        self._comms.clear()
        if self._server is not None:
            self._server.close()
        # Stream teardown precedes the data-plane wipe: the hub wakes
        # blocked endpoints and releases unconsumed refs through its
        # ledger while the store can still honor the evictions.
        with self._streams_lock:
            hub, self._streams = self._streams, None
        if hub is not None:
            hub.close()
        # The data-plane namespace is cluster-owned: closing the cluster
        # evicts every still-published ref.
        self.data_plane.close()
        if self._store_dir is not None:
            shutil.rmtree(self._store_dir, ignore_errors=True)

    def __enter__(self) -> "LocalCluster":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
