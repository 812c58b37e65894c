"""Process workers: the scheduler's wire side and the worker's child side.

The scheduler stays transport-agnostic -- it talks to every worker through
a mailbox-shaped object.  This module supplies both sides of the wire:

* **Parent**: :class:`CommServer` listens on a transport address; each
  accepted connection performs a REGISTER handshake and is then pumped
  into ``scheduler.inbox`` as raw blobs (one encode on the worker, one
  decode in the scheduler loop -- the hub's byte accounting is identical
  to the in-process path).  :class:`CommSender` adapts the connection to
  the ``put_msg`` mailbox protocol ``Scheduler._send_worker`` expects.
* **Child**: :func:`start_comm_worker` runs the unmodified
  :class:`~repro_torch.runtime.worker.ThreadWorker` control pump + executor
  threads against a :class:`SchedulerLink` shim that forwards outbound
  messages over the comm; a reader thread pumps inbound blobs into the
  worker's mailbox.  :func:`_worker_main` is the module-level (spawn-safe)
  child entry point, and :class:`ProcessWorker` is the parent-side handle
  that spawns it.

Each process worker also runs a **data server** (``runtime/dataserver``):
a second listener, on the same transport family as the scheduler link,
serving the worker's cache blobs directly to peers.  Dependencies
resolve cache -> shm attach (same host) -> direct peer wire fetch ->
shared store (file/kv connectors -- the durable fallback and lineage
root).  The data address rides the REGISTER handshake and every
heartbeat into ``WorkerState`` and is pushed to dependents in task
payloads; ``TransferSpec(peer_transfer=..., pool_size=...,
chunk_bytes=...)`` are the knobs.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import threading
from typing import Any

from repro_torch.runtime import messages as M
from repro_torch.runtime.comm import ChannelClosed, Comm, connect, listen

_SPAWN = mp.get_context("spawn")

#: How long an accepted connection may take to send its REGISTER.
_HANDSHAKE_TIMEOUT = 30.0


class CommSender:
    """Mailbox-shaped adapter over a comm: what the scheduler sends into."""

    def __init__(self, comm: Comm):
        self.comm = comm

    def put_msg(self, message: Any) -> int:
        return self.comm.send(message)


class CommServer:
    """Accepts worker connections for a scheduler and pumps their traffic.

    Handshake: the first message on a new connection must be REGISTER
    with ``worker`` and ``nthreads``; the server registers a
    :class:`CommSender` as the worker's mailbox and then forwards every
    subsequent blob straight into the scheduler inbox.  A dying
    connection needs no explicit deregistration -- the scheduler's
    heartbeat timeout reaps the worker and reschedules its lineage.
    """

    def __init__(
        self,
        scheduler: Any,
        address: str = "tcp://127.0.0.1:0",
        *,
        transfer: Any = None,
    ):
        self.scheduler = scheduler
        self._comms: dict[str, Comm] = {}
        self._threads: list[threading.Thread] = []
        self._lock = threading.Lock()
        self._closing = threading.Event()
        # ``transfer`` sets the compression policy for scheduler->worker
        # sends on accepted connections (worker->scheduler blobs forward
        # into the inbox still compressed; decode is self-describing).
        self.listener = listen(address, self._on_connection, transfer=transfer)

    @property
    def address(self) -> str:
        return self.listener.address

    def _on_connection(self, comm: Comm) -> None:
        t = threading.Thread(
            target=self._serve, args=(comm,), daemon=True, name="comm-serve"
        )
        with self._lock:
            self._threads.append(t)
        t.start()

    def _serve(self, comm: Comm) -> None:
        try:
            tag, p = comm.recv(timeout=_HANDSHAKE_TIMEOUT)
        except Exception:  # ChannelClosed, TimeoutError, bad handshake bytes
            comm.close()
            return
        if tag != M.REGISTER:
            comm.close()
            return
        worker_id = p["worker"]
        with self._lock:
            self._comms[worker_id] = comm
        self.scheduler.register_worker(
            worker_id,
            CommSender(comm),
            p.get("nthreads", 1),
            data_address=p.get("data_address"),
        )
        while not self._closing.is_set():
            try:
                blob = comm.recv_blob(timeout=1.0)
            except TimeoutError:
                continue
            except ChannelClosed:
                break
            self.scheduler.inbox.put_blob(blob)

    def close(self) -> None:
        self._closing.set()
        self.listener.stop()
        with self._lock:
            comms = list(self._comms.values())
            threads = list(self._threads)
        for comm in comms:
            comm.close()
        for t in threads:
            t.join(timeout=2)


class SchedulerLink:
    """The child's stand-in for the Scheduler: same attribute surface the
    worker touches (``inbox.put_msg``, ``register_worker``,
    ``inline_result_max``), every call forwarded over the comm."""

    def __init__(self, comm: Comm, inline_result_max: int = 64 * 1024):
        self.comm = comm
        self.inline_result_max = inline_result_max
        self.inbox = self  # worker sends via scheduler.inbox.put_msg

    def put_msg(self, message: Any) -> int:
        try:
            return self.comm.send(message)
        except ChannelClosed:
            return 0

    def register_worker(
        self,
        worker_id: str,
        mailbox: Any,
        nthreads: int = 1,
        data_address: str | None = None,
    ) -> None:
        # The mailbox handle is process-local; over the wire the server
        # binds this connection as the worker's mailbox instead.  The data
        # address crosses verbatim -- peers connect to it directly.
        self.comm.send(
            M.msg(
                M.REGISTER,
                worker=worker_id,
                nthreads=nthreads,
                pid=os.getpid(),
                data_address=data_address,
            )
        )


def _reader_loop(comm: Comm, worker: Any) -> None:
    while not worker._stop.is_set():
        try:
            blob = comm.recv_blob(timeout=0.2)
        except TimeoutError:
            continue
        except ChannelClosed:
            worker.stop()
            return
        worker.mailbox.put_blob(blob)


def start_comm_worker(
    address: str,
    worker_id: str,
    *,
    nthreads: int = 1,
    store_config: dict[str, Any] | None = None,
    result_store: Any = None,
    transfers: Any = None,
    cache_bytes: int = 256 * 1024 * 1024,
    memory: Any = None,
    transfer: Any = None,
    inline_result_max: int = 64 * 1024,
    connect_timeout: float = 30.0,
) -> tuple[Any, Comm]:
    """Connect to a scheduler at ``address`` and run a worker over the wire.

    Returns ``(worker, comm)``; the caller owns the worker's lifetime
    (``worker._stop.wait()`` then ``worker.stop()``).  Pass either a live
    ``result_store`` (same process) or a ``store_config`` to attach to the
    cluster's shared store tier from another process.  ``transfer`` (the
    ``TransferSpec`` wire dict) configures compression on both this
    worker's comm link and its store byte paths; one shared
    :class:`TransferLedger` covers both (including the peer-wire data
    plane), so the heartbeat snapshot is the whole per-worker wire story.

    Unless ``transfer`` disables it (``peer_transfer=False``), the worker
    also gets its half of the peer data plane: a :class:`DataServer` on
    the scheduler transport's family (an ephemeral tcp port for
    ``tcp://`` schedulers, a private inproc name otherwise) serving its
    cache to peers, and a pooled :class:`PeerWireClient` for fetching
    from theirs.  Both are wired up *before* ``start()`` so the REGISTER
    handshake carries the data address.
    """
    import uuid

    from repro_torch.core.compress import TransferLedger
    from repro_torch.runtime.dataserver import DataServer, PeerWireClient
    from repro_torch.runtime.transfer import DEFAULT_CHUNK_BYTES, ResultStore
    from repro_torch.runtime.worker import ThreadWorker

    ledger = TransferLedger()
    comm = connect(address, timeout=connect_timeout, transfer=transfer, ledger=ledger)
    comm.name = worker_id
    link = SchedulerLink(comm, inline_result_max=inline_result_max)
    if result_store is None and store_config is not None:
        result_store = ResultStore(dict(store_config))
    worker = ThreadWorker(
        worker_id,
        link,
        nthreads=nthreads,
        result_store=result_store,
        transfers=transfers,
        cache_bytes=cache_bytes,
        memory=memory,
        transfer=transfer,
        ledger=ledger,
    )
    tcfg = dict(transfer) if isinstance(transfer, dict) else {}
    if bool(tcfg.get("peer_transfer", True)):
        scheme = address.split("://", 1)[0]
        data_addr = (
            "tcp://127.0.0.1:0"
            if scheme == "tcp"
            else f"inproc://data-{worker_id}-{uuid.uuid4().hex[:6]}"
        )
        worker.data_server = DataServer(
            worker.cache,
            data_addr,
            chunk_bytes=int(tcfg.get("chunk_bytes") or DEFAULT_CHUNK_BYTES),
            transfer=transfer,
            ledger=ledger,
            # Serve cap = per-holder fetcher budget: excess fetchers get
            # an in-band busy reply and spill onto other replicas instead
            # of convoying here.
            max_concurrent_serves=int(tcfg.get("max_peer_fanout") or 4),
        )
        worker.peer_wire = PeerWireClient(
            pool_size=int(tcfg.get("pool_size") or 2),
            ledger=ledger,
            copies=worker.cache.copies,
        )
    worker.start()
    threading.Thread(
        target=_reader_loop,
        args=(comm, worker),
        daemon=True,
        name=f"{worker_id}-reader",
    ).start()
    return worker, comm


def _worker_main(address: str, worker_id: str, cfg: dict[str, Any]) -> None:
    """Spawned child entry point: run one worker until told to stop."""
    worker, comm = start_comm_worker(
        address,
        worker_id,
        nthreads=cfg.get("nthreads", 1),
        store_config=cfg.get("store"),
        cache_bytes=cfg.get("cache_bytes", 256 * 1024 * 1024),
        memory=cfg.get("memory"),
        transfer=cfg.get("transfer"),
        inline_result_max=cfg.get("inline_result_max", 64 * 1024),
    )
    try:
        worker._stop.wait()
    finally:
        # The parent owns the store namespace; stopping the worker must
        # not clear shared keys other workers still serve.
        worker.stop()
        comm.close()


class ProcessWorker:
    """Parent-side handle for a worker running in its own interpreter."""

    kind = "process"

    def __init__(
        self,
        worker_id: str,
        address: str,
        cfg: dict[str, Any],
        *,
        ctx: Any = None,
    ):
        self.worker_id = worker_id
        ctx = ctx or _SPAWN
        self._proc = ctx.Process(
            target=_worker_main,
            args=(address, worker_id, dict(cfg)),
            daemon=True,
            name=worker_id,
        )

    def start(self) -> "ProcessWorker":
        self._proc.start()
        return self

    @property
    def pid(self) -> int | None:
        return self._proc.pid

    def is_alive(self) -> bool:
        return self._proc.is_alive()

    def join(self, timeout: float | None = None) -> None:
        self._proc.join(timeout)

    def stop(self, timeout: float = 5.0) -> None:
        """Graceful stop: the scheduler has already sent STOP over the
        wire (or the connection dropped); escalate if the child lingers."""
        self._proc.join(timeout)
        if self._proc.is_alive():
            self._proc.terminate()
            self._proc.join(2)

    def kill(self) -> None:
        """Hard kill -- abrupt-failure injection for recovery tests."""
        if self._proc.is_alive():
            self._proc.kill()
        self._proc.join(5)
