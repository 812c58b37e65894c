"""Direct worker-to-worker wire transfers: the peer data plane for
process clusters.

Thread clusters got a peer mesh in PR 2 (`PeerTransfer`: fetches read the
producing worker's cache directly).  Process workers could not share that
mesh -- each interpreter owns its own caches -- so until this module every
cross-worker dependency fell through to the shared store: a file/kv
round trip per dependency, with shm rescuing only same-host fetches.

This module closes that gap with two halves:

* :class:`DataServer` -- a second listener per worker, built on the same
  ``runtime/comm`` transport registry as the scheduler channel
  (``inproc://`` for deterministic tests, framed ``tcp://`` for real
  clusters), that serves the worker's :class:`~repro_torch.runtime.transfer`
  cache blobs to peers.  Chunks are served as ``cache.read_range`` views
  at frame boundaries -- no full-blob join on the sender, writev sends --
  with adaptive compression per chunk via the existing
  :class:`TransferPolicy` under the ``peer-wire`` link class.
* :class:`PeerWireClient` -- the fetch side, with a bounded per-peer
  connection pool (connections are reused across fetches; only cleanly
  completed request/response pairs return to the pool) and prompt
  invalidation on worker loss (``PEER_GONE`` push from the scheduler)
  so a dead peer fails fast to the store instead of waiting out a
  socket timeout.

Wire protocol, per request/response pair on a pooled connection:

1. client: ``(DATA_GET, {key})``          -- msgpack control fast path
2. server: ``(DATA_HDR, {key, ok, nbytes})`` -- ``ok=False`` with
   ``busy=True`` is an in-band "at my concurrent-serve cap" reply: no
   stream follows, the connection stays aligned, and the client falls
   through to the next replica
3. server: a stream of raw marker frames (``Comm.send_raw``):
   ``RAW_CHUNK`` (logical bytes, landing directly in the client's
   pre-sized assembly buffer via ``recv_raw_into``), ``RAW_COMPRESSED``
   (a compression envelope, decoded from a scratch buffer), or
   ``RAW_ABORT`` (source lost mid-serve; the stream stays aligned and
   the client falls back to the store).

The receiver holds at most one resident copy: blobs that fit the memory
tier assemble into a single pre-sized buffer (raw chunks are received
*into* it); oversized blobs stream chunk-by-chunk into the receiver's
disk tier via ``SpillCache.put_stream``.  Both ends account the transfer
on their :class:`TransferLedger` under ``peer-wire`` (wire vs logical
bytes, codec ns), so ``worker_stats()`` / ``transfer_summary()`` expose
the new path like every other link.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable

from repro_torch.core.compress import (
    LINK_PEER,
    TransferLedger,
    TransferPolicy,
    compress_frames,
    decompress_frames,
)
from repro_torch.core.serialize import CopyCounter, FrameBundle
from repro_torch.runtime import messages as M
from repro_torch.runtime.comm import ChannelClosed, Comm, connect, listen
from repro_torch.runtime.comm.core import RAW_ABORT, RAW_CHUNK, RAW_COMPRESSED
from repro_torch.runtime.transfer import DEFAULT_CHUNK_BYTES, BlobCache, SpillCache

__all__ = ["DataServer", "PeerWireClient"]

#: How long a client waits for the DATA_HDR reply / the next chunk's
#: first byte.  Generous: a loaded peer may be mid-writev on another
#: connection; a *dead* peer fails much faster (closed socket / refused
#: connect / PEER_GONE invalidation), so this is a backstop, not the
#: common failure path.
_REQUEST_TIMEOUT = 30.0

#: Server-side poll granularity while idle-waiting for the next request
#: (re-checks the closing flag so ``close()`` is prompt).
_SERVE_POLL = 0.5


class _Aborted(Exception):
    """Server sent RAW_ABORT: the source lost the blob mid-serve.  The
    stream is aligned at a request boundary, so the connection stays
    reusable; the fetch itself falls back to the store."""


class DataServer:
    """Serves one worker's cache blobs to peers over a comm listener.

    ``cache`` is the worker's own (Spill)BlobCache; every tier it holds a
    blob in is servable (``read_range`` spans memory and mmap'd disk).
    ``transfer`` is the usual transfer-config dict; the policy decides
    per chunk under the ``peer-wire`` link class.  ``ledger`` records the
    serve side of every transfer.
    """

    def __init__(
        self,
        cache: BlobCache,
        address: str,
        *,
        chunk_bytes: int = DEFAULT_CHUNK_BYTES,
        transfer: Any = None,
        ledger: TransferLedger | None = None,
        max_concurrent_serves: int = 0,
    ):
        self.cache = cache
        self.chunk_bytes = max(1, int(chunk_bytes))
        self._policy = TransferPolicy.from_config(transfer)
        self._ledger = ledger
        self._closing = threading.Event()
        self._lock = threading.Lock()
        self._conns: list[Comm] = []
        #: Concurrent-serve cap (0 = unlimited).  A saturated server
        #: answers DATA_GET with an in-band ``busy`` header instead of
        #: queueing the stream -- the connection stays aligned and the
        #: client falls through to the next replica, which is what turns
        #: replica selection into a deterministic spread instead of N
        #: fetchers convoying on one producer.
        self.max_concurrent_serves = max(0, int(max_concurrent_serves))
        self._serving = 0
        #: Serve-side telemetry: per-replica fan-out shares come from here.
        self.serve_count = 0
        self.serve_bytes = 0
        self.busy_rejects = 0
        self.listener = listen(address, self._on_connection)

    @property
    def address(self) -> str:
        return self.listener.address

    def _on_connection(self, comm: Comm) -> None:
        with self._lock:
            if self._closing.is_set():
                comm.close()
                return
            self._conns.append(comm)
        threading.Thread(
            target=self._serve, args=(comm,), daemon=True, name="data-serve"
        ).start()

    def _serve(self, comm: Comm) -> None:
        try:
            while not self._closing.is_set():
                try:
                    tag, p = comm.recv(timeout=_SERVE_POLL)
                except TimeoutError:
                    continue
                except Exception:
                    return
                if tag != M.DATA_GET:
                    return  # protocol violation: drop the connection
                try:
                    self._serve_key(comm, str(p.get("key")))
                except (ChannelClosed, OSError):
                    return
        finally:
            comm.close()
            with self._lock:
                try:
                    self._conns.remove(comm)
                except ValueError:
                    pass

    def _serve_key(self, comm: Comm, key: str) -> None:
        nbytes = self.cache.nbytes_of(key)
        if nbytes is None:
            comm.send(M.msg(M.DATA_HDR, key=key, ok=False))
            return
        with self._lock:
            if (
                self.max_concurrent_serves
                and self._serving >= self.max_concurrent_serves
            ):
                self.busy_rejects += 1
                busy = True
            else:
                self._serving += 1
                busy = False
        if busy:
            # In-band busy reply: no stream follows, the connection stays
            # request-aligned, and the client tries the next replica.
            comm.send(M.msg(M.DATA_HDR, key=key, ok=False, busy=True))
            return
        try:
            self._stream_key(comm, key, nbytes)
        finally:
            with self._lock:
                self._serving -= 1

    def _stream_key(self, comm: Comm, key: str, nbytes: int) -> None:
        comm.send(M.msg(M.DATA_HDR, key=key, ok=True, nbytes=nbytes))
        offset = wire = compressed = compress_ns = 0
        while offset < nbytes:
            chunk = self.cache.read_range(key, offset, self.chunk_bytes)
            if chunk is None or len(chunk) == 0 or offset + len(chunk) > nbytes:
                # Evicted (or replaced with a larger blob) mid-serve: an
                # in-band abort keeps the stream aligned for the next
                # request; the peer falls back to the store.
                comm.send_raw(RAW_ABORT, [])
                return
            frames: list[Any] = [chunk]
            marker = RAW_CHUNK
            packed = compress_frames(
                [chunk], policy=self._policy, link_class=LINK_PEER
            )
            if packed is not None:
                envelope, st = packed
                frames, marker = list(envelope), RAW_COMPRESSED
                compressed += st["compressed_bytes"]
                compress_ns += st["compress_ns"]
            wire += comm.send_raw(marker, frames)
            offset += len(chunk)
        with self._lock:
            self.serve_count += 1
            self.serve_bytes += nbytes
        if self._ledger is not None:
            self._ledger.record(
                LINK_PEER,
                logical_bytes=nbytes,
                wire_bytes=wire,
                compressed_bytes=compressed,
                compress_ns=compress_ns,
            )

    def snapshot(self) -> dict[str, int]:
        """Serve-side counters (rides ``worker_stats()``): how much of the
        fan-out this replica absorbed."""
        with self._lock:
            return {
                "data_server_serves": self.serve_count,
                "data_server_bytes": self.serve_bytes,
                "data_server_busy_rejects": self.busy_rejects,
            }

    def close(self) -> None:
        """Stop accepting and close every serving connection -- a peer
        blocked mid-fetch on one of them wakes with ChannelClosed."""
        self._closing.set()
        self.listener.stop()
        with self._lock:
            conns, self._conns = list(self._conns), []
        for c in conns:
            c.close()


class _Pool:
    """Idle connections + active count for one peer address."""

    __slots__ = ("idle", "active")

    def __init__(self) -> None:
        self.idle: list[Comm] = []
        self.active = 0


class PeerWireClient:
    """Pooled fetch side of the peer data plane.

    At most ``pool_size`` connections per peer address; a fetch whose
    request/response pair completes cleanly returns its connection to the
    pool for reuse, anything else (torn stream, timeout, peer death)
    closes it.  ``invalidate(address)`` -- driven by the scheduler's
    PEER_GONE push -- closes pooled connections and blacklists the
    address so subsequent fetches skip straight to the store.

    ``fetch`` returns a :class:`FrameBundle` or ``None``; ``None`` means
    "try the next tier" (peer miss, abort, or any wire failure) -- the
    peer path is an opportunistic accelerator, never the only way to the
    bytes.
    """

    def __init__(
        self,
        *,
        pool_size: int = 2,
        ledger: TransferLedger | None = None,
        copies: CopyCounter | None = None,
        connect_timeout: float = 2.0,
        request_timeout: float = _REQUEST_TIMEOUT,
    ):
        self.pool_size = max(1, int(pool_size))
        self._ledger = ledger
        self.copies = copies if copies is not None else CopyCounter()
        self._connect_timeout = connect_timeout
        self._request_timeout = request_timeout
        self._cv = threading.Condition()
        self._pools: dict[str, _Pool] = {}
        self._dead: set[str] = set()
        self._closed = False
        self.fetch_count = 0
        self.fetch_bytes = 0
        #: address -> monotonic time of the last dial: ``fetch_any``
        #: prefers the least-recently-dialed replica so repeated fetches
        #: from this worker rotate across holders instead of convoying on
        #: one.  Undialed addresses sort first *in list order*, keeping
        #: the scheduler's freshness ordering for the first contact.
        self._last_dial: dict[str, float] = {}

    # -- pool ---------------------------------------------------------------

    def _acquire(self, address: str) -> Comm | None:
        deadline = time.monotonic() + self._request_timeout
        with self._cv:
            while True:
                if self._closed or address in self._dead:
                    return None
                pool = self._pools.setdefault(address, _Pool())
                while pool.idle:
                    comm = pool.idle.pop()
                    if not comm.closed:
                        pool.active += 1
                        return comm
                    comm.close()
                if pool.active < self.pool_size:
                    pool.active += 1
                    break
                remaining = deadline - time.monotonic()
                if remaining <= 0 or not self._cv.wait(timeout=remaining):
                    return None  # pool saturated for the whole window
        try:
            comm = connect(address, timeout=self._connect_timeout)
        except Exception:
            # Refused/unreachable: release the slot; the caller falls back.
            with self._cv:
                pool = self._pools.get(address)
                if pool is not None:
                    pool.active -= 1
                self._cv.notify_all()
            return None
        return comm

    def _release(self, address: str, comm: Comm, reusable: bool) -> None:
        with self._cv:
            pool = self._pools.get(address)
            if pool is not None:
                pool.active -= 1
                if (
                    reusable
                    and not comm.closed
                    and not self._closed
                    and address not in self._dead
                    and len(pool.idle) < self.pool_size
                ):
                    pool.idle.append(comm)
                    self._cv.notify_all()
                    return
            self._cv.notify_all()
        comm.close()

    def invalidate(self, address: str) -> None:
        """Worker-loss push: blacklist ``address`` and close its pooled
        connections so nothing waits out a socket timeout on a dead peer."""
        with self._cv:
            self._dead.add(address)
            pool = self._pools.pop(address, None)
            self._cv.notify_all()
        if pool is not None:
            for c in pool.idle:
                c.close()

    def close(self) -> None:
        with self._cv:
            self._closed = True
            pools, self._pools = list(self._pools.values()), {}
            self._cv.notify_all()
        for pool in pools:
            for c in pool.idle:
                c.close()

    # -- fetch --------------------------------------------------------------

    def fetch(
        self, address: str, key: str, *, sink: BlobCache | None = None
    ) -> FrameBundle | None:
        """Fetch ``key``'s serialized bytes from the data server at
        ``address``.  Mirrors ``PeerTransfer.fetch`` landing semantics:
        oversized blobs stream into the sink's disk tier, everything else
        assembles into exactly one resident pre-sized buffer and is
        retained via ``sink.put``.  Returns ``None`` on any miss or wire
        failure -- the caller's resolution chain continues to the store."""
        bundle, _ = self._fetch_once(address, key, sink=sink)
        return bundle

    def fetch_any(
        self, addresses: list[str], key: str, *, sink: BlobCache | None = None
    ) -> FrameBundle | None:
        """Fetch ``key`` from the first replica that serves it.

        ``addresses`` arrive in the scheduler's freshness order (newest
        holder first, origin last); a stable sort by last-dial time makes
        this worker prefer the replica it has bothered least recently
        while first contacts keep the shipped order.  A miss, in-band
        busy reply, or abort falls through to the next address *before*
        anything lands in the sink, so at most one replica's bytes are
        ever retained.  ``None`` means every replica declined -- the
        caller's chain continues to the store."""
        seen: set[str] = set()
        candidates = [
            a for a in addresses if a and not (a in seen or seen.add(a))
        ]
        candidates.sort(key=lambda a: self._last_dial.get(a, 0.0))
        for address in candidates:
            bundle, _ = self._fetch_once(address, key, sink=sink)
            if bundle is not None:
                return bundle
        return None

    def _fetch_once(
        self, address: str, key: str, *, sink: BlobCache | None = None
    ) -> tuple[FrameBundle | None, str]:
        """One fetch attempt against one replica; returns ``(bundle,
        status)`` with status in {hit, miss, busy, abort, error}."""
        if not address:
            return None, "error"
        comm = self._acquire(address)
        if comm is None:
            return None, "error"
        self._last_dial[address] = time.monotonic()
        reusable = False
        try:
            comm.send(M.msg(M.DATA_GET, key=key))
            tag, hdr = comm.recv(timeout=self._request_timeout)
            if tag != M.DATA_HDR or hdr.get("key") != key:
                return None, "error"  # desynced reply: drop the connection
            if not hdr.get("ok"):
                reusable = True  # clean miss/busy, stream aligned
                return None, ("busy" if hdr.get("busy") else "miss")
            nbytes = int(hdr.get("nbytes", 0))
            if nbytes == 0:
                reusable = True
                bundle: FrameBundle | None = FrameBundle([])
            elif (
                sink is not None
                and isinstance(sink, SpillCache)
                and nbytes > sink.max_bytes
            ):
                bundle = self._fetch_streaming(comm, key, nbytes, sink)
                reusable = bundle is not None
                return bundle, ("hit" if bundle is not None else "error")
            else:
                bundle = self._fetch_assembled(comm, key, nbytes)
                reusable = bundle is not None
            if bundle is not None and nbytes and sink is not None:
                sink.put(key, bundle)
            return bundle, ("hit" if bundle is not None else "error")
        except _Aborted:
            reusable = True  # in-band abort leaves the stream aligned
            return None, "abort"
        except (ChannelClosed, TimeoutError, OSError):
            return None, "error"
        finally:
            self._release(address, comm, reusable)

    def _account(self, nbytes: int, wire: int, decompress_ns: int) -> None:
        self.copies.add_moved(nbytes)
        self.copies.add_copied(nbytes)  # the single receiver-side landing
        if self._ledger is not None:
            self._ledger.record(
                LINK_PEER,
                logical_bytes=nbytes,
                wire_bytes=wire,
                decompress_ns=decompress_ns,
            )
        self.fetch_count += 1
        self.fetch_bytes += nbytes

    def _fetch_assembled(
        self, comm: Comm, key: str, nbytes: int
    ) -> FrameBundle | None:
        """Single pre-sized assembly: raw chunks are received *directly
        into* the final buffer (``recv_raw_into``); compressed chunks land
        in a scratch buffer, decode, and copy in.  Any overrun closes the
        connection (torn stream) and surfaces as a store fallback."""
        buf = memoryview(bytearray(nbytes))
        pos = 0
        wire = 0
        decompress_ns = 0

        def get_buffer(marker: int, body_len: int) -> Any:
            if marker == RAW_CHUNK:
                if pos + body_len > nbytes:
                    raise ChannelClosed(f"peer-wire: {key} chunk overruns blob")
                return buf[pos : pos + body_len]
            return memoryview(bytearray(body_len))

        while pos < nbytes:
            marker, body = comm.recv_raw_into(
                get_buffer, timeout=self._request_timeout
            )
            wire += 1 + body.nbytes
            if marker == RAW_CHUNK:
                pos += body.nbytes
            elif marker == RAW_COMPRESSED:
                t0 = time.perf_counter_ns()
                frames = decompress_frames(body)
                decompress_ns += time.perf_counter_ns() - t0
                for f in frames:
                    fv = memoryview(f)
                    if pos + fv.nbytes > nbytes:
                        comm.close()
                        raise ChannelClosed(
                            f"peer-wire: {key} decoded chunk overruns blob"
                        )
                    buf[pos : pos + fv.nbytes] = fv
                    pos += fv.nbytes
            elif marker == RAW_ABORT:
                raise _Aborted(key)
            else:
                comm.close()
                raise ChannelClosed(f"peer-wire: unknown marker {marker}")
        self._account(nbytes, wire, decompress_ns)
        return FrameBundle([buf])

    def _fetch_streaming(
        self, comm: Comm, key: str, nbytes: int, sink: SpillCache
    ) -> FrameBundle | None:
        """Oversized for the receiver's memory tier: stream chunks
        straight into the sink's disk tier, at most one chunk resident."""
        stats = {"wire": 0, "decompress_ns": 0}

        def chunks():
            pos = 0
            scratch: Callable[[int, int], Any] = lambda m, n: memoryview(
                bytearray(n)
            )
            while pos < nbytes:
                marker, body = comm.recv_raw_into(
                    scratch, timeout=self._request_timeout
                )
                stats["wire"] += 1 + body.nbytes
                if marker == RAW_CHUNK:
                    if pos + body.nbytes > nbytes:
                        comm.close()
                        raise ChannelClosed(f"peer-wire: {key} overruns blob")
                    pos += body.nbytes
                    yield body
                elif marker == RAW_COMPRESSED:
                    t0 = time.perf_counter_ns()
                    frames = decompress_frames(body)
                    stats["decompress_ns"] += time.perf_counter_ns() - t0
                    for f in frames:
                        fv = memoryview(f)
                        if pos + fv.nbytes > nbytes:
                            comm.close()
                            raise ChannelClosed(f"peer-wire: {key} overruns blob")
                        pos += fv.nbytes
                        yield fv
                elif marker == RAW_ABORT:
                    raise _Aborted(key)
                else:
                    comm.close()
                    raise ChannelClosed(f"peer-wire: unknown marker {marker}")

        if not sink.put_stream(key, nbytes, chunks()):
            return None
        self._account(nbytes, stats["wire"], stats["decompress_ns"])
        return sink.get(key)

    def snapshot(self) -> dict[str, int]:
        return {
            "peer_wire_fetches": self.fetch_count,
            "peer_wire_bytes": self.fetch_bytes,
        }
