"""Peer-to-peer data plane: the bytes path that bypasses the scheduler.

The refactored runtime splits Dask's hub topology in two, following the
lesson of "Runtime vs Scheduler: Analyzing Dask's Overheads" (the hub is
the bottleneck) and MPI4Dask (give the data its own point-to-point path):

* **control plane** -- the scheduler sees only metadata:
  ``(key, ref, nbytes, locations)``.  No result blob ever enters its
  mailbox.
* **data plane** -- workers publish results >= ``inline_result_max`` into a
  shared ``Store`` namespace (:class:`ResultStore`) and keep the serialized
  bytes in a per-worker cache.  Dependents pull bytes themselves: local
  cache, then a direct worker-to-worker fetch (:class:`PeerTransfer`),
  then the shared store.

The cache is **tiered** (per "Object Proxy Patterns for Accelerating
Distributed Applications", arXiv:2407.01764, multi-tier store policies):

* :class:`BlobCache` is the memory-only LRU tier.  Evicting or refusing a
  blob *discards* bytes (counted, never silent), so peers and dependents
  must fall back to the shared store -- the refetch churn arXiv:2010.11105
  identifies as a first-order worker-side cost.
* :class:`SpillCache` adds a disk tier: cold blobs are demoted to disk
  instead of dropped, promoted back on access, and blobs larger than the
  whole memory budget stream straight to disk.  A spilled blob is still
  servable -- to local dependents *and* to peers -- so memory pressure
  costs disk I/O, not store refetches or lineage recovery.

Peer fetches move in bounded fixed-size chunks (``chunk_size``): the
producer side serves ranges out of whichever tier holds the blob (range
reads never perturb the producer's LRU order), and the consumer side
lands oversized blobs directly in its own disk tier -- so a transfer never
holds two full copies of a blob in memory at once.

The whole path is **frame-native** (zero-copy end to end): caches retain
results as :class:`~repro_torch.core.serialize.FrameBundle` frame lists exactly
as ``serialize`` emitted them, peer serving slices ``memoryview`` ranges
bounded at frame edges (never joining the payload), spilled blobs are
``mmap``-served (restores and range reads touch only the pages read), and
consumers hand the received bundle straight to ``deserialize``.  A
result's bytes are copied at most once on the chunked peer path (the
receiver-side assembly) and zero times on the same-host shm fast path --
and every copy is accounted (:class:`~repro_torch.core.serialize.CopyCounter`),
so the zero-copy claim is measured, not asserted.

Both sides of every peer fetch are byte-counted, so benchmarks can
attribute traffic the way the paper's Figs 3-4 do: scheduler bytes vs
peer bytes vs mediated-store bytes.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import tempfile
import threading
import time
import uuid
from collections import OrderedDict
from typing import Any, Iterable, Iterator

from repro_torch.core.compress import (
    LINK_INPROC,
    LINK_PROCESS,
    LINK_SHM,
    NEVER_COMPRESS_LINKS,
    TransferLedger,
    TransferPolicy,
    compress_frames,
    decompress_frames,
    is_compressed,
)
from repro_torch.core.connectors.base import (
    Key,
    Payload,
    has_peer_capability,
    has_zero_copy_capability,
    mmap_readonly_view,
    payload_nbytes,
)
from repro_torch.core.serialize import CopyCounter, FrameBundle
from repro_torch.core.store import get_or_create_store, unregister_store
from repro_torch.runtime.comm import ByteCounter

#: Default peer-transfer chunk: large enough to amortize per-chunk
#: bookkeeping, small enough that an in-flight transfer's resident slice
#: stays far below any realistic worker memory budget.
DEFAULT_CHUNK_BYTES = 4 * 1024 * 1024

#: Spill-tier compression skips frames below this: envelope overhead
#: dominates tiny frames and the disk write is already cheap.
_ZB_SPILL_MIN = 4096


class MissingDependencyError(RuntimeError):
    """A dependency's bytes are gone from every holder and the store.

    Workers surface this to the scheduler (``TASK_FAILED`` with
    ``missing_deps``), which answers with lineage recovery: the upstream
    task is recomputed from its retained spec and the dependent re-queued.
    """

    def __init__(self, keys: list[str]):
        self.keys = list(keys)
        super().__init__(f"dependency bytes unavailable for {self.keys}")


class _LostDuringTransfer(RuntimeError):
    """The source blob vanished between chunks (eviction or worker death)."""


class BlobCache:
    """Byte-bounded LRU of serialized task results: the memory tier.

    ``put`` returns whether the blob was *retained*; a refusal (blob larger
    than the whole budget) or an eviction that discards bytes is counted in
    ``stats()`` -- dropped bytes are exactly the blobs dependents will have
    to refetch from the shared store.  :class:`SpillCache` overrides the
    two discard points (``_admit_oversize`` / ``_evict_one``) to demote to
    a disk tier instead.
    """

    def __init__(self, max_bytes: int = 256 * 1024 * 1024):
        self.max_bytes = max_bytes
        self._data: OrderedDict[str, FrameBundle] = OrderedDict()
        self._nbytes = 0
        self._lock = threading.RLock()
        self._dropped = 0
        self._dropped_bytes = 0
        #: Copy accounting for bytes that land in / are served from this
        #: cache; the owning worker reports it in ``worker_stats()``.
        self.copies = CopyCounter()

    # -- read side -----------------------------------------------------------

    def get(self, key: str) -> FrameBundle | None:
        with self._lock:
            bundle = self._data.get(key)
            if bundle is not None:
                self._data.move_to_end(key)
            return bundle

    def nbytes_of(self, key: str) -> int | None:
        """Size of ``key``'s blob in any tier, or ``None`` if absent."""
        with self._lock:
            bundle = self._data.get(key)
            return None if bundle is None else bundle.nbytes

    def read_range(self, key: str, offset: int, size: int) -> memoryview | None:
        """Zero-copy view of a slice of ``key``'s blob, without touching
        LRU order.

        This is the peer-transfer read path: a remote fetch must not
        refresh the producer's recency (the producer may never use the
        blob again), and must never force a copy on the serving side --
        the returned view is bounded at the containing frame's edge (so it
        may be shorter than ``size``; callers advance by its length).
        """
        with self._lock:
            bundle = self._data.get(key)
            if bundle is None:
                return None
            return bundle.read_range(offset, size)

    def is_hot(self, key: str) -> bool:
        """Whether ``key`` is resident in the memory tier."""
        with self._lock:
            return key in self._data

    # -- write side ----------------------------------------------------------

    def put(self, key: str, blob: Payload) -> bool:
        """Retain ``blob``'s frames (no join, no copy); returns False when
        the bytes were discarded."""
        bundle = FrameBundle.of(blob)
        if bundle.nbytes > self.max_bytes:
            return self._admit_oversize(key, bundle)
        with self._lock:
            old = self._data.pop(key, None)
            if old is not None:
                self._nbytes -= old.nbytes
            self._data[key] = bundle
            self._nbytes += bundle.nbytes
            while self._nbytes > self.max_bytes and self._data:
                self._evict_one()
            return True

    def _admit_oversize(self, key: str, bundle: FrameBundle) -> bool:
        """A blob larger than the whole memory budget.  The memory-only
        cache cannot hold it: count the drop (the shared store is its only
        home) and tell the caller.  The spill tier overrides this to stream
        the blob to disk instead."""
        with self._lock:
            self._dropped += 1
            self._dropped_bytes += bundle.nbytes
        return False

    def _evict_one(self) -> None:
        """Discard the LRU entry (caller holds the lock).  Overridden by
        the spill tier to demote instead of drop."""
        _, evicted = self._data.popitem(last=False)
        self._nbytes -= evicted.nbytes
        self._dropped += 1
        self._dropped_bytes += evicted.nbytes

    def pop(self, key: str) -> None:
        with self._lock:
            bundle = self._data.pop(key, None)
            if bundle is not None:
                self._nbytes -= bundle.nbytes

    def clear(self) -> None:
        with self._lock:
            self._data.clear()
            self._nbytes = 0

    def close(self) -> None:
        self.clear()

    # -- introspection ---------------------------------------------------------

    def __contains__(self, key: str) -> bool:
        with self._lock:
            return key in self._data

    def __len__(self) -> int:
        with self._lock:
            return len(self._data)

    @property
    def nbytes(self) -> int:
        """Bytes resident in the memory tier."""
        with self._lock:
            return self._nbytes

    @property
    def spilled_bytes(self) -> int:
        return 0

    def spilled_keys(self) -> list[str]:
        return []

    def servable_keys(self) -> list[str]:
        """Keys this cache can serve to a peer, across every tier it has.
        Heartbeats carry a bounded sample of these so the scheduler can
        register the worker as a replica holder for fan-out spreading."""
        with self._lock:
            return list(self._data)

    def stats(self) -> dict[str, int]:
        with self._lock:
            return {
                "memory_bytes": self._nbytes,
                "spilled_bytes": 0,
                "spilled_bytes_total": 0,
                "dropped": self._dropped,
                "dropped_bytes": self._dropped_bytes,
                "spill_count": 0,
                "restore_count": 0,
                "mmap_restores": 0,
            }


class SpillCache(BlobCache):
    """Two-tier blob cache: hot in-memory LRU over a cold disk tier.

    * Eviction **demotes** the LRU blob to a file instead of discarding it;
      a later ``get`` promotes it back (evicting/demoting others to make
      room) -- so under memory pressure the worker trades disk I/O for
      store refetches, never losing bytes.
    * A blob larger than the whole memory budget streams straight to disk
      (the fix for the old silent ``BlobCache.put`` no-op) and is served
      from there by range reads without ever being resident.
    * ``shed(target)`` demotes until the memory tier fits ``target`` --
      the pause-state pressure-relief hook.

    Disk-tier reads are **mmap-served**: a restore or range read attaches
    the spill file once and hands out views over the mapping, so neither
    path ever loads the full file (pages fault in only as they are read)
    and a restored blob is byte-for-byte the mapped file.  The mapping
    stays valid after the file is unlinked (POSIX), so promotion frees the
    disk space while the hot-tier bundle keeps serving.

    All tier movements are counted (``spill_count`` / ``restore_count`` /
    ``mmap_restores`` / ``spilled_bytes``) so heartbeats and
    ``worker_stats()`` can report real memory state.  ``dropped`` stays 0
    unless disk writes fail.

    ``compress`` names a frame codec for the disk tier: demotes write a
    compression envelope, restores and range reads decode it.  All public
    accounting (``nbytes_of`` / ``spilled_bytes`` / promotion budgeting)
    stays in *logical* bytes, so the knob trades codec time for disk I/O
    without changing eviction behavior.
    """

    def __init__(
        self,
        max_bytes: int = 256 * 1024 * 1024,
        spill_dir: str | None = None,
        compress: str | None = None,
    ):
        super().__init__(max_bytes)
        self._owns_dir = spill_dir is None
        self.spill_dir = spill_dir or tempfile.mkdtemp(prefix="repro-spill-")
        os.makedirs(self.spill_dir, exist_ok=True)
        self._disk: dict[str, int] = {}  # key -> *logical* nbytes on disk
        self._mmaps: dict[str, memoryview] = {}  # key -> attached spill mapping
        self._spill_policy = (
            None
            if compress in (None, "none")
            else TransferPolicy(compress, min_frame_bytes=_ZB_SPILL_MIN)
        )
        self._disk_compressed: set[str] = set()
        #: Decoded-form memo for exactly one compressed spill entry: peer
        #: chunk loops re-read the same key many times in a row, and
        #: decoding the envelope per range read would be quadratic.
        self._decoded: tuple[str, FrameBundle] | None = None
        self._spilled_bytes = 0
        self._spill_count = 0
        self._restore_count = 0
        self._mmap_restores = 0
        self._spilled_bytes_total = 0

    def _path(self, key: str) -> str:
        # Task keys are content tokens but not guaranteed filesystem-safe.
        return os.path.join(self.spill_dir, hashlib.sha1(key.encode()).hexdigest())

    # -- tier movement (caller holds the lock) ---------------------------------
    #
    # Demotion writes happen under the lock: moving them out would open a
    # window where a blob is in neither tier and a dependent would falsely
    # conclude the bytes are gone.  Disk *reads* are a cheap mmap attach,
    # so they stay under the lock too; the actual page I/O happens when the
    # consumer reads the returned views, outside any cache lock.

    def _demote(self, key: str, bundle: FrameBundle) -> bool:
        frames: Iterable[Any] = bundle.frames
        compressed = False
        if self._spill_policy is not None and not is_compressed(bundle.frames):
            packed = compress_frames(
                bundle.frames, policy=self._spill_policy, link_class=LINK_PROCESS
            )
            if packed is not None:
                frames = packed[0]
                compressed = True
        try:
            with open(self._path(key), "wb") as f:
                # writev-style: frames stream out without a join.
                for frame in frames:
                    f.write(frame)
        except OSError:
            self._dropped += 1
            self._dropped_bytes += bundle.nbytes
            return False
        self._disk[key] = bundle.nbytes
        if compressed:
            self._disk_compressed.add(key)
        else:
            self._disk_compressed.discard(key)
        self._mmaps.pop(key, None)  # a fresh write invalidates old mappings
        self._spilled_bytes += bundle.nbytes
        self._spill_count += 1
        self._spilled_bytes_total += bundle.nbytes
        return True

    def _drop_disk(self, key: str) -> None:
        n = self._disk.pop(key, None)
        self._mmaps.pop(key, None)  # live views keep the mapping alive
        self._disk_compressed.discard(key)
        if self._decoded is not None and self._decoded[0] == key:
            self._decoded = None
        if n is not None:
            self._spilled_bytes -= n
            try:
                os.unlink(self._path(key))
            except OSError:
                pass

    def _attach_disk(self, key: str) -> memoryview | None:
        """mmap the spill file (cached per key); caller holds the lock."""
        view = self._mmaps.get(key)
        if view is not None:
            return view
        view = mmap_readonly_view(self._path(key))
        if view is None:
            return None
        self._mmaps[key] = view
        return view

    def _disk_bundle(self, key: str, view: memoryview) -> FrameBundle:
        """Logical-form bundle for a disk entry (caller holds the lock):
        decodes the compression envelope when the entry was demoted
        compressed, memoized for one key at a time."""
        if key not in self._disk_compressed:
            return FrameBundle([view])
        if self._decoded is not None and self._decoded[0] == key:
            return self._decoded[1]
        bundle = FrameBundle(decompress_frames(view))
        self._decoded = (key, bundle)
        return bundle

    def _evict_one(self) -> None:
        key, evicted = self._data.popitem(last=False)
        self._nbytes -= evicted.nbytes
        self._drop_disk(key)  # a stale disk copy would double-count
        self._demote(key, evicted)

    def _admit_oversize(self, key: str, bundle: FrameBundle) -> bool:
        with self._lock:
            self._drop_disk(key)
            return self._demote(key, bundle)

    # -- read side -------------------------------------------------------------

    def get(self, key: str) -> FrameBundle | None:
        with self._lock:
            bundle = self._data.get(key)
            if bundle is not None:
                self._data.move_to_end(key)
                return bundle
            n = self._disk.get(key)
            if n is None:
                return None
            fresh = key not in self._mmaps
            view = self._attach_disk(key)
            if view is None:  # disk file lost (I/O error): really gone
                self._drop_disk(key)
                return None
            if fresh:
                # A restore is a tier movement: count the attach, not every
                # re-read through the cached mapping (an oversized blob is
                # served disk-resident many times but restored once).
                self._restore_count += 1
                self._mmap_restores += 1
            bundle = self._disk_bundle(key, view)
            if n <= self.max_bytes:
                # Promote back to the hot tier (demoting others as needed).
                # The bundle keeps the mapping alive, so dropping the disk
                # entry (and its file) cannot tear concurrent readers.
                self._drop_disk(key)
                self._data[key] = bundle
                self._nbytes += n
                while self._nbytes > self.max_bytes and len(self._data) > 1:
                    self._evict_one()
            return bundle

    def nbytes_of(self, key: str) -> int | None:
        with self._lock:
            bundle = self._data.get(key)
            if bundle is not None:
                return bundle.nbytes
            return self._disk.get(key)

    def servable_keys(self) -> list[str]:
        # A spilled blob is still servable (range reads span both tiers).
        with self._lock:
            return list(self._data) + [k for k in self._disk if k not in self._data]

    def read_range(self, key: str, offset: int, size: int) -> memoryview | None:
        with self._lock:
            bundle = self._data.get(key)
            if bundle is not None:
                return bundle.read_range(offset, size)
            if key not in self._disk:
                return None
            view = self._attach_disk(key)
            if view is None:
                self._drop_disk(key)
                return None
            if key in self._disk_compressed:
                # Ranges are logical-byte offsets: serve them from the
                # decoded form (memoized, so a chunk loop decodes once).
                return self._disk_bundle(key, view).read_range(offset, size)
            # mmap-served range: a view over the mapping, no file read.
            return view[offset : offset + size]

    # -- streaming write (chunked peer transfers) ------------------------------

    def put_stream(self, key: str, nbytes: int, chunks: Iterable[bytes]) -> bool:
        """Land an incoming chunked transfer without assembling it in memory
        when it would not fit the hot tier anyway.

        Oversized blobs are written chunk-by-chunk to the disk tier, so the
        receiving side of a transfer holds at most one chunk; blobs that fit
        the memory budget assemble into a single buffer (one resident copy)
        and take the normal ``put`` path.

        Concurrent-safe per key: each call streams into a private temp
        file (the chunk loop runs outside the cache lock), and if another
        transfer landed the key first the incumbent wins -- blobs are
        addressed by task key, so racing transfers carry the same bytes.
        """
        if nbytes <= self.max_bytes:
            buf = bytearray()
            for c in chunks:
                buf += c
            return self.put(key, FrameBundle([memoryview(buf)]))
        path = self._path(key)
        tmp = f"{path}.part-{uuid.uuid4().hex[:8]}"
        try:
            with open(tmp, "wb") as f:
                for c in chunks:
                    f.write(c)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise
        with self._lock:
            if key in self._data or key in self._disk:
                try:
                    os.unlink(tmp)
                except OSError:
                    pass
                return True
            try:
                os.replace(tmp, path)
            except OSError:
                self._dropped += 1
                self._dropped_bytes += nbytes
                return False
            self._disk[key] = nbytes
            self._spilled_bytes += nbytes
            self._spill_count += 1
            self._spilled_bytes_total += nbytes
        return True

    # -- pressure relief -------------------------------------------------------

    def shed(self, target_bytes: int) -> int:
        """Demote LRU entries until the memory tier is <= ``target_bytes``;
        returns the number of bytes demoted (the paused worker's relief)."""
        demoted = 0
        with self._lock:
            while self._nbytes > max(0, target_bytes) and self._data:
                before = self._nbytes
                self._evict_one()
                demoted += before - self._nbytes
        return demoted

    # -- lifecycle -------------------------------------------------------------

    def pop(self, key: str) -> None:
        with self._lock:
            bundle = self._data.pop(key, None)
            if bundle is not None:
                self._nbytes -= bundle.nbytes
            self._drop_disk(key)

    def clear(self) -> None:
        with self._lock:
            self._data.clear()
            self._nbytes = 0
            for key in list(self._disk):
                self._drop_disk(key)

    def close(self) -> None:
        self.clear()
        if self._owns_dir:
            shutil.rmtree(self.spill_dir, ignore_errors=True)

    # -- introspection ---------------------------------------------------------

    def __contains__(self, key: str) -> bool:
        with self._lock:
            return key in self._data or key in self._disk

    def __len__(self) -> int:
        with self._lock:
            return len(self._data) + len(self._disk)

    @property
    def spilled_bytes(self) -> int:
        with self._lock:
            return self._spilled_bytes

    def spilled_keys(self) -> list[str]:
        with self._lock:
            return list(self._disk)

    def stats(self) -> dict[str, int]:
        with self._lock:
            return {
                "memory_bytes": self._nbytes,
                "spilled_bytes": self._spilled_bytes,
                "spilled_bytes_total": self._spilled_bytes_total,
                "dropped": self._dropped,
                "dropped_bytes": self._dropped_bytes,
                "spill_count": self._spill_count,
                "restore_count": self._restore_count,
                "mmap_restores": self._mmap_restores,
            }


class PeerTransfer:
    """Cluster-scoped directory of worker caches for direct transfers.

    The thread-worker analogue of a worker-to-worker socket mesh: a fetch
    reads straight from the producing worker's cache -- *whichever tier*
    holds the blob -- never touching the scheduler, and is byte-counted on
    the shared counter so the benchmarks can report the peer-path volume.

    Transfers move in bounded ``chunk_size`` pieces: the serving side
    yields range reads (no full-blob copy, no LRU perturbation) and the
    receiving side either assembles one resident copy (fits its memory
    tier) or streams chunks straight into its own disk tier -- a transfer
    never doubles peak memory by holding sender-side and receiver-side
    copies of the full blob at once.

    A worker that dies is unregistered, so fetches from it fail fast
    (including mid-transfer: a vanished source aborts the fetch cleanly)
    and callers fall back to the shared store (or trigger lineage
    recovery).
    """

    def __init__(self, chunk_size: int = DEFAULT_CHUNK_BYTES) -> None:
        self.chunk_size = max(1, int(chunk_size))
        self._peers: dict[str, BlobCache] = {}
        self._lock = threading.Lock()
        self.counter = ByteCounter()
        #: Copy accounting for sink-less fetches (tests, gather helpers);
        #: fetches with a sink charge the sink cache's counter instead.
        self.copies = CopyCounter()

    def register(self, worker_id: str, cache: BlobCache) -> None:
        with self._lock:
            self._peers[worker_id] = cache

    def unregister(self, worker_id: str) -> None:
        with self._lock:
            self._peers.pop(worker_id, None)

    def peers(self) -> list[str]:
        with self._lock:
            return list(self._peers)

    def _chunks(
        self, cache: BlobCache, key: str, nbytes: int
    ) -> Iterator[memoryview]:
        """Serve ``key`` as a stream of zero-copy views from the holder's
        cache.  Views are bounded at frame boundaries (so chunks may be
        shorter than ``chunk_size``); nothing on the serving side joins or
        copies the payload."""
        offset = 0
        while offset < nbytes:
            chunk = cache.read_range(key, offset, self.chunk_size)
            if chunk is None or len(chunk) == 0:
                # Evicted from every tier mid-transfer (or the worker died
                # and its cache was cleared): abort, caller falls back.
                raise _LostDuringTransfer(key)
            if offset + len(chunk) > nbytes:
                # The source blob was replaced with a *larger* one between
                # chunks (impure recompute): any landing would be torn
                # old/new bytes.  Abort like any other mid-transfer loss.
                raise _LostDuringTransfer(key)
            self.counter.add_sent(len(chunk))
            self.counter.add_recv(len(chunk))
            offset += len(chunk)
            yield chunk

    def fetch(
        self,
        worker_id: str,
        key: str,
        *,
        sink: BlobCache | None = None,
        policy: TransferPolicy | None = None,
        ledger: TransferLedger | None = None,
    ) -> FrameBundle | None:
        """Fetch ``key``'s serialized bytes directly from a peer's cache.

        With a ``sink`` (the fetching worker's own cache) the transfer
        lands tier-appropriately -- oversized blobs stream chunk-by-chunk
        into the sink's disk tier and are mmap-read back from there;
        everything else assembles into exactly **one** resident copy
        (pre-sized, counted on the sink's :class:`CopyCounter`) and is
        retained via ``sink.put``.  That assembly is the only copy on the
        whole chunked path -- the serving side yields views.

        ``policy`` is consulted per the link class, which for this
        in-process cache mesh is ``inproc`` -- one of the hard-wired
        never-compress links (chunks are direct memory reads; a codec
        would add a copy to both ends).  ``ledger`` records the transfer
        with wire bytes == logical bytes accordingly.
        """
        with self._lock:
            cache = self._peers.get(worker_id)
        if cache is None:
            return None
        nbytes = cache.nbytes_of(key)
        if nbytes is None:
            return None
        copies = getattr(sink, "copies", None) or self.copies
        if nbytes == 0:
            return FrameBundle([])
        try:
            if (
                sink is not None
                and isinstance(sink, SpillCache)
                and nbytes > sink.max_bytes
            ):
                # Oversized for the receiver's memory tier: stream straight
                # to its disk tier, at most one chunk resident at a time.
                if not sink.put_stream(key, nbytes, self._chunks(cache, key, nbytes)):
                    return None
                copies.add_moved(nbytes)
                copies.add_copied(nbytes)  # the disk landing
                if ledger is not None:
                    ledger.record(
                        LINK_INPROC, logical_bytes=nbytes, wire_bytes=nbytes
                    )
                return sink.get(key)
            buf = memoryview(bytearray(nbytes))
            pos = 0
            for chunk in self._chunks(cache, key, nbytes):
                if pos + len(chunk) > nbytes:
                    # The source blob was replaced with a larger one
                    # mid-transfer (impure recompute): the assembly would
                    # be torn.  Abort like any other mid-transfer loss.
                    raise _LostDuringTransfer(key)
                buf[pos : pos + len(chunk)] = chunk
                pos += len(chunk)
            if pos != nbytes:
                raise _LostDuringTransfer(key)
        except _LostDuringTransfer:
            return None
        copies.add_moved(nbytes)
        copies.add_copied(nbytes)  # the receiver-side assembly
        if ledger is not None:
            ledger.record(LINK_INPROC, logical_bytes=nbytes, wire_bytes=nbytes)
        bundle = FrameBundle([buf])
        if sink is not None:
            sink.put(key, bundle)
        return bundle

    def snapshot(self) -> dict[str, int]:
        snap = self.counter.snapshot()
        return {
            "peer_fetches": snap["recv_msgs"],
            "peer_bytes": snap["recv_bytes"],
        }


class ResultStore:
    """Byte-level view of the shared result namespace for one process.

    Wraps the cluster store's connector (re-opened from config, shared via
    the process-global store registry) and publishes serialized result
    blobs under *deterministic* refs -- the task key -- which requires the
    connector's ``peer`` capability (``put_at``).  Deterministic refs make
    speculative duplicate publishes idempotent overwrites, so release-time
    eviction stays exactly-once.  Connectors without the capability still
    work (random keys per publish); the scheduler then reclaims the losing
    duplicate's ref explicitly.
    """

    def __init__(self, store_config: dict[str, Any]):
        self._config = dict(store_config)
        self._lock = threading.Lock()
        self._connector: Any = None
        #: Default compression policy for publishes through this store
        #: (``transfer`` key in the store config; per-call ``policy``
        #: overrides it).  The link class keeps shm/inproc exempt.
        self._policy = TransferPolicy.from_config(store_config.get("transfer"))

    @property
    def name(self) -> str:
        return self._config["name"]

    @property
    def connector(self) -> Any:
        with self._lock:
            if self._connector is None:
                self._connector = get_or_create_store(self._config).connector
            return self._connector

    def config(self) -> dict[str, Any]:
        return dict(self._config)

    # -- publish / fetch -----------------------------------------------------

    @property
    def zero_copy(self) -> bool:
        """Whether published bytes are same-host attachable with zero
        copies (shm connector) -- enables the data plane's fast path:
        dependents fetch by ref *before* trying the chunked peer channel."""
        return has_zero_copy_capability(self.connector)

    @property
    def link_class(self) -> str:
        """The compression link class of this store's byte path: shm
        connectors are the same-host zero-copy handoff, the in-memory
        connector passes frames by reference, everything else crosses a
        process boundary (file/kv/redis)."""
        if self.zero_copy:
            return LINK_SHM
        connector_type = (self._config.get("connector") or {}).get("connector_type")
        if connector_type == "memory":
            return LINK_INPROC
        return LINK_PROCESS

    def publish(
        self,
        task_key: str,
        blob: Payload,
        *,
        policy: TransferPolicy | None = None,
        ledger: TransferLedger | None = None,
    ) -> str:
        """Store a serialized result; returns the ref dependents fetch by.

        Frame-native: a ``SerializedObject``/``FrameBundle`` payload passes
        straight through to the connector's writev-style put -- the
        publish never joins the frames.  On cross-process stores the
        ``policy`` (defaulting to the store config's) may wrap eligible
        frames in a compression envelope; ``fetch`` restores it (decode is
        self-describing).  The shm and in-memory link classes never
        compress, so the PR 5 zero-copy paths are byte-for-byte unchanged.
        """
        connector = self.connector
        link = self.link_class
        payload: Payload = blob
        logical = payload_nbytes(blob)
        stored_nbytes = logical
        comp_stats: dict[str, int] | None = None
        if link not in NEVER_COMPRESS_LINKS:
            packed = compress_frames(
                FrameBundle.of(blob).frames,
                policy=policy if policy is not None else self._policy,
                link_class=link,
            )
            if packed is not None:
                envelope, comp_stats = packed
                payload = FrameBundle(envelope)
                stored_nbytes = comp_stats["wire_bytes"]
        if has_peer_capability(connector):
            key = connector.put_at(
                Key(object_id=task_key, size=stored_nbytes), payload
            )
        else:
            key = connector.put(payload)
        if ledger is not None:
            ledger.record(
                link,
                logical_bytes=logical,
                wire_bytes=stored_nbytes,
                compressed_bytes=comp_stats["compressed_bytes"] if comp_stats else 0,
                compress_ns=comp_stats["compress_ns"] if comp_stats else 0,
            )
        return key.object_id

    def fetch(
        self,
        ref: str,
        nbytes: int = -1,
        copies: CopyCounter | None = None,
        *,
        ledger: TransferLedger | None = None,
    ) -> FrameBundle | None:
        """Fetch published bytes as a :class:`FrameBundle`.

        Prefers the connector's zero-copy view (``get_view`` / a retained
        frame list / an mmap-backed read) and never materializes a joined
        blob itself; ``copies`` (when given) is charged for the delivery,
        with a copy recorded only when the connector had to hand back
        fresh ``bytes``.  A publish-side compression envelope is detected
        by its marker byte and restored here, with decode time and
        wire-vs-logical bytes recorded on ``ledger``.
        """
        connector = self.connector
        get_view = getattr(connector, "get_view", None)
        key = Key(object_id=ref, size=nbytes)
        raw = get_view(key) if get_view is not None else connector.get(key)
        if raw is None:
            return None
        bundle = FrameBundle.of(raw)
        if is_compressed(bundle.frames):
            t0 = time.perf_counter_ns()
            out = FrameBundle(decompress_frames(bundle.frames))
            decompress_ns = time.perf_counter_ns() - t0
            if ledger is not None:
                ledger.record(
                    self.link_class,
                    logical_bytes=out.nbytes,
                    wire_bytes=bundle.nbytes,
                    compressed_bytes=out.nbytes,
                    decompress_ns=decompress_ns,
                )
            if copies is not None:
                copies.add_moved(out.nbytes)
                copies.add_copied(out.nbytes)  # decode materializes fresh bytes
            return out
        if ledger is not None:
            ledger.record(
                self.link_class,
                logical_bytes=bundle.nbytes,
                wire_bytes=bundle.nbytes,
            )
        if copies is not None:
            copies.add_moved(bundle.nbytes)
            if isinstance(raw, (bytes, bytearray)):
                copies.add_copied(bundle.nbytes)
        return bundle

    def exists(self, ref: str) -> bool:
        return self.connector.exists(Key(object_id=ref))

    def evict(self, ref: str) -> None:
        self.connector.evict(Key(object_id=ref))

    # -- lifecycle -----------------------------------------------------------

    def clear(self) -> None:
        """Wipe the namespace (cluster teardown evicts every published ref)."""
        clear = getattr(self.connector, "clear", None)
        if clear is not None:
            clear()

    def close(self) -> None:
        try:
            self.clear()
        except Exception:
            pass
        unregister_store(self.name)
        with self._lock:
            self._connector = None
