"""POSIX shared-memory connector -- the node-local zero-copy fast path.

The RDMA/NVLink analogue available on a CPU container: producer writes
frames straight into a named ``SharedMemory`` segment; any consumer process
on the same host attaches by name and reads a zero-copy ``memoryview``.

Segment names are derived from the object id, so the Key alone is enough to
attach from a different process (self-contained factories).  Eviction
unlinks the segment.
"""

from __future__ import annotations

import atexit
import threading
from multiprocessing import shared_memory
from typing import Any, Sequence

from repro_torch.core.connectors.base import (
    ConnectorStats,
    Key,
    Payload,
    payload_frames,
    register_connector,
)


def _open_segment(
    name: str, *, create: bool = False, size: int = 0
) -> shared_memory.SharedMemory:
    """Create/attach a segment; ``track=False`` (no resource-tracker unlink
    races across processes) exists only on Python >= 3.13."""
    try:
        return shared_memory.SharedMemory(
            name=name, create=create, size=size, track=False
        )
    except TypeError:
        return shared_memory.SharedMemory(name=name, create=create, size=size)


@register_connector("shm")
class SharedMemoryConnector:
    #: Same-host consumers can attach a published segment by ref and read
    #: it with zero copies (``get_view``) -- the data plane's shm fast
    #: path keys off this marker.
    SAME_HOST_ZERO_COPY = True

    def __init__(self, prefix: str = "psx", zero_copy: bool = False) -> None:
        # zero_copy=True returns live views into the segment (fastest, but
        # the consumer must drop views before the segment can be unlinked);
        # the default copies out, which is still one copy total.
        self.prefix = prefix
        self.zero_copy = zero_copy
        self.stats = ConnectorStats()
        self._attached: dict[str, shared_memory.SharedMemory] = {}
        #: Segments evicted while zero-copy views were still alive: their
        #: unmap raised BufferError, so we park them here (preventing a
        #: noisy GC-time ``__del__``) and retry on later lifecycle calls.
        self._zombies: list[shared_memory.SharedMemory] = []
        self._lock = threading.Lock()
        atexit.register(self.close)

    def _name(self, object_id: str) -> str:
        return f"{self.prefix}_{object_id}"[:30]  # POSIX name length limits

    def put(self, data: Payload) -> Key:
        frames = [memoryview(f).cast("B") for f in payload_frames(data)]
        total = sum(f.nbytes for f in frames) or 1
        key = Key.new()
        seg = _open_segment(self._name(key.object_id), create=True, size=total)
        off = 0
        for f in frames:
            seg.buf[off : off + f.nbytes] = f
            off += f.nbytes
        with self._lock:
            self._attached[key.object_id] = seg
        self.stats.record_put(off)
        return Key(key.object_id, size=off)

    def put_at(self, key: Key, data: Payload) -> Key:
        """Deterministic-key write (``peer`` capability).  A pre-existing
        segment under the same id (speculative duplicate) is overwritten
        *in place* when it fits -- duplicates of the same task write
        identical bytes, so concurrent readers never observe a change.
        Only a size mismatch (impure recompute) unlinks and recreates."""
        frames = [memoryview(f).cast("B") for f in payload_frames(data)]
        total = sum(f.nbytes for f in frames) or 1
        try:
            seg = _open_segment(self._name(key.object_id), create=True, size=total)
        except FileExistsError:
            seg = self._attach(key)
            if seg is None or seg.size < total:
                self.evict(key)
                seg = _open_segment(self._name(key.object_id), create=True, size=total)
        off = 0
        for f in frames:
            seg.buf[off : off + f.nbytes] = f
            off += f.nbytes
        with self._lock:
            self._attached[key.object_id] = seg
        self.stats.record_put(off)
        return Key(key.object_id, size=off, tag=key.tag)

    def put_frames(self, frames: Sequence[bytes | memoryview]) -> Key:
        """Writev-style put: frames land in the segment back-to-back; the
        single segment write is the publish, not an extra copy."""
        from repro_torch.core.serialize import FrameBundle

        return self.put(FrameBundle(frames))

    def put_batch(self, datas: Sequence[Payload]) -> list[Key]:
        return [self.put(d) for d in datas]

    def _attach(self, key: Key) -> shared_memory.SharedMemory | None:
        with self._lock:
            seg = self._attached.get(key.object_id)
        if seg is not None:
            return seg
        try:
            seg = _open_segment(self._name(key.object_id))
        except FileNotFoundError:
            return None
        with self._lock:
            self._attached[key.object_id] = seg
        return seg

    def get(self, key: Key) -> memoryview | bytes | None:
        seg = self._attach(key)
        if seg is None:
            return None
        size = key.size if key.size >= 0 else seg.size
        self.stats.record_get(size)
        if self.zero_copy:
            # Live view; the segment stays attached while views exist.
            return memoryview(seg.buf)[:size]
        return bytes(seg.buf[:size])

    def get_view(self, key: Key) -> memoryview | None:
        """Same-host zero-copy attach: a live view of the mapped segment,
        regardless of the connector's copy-out default.  The mapping stays
        readable after an evict (only the *name* is unlinked), so handing
        these views to ``deserialize`` is safe against racing releases."""
        seg = self._attach(key)
        if seg is None:
            return None
        size = key.size if key.size >= 0 else seg.size
        self.stats.record_get(size)
        return memoryview(seg.buf)[:size]

    def get_batch(self, keys: Sequence[Key]) -> list[memoryview | None]:
        return [self.get(k) for k in keys]

    def exists(self, key: Key) -> bool:
        return self._attach(key) is not None

    def _release(self, seg: shared_memory.SharedMemory, *, unlink: bool) -> None:
        """Unlink the name first (new attaches fail immediately), then try
        to unmap.  With zero-copy views still alive the unmap raises
        BufferError -- the segment is parked on the zombie list and retried
        later; the mapping itself is reclaimed when the last view drops."""
        if unlink:
            try:
                seg.unlink()
            except FileNotFoundError:
                pass
        try:
            seg.close()
        except BufferError:
            with self._lock:
                self._zombies.append(seg)

    def _reap_zombies(self, *, final: bool = False) -> None:
        """Retry unmapping evicted-while-viewed segments.  On the final
        pass, segments still pinned by live views get their ``close``
        neutered: unmapping is left to view refcounting, so GC never
        trips over an un-closeable segment."""
        with self._lock:
            zombies, self._zombies = self._zombies, []
        survivors = []
        for seg in zombies:
            try:
                seg.close()
            except BufferError:
                if final:
                    seg.close = lambda: None  # type: ignore[method-assign]
                else:
                    survivors.append(seg)
        if survivors:
            with self._lock:
                self._zombies.extend(survivors)

    def evict(self, key: Key) -> None:
        self._reap_zombies()
        seg = self._attach(key)
        if seg is None:
            return
        with self._lock:
            self._attached.pop(key.object_id, None)
        self._release(seg, unlink=True)
        self.stats.record_evict()

    def close(self) -> None:
        with self._lock:
            segs = list(self._attached.values())
            self._attached.clear()
        for seg in segs:
            try:
                self._release(seg, unlink=False)
            except Exception:
                pass
        self._reap_zombies(final=True)

    def clear(self) -> None:
        """Unlink every segment this connector is attached to.

        Only locally-attached segments can be enumerated; segments created
        by *other* processes under the same prefix are theirs to unlink.
        """
        with self._lock:
            segs = list(self._attached.values())
            self._attached.clear()
        for seg in segs:
            try:
                self._release(seg, unlink=True)
            except Exception:
                pass
        self._reap_zombies(final=True)

    def config(self) -> dict[str, Any]:
        return {
            "connector_type": "shm",
            "prefix": self.prefix,
            "zero_copy": self.zero_copy,
        }

    @classmethod
    def from_config(cls, config: dict[str, Any]) -> "SharedMemoryConnector":
        return cls(**config)
