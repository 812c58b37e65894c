"""Shared-filesystem connector (the Lustre/NFS analogue).

One file per object under a root directory; writes are atomic
(tmp + rename) so concurrent readers in other processes never observe a
partial object.  Writes are scatter-gather: the frames of a
``SerializedObject`` are written sequentially without first concatenating
them (no extra copy).  Reads are ``mmap``-backed: ``get`` returns a
memoryview over the mapped file, so a consumer (and ``deserialize``)
touches only the pages it actually reads -- no full-file read, no copy.
"""

from __future__ import annotations

import os
import tempfile
import threading
from collections import OrderedDict
from pathlib import Path
from typing import Any, Sequence

from repro_torch.core.connectors.base import (
    ConnectorStats,
    Key,
    Payload,
    mmap_readonly_view,
    payload_frames,
    register_connector,
)
from repro_torch.core.serialize import FrameBundle

#: Bound on the per-key mapping cache: dropped entries stay valid for any
#: outstanding views (the view pins the mapping), so the cap only limits
#: how many *idle* mappings the connector keeps warm.
_MAPS_MAX = 64


@register_connector("file")
class FileConnector:
    def __init__(self, store_dir: str) -> None:
        self.store_dir = str(store_dir)
        Path(self.store_dir).mkdir(parents=True, exist_ok=True)
        self.stats = ConnectorStats()
        #: Per-key mapping cache (LRU-bounded): repeated gets of one object
        #: share a single mmap instead of stacking a fresh VMA per call.
        #: Writes and evicts invalidate; a dropped entry's mapping stays
        #: alive as long as previously-returned views reference it.
        self._maps: OrderedDict[str, memoryview] = OrderedDict()
        self._maps_lock = threading.Lock()

    def _path(self, key: Key) -> Path:
        return Path(self.store_dir) / key.object_id

    def _write(self, path: Path, data: Payload) -> int:
        nbytes = 0
        fd, tmp = tempfile.mkstemp(dir=self.store_dir, prefix=".tmp-")
        try:
            with os.fdopen(fd, "wb") as f:
                for frame in payload_frames(data):
                    f.write(frame)
                    nbytes += memoryview(frame).nbytes
            os.replace(tmp, path)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise
        return nbytes

    def put(self, data: Payload) -> Key:
        key = Key.new()
        nbytes = self._write(self._path(key), data)
        self.stats.record_put(nbytes)
        return Key(key.object_id, size=nbytes)

    def put_at(self, key: Key, data: Payload) -> Key:
        """Deterministic-key write (``peer`` capability); atomic via rename,
        so a speculative duplicate publishing the same key is an overwrite,
        never a torn read."""
        nbytes = self._write(self._path(key), data)
        with self._maps_lock:
            self._maps.pop(key.object_id, None)  # fresh bytes, stale mapping
        self.stats.record_put(nbytes)
        return Key(key.object_id, size=nbytes, tag=key.tag)

    def put_frames(self, frames: Sequence[bytes | memoryview]) -> Key:
        """Writev-style put: frames stream to the file without a join."""
        return self.put(FrameBundle(frames))

    def put_batch(self, datas: Sequence[Payload]) -> list[Key]:
        return [self.put(d) for d in datas]

    def get(self, key: Key) -> memoryview | bytes | None:
        """mmap-backed read: the returned view maps the file, so range
        reads and ``deserialize`` never load (or copy) the whole object.
        The mapping stays valid after an evict/unlink (POSIX), so a racing
        release cannot tear a reader."""
        with self._maps_lock:
            view = self._maps.get(key.object_id)
            if view is not None:
                self._maps.move_to_end(key.object_id)
        if view is not None:
            self.stats.record_get(view.nbytes)
            return view
        view = mmap_readonly_view(str(self._path(key)))
        if view is None:
            return None
        if view.nbytes == 0:
            self.stats.record_get(0)
            return b""
        with self._maps_lock:
            view = self._maps.setdefault(key.object_id, view)
            self._maps.move_to_end(key.object_id)
            while len(self._maps) > _MAPS_MAX:
                self._maps.popitem(last=False)
        if not self._path(key).exists():
            # Raced a concurrent evict between mapping and caching: drop
            # the entry so the evicted object is not resurrected.
            with self._maps_lock:
                self._maps.pop(key.object_id, None)
            return None
        self.stats.record_get(view.nbytes)
        return view

    def get_batch(self, keys: Sequence[Key]) -> list[memoryview | bytes | None]:
        return [self.get(k) for k in keys]

    def exists(self, key: Key) -> bool:
        return self._path(key).exists()

    def evict(self, key: Key) -> None:
        with self._maps_lock:
            self._maps.pop(key.object_id, None)
        try:
            self._path(key).unlink()
            self.stats.record_evict()
        except FileNotFoundError:
            pass

    def close(self) -> None:
        with self._maps_lock:
            self._maps.clear()

    def clear(self) -> None:
        """Remove every stored object (namespace-owner teardown)."""
        with self._maps_lock:
            self._maps.clear()
        for path in Path(self.store_dir).glob("*"):
            try:
                path.unlink()
            except (FileNotFoundError, IsADirectoryError):
                pass

    def config(self) -> dict[str, Any]:
        return {"connector_type": "file", "store_dir": self.store_dir}

    @classmethod
    def from_config(cls, config: dict[str, Any]) -> "FileConnector":
        return cls(**config)
