"""In-memory connector: process-local dict storage.

The fastest option when producer and consumer share an address space
(thread-based workers, single-process pipelines, tests).  Named segments are
process-global so that two ``Store`` instances with the same segment name
share objects, mirroring how a Redis/DAOS namespace outlives any one client.

Storage is frame-native: a ``put`` retains the payload's frame list as a
:class:`FrameBundle` (views over the producer's buffers -- zero copies) and
``get`` hands the same bundle back, so a same-process round trip through
this connector never joins or copies the payload.
"""

from __future__ import annotations

import threading
from typing import Any, Sequence

from repro_torch.core.connectors.base import (
    ConnectorStats,
    Key,
    Payload,
    register_connector,
)
from repro_torch.core.serialize import FrameBundle

_SEGMENTS: dict[str, dict[str, FrameBundle]] = {}
_SEGMENTS_LOCK = threading.Lock()


@register_connector("memory")
class MemoryConnector:
    def __init__(self, segment: str = "default") -> None:
        self.segment = segment
        with _SEGMENTS_LOCK:
            self._data = _SEGMENTS.setdefault(segment, {})
        self.stats = ConnectorStats()

    def put(self, data: Payload) -> Key:
        bundle = FrameBundle.of(data)
        key = Key.new(size=bundle.nbytes)
        self._data[key.object_id] = bundle
        self.stats.record_put(bundle.nbytes)
        return key

    def put_at(self, key: Key, data: Payload) -> Key:
        """Deterministic-key write (``peer`` capability): idempotent publish."""
        bundle = FrameBundle.of(data)
        self._data[key.object_id] = bundle
        self.stats.record_put(bundle.nbytes)
        return Key(key.object_id, size=bundle.nbytes, tag=key.tag)

    def put_frames(self, frames: Sequence[bytes | memoryview]) -> Key:
        """Writev-style put: retain the frame list as-is (no join)."""
        return self.put(FrameBundle(frames))

    def put_batch(self, datas: Sequence[Payload]) -> list[Key]:
        return [self.put(d) for d in datas]

    def get(self, key: Key) -> FrameBundle | None:
        bundle = self._data.get(key.object_id)
        if bundle is None:
            return None
        self.stats.record_get(bundle.nbytes)
        return bundle

    def get_batch(self, keys: Sequence[Key]) -> list[FrameBundle | None]:
        return [self.get(k) for k in keys]

    def exists(self, key: Key) -> bool:
        return key.object_id in self._data

    def evict(self, key: Key) -> None:
        if self._data.pop(key.object_id, None) is not None:
            self.stats.record_evict()

    def close(self) -> None:
        pass

    def clear(self) -> None:
        self._data.clear()

    def config(self) -> dict[str, Any]:
        return {"connector_type": "memory", "segment": self.segment}

    @classmethod
    def from_config(cls, config: dict[str, Any]) -> "MemoryConnector":
        return cls(**config)
