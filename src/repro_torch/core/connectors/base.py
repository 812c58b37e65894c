"""Connector protocol: the byte-level mediated storage interface.

The paper separates the high-level ``Store`` (proxy creation) from the
low-level ``Connector`` (byte put/get against some storage or transfer
substrate).  A connector must be *reconstructible from its config* in an
arbitrary process -- that is what makes proxy factories self-contained.
"""

from __future__ import annotations

import mmap
import os
import threading
import uuid
from dataclasses import dataclass
from typing import Any, Protocol, Sequence, runtime_checkable

from repro_torch.core.plugins import PluginRegistry
from repro_torch.core.serialize import FrameBundle, SerializedObject


@dataclass(frozen=True)
class Key:
    """Identifies an object inside a connector's namespace."""

    object_id: str
    size: int = -1  # serialized size in bytes, when known (-1 = unknown)
    tag: str = ""   # connector-specific placement hint (e.g. shard id)

    @staticmethod
    def new(size: int = -1, tag: str = "") -> "Key":
        return Key(object_id=uuid.uuid4().hex, size=size, tag=tag)


Payload = SerializedObject | FrameBundle | bytes | bytearray | memoryview

#: Capability name for connectors that support deterministic-key writes
#: (``put_at``).  The runtime's peer-to-peer data plane requires it: workers
#: publish task results under the task key, so speculative duplicates
#: overwrite the same entry instead of leaking a second copy.
PEER_CAPABILITY = "peer"

#: Capability name for connectors whose ``get`` hands back a view of the
#: stored bytes that a *same-host* consumer can read with zero copies
#: (shared memory).  The data plane's same-host fast path keys off this:
#: dependents attach the published segment by ref and deserialize over the
#: mapped view instead of pulling chunks through the peer channel.
ZERO_COPY_CAPABILITY = "zero-copy"


def payload_frames(data: Payload) -> list[bytes | memoryview]:
    if isinstance(data, SerializedObject):
        return data.frames()
    if isinstance(data, FrameBundle):
        return list(data.frames)
    return [memoryview(data)]


def payload_nbytes(data: Payload) -> int:
    if isinstance(data, (SerializedObject, FrameBundle)):
        return data.nbytes
    return memoryview(data).nbytes


def mmap_readonly_view(path: str) -> memoryview | None:
    """Attach ``path`` as a read-only mapped view -- the shared mmap-attach
    idiom for file-backed zero-copy reads (connector gets, spill-tier
    restores).  Pages fault in only as they are read; the mapping stays
    valid after an unlink (POSIX).  Returns an empty view for an empty
    file (which cannot be mapped) and ``None`` when the file is missing
    or unreadable.
    """
    try:
        with open(path, "rb") as f:
            size = os.fstat(f.fileno()).st_size
            if size == 0:
                return memoryview(b"")
            return memoryview(mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ))
    except OSError:
        return None


@runtime_checkable
class Connector(Protocol):
    """Byte-level storage/transfer channel.

    Implementations must be cheap to construct from ``config()`` output so
    factories can lazily re-open them inside worker processes.
    """

    def put(self, data: Payload) -> Key: ...

    def put_batch(self, datas: Sequence[Payload]) -> list[Key]: ...

    def get(self, key: Key) -> memoryview | bytes | None: ...

    def get_batch(self, keys: Sequence[Key]) -> list[memoryview | bytes | None]: ...

    def exists(self, key: Key) -> bool: ...

    def evict(self, key: Key) -> None: ...

    def close(self) -> None: ...

    def config(self) -> dict[str, Any]: ...


@runtime_checkable
class PeerCapable(Protocol):
    """Connectors usable as a shared cluster data plane (``peer`` capability).

    ``put_at`` writes under a caller-chosen key: every worker that produces
    the same task result publishes to the same entry, which is what makes
    release-time eviction exactly-once across speculation and recovery.
    """

    def put_at(self, key: Key, data: Payload) -> Key: ...


def has_peer_capability(connector: Any) -> bool:
    """True when a connector instance or class supports ``put_at``."""
    return callable(getattr(connector, "put_at", None))


def has_zero_copy_capability(connector: Any) -> bool:
    """True when a connector's stored bytes are same-host attachable with
    zero copies (it marks itself ``SAME_HOST_ZERO_COPY``)."""
    return bool(getattr(connector, "SAME_HOST_ZERO_COPY", False))


def connector_capabilities(kind: str) -> frozenset[str]:
    """Capability names of a registered connector type."""
    cls = connector_registry.get(kind)
    caps = set(getattr(cls, "CAPABILITIES", ()))
    if has_peer_capability(cls):
        caps.add(PEER_CAPABILITY)
    if has_zero_copy_capability(cls):
        caps.add(ZERO_COPY_CAPABILITY)
    return frozenset(caps)


class ConnectorStats:
    """Thread-safe byte/op counters every connector maintains.

    These power the benchmark attribution: bytes moved via mediated storage
    vs. bytes moved through the scheduler.
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.puts = 0
        self.gets = 0
        self.evicts = 0
        self.bytes_put = 0
        self.bytes_got = 0

    def record_put(self, nbytes: int) -> None:
        with self._lock:
            self.puts += 1
            self.bytes_put += nbytes

    def record_get(self, nbytes: int) -> None:
        with self._lock:
            self.gets += 1
            self.bytes_got += nbytes

    def record_evict(self) -> None:
        with self._lock:
            self.evicts += 1

    def snapshot(self) -> dict[str, int]:
        with self._lock:
            return {
                "puts": self.puts,
                "gets": self.gets,
                "evicts": self.evicts,
                "bytes_put": self.bytes_put,
                "bytes_got": self.bytes_got,
            }


connector_registry: PluginRegistry[type] = PluginRegistry("connector")


def register_connector(name: str):
    """Class decorator registering a connector type for config round-trips."""

    def deco(cls: type) -> type:
        connector_registry.register(name, cls)
        cls.connector_type = name
        return cls

    return deco


def list_connectors() -> list[str]:
    """Names of every registered connector type."""
    return connector_registry.names()


def connector_from_config(config: dict[str, Any]) -> "Connector":
    config = dict(config)
    kind = config.pop("connector_type")
    return connector_registry.get(kind).from_config(config)
