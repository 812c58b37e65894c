"""Store: the high-level proxy-creating interface (paper §2).

A ``Store`` pairs a connector with a serializer and mints proxies.  Store
*configs* -- not live stores -- travel inside proxy factories; a process-
global registry re-opens (and re-uses) stores on first resolution in each
process, so a thousand proxies resolving on one worker share a single
connector instance/connection.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Any, Callable, Sequence, TypeVar

from repro_torch.core.connectors.base import Connector, Key, connector_from_config
from repro_torch.core.plugins import PluginRegistry
from repro_torch.core.proxy import (
    Proxy,
    StoreFactory,
    TargetMetadata,
    is_proxy,
)
from repro_torch.core.serialize import (
    default_deserializer,
    default_serializer,
)

T = TypeVar("T")

_REGISTRY: dict[str, "Store"] = {}
_REGISTRY_LOCK = threading.Lock()

serializer_registry: PluginRegistry[tuple[Callable, Callable]] = PluginRegistry(
    "serializer"
)
serializer_registry.register("default", (default_serializer, default_deserializer))


def register_serializer(name: str, ser: Callable, deser: Callable) -> None:
    serializer_registry.register(name, (ser, deser))


def list_serializers() -> list[str]:
    _ensure_lazy_serializers()
    return serializer_registry.names()


def _ensure_lazy_serializers() -> None:
    # Lazy-register the pickle baseline to avoid import cycles.
    if "pickle" not in serializer_registry:
        from repro_torch.core.serialize import deserialize, pickle_serializer

        register_serializer("pickle", pickle_serializer, deserialize)


def _load_serializer(name: str) -> tuple[Callable, Callable]:
    _ensure_lazy_serializers()
    return serializer_registry.get(name)


class _LRUCache:
    def __init__(self, maxsize: int):
        self.maxsize = maxsize
        self._data: OrderedDict[str, Any] = OrderedDict()
        self._lock = threading.Lock()

    def get(self, key: str) -> Any:
        with self._lock:
            if key in self._data:
                self._data.move_to_end(key)
                return self._data[key]
        return None

    def put(self, key: str, value: Any) -> None:
        if self.maxsize <= 0:
            return
        with self._lock:
            self._data[key] = value
            self._data.move_to_end(key)
            while len(self._data) > self.maxsize:
                self._data.popitem(last=False)

    def pop(self, key: str) -> None:
        with self._lock:
            self._data.pop(key, None)


class Store:
    """High-level object store + proxy factory."""

    def __init__(
        self,
        name: str,
        connector: Connector,
        *,
        serializer: str = "default",
        cache_size: int = 16,
        register: bool = True,
    ):
        self.name = name
        self.connector = connector
        self.serializer_name = serializer
        self._ser, self._deser = _load_serializer(serializer)
        self._cache = _LRUCache(cache_size)
        self.cache_size = cache_size
        if register:
            register_store(self)

    # -- config round-trip ---------------------------------------------------

    def config(self) -> dict[str, Any]:
        return {
            "name": self.name,
            "connector": self.connector.config(),
            "serializer": self.serializer_name,
            "cache_size": self.cache_size,
        }

    @classmethod
    def from_config(cls, config: dict[str, Any]) -> "Store":
        return cls(
            config["name"],
            connector_from_config(config["connector"]),
            serializer=config.get("serializer", "default"),
            cache_size=config.get("cache_size", 16),
            register=False,
        )

    # -- byte-level ------------------------------------------------------------

    def put(self, obj: Any) -> Key:
        return self.connector.put(self._ser(obj))

    def put_batch(self, objs: Sequence[Any]) -> list[Key]:
        return self.connector.put_batch([self._ser(o) for o in objs])

    def get(self, key: Key) -> Any:
        cached = self._cache.get(key.object_id)
        if cached is not None:
            return cached
        blob = self.connector.get(key)
        if blob is None:
            return None
        obj = self._deser(blob)
        self._cache.put(key.object_id, obj)
        return obj

    def exists(self, key: Key) -> bool:
        return self.connector.exists(key)

    def evict(self, key: Key) -> None:
        self._cache.pop(key.object_id)
        self.connector.evict(key)

    # -- proxy-level ---------------------------------------------------------------

    def proxy(self, obj: T, *, evict: bool = False) -> Proxy[T]:
        """Store ``obj`` and return a transparent proxy to it.

        ``evict=True`` makes the proxy one-shot: the stored bytes are evicted
        after the first resolution (borrowed single-consumer semantics).
        """
        if is_proxy(obj):
            return obj  # idempotent: never proxy a proxy
        key = self.put(obj)
        md = TargetMetadata.from_target(obj, token=key.object_id)
        return Proxy(StoreFactory(self.config(), key, evict=evict, md=md))

    def proxy_batch(self, objs: Sequence[Any], *, evict: bool = False) -> list[Proxy]:
        keys = self.put_batch(objs)
        return [
            Proxy(
                StoreFactory(
                    self.config(),
                    key,
                    evict=evict,
                    md=TargetMetadata.from_target(obj, token=key.object_id),
                )
            )
            for key, obj in zip(keys, objs)
        ]

    def owned_proxy(self, obj: T) -> "OwnedProxy[T]":
        from repro_torch.core.ownership import OwnedProxy

        key = self.put(obj)
        md = TargetMetadata.from_target(obj, token=key.object_id)
        return OwnedProxy(StoreFactory(self.config(), key, evict=False, md=md))

    def proxy_from_key(self, key: Key, md: TargetMetadata | None = None) -> Proxy:
        """Proxy an already-stored object (e.g. a worker-produced result)."""
        if md is None:
            md = TargetMetadata(token=key.object_id)
        elif md.token is None:
            md.token = key.object_id
        return Proxy(StoreFactory(self.config(), key, evict=False, md=md))

    # -- lifecycle -------------------------------------------------------------------

    def close(self) -> None:
        unregister_store(self.name)
        self.connector.close()

    def __enter__(self) -> "Store":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __repr__(self) -> str:
        return f"Store(name={self.name!r}, connector={type(self.connector).__name__})"


# -- process-global registry ---------------------------------------------------

def register_store(store: Store) -> None:
    with _REGISTRY_LOCK:
        _REGISTRY[store.name] = store


def unregister_store(name: str) -> None:
    with _REGISTRY_LOCK:
        _REGISTRY.pop(name, None)


def get_store(name: str) -> Store | None:
    with _REGISTRY_LOCK:
        return _REGISTRY.get(name)


def get_or_create_store(config: dict[str, Any]) -> Store:
    """Open (or re-use) the store described by ``config`` in this process."""
    name = config["name"]
    with _REGISTRY_LOCK:
        store = _REGISTRY.get(name)
        if store is None:
            store = Store.from_config(config)
            _REGISTRY[name] = store
        return store
