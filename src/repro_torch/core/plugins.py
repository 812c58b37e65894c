"""Generic name -> implementation plugin registries.

Connectors, policies, and serializers are all *declared by name + params*
(the ``repro_torch.api`` configuration layer) instead of by passing live objects
or hand-built dicts around.  This module provides the single registry
primitive backing all three, so third-party code extends the system the
same way the built-ins do::

    from repro_torch.core.connectors.base import register_connector

    @register_connector("redis")
    class RedisConnector: ...

    StoreConfig(name="s", connector=ConnectorSpec("redis", host=...))
"""

from __future__ import annotations

import threading
from typing import Callable, Generic, Iterator, TypeVar

T = TypeVar("T")


class UnknownPluginError(ValueError):
    """Raised on lookup of a name nobody registered.

    The message lists the registered names so a typo'd config fails with an
    actionable error instead of a bare KeyError deep inside ``from_config``.
    """

    def __init__(self, kind: str, name: str, known: list[str]):
        self.kind = kind
        self.name = name
        self.known = known
        super().__init__(
            f"unknown {kind} {name!r}; registered {kind}s: "
            f"{', '.join(sorted(known)) or '(none)'}"
        )


class PluginRegistry(Generic[T]):
    """Thread-safe mapping of short names to plugin implementations."""

    def __init__(self, kind: str):
        self.kind = kind
        self._plugins: dict[str, T] = {}
        self._lock = threading.Lock()

    def register(self, name: str, plugin: T, *, overwrite: bool = True) -> T:
        with self._lock:
            if not overwrite and name in self._plugins:
                raise ValueError(f"{self.kind} {name!r} already registered")
            self._plugins[name] = plugin
        return plugin

    def decorator(self, name: str) -> Callable[[T], T]:
        """``@registry.decorator("name")`` registration form."""

        def deco(plugin: T) -> T:
            return self.register(name, plugin)

        return deco

    def get(self, name: str) -> T:
        with self._lock:
            try:
                return self._plugins[name]
            except KeyError:
                raise UnknownPluginError(
                    self.kind, name, list(self._plugins)
                ) from None

    def __contains__(self, name: str) -> bool:
        with self._lock:
            return name in self._plugins

    def names(self) -> list[str]:
        with self._lock:
            return sorted(self._plugins)

    def __iter__(self) -> Iterator[str]:
        return iter(self.names())
