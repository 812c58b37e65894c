"""Rust-inspired ownership model for proxies (paper §3, Methods; ref [8]).

``OwnedProxy`` uniquely owns the stored bytes: when it is garbage collected
(or its owning scope exits) the object is evicted from the store --
automatic distributed memory management.  Borrowing hands out non-owning
references with lifetime checks:

* ``borrow(owned)``     -> immutable ``RefProxy`` (many allowed)
* ``mut_borrow(owned)`` -> exclusive ``RefMutProxy`` (one at a time)
* ``transfer(owned)``   -> moves ownership to a fresh ``OwnedProxy``;
                            the original is invalidated (use-after-move
                            raises, like Rust's moved-from values)

Borrow bookkeeping is intentionally process-local advisory (as in the
paper's implementation): it catches the common lifetime bugs in pipelines
without requiring a distributed lock service.
"""

from __future__ import annotations

import threading
from typing import Callable, TypeVar

from repro_torch.core.proxy import (
    Factory,
    Proxy,
    _reconstruct_proxy,
    get_factory,
    register_proxy_type,
)

T = TypeVar("T")


class OwnershipError(RuntimeError):
    pass


class RefLedger:
    """Exactly-once release of shared data-plane refs.

    The scheduler's control plane never holds result bytes, only refs into
    the cluster store.  Every published ref is tracked here, and however
    many paths later ask for its release -- client RELEASE, speculative
    duplicates, lineage-recovery republication, worker-loss cleanup -- the
    backing entry is evicted at most once: ``release`` pops the ref, so a
    second call is a no-op rather than a double eviction.
    """

    def __init__(self, evict: Callable[[str], None]):
        self._evict = evict
        self._live: dict[str, int] = {}  # ref -> nbytes
        self._lock = threading.Lock()

    def track(self, ref: str, nbytes: int = 0) -> None:
        """Record a published ref (idempotent across duplicate publishes)."""
        with self._lock:
            self._live.setdefault(ref, nbytes)

    def release(self, ref: str) -> bool:
        """Evict the ref's store entry; True only on the call that evicted."""
        with self._lock:
            if self._live.pop(ref, None) is None:
                return False
        try:
            self._evict(ref)
        except Exception:
            pass  # store already gone: nothing left to leak
        return True

    def forget(self, ref: str) -> None:
        """Drop tracking without evicting (entry adopted by another owner)."""
        with self._lock:
            self._live.pop(ref, None)

    def live_refs(self) -> list[str]:
        with self._lock:
            return list(self._live)

    def live_bytes(self) -> int:
        with self._lock:
            return sum(self._live.values())


@register_proxy_type
class OwnedProxy(Proxy[T]):
    """Uniquely-owning proxy; evicts its target when it goes out of scope."""

    __slots__ = ("__proxy_owned__", "__proxy_borrows__", "__proxy_mut_borrowed__")

    def __init__(self, factory: Factory[T]):
        super().__init__(factory)
        object.__setattr__(self, "__proxy_owned__", True)
        object.__setattr__(self, "__proxy_borrows__", 0)
        object.__setattr__(self, "__proxy_mut_borrowed__", False)

    def __reduce__(self):
        # Ownership cannot be implicitly duplicated by pickling: a pickled
        # owned proxy deserializes as a *borrowed* reference.
        return (_reconstruct_proxy, (get_factory(self),))

    def __del__(self):
        try:
            if object.__getattribute__(self, "__proxy_owned__"):
                _evict_target(self)
        except Exception:
            pass  # interpreter shutdown etc.

    def __enter__(self) -> "OwnedProxy[T]":
        return self

    def __exit__(self, *exc) -> None:
        release(self)


@register_proxy_type
class RefProxy(Proxy[T]):
    """Immutable borrow of an OwnedProxy."""

    __slots__ = ("__proxy_owner__",)

    def __init__(self, factory: Factory[T], owner: OwnedProxy[T]):
        super().__init__(factory)
        object.__setattr__(self, "__proxy_owner__", owner)

    def __reduce__(self):
        return (_reconstruct_proxy, (get_factory(self),))

    def __del__(self):
        try:
            owner = object.__getattribute__(self, "__proxy_owner__")
            n = object.__getattribute__(owner, "__proxy_borrows__")
            object.__setattr__(owner, "__proxy_borrows__", max(0, n - 1))
        except Exception:
            pass


@register_proxy_type
class RefMutProxy(Proxy[T]):
    """Exclusive mutable borrow of an OwnedProxy."""

    __slots__ = ("__proxy_owner__",)

    def __init__(self, factory: Factory[T], owner: OwnedProxy[T]):
        super().__init__(factory)
        object.__setattr__(self, "__proxy_owner__", owner)

    def __reduce__(self):
        return (_reconstruct_proxy, (get_factory(self),))

    def __del__(self):
        try:
            owner = object.__getattribute__(self, "__proxy_owner__")
            object.__setattr__(owner, "__proxy_mut_borrowed__", False)
        except Exception:
            pass


def _check_owned(p: OwnedProxy) -> None:
    if type(p) is not OwnedProxy:
        raise OwnershipError(f"expected OwnedProxy, got {type(p).__name__}")
    if not object.__getattribute__(p, "__proxy_owned__"):
        raise OwnershipError("use of moved-from OwnedProxy")


def _evict_target(p: Proxy) -> None:
    factory = get_factory(p)
    key = getattr(factory, "key", None)
    store_config = getattr(factory, "store_config", None)
    if key is None or store_config is None:
        return
    from repro_torch.core.store import get_or_create_store

    get_or_create_store(store_config).evict(key)


def borrow(p: OwnedProxy[T]) -> RefProxy[T]:
    """Immutably borrow; many simultaneous immutable borrows are fine."""
    _check_owned(p)
    if object.__getattribute__(p, "__proxy_mut_borrowed__"):
        raise OwnershipError("cannot borrow: exclusive mutable borrow active")
    n = object.__getattribute__(p, "__proxy_borrows__")
    object.__setattr__(p, "__proxy_borrows__", n + 1)
    return RefProxy(get_factory(p), p)


def mut_borrow(p: OwnedProxy[T]) -> RefMutProxy[T]:
    """Exclusively borrow for mutation; conflicts raise."""
    _check_owned(p)
    if object.__getattribute__(p, "__proxy_mut_borrowed__"):
        raise OwnershipError("cannot mut-borrow twice")
    if object.__getattribute__(p, "__proxy_borrows__") > 0:
        raise OwnershipError("cannot mut-borrow: immutable borrows active")
    object.__setattr__(p, "__proxy_mut_borrowed__", True)
    return RefMutProxy(get_factory(p), p)


def transfer(p: OwnedProxy[T]) -> OwnedProxy[T]:
    """Move ownership; the argument becomes invalid (moved-from)."""
    _check_owned(p)
    if object.__getattribute__(p, "__proxy_borrows__") > 0 or object.__getattribute__(
        p, "__proxy_mut_borrowed__"
    ):
        raise OwnershipError("cannot move while borrowed")
    object.__setattr__(p, "__proxy_owned__", False)
    return OwnedProxy(get_factory(p))


def release(p: OwnedProxy[T]) -> None:
    """Explicitly end the owned lifetime (evict now)."""
    _check_owned(p)
    object.__setattr__(p, "__proxy_owned__", False)
    _evict_target(p)


def disown(p: OwnedProxy[T]) -> Proxy[T]:
    """Give up ownership without evicting (leak to the store's GC policy)."""
    _check_owned(p)
    object.__setattr__(p, "__proxy_owned__", False)
    return Proxy(get_factory(p))
