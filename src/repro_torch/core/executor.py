"""StoreExecutor: policy-driven auto-proxying over any executor (Fig 2c).

Wraps any ``concurrent.futures.Executor``-shaped client (including this
framework's :class:`repro_torch.runtime.client.Client`, a stdlib pool, Parsl,
TaskVine...).  On ``submit``:

* arguments selected by ``should_proxy`` are stored and replaced with
  proxies (producer side);
* the function is wrapped so the *worker* stores large results and ships
  back a proxy instead of the value (consumer side);
* lifetimes are managed: one-shot argument proxies evict after first
  resolution, and result proxies are owned by the returned future's
  consumer (``OwnedProxy`` semantics) when ``ownership=True``.
"""

from __future__ import annotations

import functools
from concurrent.futures import Future
from typing import Any, Callable, TypeVar

from repro_torch.core.policy import Policy, SizePolicy
from repro_torch.core.proxy import Proxy, is_proxy
from repro_torch.core.store import Store, get_or_create_store

T = TypeVar("T")


def _proxy_result_task(
    fn: Callable,
    store_config: dict[str, Any],
    policy: Policy,
    ownership: bool,
    /,
    *args: Any,
    **kwargs: Any,
) -> Any:
    """Worker-side wrapper: run ``fn`` then proxy a large result in-place.

    Module-level (picklable) by design; the store is re-opened from config
    via the process-global registry, so repeated tasks share a connection.
    """
    result = fn(*args, **kwargs)
    if is_proxy(result) or not policy(result):
        return result
    store = get_or_create_store(store_config)
    if ownership:
        return store.owned_proxy(result)
    return store.proxy(result)


class StoreExecutor:
    """Executor adapter implementing the paper's most powerful integration."""

    def __init__(
        self,
        executor: Any,
        store: Store,
        *,
        should_proxy: Policy | None = None,
        proxy_results: bool = True,
        ownership: bool = False,
        evict_args_after_use: bool = True,
    ):
        self.executor = executor
        self.store = store
        self.should_proxy: Policy = should_proxy or SizePolicy(100_000)
        self.proxy_results = proxy_results
        self.ownership = ownership
        self.evict_args_after_use = evict_args_after_use

    # -- argument handling ----------------------------------------------------

    def _maybe_proxy(self, obj: Any) -> Any:
        if is_proxy(obj) or not self.should_proxy(obj):
            return obj
        # One-shot semantics: the worker's first resolution evicts, so
        # fire-and-forget task arguments do not leak storage.
        return self.store.proxy(obj, evict=self.evict_args_after_use)

    # -- executor interface ------------------------------------------------------

    def submit(self, fn: Callable[..., T], /, *args: Any, **kwargs: Any) -> Future:
        args = tuple(self._maybe_proxy(a) for a in args)
        kwargs = {k: self._maybe_proxy(v) for k, v in kwargs.items()}
        if self.proxy_results:
            call = functools.partial(
                _proxy_result_task,
                fn,
                self.store.config(),
                self.should_proxy,
                self.ownership,
            )
            return self.executor.submit(call, *args, **kwargs)
        return self.executor.submit(fn, *args, **kwargs)

    def map(self, fn: Callable[..., T], *iterables: Any, **kwargs: Any):
        futures = [self.submit(fn, *args) for args in zip(*iterables)]
        for f in futures:
            yield f.result()

    def shutdown(self, wait: bool = True, *, cancel_futures: bool = False) -> None:
        shutdown = getattr(self.executor, "shutdown", None)
        if shutdown is not None:
            try:
                shutdown(wait=wait, cancel_futures=cancel_futures)
            except TypeError:  # older executor signatures
                shutdown(wait)

    def __enter__(self) -> "StoreExecutor":
        return self

    def __exit__(self, *exc) -> None:
        self.shutdown()
