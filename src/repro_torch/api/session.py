"""Session: one facade over the paper's three integration patterns.

A ``Session`` composes an execution backend, a store, and a should-proxy
policy behind a uniform ``submit`` / ``map`` / ``gather`` / ``scatter`` /
``as_completed`` surface:

* ``Session()``                      — bare in-process execution,
* ``Session(executor=pool)``         — any ``concurrent.futures`` executor
  (policy-driven auto-proxying, Fig 2c),
* ``Session(cluster=LocalCluster())``— the runtime scheduler with drop-in
  pass-by-proxy (Fig 2b),

or declaratively via the one-knob ``backend`` selector::

    Session(backend="in-process")
    Session(backend="executor")                     # owns a thread pool
    Session(backend="cluster")                      # owns a LocalCluster
    Session(backend="cluster", cluster=ClusterSpec(n_workers=8))

A backend built by the session (from a :class:`ClusterSpec`, a worker
count, or the defaults) is session-owned and shut down on close — for the
cluster backend that also evicts every ref the data plane still holds.

``session.scatter`` / ``session.proxy`` cover the manual pattern
(Fig 2a).  Every proxy the session mints client-side is *session-owned*:
closing the session (or leaving its ``with`` block) evicts the backing
objects, so no storage leaks past the session's lifetime.
"""

from __future__ import annotations

import uuid
from concurrent.futures import Future, ThreadPoolExecutor
from concurrent.futures import as_completed as _futures_as_completed
from typing import Any, Callable, Iterable, Iterator, Sequence, TypeVar

from repro_torch.api.config import ClusterSpec, PolicySpec, StoreConfig
from repro_torch.core.connectors.base import Key
from repro_torch.core.executor import StoreExecutor
from repro_torch.core.policy import Policy, SizePolicy
from repro_torch.core.proxy import Proxy, get_factory, is_proxy
from repro_torch.core.store import Store
from repro_torch.runtime.graph import GraphNode, TaskGraph, substitute_refs

T = TypeVar("T")


def as_completed(futures: Iterable[Future], timeout: float | None = None) -> Iterator[Future]:
    """Yield futures as they finish (works for every Session backend)."""
    return _futures_as_completed(list(futures), timeout=timeout)


class SessionClosedError(RuntimeError):
    pass


class Session:
    """Cluster + store + policy behind one uniform futures interface."""

    def __init__(
        self,
        *,
        backend: str | None = None,
        store: StoreConfig | Store | None = None,
        cluster: Any = None,
        executor: Any = None,
        policy: PolicySpec | Policy | str | None = None,
        proxy_results: bool = True,
        ownership: bool = False,
        name: str | None = None,
    ):
        if cluster is not None and executor is not None:
            raise ValueError("pass either cluster= or executor=, not both")
        backend, cluster, executor, owns_backend = _resolve_backend(
            backend, cluster, executor
        )
        self._backend = backend
        self._owns_backend = owns_backend
        self.name = name or f"session-{uuid.uuid4().hex[:8]}"

        try:
            # -- store: build from config (owned) or adopt a live one (borrowed)
            if store is None:
                store = StoreConfig(self.name, ("memory", {"segment": self.name}))
            if isinstance(store, StoreConfig):
                self.store = store.build(register=True)
                self._owns_store = True
            else:
                self.store = store
                self._owns_store = False

            # -- policy: spec, registered name, or bare callable
            if policy is None:
                policy = SizePolicy()
            elif isinstance(policy, str):
                policy = PolicySpec(policy).build()
            elif isinstance(policy, PolicySpec):
                policy = policy.build()
            self.policy: Policy = policy

            self.proxy_results = proxy_results
            self.ownership = ownership
            self._owned_keys: dict[str, Key] = {}
            # Stream endpoints and model servers this session opened, in
            # open order.  close() drains them (producers flush EOS,
            # servers drain their admission queues, consumers release
            # unacked refs) *before* the cluster data plane is wiped.
            self._streams: list[Any] = []
            self._servers: list[Any] = []
            self._closed = False

            # -- execution backend
            self._client = None
            self._executor = None
            self._cluster = cluster
            self._raw_executor = executor
            if cluster is not None:
                self._client = _make_session_client(
                    self,
                    cluster,
                    store=self.store,
                    policy=self.policy,
                    proxy_results=proxy_results,
                )
            elif executor is not None:
                self._executor = _SessionStoreExecutor(
                    self,
                    executor,
                    self.store,
                    should_proxy=self.policy,
                    proxy_results=proxy_results,
                    ownership=ownership,
                )
        except BaseException:
            # A backend this constructor built must not outlive a failed
            # construction (bad store spec, unknown policy, ...): tear down
            # the cluster threads / thread pool before propagating.
            if owns_backend:
                if cluster is not None:
                    try:
                        cluster.close()
                    except Exception:
                        pass
                if executor is not None:
                    try:
                        executor.shutdown(wait=False)
                    except Exception:
                        pass
            raise

    # -- proxy lifetime scoping ------------------------------------------------

    def _track(self, proxy: Proxy) -> Proxy:
        key = getattr(get_factory(proxy), "key", None)
        if isinstance(key, Key):
            self._owned_keys[key.object_id] = key
        return proxy

    def owned_count(self) -> int:
        return len(self._owned_keys)

    # -- manual pattern (Fig 2a) -----------------------------------------------

    def proxy(self, obj: T, *, evict: bool = False, owned: bool = True) -> Proxy[T]:
        """Store ``obj`` and return a transparent proxy (manual pattern)."""
        self._check_open()
        p = self.store.proxy(obj, evict=evict)
        return self._track(p) if owned and not evict else p

    def scatter(
        self, data: T | Sequence[T], *, owned: bool = True
    ) -> Proxy[T] | list[Proxy]:
        """Place data in the session store, returning session-owned proxies.

        Lists/tuples scatter element-wise (one proxy per element), matching
        Dask's ``Client.scatter`` shape.
        """
        self._check_open()
        if isinstance(data, (list, tuple)):
            proxies = self.store.proxy_batch(list(data))
            if owned:
                for p in proxies:
                    self._track(p)
            return proxies
        p = self.store.proxy(data)
        return self._track(p) if owned else p

    # -- uniform execution surface ----------------------------------------------

    def submit(self, fn: Callable[..., T], /, *args: Any, **kwargs: Any) -> Future:
        """Run ``fn`` on the session backend; always returns a Future.

        Futures are accepted as arguments on every backend: the cluster
        client turns them into graph dependencies; the executor and
        in-process backends resolve them before dispatch, so task chains
        written once run unchanged under any backend.
        """
        self._check_open()
        if self._client is not None:
            return self._client.submit(fn, *args, **kwargs)
        # Dask-style scheduling hints are cluster-backend concepts; the
        # executor and in-process backends must not pass them to user code.
        kwargs.pop("pure", None)
        kwargs.pop("retries", None)
        args = tuple(_resolve_future_args(a) for a in args)
        kwargs = {k: _resolve_future_args(v) for k, v in kwargs.items()}
        if self._executor is not None:
            return self._executor.submit(fn, *args, **kwargs)
        return self._submit_inprocess(fn, *args, **kwargs)

    def map(self, fn: Callable[..., T], *iterables: Iterable) -> list[Future]:
        """On the cluster backend the whole map batches into ONE task-graph
        submission (one scheduler message); other backends submit per item."""
        self._check_open()
        if self._client is not None:
            return self._client.map(fn, *iterables)
        return [self.submit(fn, *args) for args in zip(*iterables)]

    # -- task graphs -------------------------------------------------------------

    def graph(self) -> TaskGraph:
        """A fresh :class:`TaskGraph` (convenience constructor)."""
        self._check_open()
        return TaskGraph()

    def submit_graph(
        self, graph: TaskGraph, nodes: Sequence[GraphNode] | None = None
    ) -> list[Future]:
        """Submit a dependency graph; returns futures for ``nodes``
        (default: the graph's outputs).

        On the cluster backend the graph crosses the control plane as a
        single ``SUBMIT_GRAPH`` message and interior nodes complete without
        any per-task client traffic.  Other backends execute the graph
        locally in topological order (the executor backend runs independent
        nodes concurrently), so graph-shaped code is portable across every
        backend.
        """
        self._check_open()
        if self._client is not None:
            return self._client.submit_graph(graph, nodes=nodes)
        nodes = graph.outputs() if nodes is None else list(nodes)
        for node in nodes:  # fail before running anything, like the cluster path
            if node.key not in graph:
                raise ValueError(f"node {node.key} is not part of this graph")
        futures_by_key: dict[str, Future] = {}
        for key, spec in graph.items():
            # Resolve dependency futures and any live Future arguments
            # *here*, client-side: process pools cannot pickle Future
            # objects, and deps were submitted first (topo order), so
            # waiting on them cannot deadlock.  Dependency-free nodes
            # (wide fan-outs) never block this loop.
            try:
                dep_values = {
                    d: futures_by_key[d].result()
                    for d in spec["deps"]
                    if d in futures_by_key
                }
                spec = {
                    **spec,
                    "args": _resolve_future_args(spec["args"]),
                    "kwargs": _resolve_future_args(spec["kwargs"]),
                }
            except BaseException as exc:
                f = Future()
                f.set_exception(exc)
                futures_by_key[key] = f
                continue
            if self._raw_executor is not None:
                futures_by_key[key] = self._raw_executor.submit(
                    _run_graph_node, spec, dep_values
                )
            else:
                f = Future()
                try:
                    f.set_result(_run_graph_node(spec, dep_values))
                except BaseException as exc:
                    f.set_exception(exc)
                futures_by_key[key] = f
        return [futures_by_key[n.key] for n in nodes]

    def compute(
        self, graph: TaskGraph, nodes: Sequence[GraphNode] | GraphNode | None = None
    ) -> Any:
        """Submit ``graph`` and block for its results.

        Returns the result list for ``nodes`` (default: graph outputs); a
        single :class:`GraphNode` returns its bare result.
        """
        single = isinstance(nodes, GraphNode)
        futures = self.submit_graph(graph, nodes=[nodes] if single else nodes)
        results = [f.result() for f in futures]
        return results[0] if single else results

    def gather(self, futures: Sequence[Future] | Future) -> list[Any] | Any:
        if isinstance(futures, Future):
            return futures.result()
        return [f.result() for f in futures]

    def as_completed(
        self, futures: Iterable[Future], timeout: float | None = None
    ) -> Iterator[Future]:
        return as_completed(futures, timeout=timeout)

    def _submit_inprocess(self, fn: Callable, /, *args: Any, **kwargs: Any) -> Future:
        f: Future = Future()
        try:
            result = fn(*args, **kwargs)  # proxy args resolve transparently
        except BaseException as exc:
            f.set_exception(exc)
            return f
        if self.proxy_results and not is_proxy(result) and self.policy(result):
            result = self._track(self.store.proxy(result))
        f.set_result(result)
        return f

    # -- streaming & serving (cluster backend) ------------------------------------

    def _stream_hub(self) -> Any:
        self._check_open()
        if self._cluster is None:
            raise ValueError(
                "streams need the cluster backend: its ResultStore tiers "
                "carry the payload bytes (use Session(backend='cluster'))"
            )
        return self._cluster.streams()

    def stream_producer(
        self,
        topic: str,
        *,
        buffer: int | None = None,
        send_timeout: float | None = None,
    ) -> Any:
        """A :class:`~repro_torch.runtime.stream.StreamProducer` on ``topic``.

        Payload bytes ride the cluster's store tiers; only (key, ref,
        nbytes, metadata) events touch the broker.  ``buffer`` bounds the
        topic's event queue (backpressure); the endpoint is session-owned
        and flushed/closed by ``Session.close``.
        """
        kwargs: dict[str, Any] = {}
        if buffer is not None:
            kwargs["buffer"] = buffer
        if send_timeout is not None:
            kwargs["send_timeout"] = send_timeout
        producer = self._stream_hub().producer(topic, **kwargs)
        self._streams.append(producer)
        return producer

    def stream_consumer(self, topic: str, *, auto_ack: bool = True) -> Any:
        """A :class:`~repro_torch.runtime.stream.StreamConsumer` on ``topic``.

        Each consumed item's ack releases its bytes from the cluster
        store exactly once; ``auto_ack=False`` defers that to
        ``item.ack()``.  Session-owned: closed by ``Session.close``.
        """
        consumer = self._stream_hub().consumer(topic, auto_ack=auto_ack)
        self._streams.append(consumer)
        return consumer

    def serve(self, model_fn: Callable[[list[Any]], Sequence[Any]], **overrides: Any) -> Any:
        """A continuous-batching :class:`~repro_torch.runtime.serving.ModelServer`.

        Batching knobs default from the cluster's :class:`ServeSpec`
        (``ClusterSpec(serve=...)``); keyword ``overrides`` win.  The
        server is session-owned: ``Session.close`` drains and stops it.
        """
        self._check_open()
        if self._cluster is None:
            raise ValueError(
                "serve() needs the cluster backend "
                "(use Session(backend='cluster'))"
            )
        from repro_torch.runtime.serving import ModelServer

        kwargs = dict(getattr(self._cluster, "serve_config", None) or {})
        kwargs.update(overrides)
        server = ModelServer(model_fn, **kwargs)
        self._servers.append(server)
        return server

    # -- introspection -----------------------------------------------------------

    def stats(self) -> dict[str, int]:
        """Connector byte/op counters, when the connector keeps them."""
        stats = getattr(self.store.connector, "stats", None)
        return stats.snapshot() if stats is not None else {}

    def worker_stats(self) -> dict[str, dict[str, Any]]:
        """Per-worker memory telemetry on the cluster backend.

        One row per live worker: ``{running, managed_bytes, spilled_bytes,
        state, ...}`` (see ``LocalCluster.worker_stats``).  Non-cluster
        backends have no workers and return ``{}``.
        """
        self._check_open()
        if self._cluster is None:
            return {}
        return self._cluster.worker_stats()

    @property
    def backend(self) -> str:
        return self._backend

    @property
    def cluster(self) -> Any:
        """The live cluster backend, if any (owned or borrowed)."""
        return self._cluster

    # -- lifecycle ----------------------------------------------------------------

    def _check_open(self) -> None:
        if self._closed:
            raise SessionClosedError(f"session {self.name!r} is closed")

    def close(self) -> None:
        """Evict session-owned proxies and release session-created resources.

        A store the session built from a :class:`StoreConfig` is a
        session-private namespace, so its connector is wiped wholesale --
        this also reclaims result proxies minted worker-side, which the
        client never sees and so cannot track key-by-key.  A borrowed live
        ``Store`` (and the caller's cluster/executor) is left running; only
        the keys this session minted are evicted from it.
        """
        if self._closed:
            return
        self._closed = True
        for key in self._owned_keys.values():
            try:
                self.store.evict(key)
            except Exception:  # connector already gone: nothing to leak
                pass
        self._owned_keys.clear()
        # Streams drain before the backend dies: model servers finish
        # admitted requests, producers flush their EOS markers, and
        # consumers release delivered-but-unacked refs -- all while the
        # cluster's broker and data plane are still alive.  Reverse open
        # order closes downstream endpoints before the stages feeding them.
        for server in reversed(self._servers):
            try:
                server.close()
            except Exception:
                pass
        self._servers.clear()
        for endpoint in reversed(self._streams):
            try:
                endpoint.close()
            except Exception:
                pass
        self._streams.clear()
        if self._client is not None:
            self._client.close()
        if self._owns_backend:
            # Session-built backend: tear it down.  Closing an owned cluster
            # also wipes its data plane, so every cluster-published ref is
            # evicted with the session.
            if self._cluster is not None:
                try:
                    self._cluster.close()
                except Exception:
                    pass
            if self._raw_executor is not None:
                try:
                    self._raw_executor.shutdown(wait=True)
                except Exception:
                    pass
        if self._owns_store:
            clear = getattr(self.store.connector, "clear", None)
            if clear is not None:
                try:
                    clear()
                except Exception:
                    pass
            self.store.close()

    def __enter__(self) -> "Session":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __repr__(self) -> str:
        state = "closed" if self._closed else "open"
        return (
            f"Session(name={self.name!r}, backend={self.backend!r}, "
            f"store={self.store.name!r}, {state})"
        )


def _run_graph_node(spec: dict[str, Any], dep_values: dict[str, Any]) -> Any:
    """Execute one graph node outside the cluster: substitute resolved
    dependency values into the arg spec and call the function."""
    args = substitute_refs(spec["args"], dep_values)
    kwargs = substitute_refs(spec["kwargs"], dep_values)
    return spec["fn"](*args, **kwargs)


def _resolve_future_args(obj: Any) -> Any:
    """Replace Futures (possibly nested in containers) with their results."""
    if isinstance(obj, Future):
        return obj.result()
    if isinstance(obj, list):
        return [_resolve_future_args(x) for x in obj]
    if isinstance(obj, tuple):
        return tuple(_resolve_future_args(x) for x in obj)
    if isinstance(obj, dict):
        return {k: _resolve_future_args(v) for k, v in obj.items()}
    return obj


# -- backend resolution --------------------------------------------------------


_BACKEND_ALIASES = {
    "in-process": "in-process",
    "inprocess": "in-process",
    "local": "in-process",
    "executor": "executor",
    "cluster": "cluster",
}


def _resolve_backend(
    backend: str | None, cluster: Any, executor: Any
) -> tuple[str, Any, Any, bool]:
    """Normalize the one-knob backend selection.

    Returns ``(backend, cluster, executor, owns_backend)``.  A ClusterSpec,
    an integer worker count, or a ``backend=`` name with no live object
    makes the session build -- and therefore own and later close -- the
    backend; live objects passed in are borrowed.
    """
    if backend is None:
        backend = (
            "cluster"
            if cluster is not None
            else "executor"
            if executor is not None
            else "in-process"
        )
    try:
        backend = _BACKEND_ALIASES[backend]
    except KeyError:
        raise ValueError(
            f"unknown backend {backend!r}; pick one of "
            f"{sorted(set(_BACKEND_ALIASES.values()))}"
        ) from None

    owns = False
    if backend == "cluster":
        if executor is not None:
            raise ValueError("backend='cluster' does not take executor=")
        if cluster is None:
            cluster = ClusterSpec()
        if isinstance(cluster, ClusterSpec):
            cluster = cluster.build()
            owns = True
    elif backend == "executor":
        if cluster is not None:
            raise ValueError("backend='executor' does not take cluster=")
        if executor is None:
            executor = 4
        if isinstance(executor, int):
            executor = ThreadPoolExecutor(executor)
            owns = True
    else:  # in-process
        if cluster is not None or executor is not None:
            raise ValueError("backend='in-process' takes neither cluster= nor executor=")
        cluster = executor = None
    return backend, cluster, executor, owns


# -- session-tracking backend adapters ----------------------------------------
#
# Thin subclasses whose only job is to report client-side auto-minted arg
# proxies back to the session, so session exit can evict them.


class _SessionStoreExecutor(StoreExecutor):
    def __init__(self, session: Session, *args: Any, **kwargs: Any):
        super().__init__(*args, **kwargs)
        self._session = session

    def _maybe_proxy(self, obj: Any) -> Any:
        out = super()._maybe_proxy(obj)
        # One-shot arg proxies self-evict after first resolution; only
        # lasting ones need session-lifetime scoping.
        if out is not obj and is_proxy(out) and not self.evict_args_after_use:
            self._session._track(out)
        return out


def _make_session_client(
    session: Session, cluster: Any, *, store: Store, policy: Policy, proxy_results: bool
):
    from repro_torch.runtime.client import ProxyClient

    class _SessionProxyClient(ProxyClient):
        def _maybe_proxy(self, obj: Any) -> Any:
            out = super()._maybe_proxy(obj)
            if out is not obj and is_proxy(out):
                session._track(out)
            return out

    return _SessionProxyClient(
        cluster, ps_store=store, should_proxy=policy, proxy_results=proxy_results
    )
