"""Task graphs, task keys, and deterministic argument tokenization.

Mirrors Dask's behavior that motivated the paper's compatibility work: the
scheduler derives a key from the function and its arguments (for caching of
pure functions), which means it *introspects every argument*.  Proxy
arguments are tokenized from their cached metadata token -- never resolved.

:class:`TaskGraph` is the client-side constructor behind graph-native
submission: nodes carry explicit dependencies (other nodes or live
futures), pure nodes dedup by content token at ``add`` time, and the whole
graph crosses the control plane as **one** ``SUBMIT_GRAPH`` message instead
of N ``SUBMIT`` round-trips -- the per-task scheduler overhead the
fan-out benchmarks stress.
"""

from __future__ import annotations

import hashlib
import pickle
import uuid
from concurrent.futures import Future
from typing import Any, Callable, Iterator, Mapping, Sequence

import numpy as np

from repro_torch.core.proxy import is_proxy, proxy_token


def tokenize(*args: Any) -> str:
    h = hashlib.blake2b(digest_size=16)
    for a in args:
        _update(h, a)
    return h.hexdigest()


def _update(h: "hashlib._Hash", obj: Any) -> None:
    if isinstance(obj, FutureRef):
        # An upstream task is identified by its key alone: tokenizing the
        # placeholder (not the eventual value) keeps keys computable before
        # any dependency has run.
        h.update(b"ref:")
        h.update(obj.key.encode())
        return
    if is_proxy(obj):
        # Cached identity token; resolving here would defeat pass-by-proxy.
        h.update(b"proxy:")
        h.update((proxy_token(obj) or repr(obj)).encode())
        return
    if isinstance(obj, np.ndarray):
        h.update(b"nd:")
        h.update(str(obj.dtype).encode())
        h.update(str(obj.shape).encode())
        # Content digest of at most 64 KiB: cheap yet collision-safe enough
        # for scheduler-side caching (Dask tokenizes full content; we bound
        # the cost, trading exactness on giant arrays for dispatch latency).
        flat = obj.reshape(-1).view(np.uint8) if obj.flags.c_contiguous else None
        if flat is not None:
            h.update(memoryview(flat[: 64 * 1024]))
        else:
            h.update(obj.tobytes()[: 64 * 1024])
        return
    if isinstance(obj, (str, bytes)):
        h.update(obj.encode() if isinstance(obj, str) else obj)
        return
    if isinstance(obj, (int, float, bool, complex, type(None))):
        h.update(repr(obj).encode())
        return
    if isinstance(obj, (list, tuple)):
        h.update(b"seq:")
        for x in obj:
            _update(h, x)
        return
    if isinstance(obj, dict):
        h.update(b"map:")
        for k in sorted(obj, key=repr):
            _update(h, k)
            _update(h, obj[k])
        return
    if callable(obj):
        name = getattr(obj, "__qualname__", None) or repr(obj)
        mod = getattr(obj, "__module__", "")
        h.update(f"fn:{mod}.{name}".encode())
        return
    try:
        h.update(pickle.dumps(obj, protocol=5))
    except Exception:
        h.update(repr(obj).encode())


class FutureRef:
    """Placeholder for an unfinished upstream task inside task args."""

    __slots__ = ("key",)

    def __init__(self, key: str):
        self.key = key

    def __repr__(self) -> str:
        return f"FutureRef({self.key})"

    def __reduce__(self):
        return (FutureRef, (self.key,))


def substitute_refs(obj: Any, results: dict[str, Any]) -> Any:
    """Replace FutureRefs in (possibly nested) args with their results."""
    if isinstance(obj, FutureRef):
        return results[obj.key]
    if isinstance(obj, list):
        return [substitute_refs(x, results) for x in obj]
    if isinstance(obj, tuple):
        return tuple(substitute_refs(x, results) for x in obj)
    if isinstance(obj, dict):
        return {k: substitute_refs(v, results) for k, v in obj.items()}
    return obj


def find_refs(obj: Any) -> list[str]:
    out: list[str] = []
    _find(obj, out)
    return out


class GraphNode:
    """Handle to one task inside a :class:`TaskGraph`.

    Usable as an argument to later ``add`` calls (becoming an in-graph
    dependency) and as a selector for ``Client.submit_graph`` /
    ``Session.compute`` outputs.
    """

    __slots__ = ("graph", "key")

    def __init__(self, graph: "TaskGraph", key: str):
        self.graph = graph
        self.key = key

    def __repr__(self) -> str:
        return f"GraphNode({self.key})"


class TaskGraph:
    """A dependency graph submitted as a single message.

    ``add(fn, *args, **kwargs)`` returns a :class:`GraphNode`; arguments may
    be plain values, earlier nodes of *this* graph, or live futures (any
    ``concurrent.futures.Future`` with a ``.key`` -- i.e. a task already
    submitted to the same scheduler).  Pure nodes reuse the content
    tokenizer, so adding the same pure call twice yields the same node
    (within-graph dedup); acyclicity holds by construction because a node
    can only depend on nodes that already exist.
    """

    def __init__(self) -> None:
        self._specs: dict[str, dict[str, Any]] = {}  # insertion = topo order
        self._dependents: dict[str, set[str]] = {}

    def add(
        self,
        fn: Callable,
        /,
        *args: Any,
        key: str | None = None,
        pure: bool = True,
        retries: int = 2,
        **kwargs: Any,
    ) -> GraphNode:
        """Add one task.  ``key``/``pure``/``retries`` are reserved task
        parameters (like Dask's submit); a function kwarg with one of those
        names must go through :meth:`add_call` instead."""
        return self.add_call(fn, args, kwargs, key=key, pure=pure, retries=retries)

    def add_call(
        self,
        fn: Callable,
        args: Sequence[Any] = (),
        kwargs: Mapping[str, Any] | None = None,
        *,
        key: str | None = None,
        pure: bool = True,
        retries: int = 2,
    ) -> GraphNode:
        """Collision-free form of :meth:`add`: the function's positional
        and keyword arguments travel as a sequence and a mapping, so user
        kwargs named ``key``/``pure``/``retries`` reach the function."""
        conv_args = [self._convert(a) for a in args]
        conv_kwargs = {k: self._convert(v) for k, v in (kwargs or {}).items()}
        deps = sorted(set(find_refs(conv_args) + find_refs(conv_kwargs)))
        if key is None:
            if pure:
                key = tokenize(fn, conv_args, sorted(conv_kwargs.items(), key=repr))
            else:
                key = f"task-{uuid.uuid4().hex}"
        if key in self._specs:
            return GraphNode(self, key)  # pure within-graph dedup
        self._specs[key] = {
            "fn": fn,
            "args": conv_args,
            "kwargs": conv_kwargs,
            "deps": deps,
            "pure": pure,
            "retries": retries,
        }
        for d in deps:
            if d in self._specs:
                self._dependents.setdefault(d, set()).add(key)
        return GraphNode(self, key)

    def _convert(self, obj: Any) -> Any:
        if isinstance(obj, GraphNode):
            if obj.graph is not self:
                raise ValueError(
                    f"node {obj.key} belongs to a different TaskGraph; "
                    "cross-graph dependencies must go through submitted futures"
                )
            return FutureRef(obj.key)
        if isinstance(obj, Future) and isinstance(getattr(obj, "key", None), str):
            return FutureRef(obj.key)  # already-submitted task
        if isinstance(obj, list):
            return [self._convert(x) for x in obj]
        if isinstance(obj, tuple):
            return tuple(self._convert(x) for x in obj)
        if isinstance(obj, dict):
            return {k: self._convert(v) for k, v in obj.items()}
        return obj

    # -- introspection -------------------------------------------------------

    def __len__(self) -> int:
        return len(self._specs)

    def __contains__(self, key: str) -> bool:
        return key in self._specs

    def items(self) -> Iterator[tuple[str, dict[str, Any]]]:
        """(key, spec) pairs in insertion (= topological) order."""
        return iter(self._specs.items())

    def outputs(self) -> list[GraphNode]:
        """Nodes no other node of this graph depends on, in insertion order."""
        return [
            GraphNode(self, key)
            for key in self._specs
            if not self._dependents.get(key)
        ]


def _find(obj: Any, out: list[str]) -> None:
    if isinstance(obj, FutureRef):
        out.append(obj.key)
    elif isinstance(obj, (list, tuple)):
        for x in obj:
            _find(x, out)
    elif isinstance(obj, dict):
        for v in obj.values():
            _find(v, out)
