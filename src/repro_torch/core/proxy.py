"""Transparent object proxy with cached target metadata.

The proxy is the paper's core building block: a reference-like object that
is valid across process/machine boundaries, resolves its target
*just-in-time* on first use, and forwards every operation to the target.

Two properties matter for integration with task schedulers (paper §3,
"Compatibility"):

1. **Cheap to communicate** -- ``pickle(proxy)`` serializes only the factory
   (a few hundred bytes), never the target.
2. **Introspection never resolves** -- schedulers hash task arguments and
   inspect ``__class__`` / ``__module__`` to pick serializers.  A naive
   proxy would fire a (possibly remote) resolve on each of these.  We cache
   common read-only metadata of the target at proxy-creation time (class,
   module, hash, length, and array ``shape``/``dtype``/``nbytes``) and serve
   them from the cache, exactly as the paper's custom ``@property``
   implementation does.

PyTorch note: a proxy of an ndarray resolves through ``__array__``.
``torch.as_tensor(proxy)`` takes the forwarded ``__dlpack__`` of the
resolved, read-only array and raises ``BufferError``; build tensors with
``torch.from_numpy(np.array(proxy))`` (``repro_torch.bridge.to_tensor``).
"""

from __future__ import annotations

import operator
from dataclasses import dataclass
from typing import Any, Callable, Generic, TypeVar, Union

T = TypeVar("T")

_SLOTS = (
    "__proxy_factory__",
    "__proxy_target__",
    "__proxy_resolved__",
    "__proxy_metadata__",
)


@dataclass
class TargetMetadata:
    """Read-only facts about the target, captured at proxy creation."""

    cls: type | None = None
    module: str | None = None
    qualname: str | None = None
    hash_value: int | None = None
    hashable: bool = False
    length: int | None = None
    # array-likes (np.ndarray / torch.Tensor)
    shape: tuple | None = None
    dtype: Any = None
    nbytes: int | None = None
    # opaque token for scheduler key hashing (never requires resolution)
    token: str | None = None

    @staticmethod
    def from_target(target: Any, token: str | None = None) -> "TargetMetadata":
        cls: type | None = type(target)
        md = TargetMetadata(
            cls=cls,
            module=type(target).__module__,
            qualname=type(target).__qualname__,
            token=token,
        )
        try:
            md.hash_value = hash(target)
            md.hashable = True
        except TypeError:
            md.hashable = False
        try:
            md.length = len(target)
        except TypeError:
            md.length = None
        shape = getattr(target, "shape", None)
        if isinstance(shape, tuple):
            md.shape = shape
            md.dtype = getattr(target, "dtype", None)
            nbytes = getattr(target, "nbytes", None)
            md.nbytes = nbytes if isinstance(nbytes, int) else None
        return md


class Factory(Generic[T]):
    """Self-contained callable that produces the proxy's target."""

    def __call__(self) -> T:  # pragma: no cover - interface
        raise NotImplementedError

    def metadata(self) -> TargetMetadata | None:
        return None


class SimpleFactory(Factory[T]):
    """Holds the target directly (testing / pass-through semantics)."""

    def __init__(self, obj: T):
        self.obj = obj

    def __call__(self) -> T:
        return self.obj

    def metadata(self) -> TargetMetadata | None:
        return TargetMetadata.from_target(self.obj)


class LambdaFactory(Factory[T]):
    """Wraps an arbitrary picklable zero-arg callable."""

    def __init__(self, fn: Callable[[], T], md: TargetMetadata | None = None):
        self.fn = fn
        self._md = md

    def __call__(self) -> T:
        return self.fn()

    def metadata(self) -> TargetMetadata | None:
        return self._md


class StoreFactory(Factory[T]):
    """Resolves the target from a ``Store`` identified by its config.

    The config (not the live connection) travels with the proxy, so the
    factory can lazily re-open the store inside any process: this is the
    "self-contained" property that makes proxies wide-area references.
    """

    def __init__(
        self,
        store_config: dict[str, Any],
        key: Any,
        evict: bool = False,
        md: TargetMetadata | None = None,
    ):
        self.store_config = store_config
        self.key = key
        self.evict = evict
        self._md = md

    def __call__(self) -> T:
        from repro_torch.core.store import get_or_create_store

        store = get_or_create_store(self.store_config)
        obj = store.get(self.key)
        if obj is None:
            raise ProxyResolveError(
                f"object {self.key} not found in store "
                f"{self.store_config.get('name')!r} (evicted or never stored)"
            )
        if self.evict:
            store.evict(self.key)
        return obj

    def metadata(self) -> TargetMetadata | None:
        return self._md


class ProxyResolveError(RuntimeError):
    pass


def _resolve(p: "Proxy") -> Any:
    if not object.__getattribute__(p, "__proxy_resolved__"):
        factory = object.__getattribute__(p, "__proxy_factory__")
        target = factory()
        object.__setattr__(p, "__proxy_target__", target)
        object.__setattr__(p, "__proxy_resolved__", True)
    return object.__getattribute__(p, "__proxy_target__")


def _metadata(p: "Proxy") -> TargetMetadata | None:
    return object.__getattribute__(p, "__proxy_metadata__")


def _make_forward(name: str):
    def fwd(self, *args, **kwargs):
        target = _resolve(self)
        return getattr(target, name)(*args, **kwargs)

    fwd.__name__ = name
    return fwd


def _make_binary(op):
    def fwd(self, other):
        return op(_resolve(self), extract(other))

    return fwd


def _make_rbinary(op):
    def fwd(self, other):
        return op(extract(other), _resolve(self))

    return fwd


def _make_unary(op):
    def fwd(self):
        return op(_resolve(self))

    return fwd


class Proxy(Generic[T]):
    """Transparent just-in-time-resolving reference to a remote object."""

    __slots__ = _SLOTS

    def __init__(self, factory: Factory[T]):
        object.__setattr__(self, "__proxy_factory__", factory)
        object.__setattr__(self, "__proxy_target__", None)
        object.__setattr__(self, "__proxy_resolved__", False)
        object.__setattr__(self, "__proxy_metadata__", factory.metadata())

    # -- serialization: a proxy pickles as its factory alone ---------------
    # (via a module-level function: the __module__ property below makes the
    # class itself unpicklable by reference, which is fine for instances)

    def __reduce__(self):
        return (
            _reconstruct_proxy,
            (object.__getattribute__(self, "__proxy_factory__"),),
        )

    def __reduce_ex__(self, protocol):
        return self.__reduce__()

    # -- cached-introspection fast paths (paper §3 Compatibility) -----------

    @property
    def __class__(self):  # type: ignore[override]
        md = _metadata(self)
        if md is not None and md.cls is not None:
            return md.cls
        return type(_resolve(self))

    @property
    def __module__(self):  # type: ignore[override]
        md = _metadata(self)
        if md is not None and md.module is not None:
            return md.module
        return type(_resolve(self)).__module__

    def __hash__(self):
        md = _metadata(self)
        if md is not None:
            if md.hashable and md.hash_value is not None:
                return md.hash_value
            if not md.hashable:
                cls = md.qualname or "object"
                raise TypeError(f"unhashable type: '{cls}'")
        return hash(_resolve(self))

    def __len__(self):
        md = _metadata(self)
        if md is not None and not object.__getattribute__(self, "__proxy_resolved__"):
            if md.length is not None:
                return md.length
        return len(_resolve(self))

    # -- attribute protocol --------------------------------------------------

    def __getattr__(self, name: str):
        # Serve array metadata without resolving when still cold.
        if not object.__getattribute__(self, "__proxy_resolved__"):
            md = _metadata(self)
            if md is not None:
                if name == "shape" and md.shape is not None:
                    return md.shape
                if name == "dtype" and md.dtype is not None:
                    return md.dtype
                if name == "nbytes" and md.nbytes is not None:
                    return md.nbytes
        return getattr(_resolve(self), name)

    def __setattr__(self, name: str, value: Any):
        if name in _SLOTS:
            object.__setattr__(self, name, value)
        elif name == "__orig_class__":
            pass  # Generic[T].__call__ side effect; never forward to target
        else:
            setattr(_resolve(self), name, value)

    def __delattr__(self, name: str):
        delattr(_resolve(self), name)

    # -- object protocol -------------------------------------------------------

    def __repr__(self):
        if object.__getattribute__(self, "__proxy_resolved__"):
            return repr(_resolve(self))
        md = _metadata(self)
        desc = md.qualname if md is not None else "?"
        return f"<Proxy[{desc}] unresolved>"

    def __str__(self):
        return str(_resolve(self))

    def __format__(self, spec):
        return format(_resolve(self), spec)

    def __bytes__(self):
        return bytes(_resolve(self))

    def __bool__(self):
        return bool(_resolve(self))

    def __dir__(self):
        return dir(_resolve(self))

    # -- numeric coercions -----------------------------------------------------

    __int__ = _make_unary(int)
    __float__ = _make_unary(float)
    __complex__ = _make_unary(complex)
    __index__ = _make_unary(operator.index)
    __abs__ = _make_unary(operator.abs)
    __neg__ = _make_unary(operator.neg)
    __pos__ = _make_unary(operator.pos)
    __invert__ = _make_unary(operator.invert)

    # -- comparisons -------------------------------------------------------------

    __eq__ = _make_binary(operator.eq)
    __ne__ = _make_binary(operator.ne)
    __lt__ = _make_binary(operator.lt)
    __le__ = _make_binary(operator.le)
    __gt__ = _make_binary(operator.gt)
    __ge__ = _make_binary(operator.ge)

    # -- arithmetic ----------------------------------------------------------------

    __add__ = _make_binary(operator.add)
    __sub__ = _make_binary(operator.sub)
    __mul__ = _make_binary(operator.mul)
    __truediv__ = _make_binary(operator.truediv)
    __floordiv__ = _make_binary(operator.floordiv)
    __mod__ = _make_binary(operator.mod)
    __pow__ = _make_binary(operator.pow)
    __matmul__ = _make_binary(operator.matmul)
    __lshift__ = _make_binary(operator.lshift)
    __rshift__ = _make_binary(operator.rshift)
    __and__ = _make_binary(operator.and_)
    __or__ = _make_binary(operator.or_)
    __xor__ = _make_binary(operator.xor)
    __divmod__ = _make_binary(divmod)

    __radd__ = _make_rbinary(operator.add)
    __rsub__ = _make_rbinary(operator.sub)
    __rmul__ = _make_rbinary(operator.mul)
    __rtruediv__ = _make_rbinary(operator.truediv)
    __rfloordiv__ = _make_rbinary(operator.floordiv)
    __rmod__ = _make_rbinary(operator.mod)
    __rpow__ = _make_rbinary(operator.pow)
    __rmatmul__ = _make_rbinary(operator.matmul)
    __rlshift__ = _make_rbinary(operator.lshift)
    __rrshift__ = _make_rbinary(operator.rshift)
    __rand__ = _make_rbinary(operator.and_)
    __ror__ = _make_rbinary(operator.or_)
    __rxor__ = _make_rbinary(operator.xor)
    __rdivmod__ = _make_rbinary(divmod)

    # -- containers -------------------------------------------------------------------

    def __getitem__(self, item):
        return _resolve(self)[extract(item)]

    def __setitem__(self, item, value):
        _resolve(self)[extract(item)] = value

    def __delitem__(self, item):
        del _resolve(self)[extract(item)]

    def __contains__(self, item):
        return extract(item) in _resolve(self)

    def __iter__(self):
        return iter(_resolve(self))

    def __next__(self):
        return next(_resolve(self))

    def __reversed__(self):
        return reversed(_resolve(self))

    # -- callables / context managers ---------------------------------------------------

    def __call__(self, *args, **kwargs):
        return _resolve(self)(*args, **kwargs)

    def __enter__(self):
        return _resolve(self).__enter__()

    def __exit__(self, *exc):
        return _resolve(self).__exit__(*exc)

    # -- numpy interop ---------------------------------------------------------------------

    def __array__(self, dtype=None, copy=None):
        import numpy as np

        target = _resolve(self)
        arr = np.asarray(target)
        if dtype is not None:
            arr = arr.astype(dtype, copy=False)
        return arr


def _reconstruct_proxy(factory: "Factory") -> "Proxy":
    return Proxy(factory)


def extract(obj: Any) -> Any:
    """Return the target if ``obj`` is a proxy (resolving it), else ``obj``."""
    if is_proxy(obj):
        return _resolve(obj)
    return obj


def is_proxy(obj: Any) -> bool:
    # type(obj) bypasses the __class__ property lie.
    return isinstance(type(obj), type) and type(obj) in _PROXY_TYPES


def is_resolved(p: "Proxy") -> bool:
    return object.__getattribute__(p, "__proxy_resolved__")


def resolve(p: "Proxy") -> Any:
    """Eagerly resolve a proxy (fetch the target now)."""
    return _resolve(p)


def get_factory(p: "Proxy") -> Factory:
    return object.__getattribute__(p, "__proxy_factory__")


def get_metadata(p: "Proxy") -> TargetMetadata | None:
    return _metadata(p)


def proxy_token(obj: Any) -> str | None:
    """Deterministic identity token for task-key hashing, no resolution.

    Schedulers use this instead of ``hash()`` to tokenize proxy arguments.
    """
    if not is_proxy(obj):
        return None
    md = _metadata(obj)
    if md is not None and md.token is not None:
        return md.token
    factory = get_factory(obj)
    key = getattr(factory, "key", None)
    if key is not None:
        return getattr(key, "object_id", str(key))
    return None


# Populated after class definitions (OwnedProxy registers itself too).
_PROXY_TYPES: set[type] = {Proxy}


def register_proxy_type(cls: type) -> type:
    _PROXY_TYPES.add(cls)
    return cls


# Typing helper mirroring proxystore's ProxyOr[T]
ProxyOr = Union[Proxy[T], T]
