"""Typed, declarative configuration for stores, connectors, and policies.

These dataclasses replace the hand-built config dicts that previously
plumbed ``core/store.py`` / ``core/connectors`` / ``core/policy.py``
together.  Each spec:

* names its implementation (looked up in the matching plugin registry),
* validates eagerly at construction (unknown names and bad params fail at
  config time, not deep inside a worker),
* round-trips losslessly through plain dicts (``to_dict``/``from_dict``)
  using the exact wire format the existing ``Store.from_config`` /
  ``connector_from_config`` / ``policy_from_config`` functions consume, so
  a ``StoreConfig`` travels by value inside proxy factories unchanged.
"""

from __future__ import annotations

import inspect
import json
from dataclasses import dataclass, field
from typing import Any, ClassVar, Mapping

from repro_torch.core.connectors.base import (
    PEER_CAPABILITY,
    Connector,
    connector_capabilities,
    connector_registry,
)
from repro_torch.core.policy import Policy, policy_registry
from repro_torch.core.store import Store, serializer_registry


class SpecValidationError(ValueError):
    """A spec named a registered plugin but its params don't fit it."""


def _check_params(kind_label: str, name: str, cls: type, params: Mapping[str, Any]) -> None:
    """Bind ``params`` against the plugin constructor when that is decidable.

    Constructors taking ``*args``/``**kwargs`` (e.g. composite policies)
    define their own config key conventions and are validated at build time
    instead.
    """
    for key in params:
        if not isinstance(key, str):
            raise SpecValidationError(
                f"{kind_label} {name!r}: param names must be strings, got {key!r}"
            )
    try:
        sig = inspect.signature(cls)
    except (TypeError, ValueError):  # extension types without signatures
        return
    if any(
        p.kind in (p.VAR_POSITIONAL, p.VAR_KEYWORD)
        for p in sig.parameters.values()
    ):
        return
    try:
        sig.bind(**params)
    except TypeError as exc:
        raise SpecValidationError(
            f"{kind_label} {name!r} does not accept params {dict(params)!r}: {exc}"
        ) from None


def _encode(value: Any) -> Any:
    """Specs nested inside params (multi-connector rules, composite policies)
    serialize in place so ``to_dict`` output is plain JSON-able data."""
    if isinstance(value, (ConnectorSpec, PolicySpec)):
        return value.to_dict()
    if isinstance(value, (list, tuple)):
        return [_encode(v) for v in value]
    if isinstance(value, Mapping):
        return {k: _encode(v) for k, v in value.items()}
    return value


def _decode(value: Any) -> Any:
    if isinstance(value, Mapping):
        if "connector_type" in value:
            return ConnectorSpec.from_dict(value)
        if "policy_type" in value:
            return PolicySpec.from_dict(value)
        return {k: _decode(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [_decode(v) for v in value]
    return value


class _Spec:
    """Shared machinery for ``name + params`` specs.

    Subclasses set the registry, the wire-format type key, and the label
    used in error messages; everything else (validated construction, dict
    round-trips, value equality/hashing) is identical by design.
    """

    _registry: ClassVar[Any]
    _type_key: ClassVar[str]
    _label: ClassVar[str]

    kind: str
    params: dict[str, Any]

    def __init__(self, kind: str, params: Mapping[str, Any] | None = None, **extra: Any):
        merged = dict(params or {})
        merged.update(extra)
        object.__setattr__(self, "kind", kind)
        object.__setattr__(self, "params", merged)
        self.validate()

    def validate(self) -> None:
        cls = self._registry.get(self.kind)  # UnknownPluginError on typo
        _check_params(self._label, self.kind, cls, self.params)
        for v in self.params.values():
            _validate_nested(v)

    def to_dict(self) -> dict[str, Any]:
        """The exact wire format the matching ``*_from_config`` consumes."""
        return {self._type_key: self.kind, **_encode(self.params)}

    @classmethod
    def from_dict(cls, config: Mapping[str, Any]):
        config = dict(config)
        kind = config.pop(cls._type_key)
        return cls(kind, {k: _decode(v) for k, v in config.items()})

    def __eq__(self, other: Any) -> bool:
        return (
            type(other) is type(self)
            and self.kind == other.kind
            and self.params == other.params
        )

    def __hash__(self) -> int:
        # params is a dict, so hash the canonical wire form instead.
        return hash(
            (type(self), json.dumps(self.to_dict(), sort_keys=True, default=repr))
        )


@dataclass(frozen=True, init=False, eq=False)
class ConnectorSpec(_Spec):
    """A connector declared by registered name + constructor params.

    ``ConnectorSpec("memory", segment="demo")`` or, for nesting,
    ``ConnectorSpec("multi", rules=[[4096, ConnectorSpec("memory")],
    [None, ConnectorSpec("file", store_dir=...)]])``.
    """

    kind: str
    params: dict[str, Any] = field(default_factory=dict)

    _registry: ClassVar[Any] = connector_registry
    _type_key: ClassVar[str] = "connector_type"
    _label: ClassVar[str] = "connector"

    def build(self) -> Connector:
        from repro_torch.core.connectors.base import connector_from_config

        return connector_from_config(self.to_dict())


@dataclass(frozen=True, init=False, eq=False)
class PolicySpec(_Spec):
    """A should-proxy policy declared by registered name + params.

    ``PolicySpec("size", threshold=50_000)``, ``PolicySpec("never")``, or
    composites: ``PolicySpec("all", policies=[PolicySpec("type",
    types=["numpy.ndarray"]), PolicySpec("size", threshold=100)])``.
    """

    kind: str
    params: dict[str, Any] = field(default_factory=dict)

    _registry: ClassVar[Any] = policy_registry
    _type_key: ClassVar[str] = "policy_type"
    _label: ClassVar[str] = "policy"

    def build(self) -> Policy:
        from repro_torch.core.policy import policy_from_config

        return policy_from_config(self.to_dict())


def _validate_nested(value: Any) -> None:
    """Nested specs were validated by their own __init__; raw dicts that look
    like specs get validated here so errors surface at config time."""
    if isinstance(value, Mapping):
        if "connector_type" in value:
            ConnectorSpec.from_dict(value)
        elif "policy_type" in value:
            PolicySpec.from_dict(value)
    elif isinstance(value, (list, tuple)):
        for v in value:
            _validate_nested(v)


@dataclass(frozen=True, init=False)
class StoreConfig:
    """Declarative description of a :class:`repro_torch.core.store.Store`.

    Travels by value (``to_dict`` output is what proxy factories carry) and
    builds live stores on demand.  ``Store.from_config(cfg.to_dict())``
    round-trips for every registered connector.
    """

    name: str
    connector: ConnectorSpec
    serializer: str = "default"
    cache_size: int = 16
    transfer: "TransferSpec | None" = None

    def __init__(
        self,
        name: str,
        connector: ConnectorSpec | Mapping[str, Any] | tuple | str,
        serializer: str = "default",
        cache_size: int = 16,
        transfer: "TransferSpec | Mapping[str, Any] | str | None" = None,
    ):
        if isinstance(connector, str):
            connector = ConnectorSpec(connector)
        elif isinstance(connector, Mapping):
            connector = ConnectorSpec.from_dict(connector)
        elif isinstance(connector, tuple):
            connector = ConnectorSpec(*connector)
        if isinstance(transfer, str):
            transfer = TransferSpec(transfer)
        elif isinstance(transfer, Mapping):
            transfer = TransferSpec.from_dict(transfer)
        object.__setattr__(self, "name", name)
        object.__setattr__(self, "connector", connector)
        object.__setattr__(self, "serializer", serializer)
        object.__setattr__(self, "cache_size", int(cache_size))
        object.__setattr__(self, "transfer", transfer)
        self.validate()

    def validate(self) -> None:
        if not self.name or not isinstance(self.name, str):
            raise SpecValidationError("store name must be a non-empty string")
        if self.cache_size < 0:
            raise SpecValidationError("cache_size must be >= 0")
        from repro_torch.core.store import _ensure_lazy_serializers

        _ensure_lazy_serializers()
        serializer_registry.get(self.serializer)
        self.connector.validate()
        if self.transfer is not None:
            self.transfer.validate()

    def to_dict(self) -> dict[str, Any]:
        """The exact wire format ``Store.from_config`` consumes.

        ``transfer`` (the data-plane compression policy) rides the dict
        only when set, so configs without the knob are byte-identical to
        pre-compression wire dicts.
        """
        out = {
            "name": self.name,
            "connector": self.connector.to_dict(),
            "serializer": self.serializer,
            "cache_size": self.cache_size,
        }
        if self.transfer is not None:
            out["transfer"] = self.transfer.to_dict()
        return out

    @classmethod
    def from_dict(cls, config: Mapping[str, Any]) -> "StoreConfig":
        transfer = config.get("transfer")
        return cls(
            config["name"],
            ConnectorSpec.from_dict(config["connector"]),
            serializer=config.get("serializer", "default"),
            cache_size=config.get("cache_size", 16),
            transfer=TransferSpec.from_dict(transfer) if transfer else None,
        )

    def build(self, *, register: bool = False) -> Store:
        return Store(
            self.name,
            self.connector.build(),
            serializer=self.serializer,
            cache_size=self.cache_size,
            register=register,
        )


@dataclass(frozen=True, init=False)
class MemorySpec:
    """Declarative memory budget for cluster workers (the tiered data plane).

    Attaching a ``MemorySpec`` to a :class:`ClusterSpec` switches every
    worker's result cache from the memory-only LRU (which *discards* cold
    bytes, forcing store refetches) to the tiered ``SpillCache`` and turns
    on the pressure-aware scheduling loop:

    * ``limit_bytes``     -- the worker's managed-memory budget: the hot
      in-memory tier is capped here, and ``managed_bytes`` (hot cache +
      in-flight task bytes) is measured against it.  Blobs larger than
      the whole budget stream straight to the disk tier.
    * ``spill_dir``       -- directory for the disk tier (each worker gets
      a private subdirectory).  ``None`` means a per-worker tempdir that
      is removed when the worker stops.
    * ``pause_fraction``  -- above ``pause_fraction * limit_bytes`` the
      worker transitions to ``paused``: it stops pulling from its local
      ready queue, sheds (demotes) its hot tier, and the scheduler sends
      it no new work.
    * ``target_fraction`` -- the resume threshold: the worker runs again
      once managed bytes fall to ``target_fraction * limit_bytes``.

    Round-trips through plain dicts (``to_dict``/``from_dict``) like every
    other spec, so it travels by value inside a :class:`ClusterSpec`.
    """

    limit_bytes: int = 256 * 1024 * 1024
    spill_dir: str | None = None
    pause_fraction: float = 0.85
    target_fraction: float = 0.6

    def __init__(
        self,
        limit_bytes: int = 256 * 1024 * 1024,
        *,
        spill_dir: str | None = None,
        pause_fraction: float = 0.85,
        target_fraction: float = 0.6,
    ):
        object.__setattr__(self, "limit_bytes", int(limit_bytes))
        object.__setattr__(self, "spill_dir", spill_dir)
        object.__setattr__(self, "pause_fraction", float(pause_fraction))
        object.__setattr__(self, "target_fraction", float(target_fraction))
        self.validate()

    def validate(self) -> None:
        if self.limit_bytes <= 0:
            raise SpecValidationError("limit_bytes must be > 0")
        if not (0.0 < self.target_fraction <= self.pause_fraction <= 1.0):
            raise SpecValidationError(
                "fractions must satisfy 0 < target_fraction <= pause_fraction <= 1, "
                f"got target={self.target_fraction} pause={self.pause_fraction}"
            )
        if self.spill_dir is not None and not isinstance(self.spill_dir, str):
            raise SpecValidationError("spill_dir must be a string path or None")

    def to_dict(self) -> dict[str, Any]:
        """The exact wire format ``ThreadWorker(memory=...)`` consumes."""
        return {
            "limit_bytes": self.limit_bytes,
            "spill_dir": self.spill_dir,
            "pause_fraction": self.pause_fraction,
            "target_fraction": self.target_fraction,
        }

    @classmethod
    def from_dict(cls, config: Mapping[str, Any]) -> "MemorySpec":
        config = dict(config)
        return cls(
            config.pop("limit_bytes", 256 * 1024 * 1024),
            **config,
        )


@dataclass(frozen=True, init=False)
class TransferSpec:
    """Declarative compression policy for the cluster's byte paths.

    Attaching a ``TransferSpec`` to a :class:`ClusterSpec` (or a
    ``StoreConfig`` used as a cluster data plane) configures the adaptive
    per-link compression layer on every path bytes travel: tcp comm
    links, store publishes/fetches, and (optionally) the spill disk tier.

    * ``compression``      -- ``"auto"`` (default: probe each frame and
      pick the best-paying codec), ``"off"`` (ship everything raw), or a
      codec name to force (``none`` / ``zlib`` / ``lz4`` / ``cascade``;
      ``lz4`` falls back to zlib when the package is absent).
    * ``min_frame_bytes``  -- frames below this never compress: header
      overhead and codec latency dominate tiny payloads.
    * ``probe_ratio``      -- a frame compresses only when its sampled
      trial encode beats this ratio (stored/original); the guard that
      keeps incompressible payloads within a whisker of raw speed.
    * ``spill_compression`` -- codec for the spill disk tier (``None``
      keeps demotes raw).  Disk reads decode transparently.
    * ``level``            -- deflate level for the zlib-family codecs.

    It also carries the peer data plane knobs (direct worker-to-worker
    wire transfers on process clusters, ``runtime/dataserver.py``):

    * ``peer_transfer``    -- run a per-worker data server + pooled
      client so dependencies resolve cache -> shm -> peer wire -> store
      (default on; ``False`` restores the store-only byte path).
    * ``pool_size``        -- connection pool cap per peer address.
    * ``chunk_bytes``      -- transfer chunk size for both the in-proc
      peer mesh (``PeerTransfer``) and the wire path.

    And the overlap-and-spread knobs (dependency prefetch + replica-aware
    fan-out, ``runtime/prefetch.py``):

    * ``prefetch_depth``   -- how many *queued-but-not-running* tasks a
      worker's prefetch pool looks ahead when warming dependency bytes
      into the local cache (compute overlaps communication).  ``0``
      disables prefetching entirely.
    * ``max_peer_fanout``  -- replica spread bound: caps the holder list
      shipped in ``dep_info["peers"]``, the dial attempts a fetch makes
      before falling back to the store, a data server's concurrent
      serves (excess requests get a busy reply and the client falls
      through to the next replica), and the scheduler's per-holder
      concurrent-fetcher gate on wide fan-outs of heavy deps.
    * ``fetch_concurrency`` -- concurrent remote dependency fetches a
      fan-in task overlaps in ``_resolve_deps`` (was a hard-wired 4).

    The ``same-host-shm`` and ``inproc`` link classes are hard-wired to
    no compression regardless of these knobs: the zero-copy paths must
    never grow a copy.  Round-trips through plain dicts like every other
    spec; ``TransferPolicy.from_config`` consumes the compression subset
    of the wire dict and ignores the rest.
    """

    compression: str = "auto"
    min_frame_bytes: int = 64 * 1024
    probe_ratio: float = 0.9
    spill_compression: str | None = None
    level: int = 1
    peer_transfer: bool = True
    pool_size: int = 2
    chunk_bytes: int = 4 * 1024 * 1024  # runtime.transfer.DEFAULT_CHUNK_BYTES
    prefetch_depth: int = 2
    max_peer_fanout: int = 4
    fetch_concurrency: int = 4

    def __init__(
        self,
        compression: str = "auto",
        *,
        min_frame_bytes: int = 64 * 1024,
        probe_ratio: float = 0.9,
        spill_compression: str | None = None,
        level: int = 1,
        peer_transfer: bool = True,
        pool_size: int = 2,
        chunk_bytes: int = 4 * 1024 * 1024,
        prefetch_depth: int = 2,
        max_peer_fanout: int = 4,
        fetch_concurrency: int = 4,
    ):
        object.__setattr__(self, "compression", str(compression))
        object.__setattr__(self, "min_frame_bytes", int(min_frame_bytes))
        object.__setattr__(self, "probe_ratio", float(probe_ratio))
        object.__setattr__(self, "spill_compression", spill_compression)
        object.__setattr__(self, "level", int(level))
        object.__setattr__(self, "peer_transfer", bool(peer_transfer))
        object.__setattr__(self, "pool_size", int(pool_size))
        object.__setattr__(self, "chunk_bytes", int(chunk_bytes))
        object.__setattr__(self, "prefetch_depth", int(prefetch_depth))
        object.__setattr__(self, "max_peer_fanout", int(max_peer_fanout))
        object.__setattr__(self, "fetch_concurrency", int(fetch_concurrency))
        self.validate()

    def validate(self) -> None:
        from repro_torch.core.compress import available_codecs

        codecs = available_codecs()
        if self.compression not in ("auto", "off") and self.compression not in codecs:
            raise SpecValidationError(
                f"compression must be 'auto', 'off', or one of {codecs}, "
                f"got {self.compression!r}"
            )
        if self.spill_compression is not None and self.spill_compression not in codecs:
            raise SpecValidationError(
                f"spill_compression must be None or one of {codecs}, "
                f"got {self.spill_compression!r}"
            )
        if self.min_frame_bytes < 0:
            raise SpecValidationError("min_frame_bytes must be >= 0")
        if not (0.0 < self.probe_ratio <= 1.0):
            raise SpecValidationError(
                f"probe_ratio must be in (0, 1], got {self.probe_ratio}"
            )
        if self.level < 0 or self.level > 9:
            raise SpecValidationError(f"level must be in [0, 9], got {self.level}")
        if self.pool_size < 1:
            raise SpecValidationError(
                f"pool_size must be >= 1, got {self.pool_size}"
            )
        if self.chunk_bytes < 1:
            raise SpecValidationError(
                f"chunk_bytes must be >= 1, got {self.chunk_bytes}"
            )
        if self.prefetch_depth < 0:
            raise SpecValidationError(
                f"prefetch_depth must be >= 0 (0 disables), got {self.prefetch_depth}"
            )
        if self.max_peer_fanout < 1:
            raise SpecValidationError(
                f"max_peer_fanout must be >= 1, got {self.max_peer_fanout}"
            )
        if self.fetch_concurrency < 1:
            raise SpecValidationError(
                f"fetch_concurrency must be >= 1, got {self.fetch_concurrency}"
            )

    def to_dict(self) -> dict[str, Any]:
        """The wire format: ``TransferPolicy.from_config`` consumes the
        compression subset; the peer-transfer knobs are read by
        ``LocalCluster`` / ``proc.start_comm_worker``."""
        return {
            "compression": self.compression,
            "min_frame_bytes": self.min_frame_bytes,
            "probe_ratio": self.probe_ratio,
            "spill_compression": self.spill_compression,
            "level": self.level,
            "peer_transfer": self.peer_transfer,
            "pool_size": self.pool_size,
            "chunk_bytes": self.chunk_bytes,
            "prefetch_depth": self.prefetch_depth,
            "max_peer_fanout": self.max_peer_fanout,
            "fetch_concurrency": self.fetch_concurrency,
        }

    @classmethod
    def from_dict(cls, config: Mapping[str, Any]) -> "TransferSpec":
        config = dict(config)
        return cls(
            config.pop("compression", "auto"),
            **config,
        )


@dataclass(frozen=True, init=False)
class ServeSpec:
    """Declarative continuous-batching knobs for model serving.

    Attaching a ``ServeSpec`` to a :class:`ClusterSpec` sets the defaults
    for :meth:`repro_torch.api.Session.serve`'s dynamic batcher:

    * ``max_batch_size`` -- most requests one ``model_fn`` call serves.
    * ``max_wait_ms``    -- the batching window, measured from the first
      queued request: a full batch fires immediately, a lone request
      waits at most this long for company.
    * ``queue_depth``    -- admission-control bound: requests beyond this
      many pending are shed with ``ServerOverloaded`` (and counted)
      instead of growing an unbounded backlog.

    Round-trips through plain dicts like every other spec; the wire dict
    is exactly what ``ModelServer`` consumes as keyword arguments.
    """

    max_batch_size: int = 8
    max_wait_ms: float = 2.0
    queue_depth: int = 128

    def __init__(
        self,
        max_batch_size: int = 8,
        *,
        max_wait_ms: float = 2.0,
        queue_depth: int = 128,
    ):
        object.__setattr__(self, "max_batch_size", int(max_batch_size))
        object.__setattr__(self, "max_wait_ms", float(max_wait_ms))
        object.__setattr__(self, "queue_depth", int(queue_depth))
        self.validate()

    def validate(self) -> None:
        if self.max_batch_size < 1:
            raise SpecValidationError("max_batch_size must be >= 1")
        if self.max_wait_ms < 0:
            raise SpecValidationError("max_wait_ms must be >= 0")
        if self.queue_depth < 1:
            raise SpecValidationError("queue_depth must be >= 1")

    def to_dict(self) -> dict[str, Any]:
        """The exact kwargs ``ModelServer`` consumes."""
        return {
            "max_batch_size": self.max_batch_size,
            "max_wait_ms": self.max_wait_ms,
            "queue_depth": self.queue_depth,
        }

    @classmethod
    def from_dict(cls, config: Mapping[str, Any]) -> "ServeSpec":
        config = dict(config)
        return cls(
            config.pop("max_batch_size", 8),
            **config,
        )


@dataclass(frozen=True, init=False)
class ClusterSpec:
    """Declarative description of a :class:`repro_torch.runtime.client.LocalCluster`.

    The ``Session(backend="cluster")`` knob: scheduler sizing, speculation
    and fault-tolerance tuning, the inline-result threshold, and the data
    plane's connector all travel by value and round-trip through
    ``to_dict``/``from_dict`` like the other specs.

    ``data_plane`` names the connector backing the cluster's shared result
    namespace; it must have the ``peer`` capability (deterministic-key
    ``put_at``), which is what keeps speculative duplicate publishes
    idempotent.  ``None`` (the default) means a cluster-private in-memory
    segment created at build time.

    ``memory`` attaches a :class:`MemorySpec`: per-worker managed-memory
    budgets, spill-to-disk caching, and pause/resume pressure thresholds.
    ``None`` (the default) keeps the memory-only LRU cache sized by
    ``worker_cache_bytes``.

    ``transfer`` attaches a :class:`TransferSpec`: the adaptive per-link
    compression policy for comm links, store publishes/fetches, and the
    spill disk tier.  ``None`` (the default) means the stock adaptive
    policy (probe-and-pick, shm/inproc exempt).

    ``worker_kind`` picks the execution substrate: ``"thread"`` (default,
    in-process) or ``"process"`` (each worker in its own interpreter --
    CPU-bound graphs escape the GIL).  ``transport`` selects the comm
    transport (``"inproc"`` or ``"tcp"``); ``None`` means direct calls for
    thread workers and tcp for process workers.  Process workers need a
    cross-process ``data_plane`` (file/shm/kv); the in-memory default is
    replaced by a cluster-private file store at build time.

    ``serve`` attaches a :class:`ServeSpec`: the continuous-batching
    defaults (batch size, batching window, admission-queue depth) that
    ``Session.serve`` uses when standing up a ``ModelServer`` on this
    cluster.  ``None`` leaves the ``ModelServer`` defaults in force.
    """

    n_workers: int = 2
    threads_per_worker: int = 1
    heartbeat_timeout: float = 5.0
    speculation_factor: float = 4.0
    speculation_min: float = 1.0
    inline_result_max: int = 64 * 1024
    worker_cache_bytes: int = 256 * 1024 * 1024
    data_plane: ConnectorSpec | None = None
    memory: MemorySpec | None = None
    transfer: TransferSpec | None = None
    worker_kind: str = "thread"
    transport: str | None = None
    serve: ServeSpec | None = None

    def __init__(
        self,
        n_workers: int = 2,
        *,
        threads_per_worker: int = 1,
        heartbeat_timeout: float = 5.0,
        speculation_factor: float = 4.0,
        speculation_min: float = 1.0,
        inline_result_max: int = 64 * 1024,
        worker_cache_bytes: int = 256 * 1024 * 1024,
        data_plane: ConnectorSpec | Mapping[str, Any] | str | None = None,
        memory: MemorySpec | Mapping[str, Any] | None = None,
        transfer: TransferSpec | Mapping[str, Any] | str | None = None,
        worker_kind: str = "thread",
        transport: str | None = None,
        serve: "ServeSpec | Mapping[str, Any] | None" = None,
    ):
        if isinstance(data_plane, str):
            data_plane = ConnectorSpec(data_plane)
        elif isinstance(data_plane, Mapping):
            data_plane = ConnectorSpec.from_dict(data_plane)
        if isinstance(memory, Mapping):
            memory = MemorySpec.from_dict(memory)
        if isinstance(transfer, str):
            transfer = TransferSpec(transfer)
        elif isinstance(transfer, Mapping):
            transfer = TransferSpec.from_dict(transfer)
        if isinstance(serve, Mapping):
            serve = ServeSpec.from_dict(serve)
        object.__setattr__(self, "n_workers", int(n_workers))
        object.__setattr__(self, "threads_per_worker", int(threads_per_worker))
        object.__setattr__(self, "heartbeat_timeout", float(heartbeat_timeout))
        object.__setattr__(self, "speculation_factor", float(speculation_factor))
        object.__setattr__(self, "speculation_min", float(speculation_min))
        object.__setattr__(self, "inline_result_max", int(inline_result_max))
        object.__setattr__(self, "worker_cache_bytes", int(worker_cache_bytes))
        object.__setattr__(self, "data_plane", data_plane)
        object.__setattr__(self, "memory", memory)
        object.__setattr__(self, "transfer", transfer)
        object.__setattr__(self, "worker_kind", str(worker_kind))
        object.__setattr__(
            self, "transport", None if transport is None else str(transport)
        )
        object.__setattr__(self, "serve", serve)
        self.validate()

    def validate(self) -> None:
        if self.n_workers < 1:
            raise SpecValidationError("n_workers must be >= 1")
        if self.threads_per_worker < 1:
            raise SpecValidationError("threads_per_worker must be >= 1")
        if self.inline_result_max < 0:
            raise SpecValidationError("inline_result_max must be >= 0")
        if self.worker_cache_bytes < 0:
            raise SpecValidationError("worker_cache_bytes must be >= 0")
        if self.data_plane is not None:
            self.data_plane.validate()
            if PEER_CAPABILITY not in connector_capabilities(self.data_plane.kind):
                raise SpecValidationError(
                    f"connector {self.data_plane.kind!r} lacks the "
                    f"{PEER_CAPABILITY!r} capability (deterministic-key "
                    "put_at) required for the cluster data plane"
                )
        if self.memory is not None:
            self.memory.validate()
        if self.transfer is not None:
            self.transfer.validate()
        if self.serve is not None:
            self.serve.validate()
        if self.worker_kind not in ("thread", "process"):
            raise SpecValidationError(
                f"worker_kind must be 'thread' or 'process', got "
                f"{self.worker_kind!r}"
            )
        if self.transport not in (None, "inproc", "tcp"):
            raise SpecValidationError(
                f"transport must be None, 'inproc', or 'tcp', got "
                f"{self.transport!r}"
            )
        if self.worker_kind == "process":
            if self.transport not in (None, "tcp"):
                raise SpecValidationError(
                    "process workers cross interpreter boundaries and "
                    "require transport='tcp'"
                )
            if self.data_plane is not None and self.data_plane.kind == "memory":
                raise SpecValidationError(
                    "the 'memory' connector is process-local and cannot "
                    "back process workers; use file, shm, or kv"
                )

    def to_dict(self) -> dict[str, Any]:
        return {
            "n_workers": self.n_workers,
            "threads_per_worker": self.threads_per_worker,
            "heartbeat_timeout": self.heartbeat_timeout,
            "speculation_factor": self.speculation_factor,
            "speculation_min": self.speculation_min,
            "inline_result_max": self.inline_result_max,
            "worker_cache_bytes": self.worker_cache_bytes,
            "data_plane": (
                self.data_plane.to_dict() if self.data_plane is not None else None
            ),
            "memory": self.memory.to_dict() if self.memory is not None else None,
            "transfer": self.transfer.to_dict() if self.transfer is not None else None,
            "worker_kind": self.worker_kind,
            "transport": self.transport,
            "serve": self.serve.to_dict() if self.serve is not None else None,
        }

    @classmethod
    def from_dict(cls, config: Mapping[str, Any]) -> "ClusterSpec":
        config = dict(config)
        data_plane = config.pop("data_plane", None)
        memory = config.pop("memory", None)
        transfer = config.pop("transfer", None)
        serve = config.pop("serve", None)
        return cls(
            config.pop("n_workers", 2),
            data_plane=(
                ConnectorSpec.from_dict(data_plane) if data_plane else None
            ),
            memory=MemorySpec.from_dict(memory) if memory else None,
            transfer=TransferSpec.from_dict(transfer) if transfer else None,
            serve=ServeSpec.from_dict(serve) if serve else None,
            **config,
        )

    def build(self) -> Any:
        """Instantiate a live LocalCluster from this spec."""
        from repro_torch.runtime.client import LocalCluster

        store = None
        if self.data_plane is not None:
            import uuid as _uuid

            store = StoreConfig(
                f"cluster-{_uuid.uuid4().hex[:8]}", self.data_plane, cache_size=0
            )
        return LocalCluster(
            self.n_workers,
            threads_per_worker=self.threads_per_worker,
            heartbeat_timeout=self.heartbeat_timeout,
            speculation_factor=self.speculation_factor,
            speculation_min=self.speculation_min,
            store=store,
            inline_result_max=self.inline_result_max,
            worker_cache_bytes=self.worker_cache_bytes,
            memory=self.memory,
            transfer=self.transfer,
            worker_kind=self.worker_kind,
            transport=self.transport,
            serve=self.serve,
        )
