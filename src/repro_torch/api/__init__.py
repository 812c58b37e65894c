"""Unified, typed public API (the paper's three patterns behind one facade).

The three integration patterns of Fig 2 — manual proxies, the drop-in
``ProxyClient``, and the policy-driven ``StoreExecutor`` — are all reachable
through a single :class:`Session`, configured declaratively::

    from repro_torch.api import ConnectorSpec, PolicySpec, Session, StoreConfig

    cfg = StoreConfig(
        name="demo",
        connector=ConnectorSpec("sharded", store_dir="/tmp/pool", num_shards=8),
    )
    with Session(store=cfg, cluster=cluster,
                 policy=PolicySpec("size", threshold=50_000)) as s:
        p = s.scatter(big_array)            # Fig 2a: manual proxy
        fut = s.submit(fn, p)               # Fig 2b: auto-proxy submit
        for f in s.as_completed([fut]):     # uniform futures surface
            print(f.result())
    # session exit evicts every session-owned proxy

Streaming and serving ride the same facade on the cluster backend:
``Session.stream_producer(topic)`` / ``Session.stream_consumer(topic)``
move bulk bytes through the cluster store tiers while only metadata
events touch the broker, and ``Session.serve(model_fn)`` stands up a
continuous-batching :class:`ModelServer` configured by
``ClusterSpec(serve=ServeSpec(...))``.

The old ``Store(...)`` / ``ProxyClient(...)`` / ``StoreExecutor(...)``
deprecation shims have been removed: direct construction is a silent
low-level escape hatch, and Session / StoreConfig are the supported
entry points.
"""

from repro_torch.api.config import (
    ClusterSpec,
    ConnectorSpec,
    MemorySpec,
    PolicySpec,
    ServeSpec,
    SpecValidationError,
    StoreConfig,
    TransferSpec,
)
from repro_torch.api.session import Session, as_completed
from repro_torch.runtime.serving import ModelServer, ServerOverloaded
from repro_torch.runtime.stream import (
    EndOfStream,
    StreamClosed,
    StreamConsumer,
    StreamItem,
    StreamProducer,
)
from repro_torch.core.connectors.base import (
    connector_registry,
    list_connectors,
    register_connector,
)
from repro_torch.core.plugins import PluginRegistry, UnknownPluginError
from repro_torch.core.policy import (
    list_policies,
    policy_registry,
    register_policy,
)
from repro_torch.core.store import list_serializers, register_serializer
from repro_torch.runtime.graph import GraphNode, TaskGraph

__all__ = [
    "ClusterSpec",
    "ConnectorSpec",
    "MemorySpec",
    "PolicySpec",
    "SpecValidationError",
    "ServeSpec",
    "StoreConfig",
    "TransferSpec",
    "Session",
    "as_completed",
    "ModelServer",
    "ServerOverloaded",
    "StreamProducer",
    "StreamConsumer",
    "StreamItem",
    "StreamClosed",
    "EndOfStream",
    "GraphNode",
    "TaskGraph",
    "PluginRegistry",
    "UnknownPluginError",
    "connector_registry",
    "list_connectors",
    "register_connector",
    "list_policies",
    "policy_registry",
    "register_policy",
    "list_serializers",
    "register_serializer",
]
