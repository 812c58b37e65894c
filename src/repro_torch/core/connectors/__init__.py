"""Byte-level mediated storage connectors (the paper's low-level interface)."""

from repro_torch.core.connectors.base import (
    Connector,
    ConnectorStats,
    Key,
    connector_from_config,
    connector_registry,
    list_connectors,
    register_connector,
)
from repro_torch.core.connectors.file import FileConnector
from repro_torch.core.connectors.kv import KVConnector, KVServer
from repro_torch.core.connectors.memory import MemoryConnector
from repro_torch.core.connectors.multi import MultiConnector
from repro_torch.core.connectors.sharded import ShardedConnector
from repro_torch.core.connectors.shm import SharedMemoryConnector

__all__ = [
    "Connector",
    "ConnectorStats",
    "Key",
    "connector_from_config",
    "connector_registry",
    "list_connectors",
    "register_connector",
    "FileConnector",
    "KVConnector",
    "KVServer",
    "MemoryConnector",
    "MultiConnector",
    "ShardedConnector",
    "SharedMemoryConnector",
]
