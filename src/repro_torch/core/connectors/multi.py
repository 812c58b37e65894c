"""MultiConnector: policy-routed storage (paper §3, Methods).

Combined with the ``StoreExecutor``, a MultiConnector lets an application
route each object to the most appropriate mediated channel -- e.g. small
hot objects to shared memory, large checkpoints to the sharded (DAOS-like)
store -- without consumer code changes.  Routing is by object size and an
optional tag predicate; the chosen connector's index is recorded in the
``Key.tag`` so gets route back without probing.
"""

from __future__ import annotations

from typing import Any, Sequence

from repro_torch.core.connectors.base import (
    Connector,
    ConnectorStats,
    Key,
    Payload,
    connector_from_config,
    payload_nbytes,
    register_connector,
)


@register_connector("multi")
class MultiConnector:
    """Routes puts by size threshold ladder.

    ``rules`` is a list of ``(max_bytes, connector)`` sorted ascending; an
    object goes to the first rule whose ``max_bytes`` is >= its size (the
    last rule should use ``None`` = infinity).
    """

    def __init__(self, rules: Sequence[tuple[int | None, Connector]]) -> None:
        if not rules:
            raise ValueError("MultiConnector needs at least one rule")
        self.rules = list(rules)
        self.stats = ConnectorStats()

    def _route(self, nbytes: int) -> tuple[int, Connector]:
        for i, (max_bytes, conn) in enumerate(self.rules):
            if max_bytes is None or nbytes <= max_bytes:
                return i, conn
        return len(self.rules) - 1, self.rules[-1][1]

    def _conn_for(self, key: Key) -> Connector:
        idx = int(key.tag or 0)
        return self.rules[idx][1]

    def put(self, data: Payload) -> Key:
        nbytes = payload_nbytes(data)
        idx, conn = self._route(nbytes)
        inner = conn.put(data)
        self.stats.record_put(nbytes)
        return Key(inner.object_id, size=inner.size, tag=str(idx))

    def put_batch(self, datas: Sequence[Payload]) -> list[Key]:
        return [self.put(d) for d in datas]

    def get(self, key: Key):
        inner = Key(key.object_id, size=key.size)
        out = self._conn_for(key).get(inner)
        if out is not None:
            self.stats.record_get(payload_nbytes(out))
        return out

    def get_batch(self, keys: Sequence[Key]):
        return [self.get(k) for k in keys]

    def exists(self, key: Key) -> bool:
        return self._conn_for(key).exists(Key(key.object_id, size=key.size))

    def evict(self, key: Key) -> None:
        self._conn_for(key).evict(Key(key.object_id, size=key.size))
        self.stats.record_evict()

    def close(self) -> None:
        for _, conn in self.rules:
            conn.close()

    def clear(self) -> None:
        for _, conn in self.rules:
            clear = getattr(conn, "clear", None)
            if clear is not None:
                clear()

    def config(self) -> dict[str, Any]:
        return {
            "connector_type": "multi",
            "rules": [
                [max_bytes, conn.config()] for max_bytes, conn in self.rules
            ],
        }

    @classmethod
    def from_config(cls, config: dict[str, Any]) -> "MultiConnector":
        rules = [
            (max_bytes, connector_from_config(conn_cfg))
            for max_bytes, conn_cfg in config["rules"]
        ]
        return cls(rules)
