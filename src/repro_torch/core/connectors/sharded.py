"""Sharded object-store connector -- the DAOS analogue.

DAOS presents a pool of distributed NVMe targets; objects are declustered
across targets and fetched in parallel.  This connector reproduces that
deployment shape with N shard directories ("targets"):

* small objects land on one shard chosen by key hash (balanced placement);
* objects larger than ``stripe_size`` are **striped** round-robin across all
  shards in fixed-size chunks, like DAOS extent distribution, so a single
  large checkpoint does not hot-spot one target;
* a tiny msgpack manifest per striped object records the layout.

On a real cluster each shard directory would live on a different node's
NVMe (or be replaced by a true DAOS connector); the interface is identical.
"""

from __future__ import annotations

import hashlib
import os
import tempfile
from pathlib import Path
from typing import Any, Sequence

import msgpack

from repro_torch.core.connectors.base import (
    ConnectorStats,
    Key,
    Payload,
    payload_frames,
    register_connector,
)

_MANIFEST_SUFFIX = ".manifest"


@register_connector("sharded")
class ShardedConnector:
    def __init__(
        self,
        store_dir: str,
        num_shards: int = 8,
        stripe_size: int = 4 * 1024 * 1024,
    ) -> None:
        self.store_dir = str(store_dir)
        self.num_shards = int(num_shards)
        self.stripe_size = int(stripe_size)
        for s in range(self.num_shards):
            self._shard_dir(s).mkdir(parents=True, exist_ok=True)
        self.stats = ConnectorStats()

    # -- placement ----------------------------------------------------------

    def _shard_dir(self, shard: int) -> Path:
        return Path(self.store_dir) / f"shard-{shard:03d}"

    def _home_shard(self, object_id: str) -> int:
        digest = hashlib.blake2b(object_id.encode(), digest_size=4).digest()
        return int.from_bytes(digest, "little") % self.num_shards

    def _chunk_path(self, object_id: str, chunk: int) -> Path:
        shard = (self._home_shard(object_id) + chunk) % self.num_shards
        return self._shard_dir(shard) / f"{object_id}.{chunk:05d}"

    def _manifest_path(self, object_id: str) -> Path:
        shard = self._home_shard(object_id)
        return self._shard_dir(shard) / (object_id + _MANIFEST_SUFFIX)

    # -- io helpers ----------------------------------------------------------

    @staticmethod
    def _atomic_write(path: Path, chunks: Sequence[bytes | memoryview]) -> None:
        fd, tmp = tempfile.mkstemp(dir=path.parent, prefix=".tmp-")
        try:
            with os.fdopen(fd, "wb") as f:
                for c in chunks:
                    f.write(c)
            os.replace(tmp, path)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise

    # -- interface -----------------------------------------------------------

    def put(self, data: Payload) -> Key:
        key = Key.new()
        # Flatten frames into stripe_size'd chunks without an intermediate
        # full-object copy: iterate frame views, slicing stripe windows.
        frames = [memoryview(f).cast("B") for f in payload_frames(data)]
        total = sum(f.nbytes for f in frames)

        chunk_sizes: list[int] = []
        current: list[memoryview] = []
        current_n = 0
        chunk_idx = 0

        def flush() -> None:
            nonlocal current, current_n, chunk_idx
            if not current:
                return
            self._atomic_write(self._chunk_path(key.object_id, chunk_idx), current)
            chunk_sizes.append(current_n)
            chunk_idx += 1
            current, current_n = [], 0

        limit = self.stripe_size
        for frame in frames:
            off = 0
            while off < frame.nbytes:
                take = min(limit - current_n, frame.nbytes - off)
                current.append(frame[off : off + take])
                current_n += take
                off += take
                if current_n == limit:
                    flush()
        flush()
        if not chunk_sizes:  # zero-byte object still needs one chunk
            self._atomic_write(self._chunk_path(key.object_id, 0), [b""])
            chunk_sizes = [0]

        manifest = msgpack.packb({"total": total, "chunks": chunk_sizes})
        self._atomic_write(self._manifest_path(key.object_id), [manifest])
        self.stats.record_put(total)
        return Key(key.object_id, size=total)

    def put_batch(self, datas: Sequence[Payload]) -> list[Key]:
        return [self.put(d) for d in datas]

    def _read_manifest(self, object_id: str) -> dict[str, Any] | None:
        try:
            return msgpack.unpackb(self._manifest_path(object_id).read_bytes())
        except FileNotFoundError:
            return None

    def get(self, key: Key) -> bytes | None:
        manifest = self._read_manifest(key.object_id)
        if manifest is None:
            return None
        out = bytearray(manifest["total"])
        off = 0
        for chunk, size in enumerate(manifest["chunks"]):
            path = self._chunk_path(key.object_id, chunk)
            with open(path, "rb") as f:
                f.readinto(memoryview(out)[off : off + size])
            off += size
        self.stats.record_get(len(out))
        return bytes(out)

    def get_batch(self, keys: Sequence[Key]) -> list[bytes | None]:
        return [self.get(k) for k in keys]

    def exists(self, key: Key) -> bool:
        return self._manifest_path(key.object_id).exists()

    def evict(self, key: Key) -> None:
        manifest = self._read_manifest(key.object_id)
        if manifest is None:
            return
        for chunk in range(len(manifest["chunks"])):
            try:
                self._chunk_path(key.object_id, chunk).unlink()
            except FileNotFoundError:
                pass
        try:
            self._manifest_path(key.object_id).unlink()
        except FileNotFoundError:
            pass
        self.stats.record_evict()

    def close(self) -> None:
        pass

    def clear(self) -> None:
        """Remove every stored object across all shards."""
        for s in range(self.num_shards):
            for path in self._shard_dir(s).glob("*"):
                try:
                    path.unlink()
                except (FileNotFoundError, IsADirectoryError):
                    pass

    def config(self) -> dict[str, Any]:
        return {
            "connector_type": "sharded",
            "store_dir": self.store_dir,
            "num_shards": self.num_shards,
            "stripe_size": self.stripe_size,
        }

    @classmethod
    def from_config(cls, config: dict[str, Any]) -> "ShardedConnector":
        return cls(**config)
