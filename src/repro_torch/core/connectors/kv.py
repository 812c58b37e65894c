"""TCP key-value server connector -- the Redis analogue.

The paper runs a Redis server on rank 0 of each batch job.  This module
provides the same deployment shape without an external dependency: a tiny
length-prefixed binary KV server (thread-per-connection) plus a client
connector.  Factories carry only ``(host, port)``, so any process that can
reach the server can resolve proxies.

Protocol (all little-endian)::

    request : u8 op | u32 klen | key | u64 vlen | value
    response: u8 ok | u64 vlen | value

ops: 1=PUT 2=GET 3=EXISTS 4=EVICT 5=SHUTDOWN
"""

from __future__ import annotations

import socket
import socketserver
import struct
import threading
from typing import Any, Sequence

from repro_torch.core.connectors.base import (
    ConnectorStats,
    Key,
    Payload,
    payload_frames,
    register_connector,
)

_OP_PUT, _OP_GET, _OP_EXISTS, _OP_EVICT, _OP_SHUTDOWN = 1, 2, 3, 4, 5


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = bytearray(n)
    view = memoryview(buf)
    got = 0
    while got < n:
        r = sock.recv_into(view[got:], n - got)
        if r == 0:
            raise ConnectionError("socket closed mid-message")
        got += r
    return bytes(buf)


class _KVHandler(socketserver.BaseRequestHandler):
    def handle(self) -> None:  # one connection, many requests
        server: "KVServer" = self.server  # type: ignore[assignment]
        sock = self.request
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        try:
            while True:
                head = _recv_exact(sock, 1 + 4)
                op, klen = struct.unpack("<BI", head)
                key = _recv_exact(sock, klen).decode() if klen else ""
                (vlen,) = struct.unpack("<Q", _recv_exact(sock, 8))
                value = _recv_exact(sock, vlen) if vlen else b""
                if op == _OP_PUT:
                    server.data[key] = value
                    sock.sendall(struct.pack("<BQ", 1, 0))
                elif op == _OP_GET:
                    v = server.data.get(key)
                    if v is None:
                        sock.sendall(struct.pack("<BQ", 0, 0))
                    else:
                        sock.sendall(struct.pack("<BQ", 1, len(v)))
                        sock.sendall(v)
                elif op == _OP_EXISTS:
                    sock.sendall(struct.pack("<BQ", int(key in server.data), 0))
                elif op == _OP_EVICT:
                    server.data.pop(key, None)
                    sock.sendall(struct.pack("<BQ", 1, 0))
                elif op == _OP_SHUTDOWN:
                    sock.sendall(struct.pack("<BQ", 1, 0))
                    threading.Thread(target=server.shutdown, daemon=True).start()
                    return
        except (ConnectionError, OSError):
            return


class KVServer(socketserver.ThreadingTCPServer):
    """In-process KV server ("Redis on rank 0")."""

    allow_reuse_address = True
    daemon_threads = True

    def __init__(self, host: str = "127.0.0.1", port: int = 0) -> None:
        super().__init__((host, port), _KVHandler)
        self.data: dict[str, bytes] = {}
        self._thread: threading.Thread | None = None

    @property
    def address(self) -> tuple[str, int]:
        return self.server_address[0], self.server_address[1]

    def start(self) -> "KVServer":
        self._thread = threading.Thread(target=self.serve_forever, daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self.shutdown()
        self.server_close()


@register_connector("kv")
class KVConnector:
    def __init__(self, host: str, port: int) -> None:
        self.host, self.port = host, int(port)
        self.stats = ConnectorStats()
        self._local = threading.local()  # one socket per thread

    def _sock(self) -> socket.socket:
        sock = getattr(self._local, "sock", None)
        if sock is None:
            sock = socket.create_connection((self.host, self.port))
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            self._local.sock = sock
        return sock

    def _request(
        self, op: int, key: str, frames: Sequence[bytes | memoryview] = ()
    ) -> tuple[bool, bytes]:
        sock = self._sock()
        kb = key.encode()
        vlen = sum(memoryview(f).nbytes for f in frames)
        # writev-style: header + key + frames without concatenating payload
        sock.sendall(struct.pack("<BI", op, len(kb)) + kb + struct.pack("<Q", vlen))
        for f in frames:
            sock.sendall(f)
        ok, rlen = struct.unpack("<BQ", _recv_exact(sock, 9))
        value = _recv_exact(sock, rlen) if rlen else b""
        return bool(ok), value

    def put(self, data: Payload) -> Key:
        key = Key.new()
        frames = payload_frames(data)
        nbytes = sum(memoryview(f).nbytes for f in frames)
        self._request(_OP_PUT, key.object_id, frames)
        self.stats.record_put(nbytes)
        return Key(key.object_id, size=nbytes)

    def put_batch(self, datas: Sequence[Payload]) -> list[Key]:
        return [self.put(d) for d in datas]

    def get(self, key: Key) -> bytes | None:
        ok, value = self._request(_OP_GET, key.object_id)
        if not ok:
            return None
        self.stats.record_get(len(value))
        return value

    def get_batch(self, keys: Sequence[Key]) -> list[bytes | None]:
        return [self.get(k) for k in keys]

    def exists(self, key: Key) -> bool:
        ok, _ = self._request(_OP_EXISTS, key.object_id)
        return ok

    def evict(self, key: Key) -> None:
        self._request(_OP_EVICT, key.object_id)
        self.stats.record_evict()

    def close(self) -> None:
        sock = getattr(self._local, "sock", None)
        if sock is not None:
            try:
                sock.close()
            except OSError:
                pass
            self._local.sock = None

    def config(self) -> dict[str, Any]:
        return {"connector_type": "kv", "host": self.host, "port": self.port}

    @classmethod
    def from_config(cls, config: dict[str, Any]) -> "KVConnector":
        return cls(**config)
