"""Pipe transport: a comm over a ``multiprocessing.Connection``.

Kept for parent/child pairs that already hold a pipe (and for tests);
the cluster's process workers use the tcp transport, which supports many
workers per listener and writev framing.

Close semantics match the other transports: ``close()`` sends the close
sentinel (waking a peer blocked in ``recv``) *and* closes the underlying
connection, so a ``recv`` blocked on the closing side raises
:class:`ChannelClosed` too instead of hanging; a dead peer surfaces as
``EOFError``/``OSError`` -> :class:`ChannelClosed`.
"""

from __future__ import annotations

import threading
import time
from typing import Any

from repro_torch.runtime.comm.core import (
    _CLOSE,
    ChannelClosed,
    Comm,
    decode_message,
    encode_message,
    is_control,
)

#: Poll granularity for blocked receives re-checking the closed flag.
_POLL = 0.05


class PipeEndpoint(Comm):
    """Endpoint over a multiprocessing Connection (process workers)."""

    def __init__(self, conn: Any, name: str = ""):
        super().__init__(name)
        self._conn = conn
        self._closed = threading.Event()

    @property
    def closed(self) -> bool:
        return self._closed.is_set()

    def send(self, message: Any) -> int:
        blob = encode_message(message)
        if self._closed.is_set():
            raise ChannelClosed(f"{self.name}: comm closed")
        try:
            self._conn.send_bytes(blob)
        except (OSError, ValueError, BrokenPipeError):
            self._closed.set()
            raise ChannelClosed(f"{self.name}: send failed") from None
        self.counter.add_sent(len(blob), fast=is_control(blob))
        return len(blob)

    def recv_blob(self, timeout: float | None = None) -> bytes:
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            if self._closed.is_set():
                raise ChannelClosed(f"{self.name}: comm closed")
            wait = _POLL
            if deadline is not None:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise TimeoutError
                wait = min(wait, remaining)
            try:
                if self._conn.poll(wait):
                    break
            except (OSError, EOFError, ValueError):
                self._closed.set()
                raise ChannelClosed(f"{self.name}: connection lost") from None
        try:
            blob = self._conn.recv_bytes()
        except (EOFError, OSError):
            self._closed.set()
            raise ChannelClosed(f"{self.name}: peer died") from None
        if blob == _CLOSE:
            self._closed.set()
            raise ChannelClosed(f"{self.name}: peer closed")
        self.counter.add_recv(len(blob), fast=is_control(blob))
        return blob

    def recv(self, timeout: float | None = None) -> Any:
        return decode_message(self.recv_blob(timeout))

    def close(self) -> None:
        self._closed.set()
        try:
            self._conn.send_bytes(_CLOSE)
        except (OSError, ValueError, BrokenPipeError):
            pass
        try:
            self._conn.close()
        except OSError:
            pass
