"""In-process transport: bounded byte queues between threads.

Models TCP within a node without socket nondeterminism (important on a
1-core container): messages are still encoded to bytes and byte-counted,
but delivery is a ``queue.Queue`` pair.  :class:`LocalChannel` is the
historical two-ended form; ``inproc://<name>`` addresses go through the
listener registry like any other transport.

Close semantics (the hang-on-peer-death fix): each channel shares one
closed event between its two endpoints, and ``close()`` pushes the close
sentinel into *both* queues -- so a peer blocked in ``recv`` wakes with
:class:`ChannelClosed` immediately (messages already queued ahead of the
sentinel still deliver in order), and so does a ``recv`` blocked on the
closing side itself.  Queues are bounded; a sender blocked on a full
queue re-checks the closed flag instead of waiting forever.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Any, Callable

from repro_torch.runtime.comm.core import (
    _CLOSE,
    ChannelClosed,
    Comm,
    Listener,
    decode_message,
    encode_message,
    is_control,
    register_transport,
)

#: Queue bound: deep enough that control bursts never block in practice,
#: bounded so a dead consumer surfaces as backpressure, not unbounded RAM.
DEFAULT_MAXSIZE = 4096

#: Poll granularity for blocked send/recv re-checking the closed flag.
_POLL = 0.05


class Endpoint(Comm):
    """One end of an in-process channel."""

    def __init__(
        self,
        out_q: queue.Queue,
        in_q: queue.Queue,
        name: str = "",
        closed: threading.Event | None = None,
    ):
        super().__init__(name)
        self._out = out_q
        self._in = in_q
        self._closed = closed if closed is not None else threading.Event()

    @property
    def closed(self) -> bool:
        return self._closed.is_set()

    def send(self, message: Any) -> int:
        blob = encode_message(message)
        while True:
            if self._closed.is_set():
                raise ChannelClosed(f"{self.name}: channel closed")
            try:
                self._out.put(blob, timeout=_POLL)
                break
            except queue.Full:
                continue
        self.counter.add_sent(len(blob), fast=is_control(blob))
        return len(blob)

    def recv_blob(self, timeout: float | None = None) -> bytes:
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            wait = _POLL
            if deadline is not None:
                wait = min(wait, max(0.0, deadline - time.monotonic()))
            try:
                blob = self._in.get(timeout=wait)
            except queue.Empty:
                if self._closed.is_set():
                    raise ChannelClosed(f"{self.name}: channel closed") from None
                if deadline is not None and time.monotonic() >= deadline:
                    raise TimeoutError from None
                continue
            if blob == _CLOSE:
                self._closed.set()
                raise ChannelClosed(f"{self.name}: peer closed")
            self.counter.add_recv(len(blob), fast=is_control(blob))
            return blob

    def recv(self, timeout: float | None = None) -> Any:
        return decode_message(self.recv_blob(timeout))

    def send_raw(self, marker: int, frames: list[Any]) -> int:
        """Queue transports pass whole blobs, so the raw frame is joined
        here (this is the deterministic *test* transport; the zero-join
        sender guarantee is tcp's).  Markers are >= 0x03, so a raw blob
        can never collide with the 0x00 close sentinel."""
        blob = bytes((marker,)) + b"".join(bytes(f) for f in frames)
        while True:
            if self._closed.is_set():
                raise ChannelClosed(f"{self.name}: channel closed")
            try:
                self._out.put(blob, timeout=_POLL)
                break
            except queue.Full:
                continue
        self.counter.add_sent(len(blob))
        return len(blob)

    def recv_raw_into(
        self,
        get_buffer: Callable[[int, int], Any],
        timeout: float | None = None,
    ) -> tuple[int, memoryview]:
        blob = self.recv_blob(timeout)
        marker = blob[0]
        src = memoryview(blob)[1:]
        try:
            body = memoryview(get_buffer(marker, src.nbytes))
        except BaseException:
            self.close()
            raise
        if body.nbytes != src.nbytes or body.readonly:
            self.close()
            raise ChannelClosed(f"{self.name}: raw sink size mismatch")
        body[:] = src
        return marker, body

    def close(self) -> None:
        self._closed.set()
        # Sentinels into both directions wake a blocked recv on either end;
        # the shared event covers the case of a full queue rejecting them.
        for q_ in (self._out, self._in):
            try:
                q_.put_nowait(_CLOSE)
            except queue.Full:
                pass


class LocalChannel:
    """A bidirectional byte channel between two threads.

    ``endpoint_a()`` / ``endpoint_b()`` return the two ends; each end has
    ``send(msg)`` / ``recv(timeout)`` and its own ByteCounter.
    """

    def __init__(self, name: str = "", maxsize: int = DEFAULT_MAXSIZE):
        self.name = name
        self._closed = threading.Event()
        self._a_to_b: queue.Queue = queue.Queue(maxsize)
        self._b_to_a: queue.Queue = queue.Queue(maxsize)

    def endpoint_a(self) -> Endpoint:
        return Endpoint(
            self._a_to_b, self._b_to_a, f"{self.name}:a", closed=self._closed
        )

    def endpoint_b(self) -> Endpoint:
        return Endpoint(
            self._b_to_a, self._a_to_b, f"{self.name}:b", closed=self._closed
        )


# -- listener / connector ------------------------------------------------------

_LISTENERS: dict[str, "InprocListener"] = {}
_REG_LOCK = threading.Lock()


class InprocListener(Listener):
    def __init__(
        self,
        name: str,
        handler: Callable[[Comm], None],
        maxsize: int = DEFAULT_MAXSIZE,
    ):
        with _REG_LOCK:
            if name in _LISTENERS:
                raise OSError(f"inproc://{name} is already listening")
            _LISTENERS[name] = self
        self.name = name
        self.address = f"inproc://{name}"
        self._handler = handler
        self._maxsize = maxsize
        self._stopped = False

    def _accept(self) -> Comm:
        if self._stopped:
            raise ConnectionRefusedError(self.address)
        channel = LocalChannel(self.name, maxsize=self._maxsize)
        server_end, client_end = channel.endpoint_a(), channel.endpoint_b()
        # The handler runs off-thread like a TCP accept, so a handler that
        # serves the connection inline cannot deadlock the connector.
        threading.Thread(
            target=self._handler,
            args=(server_end,),
            daemon=True,
            name=f"inproc-accept-{self.name}",
        ).start()
        return client_end

    def stop(self) -> None:
        self._stopped = True
        with _REG_LOCK:
            if _LISTENERS.get(self.name) is self:
                del _LISTENERS[self.name]


def _listen(rest: str, handler: Callable[[Comm], None], **kwargs: Any) -> Listener:
    # In-process queues pass blobs by reference: the inproc link class is
    # hard-wired to no compression, so transfer/ledger knobs are inert here.
    kwargs.pop("transfer", None)
    kwargs.pop("ledger", None)
    return InprocListener(rest, handler, **kwargs)


def _connect(rest: str, timeout: float | None = None, **kwargs: Any) -> Comm:
    with _REG_LOCK:
        listener = _LISTENERS.get(rest)
    if listener is None:
        raise ConnectionRefusedError(f"no inproc listener at {rest!r}")
    return listener._accept()


register_transport("inproc", _listen, _connect)
