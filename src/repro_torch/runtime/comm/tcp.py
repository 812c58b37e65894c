"""TCP transport: length-prefixed framed wire protocol over a socket.

Wire format per message: an 8-byte little-endian payload length followed
by the encoded blob.  The blob is *sent* as the codec's frame list via
``socket.sendmsg`` (writev-style scatter/gather), so a message carrying
array buffers crosses the socket without ever being joined in user space
-- the PR 5 zero-copy discipline survives the boundary.  The receive side
pays the one unavoidable copy: a single preallocated buffer filled with
``recv_into``, handed to ``decode_message`` which builds array views over
it in place.

Raw marker frames (``send_raw``/``recv_raw_into``) share the same length
prefix but skip the codec entirely: one marker byte, then the body --
written writev-style from cache views on the sender, received straight
into a caller-provided pre-sized buffer on the receiver.  The peer data
plane (``runtime/dataserver.py``) streams blob chunks this way.

Blocking sockets with ``TCP_NODELAY``; receives poll via ``select`` in
short slices so ``close()`` from another thread (or the peer dying) wakes
a blocked ``recv`` with :class:`ChannelClosed` instead of hanging.  A
reader that timed out mid-message would desync the stream, so only the
wait for a message's *first* byte honors the caller's timeout.
"""

from __future__ import annotations

import select
import socket
import threading
import time
from typing import Any, Callable

from repro_torch.core.compress import (
    LINK_TCP,
    TransferLedger,
    TransferPolicy,
    compress_frames,
    decompress_frames,
    is_compressed,
)
from repro_torch.core.serialize import deserialize
from repro_torch.runtime.comm.core import (
    WIRE_HEADER,
    ChannelClosed,
    Comm,
    Listener,
    decode_message,
    encode_message_frames,
    is_control,
    register_transport,
)

#: Buffers per sendmsg call; Linux IOV_MAX is 1024, stay safely under it.
_IOV_CHUNK = 512

#: Poll granularity for blocked receives re-checking the closed flag.
_POLL = 0.1


def _as_view(frame: Any) -> memoryview:
    view = memoryview(frame)
    if view.ndim != 1 or view.format != "B":
        view = view.cast("B") if view.contiguous else memoryview(bytes(view))
    return view


class TCPComm(Comm):
    """``transfer`` configures the adaptive compression policy for this
    link (``None`` = the stock adaptive default: control messages and
    sub-threshold frames untouched, eligible frames probed per frame).
    ``ledger`` (a :class:`TransferLedger`) records logical-vs-wire bytes
    and codec time for every message on the ``tcp`` link class."""

    def __init__(
        self,
        sock: socket.socket,
        name: str = "",
        *,
        transfer: Any = None,
        ledger: TransferLedger | None = None,
    ):
        super().__init__(name)
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        sock.settimeout(None)
        self._sock = sock
        self._policy = TransferPolicy.from_config(transfer)
        self._ledger = ledger
        self._send_lock = threading.Lock()
        self._recv_lock = threading.Lock()
        self._closed = threading.Event()

    @property
    def closed(self) -> bool:
        return self._closed.is_set()

    # -- send ---------------------------------------------------------------

    def send(self, message: Any) -> int:
        frames = [_as_view(f) for f in encode_message_frames(message)]
        logical = sum(v.nbytes for v in frames)
        fast = bool(frames) and is_control(frames[0])
        comp_stats = None
        if not fast:
            # Adaptive per-frame compression: the msgpack control fast path
            # and sub-threshold frames never enter the probe.  Compressed
            # messages ship a self-describing envelope; the concatenation
            # discipline (and writev below) is unchanged.
            packed = compress_frames(frames, policy=self._policy, link_class=LINK_TCP)
            if packed is not None:
                envelope, comp_stats = packed
                frames = [_as_view(f) for f in envelope]
        total = sum(v.nbytes for v in frames)
        header = WIRE_HEADER.pack(total)
        views = [memoryview(header)] + [v for v in frames if v.nbytes]
        with self._send_lock:
            if self._closed.is_set():
                raise ChannelClosed(f"{self.name}: comm closed")
            try:
                self._writev(views)
            except (OSError, ValueError):
                self._closed.set()
                raise ChannelClosed(f"{self.name}: send failed") from None
        self.counter.add_sent(total, fast=fast)
        if self._ledger is not None:
            self._ledger.record(
                LINK_TCP,
                logical_bytes=logical,
                wire_bytes=total,
                compressed_bytes=comp_stats["compressed_bytes"] if comp_stats else 0,
                compress_ns=comp_stats["compress_ns"] if comp_stats else 0,
            )
        return total

    def _writev(self, views: list[memoryview]) -> None:
        while views:
            sent = self._sock.sendmsg(views[:_IOV_CHUNK])
            while sent > 0:
                head = views[0]
                if sent >= head.nbytes:
                    sent -= head.nbytes
                    views.pop(0)
                else:
                    views[0] = head[sent:]
                    sent = 0

    def send_raw(self, marker: int, frames: list[Any]) -> int:
        """One marker-framed raw payload: length prefix, 1 marker byte,
        then the frames writev-style -- no join on the sender, so a chunk
        served straight out of a cache view crosses the socket in place."""
        views = [_as_view(f) for f in frames]
        total = 1 + sum(v.nbytes for v in views)
        header = WIRE_HEADER.pack(total)
        payload = [memoryview(header), memoryview(bytes((marker,)))]
        payload += [v for v in views if v.nbytes]
        with self._send_lock:
            if self._closed.is_set():
                raise ChannelClosed(f"{self.name}: comm closed")
            try:
                self._writev(payload)
            except (OSError, ValueError):
                self._closed.set()
                raise ChannelClosed(f"{self.name}: send failed") from None
        self.counter.add_sent(total)
        return total

    # -- recv ---------------------------------------------------------------

    def recv_blob(self, timeout: float | None = None) -> bytearray:
        with self._recv_lock:
            header = bytearray(WIRE_HEADER.size)
            self._read_into(header, timeout=timeout, first=True)
            (total,) = WIRE_HEADER.unpack(header)
            blob = bytearray(total)
            if total:
                self._read_into(blob, timeout=None, first=False)
        self.counter.add_recv(total, fast=total > 0 and is_control(blob))
        return blob

    def recv(self, timeout: float | None = None) -> Any:
        """Decode with receive-side ledger accounting: a compressed
        envelope is timed through ``decompress_frames`` and recorded as
        wire-vs-logical bytes on the ``tcp`` link class."""
        blob = self.recv_blob(timeout)
        if self._ledger is None:
            return decode_message(blob)
        if is_compressed(blob):
            t0 = time.perf_counter_ns()
            frames = decompress_frames(blob)
            decompress_ns = time.perf_counter_ns() - t0
            logical = sum(
                f.nbytes if isinstance(f, memoryview) else len(f) for f in frames
            )
            self._ledger.record(
                LINK_TCP,
                logical_bytes=logical,
                wire_bytes=len(blob),
                compressed_bytes=logical,
                decompress_ns=decompress_ns,
            )
            return deserialize(frames)
        self._ledger.record(LINK_TCP, logical_bytes=len(blob), wire_bytes=len(blob))
        return decode_message(blob)

    def recv_raw_into(
        self,
        get_buffer: Callable[[int, int], Any],
        timeout: float | None = None,
    ) -> tuple[int, memoryview]:
        """Receive one raw frame directly into the caller's buffer: read
        the length prefix and marker byte, then ``recv_into`` the body
        into ``get_buffer(marker, body_len)``'s view -- the single
        receiver-side copy.  A ``get_buffer`` refusal (raise) or a
        size-mismatched buffer desyncs the stream, so the connection is
        closed before the error propagates."""
        with self._recv_lock:
            header = bytearray(WIRE_HEADER.size)
            self._read_into(header, timeout=timeout, first=True)
            (total,) = WIRE_HEADER.unpack(header)
            if total < 1:
                self.close()
                raise ChannelClosed(f"{self.name}: malformed raw frame")
            mk = bytearray(1)
            self._read_into(mk, timeout=None, first=False)
            marker = mk[0]
            body_len = total - 1
            try:
                body = _as_view(get_buffer(marker, body_len))
            except BaseException:
                self.close()
                raise
            if body.nbytes != body_len or body.readonly:
                self.close()
                raise ChannelClosed(f"{self.name}: raw sink size mismatch")
            if body_len:
                self._read_into(body, timeout=None, first=False)
        self.counter.add_recv(total)
        return marker, body

    def _read_into(
        self, buf: bytearray | memoryview, timeout: float | None, first: bool
    ) -> None:
        """Fill ``buf`` completely.  ``first`` marks the wait for a
        message's first byte -- the only point where timing out is clean;
        a timeout mid-message would desync the framing, so body reads only
        fail by the connection dying."""
        view = memoryview(buf)
        got = 0
        deadline = None if timeout is None else time.monotonic() + timeout
        while got < len(buf):
            if self._closed.is_set():
                raise ChannelClosed(f"{self.name}: comm closed")
            wait = _POLL
            if first and got == 0 and deadline is not None:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise TimeoutError
                wait = min(wait, remaining)
            try:
                ready, _, _ = select.select([self._sock], [], [], wait)
            except (OSError, ValueError):
                self._closed.set()
                raise ChannelClosed(f"{self.name}: comm closed") from None
            if not ready:
                continue
            try:
                n = self._sock.recv_into(view[got:])
            except OSError:
                self._closed.set()
                raise ChannelClosed(f"{self.name}: connection lost") from None
            if n == 0:
                self._closed.set()
                raise ChannelClosed(f"{self.name}: peer closed")
            got += n

    def close(self) -> None:
        self._closed.set()
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._sock.close()
        except OSError:
            pass


# -- listener / connector ------------------------------------------------------


def _split_host_port(rest: str) -> tuple[str, int]:
    host, _, port = rest.rpartition(":")
    if not port:
        raise ValueError(f"tcp address {rest!r} lacks a :port")
    return host or "127.0.0.1", int(port)


class TCPListener(Listener):
    def __init__(
        self,
        rest: str,
        handler: Callable[[Comm], None],
        backlog: int = 128,
        transfer: Any = None,
        ledger: TransferLedger | None = None,
    ):
        host, port = _split_host_port(rest)
        self._sock = socket.create_server((host, port), backlog=backlog)
        bound_host, bound_port = self._sock.getsockname()[:2]
        self.address = f"tcp://{bound_host}:{bound_port}"
        self._handler = handler
        self._transfer = transfer
        self._ledger = ledger
        self._stopped = threading.Event()
        self._thread = threading.Thread(
            target=self._accept_loop, daemon=True, name=f"tcp-listen-{bound_port}"
        )
        self._thread.start()

    def _accept_loop(self) -> None:
        while not self._stopped.is_set():
            try:
                conn, addr = self._sock.accept()
            except OSError:
                return  # listener socket closed
            comm = TCPComm(
                conn,
                name=f"tcp://{addr[0]}:{addr[1]}",
                transfer=self._transfer,
                ledger=self._ledger,
            )
            try:
                self._handler(comm)
            except Exception:
                comm.close()

    def stop(self) -> None:
        self._stopped.set()
        try:
            self._sock.close()
        except OSError:
            pass
        self._thread.join(timeout=2)


def _listen(rest: str, handler: Callable[[Comm], None], **kwargs: Any) -> Listener:
    return TCPListener(rest, handler, **kwargs)


def _connect(rest: str, timeout: float = 5.0, **kwargs: Any) -> Comm:
    host, port = _split_host_port(rest)
    sock = socket.create_connection((host, port), timeout=timeout)
    return TCPComm(
        sock,
        name=f"tcp://{host}:{port}",
        transfer=kwargs.get("transfer"),
        ledger=kwargs.get("ledger"),
    )


register_transport("tcp", _listen, _connect)
