"""Comm core: byte accounting, the wire codec, and the transport registry.

Every message between client, scheduler, and workers is serialized to
bytes -- even between threads -- so the framework pays (and *measures*) the
real serialization + transfer cost of its control path.  This is what lets
the benchmarks attribute wins the way the paper's Fig 3/4 do: bytes
through the scheduler vs. bytes through mediated storage.

Transports register here under an address scheme (modeled on
distributed's ``comm/core.py``):

* ``inproc://<name>``      -- bounded in-process queues (deterministic,
  byte-counted; what tests and the default thread backend ride on),
* ``tcp://<host>:<port>``  -- a real socket with a length-prefixed framed
  wire protocol (process workers and, later, multi-host clusters).

``listen(address, handler)`` starts a :class:`Listener` that invokes
``handler(comm)`` once per accepted connection; ``connect(address)``
returns the client-side :class:`Comm`.  Both ends speak the same codec:

* **general messages** pay the full array-capable ``serialize`` round
  trip.  Its frame list (header + buffer views) is exposed through
  :func:`encode_message_frames` so a transport can write the frames
  writev-style -- the concatenation of the frames *is* the encoded blob,
  which keeps the zero-copy discipline intact across a socket.
* **control messages** -- ``(tag, payload)`` pairs whose tag is in the
  plain-builtin allowlist (heartbeats, completion reports, steals,
  stop/cancel/release...) -- take a cheap msgpack fast path, prefixed with
  ``0x01`` (``serialize`` blobs start with ``PSX1``, so the formats can
  never collide).  The allowlist matters: msgpack turns tuples into
  lists, which is fine for control payloads but would corrupt user task
  arguments, so SUBMIT/RUN_TASK-style messages always take the general
  path.  Fast-path traffic is counted separately in :class:`ByteCounter`
  (``fast_msgs``/``fast_bytes``).
"""

from __future__ import annotations

import struct
import threading
from dataclasses import dataclass, field
from typing import Any, Callable

import msgpack

from repro_torch.core.compress import decompress_frames, is_compressed
from repro_torch.core.serialize import deserialize, serialize
from repro_torch.runtime import messages as M

#: 8-byte little-endian total-length prefix framing a message on stream
#: transports.
WIRE_HEADER = struct.Struct("<Q")

#: Fast-path marker byte.  ``serialize`` output starts with ``PSX1``
#: (0x50), so the first byte of a blob identifies its codec.
CONTROL_PREFIX = b"\x01"

#: Control tags whose payloads are plain builtins by protocol: nothing in
#: them carries user arguments, so the msgpack tuple->list conversion is
#: harmless.  SUBMIT/SUBMIT_GRAPH/RUN_TASK/RUN_BATCH stay on the general
#: path because their arg specs must round-trip tuples exactly.
_FAST_TAGS = frozenset(
    {
        M.REGISTER,
        M.DEREGISTER,
        M.HEARTBEAT,
        M.TASK_DONE,
        M.TASK_FAILED,
        M.REPORT_BATCH,
        M.STEAL,
        M.STEAL_ACK,
        M.CANCEL,
        M.STOP,
        M.RELEASE,
        M.CLIENT_SHUTDOWN,
        M.FINISHED,
        M.FAILED,
        # Stream broker control replies/requests: plain-builtin payloads by
        # protocol.  STREAM_PUB/STREAM_EVT stay on the general path -- their
        # event dicts carry user metadata, which must round-trip exactly.
        M.STREAM_OPEN,
        M.STREAM_NEXT,
        M.STREAM_OK,
        M.STREAM_FULL,
        M.STREAM_EMPTY,
        M.STREAM_CLOSED,
        # Peer data-plane handshake: ``{key}`` / ``{key, ok, nbytes}`` --
        # plain builtins.  The payload bytes themselves never touch the
        # message codec (they travel as raw marker frames, below).
        M.DATA_GET,
        M.DATA_HDR,
        M.PEER_GONE,
    }
)


class ChannelClosed(Exception):
    pass


#: In-band close sentinel for queue/pipe transports (never a valid blob:
#: real blobs start with 0x01, 0x02, or "P").
_CLOSE = b"\x00__CLOSE__"

#: Raw-frame markers (first byte of a ``send_raw`` frame).  Chosen >= 0x03
#: so a raw frame can never collide with the message codec's prefixes
#: (0x01 control, 0x02 compression envelope, "P" serialized bundle) or
#: the 0x00 close sentinel above.  ``RAW_CHUNK`` carries logical payload
#: bytes verbatim; ``RAW_COMPRESSED`` carries a compression envelope
#: produced by :func:`repro_torch.core.compress.compress_frames`; ``RAW_ABORT``
#: is an in-band "source lost mid-transfer" signal that leaves the stream
#: aligned for the next request/response pair.
RAW_CHUNK = 0x03
RAW_COMPRESSED = 0x04
RAW_ABORT = 0x05


@dataclass
class ByteCounter:
    sent_msgs: int = 0
    recv_msgs: int = 0
    sent_bytes: int = 0
    recv_bytes: int = 0
    #: control messages that took the msgpack fast path (both directions)
    fast_msgs: int = 0
    fast_bytes: int = 0
    _lock: threading.Lock = field(default_factory=threading.Lock, repr=False)

    def add_sent(self, n: int, fast: bool = False) -> None:
        with self._lock:
            self.sent_msgs += 1
            self.sent_bytes += n
            if fast:
                self.fast_msgs += 1
                self.fast_bytes += n

    def add_recv(self, n: int, fast: bool = False) -> None:
        with self._lock:
            self.recv_msgs += 1
            self.recv_bytes += n
            if fast:
                self.fast_msgs += 1
                self.fast_bytes += n

    def snapshot(self) -> dict[str, int]:
        with self._lock:
            return {
                "sent_msgs": self.sent_msgs,
                "recv_msgs": self.recv_msgs,
                "sent_bytes": self.sent_bytes,
                "recv_bytes": self.recv_bytes,
                "fast_msgs": self.fast_msgs,
                "fast_bytes": self.fast_bytes,
            }


# -- codec ---------------------------------------------------------------------


def _pack_control(message: Any) -> bytes | None:
    """Encode an allowlisted control message via msgpack, or None."""
    if (
        not isinstance(message, tuple)
        or len(message) != 2
        or message[0] not in _FAST_TAGS
    ):
        return None
    try:
        return CONTROL_PREFIX + msgpack.packb(message, use_bin_type=True)
    except (TypeError, ValueError, OverflowError):
        # Something non-builtin rode the payload (e.g. a live handle on an
        # in-process REGISTER): fall back to the general codec.
        return None


def is_control(blob: Any) -> bool:
    """Whether an encoded blob took the control fast path."""
    return len(blob) > 0 and bytes(blob[:1]) == CONTROL_PREFIX


def encode_message(message: Any) -> bytes:
    """Messages are (tag, payload) tuples; payload may hold arrays/pytrees."""
    blob = _pack_control(message)
    if blob is not None:
        return blob
    return serialize(message).to_bytes()


def encode_message_frames(message: Any) -> list[Any]:
    """Encode as a frame list whose concatenation equals
    :func:`encode_message` output -- stream transports write these
    writev-style so array buffers are never joined on send."""
    blob = _pack_control(message)
    if blob is not None:
        return [blob]
    return serialize(message).frames()


def decode_message(blob: Any) -> Any:
    """Inverse of :func:`encode_message`; accepts bytes/bytearray/memoryview.

    Also accepts a compression envelope (first byte 0x02): a transport may
    have compressed eligible frames on send, and a server may forward the
    still-compressed blob into a mailbox -- decode is self-describing, so
    the envelope unwraps wherever the message is finally read.
    """
    if is_control(blob):
        body = blob[1:] if isinstance(blob, (bytes, bytearray)) else bytes(blob[1:])
        tag, payload = msgpack.unpackb(body, raw=False, strict_map_key=False)
        return tag, payload
    if is_compressed(blob):
        return deserialize(decompress_frames(blob))
    return deserialize(blob)


# -- transport interfaces ------------------------------------------------------


class Comm:
    """One end of an established connection.

    ``send`` encodes + counts + writes and returns the payload byte count;
    ``recv_blob`` returns the raw encoded blob (so servers can forward it
    into a mailbox without a decode/re-encode round trip); ``recv``
    decodes.  Closing either end makes blocked and future ``send``/``recv``
    calls on *both* ends raise :class:`ChannelClosed`.
    """

    def __init__(self, name: str = ""):
        self.name = name
        self.counter = ByteCounter()

    def send(self, message: Any) -> int:
        raise NotImplementedError

    def recv_blob(self, timeout: float | None = None) -> Any:
        raise NotImplementedError

    def recv(self, timeout: float | None = None) -> Any:
        return decode_message(self.recv_blob(timeout))

    def send_raw(self, marker: int, frames: list[Any]) -> int:
        """Write one marker-framed raw payload (``RAW_*`` markers above),
        bypassing the message codec: frames go out writev-style with no
        join on the sender.  Returns the wire byte count (marker + body)."""
        raise NotImplementedError

    def recv_raw_into(
        self,
        get_buffer: "Callable[[int, int], Any]",
        timeout: float | None = None,
    ) -> tuple[int, memoryview]:
        """Receive one raw frame *in place*: after reading the marker and
        body length, ``get_buffer(marker, body_len)`` must return a
        writable buffer of exactly ``body_len`` bytes and the body lands
        directly in it -- the receiver-side single-copy assembly.  If
        ``get_buffer`` raises, the stream is considered desynced and the
        connection is closed before the exception propagates.  Returns
        ``(marker, filled_view)``."""
        raise NotImplementedError

    def close(self) -> None:
        raise NotImplementedError

    @property
    def closed(self) -> bool:
        raise NotImplementedError


class Listener:
    """A started listener; ``address`` is the resolved connect string."""

    address: str

    def stop(self) -> None:
        raise NotImplementedError

    def __enter__(self) -> "Listener":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.stop()


# -- registry ------------------------------------------------------------------

_TRANSPORTS: dict[str, tuple[Callable[..., Listener], Callable[..., Comm]]] = {}


def register_transport(
    scheme: str,
    listen_factory: Callable[..., Listener],
    connect_factory: Callable[..., Comm],
) -> None:
    _TRANSPORTS[scheme] = (listen_factory, connect_factory)


def parse_address(address: str) -> tuple[str, str]:
    scheme, sep, rest = address.partition("://")
    if not sep or not scheme:
        raise ValueError(f"address {address!r} lacks a scheme:// prefix")
    return scheme, rest


def _transport(scheme: str) -> tuple[Callable[..., Listener], Callable[..., Comm]]:
    if scheme not in _TRANSPORTS:
        # The built-in transports register on package import; resolving a
        # scheme through core alone must not depend on import order.
        from repro_torch.runtime.comm import inproc, tcp  # noqa: F401

    try:
        return _TRANSPORTS[scheme]
    except KeyError:
        raise ValueError(
            f"unknown transport scheme {scheme!r} (registered: "
            f"{sorted(_TRANSPORTS)})"
        ) from None


def listen(address: str, handler: Callable[[Comm], None], **kwargs: Any) -> Listener:
    """Start listening; ``handler(comm)`` runs once per accepted connection."""
    scheme, rest = parse_address(address)
    listen_factory, _ = _transport(scheme)
    return listen_factory(rest, handler, **kwargs)


def connect(address: str, timeout: float = 5.0, **kwargs: Any) -> Comm:
    scheme, rest = parse_address(address)
    _, connect_factory = _transport(scheme)
    return connect_factory(rest, timeout=timeout, **kwargs)
