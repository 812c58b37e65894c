"""Pluggable comm subsystem: codec + byte accounting + transports.

``repro_torch.runtime.comm`` grew from a single in-process channel module into
a transport registry (modeled on distributed's ``comm/core.py``):

* :mod:`~repro_torch.runtime.comm.core` -- wire codec (general ``serialize``
  path + msgpack control fast path), :class:`ByteCounter`, the
  :class:`Comm`/:class:`Listener` interfaces, and ``listen``/``connect``.
* :mod:`~repro_torch.runtime.comm.inproc` -- bounded-queue channels between
  threads (``inproc://<name>``); includes the historical
  :class:`LocalChannel`.
* :mod:`~repro_torch.runtime.comm.tcp` -- length-prefix framed sockets
  (``tcp://host:port``) with writev frame sends.
* :mod:`~repro_torch.runtime.comm.pipe` -- :class:`PipeEndpoint` over a
  ``multiprocessing.Connection``.

Importing this package registers the built-in transports.
"""

from repro_torch.runtime.comm.core import (
    CONTROL_PREFIX,
    WIRE_HEADER,
    ByteCounter,
    ChannelClosed,
    Comm,
    Listener,
    connect,
    decode_message,
    encode_message,
    encode_message_frames,
    is_control,
    listen,
    parse_address,
    register_transport,
)
from repro_torch.runtime.comm.inproc import Endpoint, InprocListener, LocalChannel
from repro_torch.runtime.comm.pipe import PipeEndpoint
from repro_torch.runtime.comm.tcp import TCPComm, TCPListener

__all__ = [
    "ByteCounter",
    "CONTROL_PREFIX",
    "ChannelClosed",
    "Comm",
    "Endpoint",
    "InprocListener",
    "Listener",
    "LocalChannel",
    "PipeEndpoint",
    "TCPComm",
    "TCPListener",
    "WIRE_HEADER",
    "connect",
    "decode_message",
    "encode_message",
    "encode_message_frames",
    "is_control",
    "listen",
    "parse_address",
    "register_transport",
]
