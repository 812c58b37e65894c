"""Streaming data plane: topic events on a broker, bytes through the store.

This is the ProxyStore stream split ("Object Proxy Patterns for
Accelerating Distributed Applications", arXiv:2407.01764) applied to the
cluster's existing tiers: a :class:`StreamProducer` publishes each item's
payload into the shared :class:`~repro_torch.runtime.transfer.ResultStore`
namespace (shm same-host fast path, file/kv cross-process, adaptive
per-link compression -- the PR 5-7 machinery, reused not duplicated) and
sends only a small *event* ``(key, ref, nbytes, metadata)`` to a topic
broker.  A :class:`StreamConsumer` pops events, fetches the bytes by ref,
and acks -- and the ack drives exactly-once eviction of the consumed item
through a :class:`~repro_torch.core.ownership.RefLedger`.

Two broker substrates, matching the cluster's comm story:

* :class:`InprocBroker` -- bounded in-process topic queues for thread
  clusters.  Events are still encoded through the comm codec so the
  broker's byte traffic is *measured* (the hub-byte accounting that
  verifies the broker carries metadata, never payloads).
* :class:`BrokerServer` + :class:`CommBrokerChannel` -- the same topic
  queues served over the existing comm transports (``inproc://`` /
  ``tcp://``) for clusters whose control plane crosses a wire.  The
  protocol is synchronous per connection: a publish is acknowledged only
  once the event is enqueued, so bounded-buffer backpressure propagates
  to remote producers, and a pull (``STREAM_NEXT``) blocks server-side
  until an event or the poll window arrives.

Semantics:

* **Bounded buffer**: each topic queue holds at most ``buffer`` events;
  ``send`` blocks (then times out) while the queue is full -- consumer
  lag pushes back on producers instead of growing the broker.
* **Work-queue topics**: concurrent consumers on one topic compete for
  events (each event is delivered to exactly one consumer), which is
  what keeps ack-driven eviction exactly-once.
* **End-of-stream**: ``producer.close()`` marks the topic ended.  EOS is
  broker-side *topic state*, not a competed-for event: the queue drains
  everything already buffered first, then reports end-of-stream to
  **every** consumer (each sees :class:`EndOfStream`; iteration simply
  stops) -- fan-out that a single work-queue marker could not provide.
  Because EOS never occupies a buffer slot, closing a producer never
  blocks on a full topic.
* **Mid-stream close**: closing a consumer, the hub, or the cluster
  wakes blocked ``recv`` calls with :class:`StreamClosed` within one
  poll interval -- nothing blocks on a dead stream.
"""

from __future__ import annotations

import threading
import time
import uuid
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Iterator

from repro_torch.core.ownership import RefLedger
from repro_torch.core.serialize import FrameBundle, deserialize, serialize
from repro_torch.runtime import messages as M
from repro_torch.runtime.comm import (
    ByteCounter,
    ChannelClosed,
    Comm,
    connect,
    decode_message,
    encode_message,
    listen,
)

#: Default per-topic event buffer: deep enough to smooth bursts, small
#: enough that a stalled consumer applies backpressure quickly.
DEFAULT_BUFFER = 64

#: Poll interval for close-wakeable blocking loops (send/recv re-check
#: their endpoint's closed flag this often while blocked).
_POLL = 0.1

#: Default send timeout: a full buffer that stays full this long means the
#: consumer is gone, not slow.
DEFAULT_SEND_TIMEOUT = 30.0

#: Timeout for the EOS publish inside ``producer.close()``.  Setting EOS
#: is buffer-independent (topic state, not an enqueued event), so this
#: only bounds a wedged wire RPC -- it must stay short: Session.close
#: closes consumers before producers, and shutdown must not stall on it.
_EOS_CLOSE_TIMEOUT = 2.0


class StreamClosed(RuntimeError):
    """The stream endpoint (or its hub/cluster) was closed mid-stream."""


class EndOfStream(Exception):
    """The producer closed the topic; every queued item was consumed."""


# -- topic queues --------------------------------------------------------------


class _EndOfTopic(Exception):
    """Internal: the topic's EOS state was reached (queue drained + ended).

    Raised by :meth:`_TopicQueue.get` so each broker can translate it into
    an ``{"eos": True}`` event for its own protocol.  Never escapes the
    broker layer.
    """


class _TopicQueue:
    """Bounded event queue with close-wakes-everyone semantics.

    ``put`` blocks while full, ``get`` blocks while empty; ``close`` wakes
    both sides, after which ``get`` drains what remains and then raises
    :class:`StreamClosed` (a close must not eat queued events).

    End-of-stream is queue *state* (:meth:`set_eos`), not an enqueued
    item: once set, every ``get`` first drains the buffered events, then
    raises :class:`_EndOfTopic` -- so EOS fans out to all competing
    consumers and never occupies a buffer slot.
    """

    def __init__(self, maxsize: int):
        self.maxsize = max(1, int(maxsize))
        self._items: deque[Any] = deque()
        self._cond = threading.Condition()
        self._closed = False
        self._eos = False

    def put(self, item: Any, timeout: float | None = None) -> None:
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cond:
            while not self._closed and len(self._items) >= self.maxsize:
                remaining = _POLL if deadline is None else deadline - time.monotonic()
                if remaining <= 0:
                    raise TimeoutError("stream buffer full")
                self._cond.wait(min(_POLL, remaining))
            if self._closed:
                raise StreamClosed("topic closed")
            self._items.append(item)
            self._cond.notify_all()

    def get(self, timeout: float | None = None) -> Any:
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cond:
            while not self._items and not self._closed and not self._eos:
                remaining = _POLL if deadline is None else deadline - time.monotonic()
                if remaining <= 0:
                    raise TimeoutError("no event")
                self._cond.wait(min(_POLL, remaining))
            if self._items:
                item = self._items.popleft()
                self._cond.notify_all()
                return item
            if self._eos:  # drained + ended beats closed: EOS is the
                raise _EndOfTopic  # graceful signal, close the abrupt one
            raise StreamClosed("topic closed")

    def set_eos(self) -> None:
        with self._cond:
            self._eos = True
            self._cond.notify_all()

    def close(self) -> None:
        with self._cond:
            self._closed = True
            self._cond.notify_all()

    def __len__(self) -> int:
        with self._cond:
            return len(self._items)


# -- brokers -------------------------------------------------------------------


class InprocBroker:
    """Bounded in-process topic queues: the thread cluster's event broker.

    Events round-trip the comm codec even though they never leave the
    process, so ``counter`` measures the broker's real byte traffic --
    the accounting that proves events are metadata-sized while payloads
    ride the store tiers.
    """

    def __init__(self) -> None:
        self._topics: dict[str, _TopicQueue] = {}
        self._lock = threading.Lock()
        self._closed = False
        self.counter = ByteCounter()

    def open_topic(self, topic: str, maxsize: int | None = None) -> None:
        with self._lock:
            if self._closed:
                raise StreamClosed("broker closed")
            q = self._topics.get(topic)
            if q is None:
                self._topics[topic] = _TopicQueue(maxsize or DEFAULT_BUFFER)
            elif maxsize is not None:
                q.maxsize = max(1, int(maxsize))

    def _queue(self, topic: str) -> _TopicQueue:
        with self._lock:
            q = self._topics.get(topic)
            if q is None:
                if self._closed:
                    raise StreamClosed("broker closed")
                q = self._topics[topic] = _TopicQueue(DEFAULT_BUFFER)
            return q

    def put(self, topic: str, event: dict[str, Any], timeout: float | None) -> None:
        if event.get("eos"):
            # EOS is topic state, not an enqueued event: it never takes a
            # buffer slot (so close never blocks on a full topic) and it
            # fans out to every consumer once the queue drains.
            self._queue(topic).set_eos()
            return
        blob = encode_message(M.msg(M.STREAM_EVT, **event))
        self._queue(topic).put(blob, timeout=timeout)
        self.counter.add_sent(len(blob))

    def get(self, topic: str, timeout: float | None) -> dict[str, Any]:
        try:
            blob = self._queue(topic).get(timeout=timeout)
        except _EndOfTopic:
            return {"eos": True}
        self.counter.add_recv(len(blob))
        _, event = decode_message(blob)
        return event

    def depth(self, topic: str) -> int:
        """Events still buffered on ``topic`` (EOS state takes no slot)."""
        return len(self._queue(topic))

    def bytes_total(self) -> int:
        snap = self.counter.snapshot()
        return snap["sent_bytes"] + snap["recv_bytes"]

    def close_topic(self, topic: str) -> None:
        with self._lock:
            q = self._topics.get(topic)
        if q is not None:
            q.close()

    def close(self) -> None:
        with self._lock:
            self._closed = True
            queues = list(self._topics.values())
        for q in queues:
            q.close()


class BrokerServer:
    """Topic queues served over a comm transport (process clusters).

    Each accepted connection gets a handler thread speaking a synchronous
    request/reply protocol:

    * ``STREAM_OPEN  {topic, maxsize}``       -> ``STREAM_OK``
    * ``STREAM_PUB   {topic, event, timeout}`` -> ``STREAM_OK`` once the
      event is *enqueued* (``STREAM_FULL`` on timeout, ``STREAM_CLOSED``
      after close) -- the delayed reply is what carries bounded-buffer
      backpressure across the wire.  An ``{eos: true}`` event sets the
      topic's end-of-stream state instead of enqueueing (never blocks,
      fans out to all consumers),
    * ``STREAM_NEXT  {topic, timeout}``        -> ``STREAM_EVT {event...}``
      (``STREAM_EVT {eos: true}`` once drained past end-of-stream,
      ``STREAM_EMPTY`` on timeout, ``STREAM_CLOSED`` after close),
    * ``STREAM_DEPTH {topic}``                 -> ``STREAM_OK {depth}`` --
      the buffered-event count that lets remote producers ``flush()``.

    A blocked publish occupies only its own connection's handler thread,
    so one stalled producer never wedges consumers.
    """

    def __init__(self, address: str):
        self._topics: dict[str, _TopicQueue] = {}
        self._lock = threading.Lock()
        self._closing = threading.Event()
        self._comms: list[Comm] = []
        self._threads: list[threading.Thread] = []
        self.listener = listen(address, self._on_connection)

    @property
    def address(self) -> str:
        return self.listener.address

    def _queue(self, topic: str, maxsize: int | None = None) -> _TopicQueue:
        with self._lock:
            q = self._topics.get(topic)
            if q is None:
                q = self._topics[topic] = _TopicQueue(maxsize or DEFAULT_BUFFER)
            elif maxsize is not None:
                q.maxsize = max(1, int(maxsize))
            return q

    def _on_connection(self, comm: Comm) -> None:
        t = threading.Thread(
            target=self._serve, args=(comm,), daemon=True, name="stream-broker"
        )
        with self._lock:
            self._comms.append(comm)
            self._threads.append(t)
        t.start()

    def _serve(self, comm: Comm) -> None:
        while not self._closing.is_set():
            try:
                tag, p = comm.recv(timeout=1.0)
            except TimeoutError:
                continue
            except (ChannelClosed, Exception):
                break
            try:
                self._handle(comm, tag, p)
            except ChannelClosed:
                break
        try:
            comm.close()
        except Exception:
            pass

    def _handle(self, comm: Comm, tag: str, p: dict[str, Any]) -> None:
        if tag == M.STREAM_OPEN:
            self._queue(p["topic"], p.get("maxsize"))
            comm.send(M.msg(M.STREAM_OK))
        elif tag == M.STREAM_PUB:
            q = self._queue(p["topic"])
            if p["event"].get("eos"):
                q.set_eos()
                comm.send(M.msg(M.STREAM_OK))
                return
            try:
                q.put(p["event"], timeout=p.get("timeout", DEFAULT_SEND_TIMEOUT))
                comm.send(M.msg(M.STREAM_OK))
            except TimeoutError:
                comm.send(M.msg(M.STREAM_FULL))
            except StreamClosed:
                comm.send(M.msg(M.STREAM_CLOSED))
        elif tag == M.STREAM_NEXT:
            q = self._queue(p["topic"])
            try:
                event = q.get(timeout=p.get("timeout", _POLL))
                comm.send(M.msg(M.STREAM_EVT, **event))
            except _EndOfTopic:
                comm.send(M.msg(M.STREAM_EVT, eos=True))
            except TimeoutError:
                comm.send(M.msg(M.STREAM_EMPTY))
            except StreamClosed:
                comm.send(M.msg(M.STREAM_CLOSED))
        elif tag == M.STREAM_DEPTH:
            comm.send(M.msg(M.STREAM_OK, depth=len(self._queue(p["topic"]))))
        else:  # unknown request: answer, never hang the client RPC
            comm.send(M.msg(M.STREAM_CLOSED))

    def close(self) -> None:
        self._closing.set()
        with self._lock:
            queues = list(self._topics.values())
            comms = list(self._comms)
            threads = list(self._threads)
        for q in queues:
            q.close()
        self.listener.stop()
        for comm in comms:
            try:
                comm.close()
            except Exception:
                pass
        for t in threads:
            t.join(timeout=2)


class CommBrokerChannel:
    """Client side of :class:`BrokerServer`: one connection per endpoint.

    Each producer/consumer opens its own channel, so a publish blocked on
    backpressure (a held-back ``STREAM_OK``) never serializes with another
    endpoint's traffic.  The comm's own :class:`ByteCounter` provides the
    hub-byte accounting for the wire case.
    """

    def __init__(self, address: str):
        self.comm = connect(address)
        self._lock = threading.Lock()

    @property
    def counter(self) -> ByteCounter:
        return self.comm.counter

    def _rpc(self, message: Any, timeout: float) -> tuple[str, dict[str, Any]]:
        with self._lock:
            try:
                self.comm.send(message)
                return self.comm.recv(timeout=timeout + 5.0)
            except ChannelClosed:
                raise StreamClosed("broker connection closed") from None

    def open_topic(self, topic: str, maxsize: int | None = None) -> None:
        tag, _ = self._rpc(M.msg(M.STREAM_OPEN, topic=topic, maxsize=maxsize), 5.0)
        if tag != M.STREAM_OK:
            raise StreamClosed("broker rejected topic open")

    def put(self, topic: str, event: dict[str, Any], timeout: float | None) -> None:
        step = _POLL if timeout is None else timeout
        tag, _ = self._rpc(
            M.msg(M.STREAM_PUB, topic=topic, event=event, timeout=step), step
        )
        if tag == M.STREAM_OK:
            return
        if tag == M.STREAM_FULL:
            raise TimeoutError("stream buffer full")
        raise StreamClosed("topic closed")

    def get(self, topic: str, timeout: float | None) -> dict[str, Any]:
        step = _POLL if timeout is None else timeout
        tag, p = self._rpc(M.msg(M.STREAM_NEXT, topic=topic, timeout=step), step)
        if tag == M.STREAM_EVT:
            return p
        if tag == M.STREAM_EMPTY:
            raise TimeoutError("no event")
        raise StreamClosed("topic closed")

    def depth(self, topic: str) -> int:
        tag, p = self._rpc(M.msg(M.STREAM_DEPTH, topic=topic), 5.0)
        if tag != M.STREAM_OK:
            raise StreamClosed("topic closed")
        return int(p.get("depth", 0))

    def close(self) -> None:
        try:
            self.comm.close()
        except Exception:
            pass


# -- the hub -------------------------------------------------------------------


class StreamHub:
    """Per-cluster stream fabric: broker + store handle + ref ledger.

    Owned by a :class:`~repro_torch.runtime.client.LocalCluster` (created
    lazily by ``cluster.streams()``).  Producers publish payload bytes
    through ``results`` (the cluster's existing ``ResultStore`` tiers)
    and track each ref on ``ledger``; consumer acks ``release`` the ref,
    so consumed items are evicted exactly once -- and closing the hub
    releases whatever was produced but never consumed, before the data
    plane itself is wiped.
    """

    def __init__(self, results: Any, *, address: str | None = None):
        self.results = results
        self.ledger = RefLedger(self._evict)
        self._server = BrokerServer(address) if address is not None else None
        self._broker = InprocBroker() if address is None else None
        self._channels: list[CommBrokerChannel] = []
        self._payload_bytes = 0
        self._events = 0
        self._lock = threading.Lock()
        self._closed = False

    def _evict(self, ref: str) -> None:
        try:
            self.results.evict(ref)
        except Exception:
            pass  # data plane already torn down: nothing left to leak

    def _channel(self) -> Any:
        if self._broker is not None:
            return self._broker
        ch = CommBrokerChannel(self._server.address)
        with self._lock:
            self._channels.append(ch)
        return ch

    def _note_payload(self, nbytes: int) -> None:
        with self._lock:
            self._payload_bytes += int(nbytes)
            self._events += 1

    # -- endpoints -----------------------------------------------------------

    def producer(
        self,
        topic: str,
        *,
        buffer: int = DEFAULT_BUFFER,
        send_timeout: float = DEFAULT_SEND_TIMEOUT,
    ) -> "StreamProducer":
        if self._closed:
            raise StreamClosed("stream hub closed")
        return StreamProducer(
            self, topic, buffer=buffer, send_timeout=send_timeout
        )

    def consumer(self, topic: str, *, auto_ack: bool = True) -> "StreamConsumer":
        if self._closed:
            raise StreamClosed("stream hub closed")
        return StreamConsumer(self, topic, auto_ack=auto_ack)

    # -- accounting ----------------------------------------------------------

    def broker_bytes(self) -> int:
        """Bytes that crossed the event broker (both directions).

        The streaming analogue of the scheduler's hub-byte accounting:
        this must stay metadata-sized no matter how many payload bytes
        ``payload_bytes()`` reports moving through the store tiers.
        """
        if self._broker is not None:
            return self._broker.bytes_total()
        total = 0
        with self._lock:
            channels = list(self._channels)
        for ch in channels:
            snap = ch.counter.snapshot()
            total += snap["sent_bytes"] + snap["recv_bytes"]
        return total

    def payload_bytes(self) -> int:
        """Serialized payload bytes published through the store tiers."""
        with self._lock:
            return self._payload_bytes

    def stats(self) -> dict[str, int]:
        with self._lock:
            payload, events = self._payload_bytes, self._events
        return {
            "events": events,
            "payload_bytes": payload,
            "broker_bytes": self.broker_bytes(),
            "live_refs": len(self.ledger.live_refs()),
            "live_bytes": self.ledger.live_bytes(),
        }

    # -- lifecycle -----------------------------------------------------------

    def close(self) -> None:
        """Wake every blocked endpoint, then release unconsumed refs.

        Runs *before* the cluster wipes its data plane, so eviction goes
        through the ledger (exactly-once) rather than being implied by
        namespace teardown -- borrowed data planes leak nothing either.
        """
        if self._closed:
            return
        self._closed = True
        if self._broker is not None:
            self._broker.close()
        if self._server is not None:
            self._server.close()
        with self._lock:
            channels = list(self._channels)
        for ch in channels:
            ch.close()
        for ref in self.ledger.live_refs():
            self.ledger.release(ref)


# -- endpoints -----------------------------------------------------------------


@dataclass
class StreamItem:
    """One consumed stream element: the value plus its event descriptor."""

    key: str
    value: Any
    metadata: dict[str, Any]
    nbytes: int
    ref: str | None
    _consumer: "StreamConsumer" = field(repr=False, default=None)

    def ack(self) -> bool:
        """Release this item's store bytes; True only on the acking call."""
        if self.ref is None or self._consumer is None:
            return False
        return self._consumer.ack(self.ref)


class StreamProducer:
    """Sends objects into a topic: bytes to the store, an event to the broker."""

    def __init__(
        self,
        hub: StreamHub,
        topic: str,
        *,
        buffer: int = DEFAULT_BUFFER,
        send_timeout: float = DEFAULT_SEND_TIMEOUT,
    ):
        self.hub = hub
        self.topic = topic
        self.send_timeout = send_timeout
        self._uid = uuid.uuid4().hex[:8]
        self._seq = 0
        self._seq_lock = threading.Lock()
        self._closed = False
        self._channel = hub._channel()
        self._channel.open_topic(topic, maxsize=buffer)

    @property
    def closed(self) -> bool:
        return self._closed

    def _put(self, event: dict[str, Any], timeout: float | None) -> None:
        """Close-wakeable bounded put: poll-sized broker puts so a close
        on this endpoint interrupts a blocked send within ``_POLL``."""
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            if self._closed:
                raise StreamClosed(f"producer for {self.topic!r} closed")
            remaining = None if deadline is None else deadline - time.monotonic()
            if remaining is not None and remaining <= 0:
                raise TimeoutError(
                    f"stream {self.topic!r} buffer full for {timeout:.1f}s"
                )
            step = _POLL if remaining is None else min(_POLL, remaining)
            try:
                self._channel.put(self.topic, event, timeout=step)
                return
            except TimeoutError:
                continue

    def send(
        self,
        value: Any,
        *,
        metadata: dict[str, Any] | None = None,
        timeout: float | None = None,
    ) -> str:
        """Publish ``value`` and enqueue its event; returns the item key.

        Blocks (bounded-buffer backpressure) while the topic buffer is
        full; ``timeout`` (default: the producer's ``send_timeout``)
        raises :class:`TimeoutError` without leaking the published bytes.
        """
        if self._closed:
            raise StreamClosed(f"producer for {self.topic!r} closed")
        with self._seq_lock:
            seq = self._seq
            self._seq += 1
        key = f"stream-{self.topic}-{self._uid}-{seq:08d}"
        bundle = FrameBundle.of(serialize(value))
        ref = self.hub.results.publish(key, bundle)
        self.hub.ledger.track(ref, bundle.nbytes)
        self.hub._note_payload(bundle.nbytes)
        event = {
            "key": key,
            "ref": ref,
            "nbytes": bundle.nbytes,
            "meta": dict(metadata or {}),
        }
        try:
            self._put(event, self.send_timeout if timeout is None else timeout)
        except BaseException:
            # The event never entered the topic: nobody will ever ack it,
            # so release the published bytes here (exactly-once ledger).
            self.hub.ledger.release(ref)
            raise
        return key

    def flush(self, timeout: float = DEFAULT_SEND_TIMEOUT) -> None:
        """Block until every sent event has left the topic buffer.

        Works on both broker substrates -- the inproc broker observes its
        queue directly, wire channels ask via a ``STREAM_DEPTH`` RPC --
        and raises :class:`TimeoutError` if the topic has not drained
        within ``timeout``.  Returns immediately once the producer (or
        the topic behind it) is closed: there is nothing left to drain.
        """
        deadline = time.monotonic() + timeout
        while not self._closed:
            try:
                if self._channel.depth(self.topic) == 0:
                    return
            except StreamClosed:
                return  # topic/hub gone: queued events can never drain
            if time.monotonic() >= deadline:
                raise TimeoutError(
                    f"stream {self.topic!r} did not drain in {timeout:.1f}s"
                )
            time.sleep(_POLL / 5)

    def close(self) -> None:
        """Mark the topic ended; idempotent.

        Events already queued are delivered first -- EOS is broker-side
        topic state reported only after the queue drains -- then *every*
        consumer sees :class:`EndOfStream`.  Setting EOS never waits for
        buffer space, so close stays prompt even with a full topic and no
        consumers left; the short timeout below only guards a wedged wire.
        """
        if self._closed:
            return
        try:
            self._put({"eos": True}, _EOS_CLOSE_TIMEOUT)
        except (TimeoutError, StreamClosed):
            pass  # topic gone or wedged: consumers are woken by hub close
        finally:
            self._closed = True
            if self._channel is not self.hub._broker:
                self._channel.close()

    def __enter__(self) -> "StreamProducer":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.close()


class StreamConsumer:
    """Pulls items from a topic: event from the broker, bytes from the store.

    Iterable: ``for item in consumer`` yields :class:`StreamItem` until
    end-of-stream.  With ``auto_ack`` (default) each item's store entry
    is released as soon as its bytes are fetched; with ``auto_ack=False``
    the caller acks explicitly (``item.ack()``) and anything delivered
    but unacked is released on ``close()``.
    """

    def __init__(self, hub: StreamHub, topic: str, *, auto_ack: bool = True):
        self.hub = hub
        self.topic = topic
        self.auto_ack = auto_ack
        self._closed = False
        self._eos = False
        self._unacked: set[str] = set()
        self._lock = threading.Lock()
        self._channel = hub._channel()
        self._channel.open_topic(topic)

    @property
    def closed(self) -> bool:
        return self._closed

    def recv(self, timeout: float | None = None) -> StreamItem:
        """Next item, blocking up to ``timeout`` (None: until one arrives).

        Raises :class:`EndOfStream` at the EOS marker, :class:`TimeoutError`
        when the window elapses, and :class:`StreamClosed` when this
        consumer (or the hub/cluster behind it) is closed mid-stream --
        including while blocked.
        """
        if self._eos:
            raise EndOfStream(self.topic)
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            if self._closed:
                raise StreamClosed(f"consumer for {self.topic!r} closed")
            remaining = None if deadline is None else deadline - time.monotonic()
            if remaining is not None and remaining <= 0:
                raise TimeoutError(f"no event on {self.topic!r}")
            step = _POLL if remaining is None else min(_POLL, remaining)
            try:
                event = self._channel.get(self.topic, timeout=step)
                break
            except TimeoutError:
                continue
        if event.get("eos"):
            self._eos = True
            raise EndOfStream(self.topic)
        ref, nbytes = event["ref"], event.get("nbytes", -1)
        bundle = self.hub.results.fetch(ref, nbytes)
        if bundle is None:
            raise StreamClosed(
                f"payload bytes for {event.get('key')} missing from the store"
            )
        value = deserialize(bundle)
        item = StreamItem(
            key=event.get("key", ""),
            value=value,
            metadata=event.get("meta") or {},
            nbytes=nbytes,
            ref=ref,
            _consumer=self,
        )
        if self.auto_ack:
            self.ack(ref)
        else:
            with self._lock:
                self._unacked.add(ref)
        return item

    def ack(self, ref: str) -> bool:
        """Release the item's bytes through the ledger; exactly-once."""
        with self._lock:
            self._unacked.discard(ref)
        return self.hub.ledger.release(ref)

    def __iter__(self) -> Iterator[StreamItem]:
        while True:
            try:
                yield self.recv()
            except EndOfStream:
                return

    def close(self) -> None:
        """Stop consuming and release delivered-but-unacked items.

        Wakes a ``recv`` blocked in another thread within one poll
        interval.  Items still *queued* on the topic stay tracked: the
        hub releases them when it closes (or another consumer takes
        them), so nothing is double-evicted.
        """
        if self._closed:
            return
        self._closed = True
        with self._lock:
            unacked = list(self._unacked)
            self._unacked.clear()
        for ref in unacked:
            self.hub.ledger.release(ref)
        if self._channel is not self.hub._broker:
            self._channel.close()

    def __enter__(self) -> "StreamConsumer":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.close()
