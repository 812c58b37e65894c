"""Message types for the runtime protocol (plain tuples for cheap encode).

Every message is ``(tag, payload_dict)``.  The protocol is **metadata
only**: result bytes never ride on these messages except for inline
results below ``inline_result_max``.  Large results travel the peer-to-peer
data plane (``runtime/transfer.py``) and are referenced here by
``(ref, nbytes, locations)``.

Tags:

client -> scheduler:   submit, submit_graph, release, client_shutdown
worker -> scheduler:   register, heartbeat, task_done, task_failed,
                       steal_ack, deregister
scheduler -> worker:   run_task, run_batch, steal, cancel, stop
scheduler -> client:   finished, failed

``submit_graph`` amortizes submission (one message for a whole task
graph); ``run_batch`` amortizes dispatch (one message for every task bound
to a worker in a dispatch pass -- the worker pipelines them through its
local ready queue); ``report_batch`` amortizes completion (a worker
coalesces the ``task_done``/``task_failed`` reports of a completion burst
into one message after a ~2 ms window).  ``steal``/``steal_ack``
rebalance skewed fan-outs: the
scheduler asks a loaded worker to give back *unstarted* queued tasks, the
worker confirms exactly which ones it relinquished, and only those are
re-dispatched -- so a task can never run twice because of a steal.

``heartbeat`` doubles as the memory-telemetry channel: alongside
``worker`` it carries ``managed_bytes`` (hot cache + in-flight task
bytes), ``spilled_bytes`` (disk-tier bytes), ``memory_limit``, ``state``
(``running`` or ``paused`` -- a paused worker gets no new ``run_batch``
until its managed bytes fall back below its resume target), and a capped
``spilled_keys`` list feeding the scheduler's spill-aware locality.
Workers push an immediate out-of-cycle heartbeat on every pause/resume
transition so dispatch reacts within one scheduler loop pass.

Replica-holder registration rides the existing traffic rather than new
tags: ``task_done`` carries ``cached_deps`` (deps the completing worker
fetched and still caches) and ``heartbeat`` carries a capped
``cached_keys`` list (every servable cached key, hot or spilled).  Both
are additive, advisory, and restricted scheduler-side to *done* tasks;
they feed the bounded freshness-ordered peer list dispatch ships in
``dep_info["peers"]`` so fan-out fetches spread across replicas.

The hub-mediated forwarding tags of the old data plane (``need_data`` /
``send_data`` / ``data`` / ``gather``) are gone, not deprecated: there is
no code path left that ships a result blob through the scheduler mailbox.
"""

from __future__ import annotations

from typing import Any

SUBMIT = "submit"
SUBMIT_GRAPH = "submit_graph"
RELEASE = "release"
CLIENT_SHUTDOWN = "client_shutdown"

REGISTER = "register"
HEARTBEAT = "heartbeat"
TASK_DONE = "task_done"
TASK_FAILED = "task_failed"
REPORT_BATCH = "report_batch"
STEAL_ACK = "steal_ack"
DEREGISTER = "deregister"

RUN_TASK = "run_task"
RUN_BATCH = "run_batch"
STEAL = "steal"
CANCEL = "cancel"
STOP = "stop"

FINISHED = "finished"
FAILED = "failed"

# Peer data-plane protocol (runtime/dataserver.py).  ``data_get`` /
# ``data_hdr`` are the request/response handshake on a worker's *data*
# listener (never the scheduler mailbox): a peer asks for a cached blob
# by key, the holder answers with ``ok`` + ``nbytes`` and then streams
# the payload as raw marker-framed chunks outside the message codec
# entirely (``Comm.send_raw``/``recv_raw_into``).  ``peer_gone`` is the
# scheduler's worker-loss push: every live worker drops its pooled
# connections to the dead worker's data address so in-flight fetches
# fail fast to the store instead of waiting out a socket timeout.
DATA_GET = "data_get"
DATA_HDR = "data_hdr"
PEER_GONE = "peer_gone"

# Stream broker protocol (runtime/stream.py).  Topic *events* -- (key,
# ref, nbytes, metadata) descriptors, never payload bytes -- ride these
# tags between stream endpoints and the broker; the bulk bytes they
# describe travel the ResultStore tiers.  PUB/EVT carry user metadata and
# therefore take the general codec (tuples must round-trip exactly); the
# bare control replies are msgpack-fast-path eligible.
STREAM_OPEN = "stream_open"
STREAM_PUB = "stream_pub"
STREAM_NEXT = "stream_next"
STREAM_DEPTH = "stream_depth"
STREAM_EVT = "stream_evt"
STREAM_OK = "stream_ok"
STREAM_FULL = "stream_full"
STREAM_EMPTY = "stream_empty"
STREAM_CLOSED = "stream_closed"


def msg(tag: str, **payload: Any) -> tuple[str, dict[str, Any]]:
    return (tag, payload)
