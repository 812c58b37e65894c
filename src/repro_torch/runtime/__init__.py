"""Mini-Dask-Distributed runtime: the substrate the paper integrates with.

Control plane (``scheduler``) and data plane (``transfer``) are separate:
the scheduler moves metadata; result bytes move worker-to-worker or
through the shared cluster store.  The comm subsystem (``comm``) carries
the control plane over pluggable transports (inproc queues or tcp
sockets); ``proc`` runs workers in their own interpreters on top of it.
``stream`` adds the topic-based streaming data plane (events on a broker,
bytes through the store tiers) and ``serving`` the continuous-batching
model server built on it.
"""

from repro_torch.runtime.client import Client, LocalCluster, ProxyClient, RuntimeFuture
from repro_torch.runtime.comm import ByteCounter, ChannelClosed, Comm, connect, listen
from repro_torch.runtime.graph import FutureRef, tokenize
from repro_torch.runtime.proc import (
    CommServer,
    ProcessWorker,
    SchedulerLink,
    start_comm_worker,
)
from repro_torch.runtime.scheduler import Scheduler
from repro_torch.runtime.serving import ModelServer, ServerOverloaded
from repro_torch.runtime.stream import (
    EndOfStream,
    StreamClosed,
    StreamConsumer,
    StreamHub,
    StreamItem,
    StreamProducer,
)
from repro_torch.runtime.transfer import (
    BlobCache,
    MissingDependencyError,
    PeerTransfer,
    ResultStore,
    SpillCache,
)
from repro_torch.runtime.worker import ThreadWorker

__all__ = [
    "ByteCounter",
    "ChannelClosed",
    "Client",
    "Comm",
    "CommServer",
    "LocalCluster",
    "ProcessWorker",
    "ProxyClient",
    "RuntimeFuture",
    "FutureRef",
    "SchedulerLink",
    "tokenize",
    "Scheduler",
    "ThreadWorker",
    "BlobCache",
    "SpillCache",
    "MissingDependencyError",
    "PeerTransfer",
    "ResultStore",
    "connect",
    "listen",
    "start_comm_worker",
    "ModelServer",
    "ServerOverloaded",
    "StreamHub",
    "StreamProducer",
    "StreamConsumer",
    "StreamItem",
    "StreamClosed",
    "EndOfStream",
]
