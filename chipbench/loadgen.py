"""Traffic: prompts drawn from the seed, and the closed loop that sends them.

A traffic file (``traffic/<name>.json``) gives the loop, the batch the
server forms, the number of clients, the prompt and answer lengths and the
batcher's window.  Prompt ``i`` of a run is drawn from ``(seed, i)`` alone,
so two runs of one seed send the same prompts in the same order.

In the closed loop each of C clients sends a request, waits for its reply
on the ``responses`` topic, and sends its next one at once.  Clients stop
sending when the window closes; what is in flight then is waited for (a
minute at most) and counts.
"""

from __future__ import annotations

import dataclasses
import hashlib
import time
from typing import Any, Callable

import numpy as np

#: seconds past the window's close that a reply is still waited for
GRACE_S = 60.0


@dataclasses.dataclass
class Traffic:
    name: str
    loop: str
    batch: int
    clients: int
    prompt_len: int
    gen: int
    max_wait_ms: float

    @classmethod
    def from_file(cls, name: str, spec: dict[str, Any]) -> "Traffic":
        if spec["loop"] != "closed":
            raise ValueError(f"traffic {name!r}: loop {spec['loop']!r} is not built yet")
        t = cls(name=name, loop=spec["loop"], batch=int(spec["batch"]),
                clients=int(spec["clients"]), prompt_len=int(spec["prompt_len"]),
                gen=int(spec["gen"]), max_wait_ms=float(spec["max_wait_ms"]))
        if min(t.batch, t.clients, t.prompt_len, t.gen) < 1:
            raise ValueError(f"traffic {name!r}: sizes must be positive: {spec}")
        return t


def prompt(seed: int, index: int, length: int, vocab: int, stream: int = 0) -> np.ndarray:
    """Prompt ``index`` of a run: ``length`` token ids, uniform over the
    vocabulary.  ``stream`` 1 is the warm-up's prompts."""
    rng = np.random.default_rng([seed % (1 << 63), stream, index])
    return rng.integers(0, vocab, size=length, dtype=np.int64).astype(np.int32)


def content_key(tokens: Any) -> bytes:
    """A prompt's identity wherever it is seen: the client's copy and the
    batch function's copy after the stream's round trip."""
    arr = np.ascontiguousarray(np.asarray(tokens, dtype=np.int32))
    return hashlib.blake2b(arr.tobytes(), digest_size=16).digest()


@dataclasses.dataclass
class Request:
    index: int
    client: int
    key: str
    content: bytes
    t_send: float
    t_recv: float | None = None
    status: str | None = None
    tokens: np.ndarray | None = None

    @property
    def ok(self) -> bool:
        return self.status == "ok" and self.tokens is not None

    @property
    def latency_ms(self) -> float:
        return (self.t_recv - self.t_send) * 1e3


@dataclasses.dataclass
class Window:
    requests: list[Request]
    t_first: float   # the first send
    t_close: float   # clients stop sending
    t_last: float    # the last reply (or the close, with none)


def closed_loop(
    requests: Any,
    responses: Any,
    *,
    clients: int,
    seconds: float,
    make_prompt: Callable[[int], np.ndarray],
    clock: Callable[[], float] = time.perf_counter,
    grace: float = GRACE_S,
) -> Window:
    """Keep ``clients`` requests in flight for ``seconds``, then drain."""
    sent: list[Request] = []
    by_key: dict[str, Request] = {}

    def send(client: int) -> None:
        tokens = make_prompt(len(sent))
        t = clock()
        key = requests.send(tokens)
        req = Request(len(sent), client, key, content_key(tokens), t)
        sent.append(req)
        by_key[key] = req

    t_first = clock()
    t_close = t_first + seconds
    for c in range(clients):
        send(c)
    pending = clients
    t_last = t_first
    while pending:
        left = t_close + grace - clock()
        if left <= 0:
            break
        try:
            item = responses.recv(timeout=left)
        except TimeoutError:
            break
        t = clock()
        req = by_key.get(item.metadata.get("key"))
        if req is None or req.t_recv is not None:
            continue
        req.t_recv = t
        req.status = item.metadata.get("status")
        if req.status == "ok":
            req.tokens = np.asarray(item.value)
        t_last = t
        pending -= 1
        if t < t_close:
            send(req.client)
            pending += 1
    return Window(sent, t_first, t_close, t_last)
