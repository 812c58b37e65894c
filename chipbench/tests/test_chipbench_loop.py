"""The closed loop keeps C requests in flight, stops sending when the window
closes, and waits for and counts what is in flight then; the rate and the
tail are taken over all requests."""

from __future__ import annotations

import threading
import time

import numpy as np
import pytest

from chipbench import loadgen, record
from chipbench.adapter import Batch


def _session(batch):
    from repro_torch.api import ClusterSpec, ServeSpec, Session

    spec = ClusterSpec(n_workers=1, serve=ServeSpec(max_batch_size=batch, max_wait_ms=20))
    return Session(cluster=spec, name="chipbench-test-loop")


def test_closed_loop_in_flight_close_and_drain():
    B, C, T = 2, 4, 0.05
    lock = threading.Lock()
    state = {"in_flight": 0, "most": 0}

    def model_fn(prompts):
        time.sleep(T)
        return [np.asarray(p[:3]) for p in prompts]

    with _session(B) as session:
        server = session.serve(model_fn)
        server.attach(session.stream_consumer("requests"), session.stream_producer("responses"))
        requests = session.stream_producer("requests")
        responses = session.stream_consumer("responses")

        class Counting:
            def send(self, value):
                with lock:
                    state["in_flight"] += 1
                    state["most"] = max(state["most"], state["in_flight"])
                return requests.send(value)

        class Receiving:
            def recv(self, timeout=None):
                item = responses.recv(timeout=timeout)
                with lock:
                    state["in_flight"] -= 1
                return item

        w = loadgen.closed_loop(Counting(), Receiving(), clients=C, seconds=0.6,
                                make_prompt=lambda i: loadgen.prompt(5, i, 8, 100))
        requests.close()
    assert state["most"] == C
    assert all(r.t_send < w.t_close for r in w.requests)
    assert all(r.ok for r in w.requests)
    assert any(r.t_recv > w.t_close for r in w.requests)     # the drain counts
    assert w.t_last == max(r.t_recv for r in w.requests)
    # each client's requests follow one another: the next is sent after the reply
    for c in range(C):
        mine = [r for r in w.requests if r.client == c]
        assert all(a.t_recv <= b.t_send for a, b in zip(mine, mine[1:]))
    # replies carry the prompt's first tokens: they came back to the right request
    for r in w.requests:
        assert np.array_equal(r.tokens, loadgen.prompt(5, r.index, 8, 100)[:3])


def test_prompts_repeat_by_seed():
    a = loadgen.prompt(2**31 + 11, 4, 16, 200064)
    assert np.array_equal(a, loadgen.prompt(2**31 + 11, 4, 16, 200064))
    assert not np.array_equal(a, loadgen.prompt(2**31 + 11, 5, 16, 200064))
    assert a.dtype == np.int32 and a.max() < 200064


def _run(latencies_by_batch, gen=4):
    """A finished run of batches of two requests sent together."""
    reqs, batches, t = [], [], 0.0
    for lat in latencies_by_batch:
        contents = []
        for j, extra in enumerate((0.0, 0.001)):
            i = len(reqs)
            r = loadgen.Request(i, j, f"k{i}", bytes([i]), t)
            r.t_recv, r.status, r.tokens = t + lat + extra, "ok", np.zeros(gen)
            reqs.append(r)
            contents.append(r.content)
        batches.append(Batch(t, t, t, t, t + lat, 2, contents))
        t += 0.1
    w = loadgen.Window(reqs, 0.0, t, max(r.t_recv for r in reqs))
    tr = loadgen.Traffic("t", "closed", 2, 4, 8, gen, 1.0)
    return record.Run("w", {}, "bfloat16", tr, w, batches, 1.0, 1)


def test_rate_and_tail_over_all_requests():
    from chipbench.registry import metric_reader

    lats = [0.2] * 18 + [0.9, 1.0]
    run = _run(lats)
    n = len(run.requests)
    assert metric_reader("output_tok_s")(run) == pytest.approx(4 * n / run.window_s)
    all_lat = [r.latency_ms for r in run.requests]
    assert metric_reader("latency_p95_ms")(run) == pytest.approx(np.percentile(all_lat, 95))
    # not the tail of the batches' latencies
    assert metric_reader("latency_p95_ms")(run) != pytest.approx(
        np.percentile([1e3 * x for x in lats], 95))
    assert metric_reader("queue_ms.p50")(run) == pytest.approx(0.0)
