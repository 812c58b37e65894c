"""The port's tracer (``repro_torch.runtime.trace``) on the CPU.

Spans nest on a thread with the right parents and self times; nothing is
recorded or kept while tracing is off; a span's stamps map onto the Unix
clock of ``torch.profiler``; a ``torch.profiler`` session turns recording
on for every thread; the cap drops and counts; the model's spans sit where
the layer map says (a tiny hymba prefill has ``attn.core`` spans of both
windows, all on the flash path, and ``ssm.scan`` spans); the kernel's
``flash_attention.window`` counter counts one launch a windowed layer a
prefill (``meta`` tensors stand in for CUDA ones, the launchers for the
kernels); and ``ModelServer``'s ``serve.queue``, ``serve.batch`` and
``serve.reply`` spans carry the requests' keys.
"""

from __future__ import annotations

import json
import threading
import time
import tracemalloc

import numpy as np
import pytest
import torch

from repro_torch.api import ClusterSpec, ServeSpec, Session
from repro_torch.configs import get_smoke_config
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.models import transformer as tx
from repro_torch.runtime import trace
from repro_torch.runtime.serving import ModelServer
from repro_torch.runtime.trace import Tracer

torch.set_num_threads(1)


def _by_name(spans):
    out = {}
    for s in spans:
        out.setdefault(s.name, []).append(s)
    return out


def test_spans_nest_with_parents_and_self_times():
    t = Tracer()
    with t.enabled():
        with t.span("outer", step=1) as outer:
            time.sleep(0.002)
            with t.span("inner") as a:
                time.sleep(0.003)
            with t.span("inner") as b:
                with t.span("leaf") as leaf:
                    time.sleep(0.001)
    spans = t.spans()
    assert [s.name for s in spans] == ["inner", "leaf", "inner", "outer"]
    assert outer.parent is None and outer.attrs == {"step": 1}
    assert a.parent == b.parent == outer.id and leaf.parent == b.id
    assert outer.t0 <= a.t0 <= a.t1 <= b.t0 <= leaf.t0 <= leaf.t1 <= b.t1 <= outer.t1
    ns = lambda s: s.t1 - s.t0  # noqa: E731
    rows = t.summary()
    assert rows["outer"]["count"] == 1 and rows["inner"]["count"] == 2
    assert rows["outer"]["self_ms"] == pytest.approx((ns(outer) - ns(a) - ns(b)) / 1e6)
    assert rows["inner"]["self_ms"] == pytest.approx((ns(a) + ns(b) - ns(leaf)) / 1e6)
    assert rows["leaf"]["self_ms"] == pytest.approx(ns(leaf) / 1e6)
    assert rows["outer"]["host_ms"] == pytest.approx(ns(outer) / 1e6)
    assert rows["outer"]["self_ms"] >= 1.5  # its own 2 ms sleep
    # the CPU has no device events: device time is None, never 0
    assert all(r["device_ms"] is None for r in rows.values())


def test_each_thread_nests_on_its_own():
    t = Tracer()
    seen = {}

    def worker():
        with t.span("worker") as w:
            seen["w"] = w

    with t.enabled(), t.span("main") as main:
        th = threading.Thread(target=worker)
        th.start()
        th.join(timeout=10)
    assert not th.is_alive()
    assert seen["w"].parent is None and seen["w"].thread != main.thread


def test_nothing_is_recorded_or_kept_while_off():
    t = Tracer()
    assert not t.recording()
    off = t.span("x")
    assert t.span("y", device=True, cpu=True, key="k") is off  # one shared object
    tracemalloc.start()
    try:
        before, _ = tracemalloc.get_traced_memory()
        for i in range(20_000):
            with t.span("x", index=i):
                pass
            t.add("y", 0, 1, key="k")
        after, _ = tracemalloc.get_traced_memory()
    finally:
        tracemalloc.stop()
    assert t.spans() == [] and t.dropped == 0
    assert after - before < 4096  # nothing kept from 40,000 span sites
    with t.enabled():
        assert t.span("x") is not off
    assert t.span("x") is off and not t.recording()


def test_counters_are_always_on():
    t = Tracer()
    t.count("k.launch")
    t.count("k.launch", 2)
    t.count("k.pad")
    assert t.counter("k.launch") == 3 and t.counts() == {"k.launch": 3, "k.pad": 1}
    t.reset_counts("k.launch")
    assert t.counter("k.launch") == 0 and t.counter("k.pad") == 1
    t.reset_counts()
    assert t.counts() == {}


def test_the_cap_drops_and_counts():
    t = Tracer(cap=3)
    with t.enabled():
        for i in range(5):
            with t.span("s", i=i):
                pass
        t.add("late", 0, 1)
    assert [s.attrs["i"] for s in t.spans()] == [0, 1, 2]
    assert t.dropped == 3


def test_stamps_map_onto_the_unix_clock(tmp_path):
    unix = time.time_ns()
    mapped = trace.to_unix_ns(time.perf_counter_ns())
    assert abs(mapped - unix) < 50_000_000  # 50 ms: the two reads and any clock slew
    t = Tracer()
    with t.enabled(), t.span("s", cpu=True, key="a") as s:
        time.sleep(0.001)
    path = tmp_path / "spans.json"
    t.export_chrome(str(path))
    doc = json.loads(path.read_text())
    (ev,) = [e for e in doc["traceEvents"] if e["ph"] == "X"]
    assert ev["name"] == "s" and ev["args"]["key"] == "a" and ev["args"]["id"] == s.id
    assert ev["ts"] == pytest.approx(trace.to_unix_ns(s.t0) / 1e3)
    assert ev["dur"] == pytest.approx((s.t1 - s.t0) / 1e3)
    assert abs(ev["ts"] * 1e3 - time.time_ns()) < 60e9
    assert ev["args"]["cpu_ms"] == pytest.approx(s.cpu_ms) and s.cpu_ms >= 0


def test_a_profiler_session_turns_recording_on_for_every_thread():
    """The batcher thread starts before the profiler session; its spans record
    all the same (the C++ flag is per thread; the tracer reads the process's)."""
    t = Tracer()
    go, done = threading.Event(), threading.Event()

    def batcher():
        go.wait(10)
        with t.span("from_thread"):
            pass
        done.set()

    th = threading.Thread(target=batcher)
    th.start()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        assert t.recording()
        go.set()
        assert done.wait(10)
    th.join(timeout=10)
    assert not th.is_alive()
    assert [s.name for s in t.spans()] == ["from_thread"]
    assert not t.recording()


def _inside(span, parent, by_id):
    while span.parent is not None:
        span = by_id[span.parent]
        if span is parent:
            return True
    return False


def test_a_tiny_hymba_prefill_has_both_windows_and_the_scans():
    cfg = get_smoke_config("hymba-1.5b", attention_impl="pallas")
    params = tx.init_params(cfg, torch.Generator().manual_seed(0))
    B, S, G = 2, 28, 3  # the prompt is longer than the window (16)
    tokens = torch.randint(0, cfg.vocab_size, (B, S), generator=torch.Generator().manual_seed(1))
    t0 = time.perf_counter_ns()
    trace.reset_counts(fa_ops.LAUNCHES, fa_ops.WINDOWS)
    with trace.enabled(), torch.inference_mode():
        cache = tx.init_cache(cfg, B, S + G + 1, device="cpu")
        logits, cache = tx.prefill(cfg, params, tokens, cache, tx.RunCtx(decode=True))
        tok = logits[:, -1:].argmax(-1)
        pos = torch.full((B, 1), S, dtype=torch.int64)
        tx.decode_step(cfg, params, cache, tok, pos, tx.RunCtx(decode=True))
    spans = [s for s in trace.spans() if s.t0 >= t0]
    by_id = {s.id: s for s in spans}
    names = _by_name(spans)
    (prefill,) = names["prefill"]
    (step,) = names["decode_step"]
    assert prefill.device and not step.device and step.cpu_ms is not None
    inner = [s for s in spans if _inside(s, prefill, by_id)]
    core = [s for s in inner if s.name == "attn.core"]
    assert sorted({s.attrs["window"] for s in core}) == [0, cfg.sliding_window]
    assert {s.attrs["impl"] for s in core if s.attrs["window"] == 0} == {"flash"}
    # the windowed layers' prompt attention takes the kernel's window too
    assert {s.attrs["impl"] for s in core if s.attrs["window"] > 0} == {"flash"}
    # the CPU runs the plain version, which launches nothing
    assert trace.counter(fa_ops.LAUNCHES) == trace.counter(fa_ops.WINDOWS) == 0
    assert len(core) == cfg.num_layers
    by = _by_name(inner)
    assert len(by["ssm.scan"]) == len(by["layer"]) == cfg.num_layers
    assert len(by["ssm.mix"]) == len(by["attn.proj"]) == 2 * cfg.num_layers
    assert len(by["attn.cache"]) == cfg.num_layers
    assert len(by["norm"]) == 2 * cfg.num_layers + 1
    assert len(by["embed"]) == len(by["logits"]) == 1
    assert [(s.attrs["group"], s.attrs["index"]) for s in by["layer"]] == [
        ("global0", 0), ("local1", 0), ("local1", 1), ("global1", 0)]
    # every module span sits in a layer but the embedding, the final norm and the head
    for s in inner:
        if s.name not in ("layer", "embed", "logits", "norm"):
            assert by_id[s.parent].name == "layer", s
    step_core = [s for s in spans if s.name == "attn.core" and _inside(s, step, by_id)]
    assert {s.attrs["impl"] for s in step_core} == {"decode"}
    assert all(s.device_ms() is None for s in spans)  # the CPU records no events


def _on_meta(tree):
    return tree.to("meta") if isinstance(tree, torch.Tensor) else {
        k: _on_meta(v) for k, v in tree.items()}


@pytest.mark.parametrize("arch, windowed", [("hymba-1.5b", 2), ("phi4-mini-3.8b", 0)])
def test_the_window_counter_counts_each_windowed_layer_of_a_prefill(monkeypatch, arch, windowed):
    """Off the CPU (``meta`` here, the launchers stood in), a prefill with
    ``attention_impl="pallas"`` launches K1 once a layer, and each windowed
    layer's launch (hymba's smoke config: 2 of 4 layers) adds 1 to
    ``flash_attention.window``, once for each windowed ``attn.core`` span;
    phi4 has no window and counts none."""
    launched = []

    def flash(q, k, v, *, causal, scale, window):
        launched.append((causal, window))
        return torch.empty_like(q)

    monkeypatch.setattr(fa_ops, "flash_attention_fwd", flash)
    monkeypatch.setattr(ssd_ops, "ssd_scan_fwd",
                        lambda x, a, b, c, s0, *, chunk: (torch.empty_like(x),
                                                          torch.empty_like(s0)))
    cfg = get_smoke_config(arch, attention_impl="pallas")
    params = _on_meta(tx.init_params(cfg, torch.Generator().manual_seed(0)))
    B, S = 2, 28  # longer than hymba's window of 16
    t0 = time.perf_counter_ns()
    for n in (1, 2):
        trace.reset_counts(fa_ops.LAUNCHES, fa_ops.WINDOWS)
        with trace.enabled(), torch.inference_mode():
            cache = tx.init_cache(cfg, B, S + 1, device="meta")
            tx.prefill(cfg, params, torch.zeros((B, S), dtype=torch.long, device="meta"), cache)
        assert trace.counter(fa_ops.LAUNCHES) == cfg.num_layers
        assert trace.counter(fa_ops.WINDOWS) == windowed
    assert len(launched) == 2 * cfg.num_layers
    assert sorted(w for _, w in launched if w) == [cfg.sliding_window] * 2 * windowed
    assert all(causal for causal, _ in launched)
    core = [s for s in trace.spans() if s.t0 >= t0 and s.name == "attn.core"]
    assert {s.attrs["impl"] for s in core} == {"flash"}
    assert sum(s.attrs["window"] > 0 for s in core) == 2 * windowed


def test_served_requests_carry_their_keys_on_the_server_spans():
    def model_fn(prompts):
        time.sleep(0.01)
        return [np.asarray(p[:2]) for p in prompts]

    t0 = time.perf_counter_ns()
    spec = ClusterSpec(n_workers=1, serve=ServeSpec(max_batch_size=2, max_wait_ms=20))
    with trace.enabled(), Session(cluster=spec, name="trace-keys") as session:
        server = session.serve(model_fn)
        server.attach(session.stream_consumer("requests"), session.stream_producer("responses"))
        requests = session.stream_producer("requests")
        responses = session.stream_consumer("responses")
        keys = [requests.send(np.arange(i, i + 4, dtype=np.int32)) for i in range(5)]
        requests.close()
        got = {item.metadata["key"]: item.value for item in responses}
    assert sorted(got) == sorted(keys)
    spans = [s for s in trace.spans() if s.t0 >= t0]
    by = _by_name(spans)
    assert sorted(s.attrs["key"] for s in by["serve.queue"]) == sorted(keys)
    assert sorted(s.attrs["key"] for s in by["serve.reply"]) == sorted(keys)
    assert sorted(k for s in by["serve.batch"] for k in s.attrs["keys"]) == sorted(keys)
    batch_of = {k: b for b in by["serve.batch"] for k in b.attrs["keys"]}
    for q in by["serve.queue"]:
        b = batch_of[q.attrs["key"]]
        assert q.t1 <= b.t0 and q.parent is None
    for r in by["serve.reply"]:
        b = batch_of[r.attrs["key"]]
        assert b.t1 <= r.t0 <= r.t1
    assert all(b.cpu_ms is not None for b in by["serve.batch"])


def test_server_stats_leave_the_warm_up_out():
    def model_fn(prompts):
        time.sleep(0.05 if prompts[0] == "warm" else 0.0)
        return list(prompts)

    with ModelServer(model_fn, max_batch_size=1, max_wait_ms=0.0) as server:
        server.submit("warm").result(timeout=10)
        assert server.stats()["served"] == 1
        assert server.stats()["latency_p50_ms"] >= 40
        server.reset_stats()
        assert server.stats()["served"] == server.stats()["batches"] == 0
        for i in range(4):
            server.submit(f"r{i}").result(timeout=10)
        st = server.stats()
    assert st["requests"] == st["served"] == st["batches"] == 4
    assert st["latency_p99_ms"] < 40  # the slow warm request is out of the window


def test_a_short_spans_cpu_time_stays_within_its_host_time():
    """The CPU reads lie inside the host interval: over many spans around
    almost nothing the CPU share is at most 100 %, not the reads' own cost
    over the span's."""
    t = Tracer()
    with t.enabled():
        for _ in range(2000):
            with t.span("s", cpu=True):
                pass
    spans = t.spans("s")
    share = sum(s.cpu_ms for s in spans) / sum(s.host_ms for s in spans)
    assert 0 < share <= 1.0 + 1e-3, share
