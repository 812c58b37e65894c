"""The per-layer metrics that read the program's own spans.

On the CPU the tiny cells run traced: the host-span metrics report, the
device ones (device time, launches) find nothing to read and are left out.
On the card a span around N known launches meets exactly N launch calls of
the device trace, and every span metric reports in a tiny cell.
"""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from chipbench import registry, run, spans
from chipbench.devtrace import DeviceTrace, collect
from conftest import add_tiny_cells

#: the metrics that read the program's spans, and whether they read the device
SPAN_METRICS = {
    "attn_prefill_roofline.span": True,
    "ssd_prefill_roofline.span": True,
    "window_attn_prefill_roofline": True,
    "prefill_device_ms": True,
    "decode_launches_per_step": True,
    "decode_cpu_share": False,
    "server_queue_ms.p50": False,
    "server_reply_ms.p50": False,
}
#: those that read what only a hybrid model has
HYBRID_ONLY = {"ssd_prefill_roofline.span", "window_attn_prefill_roofline"}


def test_every_span_metric_has_an_entry_and_a_file():
    bench = registry.benchmark()
    entries = {m["name"]: m for m in bench["per_layer"]}
    cells = {w["name"] for w in bench["workloads"]}
    for name in SPAN_METRICS:
        entry = entries[name]
        assert callable(registry.metric_reader(name)), name
        assert entry["workloads"] and set(entry["workloads"]) <= cells, name
        assert entry["moves"] in {m["name"] for m in bench["end_to_end"]}, name


def _with_span_metrics(root, dtype):
    """Tiny cells in a copy, each added to the span metrics' cells."""
    cells = add_tiny_cells(root, dtype)
    bench_file = root.parent / "BENCHMARK.json"
    bench = json.loads(bench_file.read_text())
    for m in bench["per_layer"]:
        if m["name"] in SPAN_METRICS:
            m["workloads"] += [c for c in cells if m["name"] not in HYBRID_ONLY or "hymba" in c]
    bench_file.write_text(json.dumps(bench))
    return cells


@pytest.mark.parametrize("family", [0, 1], ids=["dense", "hybrid"])
def test_host_span_metrics_report_on_the_cpu(bench_copy, family):
    cell = _with_span_metrics(bench_copy, "float32")[family]
    out = run.run_cell(cell, 2**31 + 17, 1.0, True, torch.device("cpu"), root=bench_copy)
    assert out["correct"], out["check"]
    got = out["metrics"]
    for name, on_device in SPAN_METRICS.items():
        assert (name in got) is not on_device, (name, got.get(name))
    assert 0 < got["decode_cpu_share"]["value"] <= 100.0 + 1e-6
    assert got["server_queue_ms.p50"]["value"] >= 0
    assert got["server_reply_ms.p50"]["value"] >= 0
    assert got["server_queue_ms.p50"]["unit"] == "ms"


def test_readers_of_a_program_without_a_tracer_return_none(monkeypatch):
    """The parent of the change that added the spans has no tracer module:
    every span metric leaves itself out, none raises."""
    from chipbench.loadgen import Traffic, Window
    from chipbench.record import Run

    monkeypatch.setattr(spans, "TRACER", "repro_torch.runtime.no_such_module")
    tr = Traffic("t", "closed", 2, 4, 8, 4, 1.0)
    trace = DeviceTrace([], np.zeros(0, np.int64), np.zeros(0, np.int64),
                        ["cudaLaunchKernel"], np.array([5], np.int64), np.array([6], np.int64),
                        0, 10)
    r = Run("w", {"family": "hybrid"}, "bfloat16", tr, Window([], 0.0, 1.0, 1.0), [], 1.0, 1,
            trace)
    for name in SPAN_METRICS:
        assert registry.metric_reader(name)(r) is None, name


def test_enqueue_calls_are_counted_where_they_start():
    from repro_torch.runtime.trace import UNIX_OFFSET_NS, Tracer

    t = Tracer()
    with t.enabled():
        t.add("decode_step", 100, 200)
        t.add("decode_step", 300, 400)
    names = ["cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cudaMemcpyAsync",
             "cudaMemsetAsync", "cudaStreamSynchronize", "cudaLaunchKernel"]
    starts = np.array([100, 150, 199, 300, 350, 360, 400], np.int64) + UNIX_OFFSET_NS
    trace = DeviceTrace([], np.zeros(0, np.int64), np.zeros(0, np.int64), names, starts,
                        starts + 1, 0, 1 << 62)
    # the sync is no enqueue and the last call starts at the span's end
    assert spans.enqueue_calls_in(trace, t.spans()) == 5
    none = DeviceTrace([], np.zeros(0, np.int64), np.zeros(0, np.int64), ["cudaFree"],
                       starts[:1], starts[:1] + 1, 0, 1 << 62)
    assert spans.enqueue_calls_in(none, t.spans()) is None


@pytest.mark.card
def test_a_span_around_n_launches_reads_n_launch_calls(card):
    from repro_torch.runtime import trace

    x = torch.zeros(1024, device=card)
    x.add_(1)  # load the kernel before the trace
    torch.cuda.synchronize(card)
    prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA])
    prof.start()
    assert trace.recording()  # the harness's CUDA-only session turns the spans on
    with trace.span("n_launches") as s:
        for _ in range(37):
            x.add_(1)
    torch.cuda.synchronize(card)
    prof.stop()
    assert float(x[0]) == 38.0
    dt = collect(prof, trace.to_unix_ns(s.t0), trace.to_unix_ns(s.t1))
    assert spans.enqueue_calls_in(dt, [s]) == 37


@pytest.mark.card
@pytest.mark.parametrize("family", [0, 1], ids=["dense", "hybrid"])
def test_every_span_metric_reports_in_a_tiny_card_cell(bench_copy, card, family):
    cell = _with_span_metrics(bench_copy, "bfloat16")[family]
    out = run.run_cell(cell, 2**31 + 29, 2.0, True, card, root=bench_copy)
    assert out["correct"], out["check"]
    got = out["metrics"]
    want = [n for n in SPAN_METRICS if family == 1 or n not in HYBRID_ONLY]
    assert all(n in got for n in want), sorted(set(want) - set(got))
    assert got["decode_launches_per_step"]["value"] > 0
    assert 0 < got["decode_cpu_share"]["value"] <= 100.0 + 1e-6
    for name in ("attn_prefill_roofline.span", "ssd_prefill_roofline.span",
                 "window_attn_prefill_roofline"):
        if name in got:
            assert 0 < got[name]["value"] < 105.0, (name, got[name])
