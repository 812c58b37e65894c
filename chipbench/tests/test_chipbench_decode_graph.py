"""`decode_graph_share`: the share of the window's decode steps that
replayed a captured CUDA graph, read from the `decode_step` spans' `graph`
attribute.  On the CPU every step runs eagerly (0 %); on the card the tiny
cells replay.
"""

from __future__ import annotations

import json
import time

import pytest
import torch

from chipbench import registry, run
from chipbench.loadgen import Traffic, Window
from chipbench.record import Run
from conftest import add_tiny_cells

NAME = "decode_graph_share"


def _run_over(t0_s: float, t1_s: float) -> Run:
    tr = Traffic("t", "closed", 2, 4, 8, 4, 1.0)
    return Run("w", {"family": "dense"}, "bfloat16", tr, Window([], t0_s, t1_s, t1_s), [],
               1.0, 1)


def _window_with(*attrs: dict) -> Run:
    """A run whose window holds one `decode_step` span per entry of attrs."""
    from repro_torch.runtime import trace

    t0 = time.perf_counter_ns()
    with trace.enabled():
        for i, a in enumerate(attrs):
            trace.add("decode_step", t0 + 10 * i + 1, t0 + 10 * i + 5, **a)
    return _run_over(t0 / 1e9, (t0 + 10 * len(attrs) + 10) / 1e9)


def test_the_entry_and_its_file():
    bench = registry.benchmark()
    (entry,) = [m for m in bench["per_layer"] if m["name"] == NAME]
    assert entry["layer"] == "driver" and entry["moves"] == "output_tok_s"
    assert entry["unit"] == "%" and entry["better"] == "higher"
    assert set(entry["workloads"]) == {w["name"] for w in bench["workloads"]}
    assert callable(registry.metric_reader(NAME))


@pytest.mark.parametrize("modes,want", [
    (["replay"] * 15, 100.0),
    (["eager", "capture"] + ["replay"] * 13, 100.0 * 13 / 15),
    (["eager"] * 4, 0.0),
])
def test_the_share_of_replayed_steps(modes, want):
    r = _window_with(*({"graph": m} for m in modes))
    assert registry.metric_reader(NAME)(r) == pytest.approx(want)


def test_steps_without_the_attribute_leave_the_metric_out():
    """The parent of the change that added the graphs records steps with no
    `graph` attribute: the metric leaves itself out, and raises nothing."""
    read = registry.metric_reader(NAME)
    assert read(_window_with({}, {})) is None
    assert read(_window_with()) is None


def test_a_tiny_cpu_cell_reads_zero(bench_copy):
    cell = add_tiny_cells(bench_copy, "float32")[0]
    bench_file = bench_copy.parent / "BENCHMARK.json"
    bench = json.loads(bench_file.read_text())
    for m in bench["per_layer"]:
        if m["name"] == NAME:
            m["workloads"].append(cell)
    bench_file.write_text(json.dumps(bench))
    out = run.run_cell(cell, 2**31 + 19, 1.0, True, torch.device("cpu"), root=bench_copy)
    assert out["correct"], out["check"]
    assert out["metrics"][NAME] == {"value": 0.0, "unit": "%"}


@pytest.mark.card
@pytest.mark.parametrize("family", [0, 1], ids=["dense", "hybrid"])
def test_a_tiny_card_cell_replays(bench_copy, card, family):
    cell = add_tiny_cells(bench_copy, "bfloat16")[family]
    bench_file = bench_copy.parent / "BENCHMARK.json"
    bench = json.loads(bench_file.read_text())
    for m in bench["per_layer"]:
        if m["name"] == NAME:
            m["workloads"].append(cell)
    bench_file.write_text(json.dumps(bench))
    out = run.run_cell(cell, 2**31 + 31, 2.0, True, card, root=bench_copy)
    assert out["correct"], out["check"]
    assert out["metrics"][NAME]["value"] > 50.0, out["metrics"]
