"""A model family is taken up from files alone: a third one, the port's MoE
decoder with latent attention at the smoke sizes of deepseek-v2-lite-16b,
added to a copy of ``chipbench`` as its family file, reference,
configuration, traffic, check and ``BENCHMARK.json`` entries
(``tests/data/moe``), runs correct with no edit of a file the copy had."""

from __future__ import annotations

import hashlib
import json
import shutil
from pathlib import Path

import torch

from chipbench import registry, run
from chipbench.record import Run
from chipbench.work import PEAK_FLOPS
from conftest import published_gaps, shapes

DATA = Path(__file__).resolve().parent / "data" / "moe"
CELL = "tiny-deepseek-v2-lite-cell"


def _files(top: Path) -> dict[Path, str]:
    return {p: hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(top.rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


def _add_family(root: Path) -> dict:
    """Copy the data's files into the copy at ``root`` (none may be there
    yet) and append its entries to ``BENCHMARK.json``; returns the entries."""
    entries = json.loads((DATA / "benchmark.json").read_text())
    for src in _files(DATA):
        if src.name == "benchmark.json":
            continue
        dst = root / src.relative_to(DATA)
        assert not dst.exists(), dst
        shutil.copy(src, dst)
    bench_file = root.parent / "BENCHMARK.json"
    bench = json.loads(bench_file.read_text())
    bench["configs"] += entries["configs"]
    bench["workloads"] += entries["workloads"]
    for m in bench["end_to_end"] + bench["per_layer"]:
        if m["name"] in entries["reports"]:
            m["workloads"] += [w["name"] for w in entries["workloads"]]
    bench_file.write_text(json.dumps(bench))
    return entries


def _entries_only_grew(old: dict, new: dict) -> None:
    """Every entry ``old`` had is in ``new`` as it was, save cells appended
    to a metric's ``workloads``."""
    assert set(old) == set(new)
    for key, value in old.items():
        if not isinstance(value, list):
            assert new[key] == value, key
            continue
        assert new[key][:len(value)] == [
            {**e, "workloads": new[key][i]["workloads"]} if "workloads" in e else e
            for i, e in enumerate(value)], key
        for i, e in enumerate(value):
            if "workloads" in e:
                assert new[key][i]["workloads"][:len(e["workloads"])] == e["workloads"]


def test_a_third_family_runs_from_files_alone(bench_copy, monkeypatch):
    before = _files(bench_copy.parent)
    old_bench = json.loads((bench_copy.parent / "BENCHMARK.json").read_text())
    entries = _add_family(bench_copy)
    (config,) = entries["configs"]
    assert published_gaps(bench_copy, config) == {}

    runs: list[Run] = []

    class Kept(Run):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            runs.append(self)

    monkeypatch.setattr(run, "Run", Kept)
    plain = run.run_cell(CELL, 2**31 + 41, 1.0, False, torch.device("cpu"), root=bench_copy)
    traced = run.run_cell(CELL, 2**31 + 43, 1.0, True, torch.device("cpu"), root=bench_copy)
    for out in (plain, traced):
        assert out["correct"], out["check"]
        assert out["failed"] == 0 and out["attempted"] > 0
    assert {"output_tok_s", "setup_s"} <= set(plain["metrics"])
    assert set(traced["metrics"]) == {"mfu"}

    # mfu counts the work the family file says a request needs
    r = runs[-1]
    assert r.family.__name__.endswith("moe") and r.model["family"] == "moe"
    t = r.traffic
    fam = registry.family("moe", bench_copy)
    need = fam.request_flops(r.model, t.prompt_len, t.gen) * len(r.done)
    assert traced["metrics"]["mfu"]["value"] == 100.0 * need / (r.window_s
                                                                 * PEAK_FLOPS[r.dtype])

    after = _files(bench_copy.parent)
    changed = [p for p, h in before.items() if after.get(p) != h]
    assert changed == [bench_copy.parent / "BENCHMARK.json"], changed
    _entries_only_grew(old_bench, json.loads(changed[0].read_text()))


def test_the_family_layout_is_the_ports_tree(bench_copy):
    """``weights.make`` of the data's family layout has ``init_params``'
    leaves in ``init_params``' order, shapes included."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer

    from chipbench import weights

    entries = _add_family(bench_copy)
    spec = registry.config(entries["configs"][0]["name"], bench_copy)
    fam = registry.family("moe", bench_copy)
    mine = weights.make(fam.layout(spec["model"]), 7, torch.device("cpu"), torch.float32)
    cfg = run.port_config(get_config, spec)
    theirs = transformer.init_params(cfg, torch.Generator().manual_seed(0))
    assert list(shapes(mine).items()) == list(shapes(theirs).items())
