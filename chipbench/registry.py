"""Find a cell's pieces by name: configuration, traffic, check, metrics, model
family, reference.

``root`` is the ``chipbench`` directory (a test passes a copy of it) and
``BENCHMARK.json`` sits in its parent.  A later cell, configuration, traffic
mix, metric, family or reference is taken up by adding its file and its entry.
"""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path
from types import ModuleType
from typing import Any, Callable

ROOT = Path(__file__).resolve().parent


def benchmark(root: Path = ROOT) -> dict[str, Any]:
    with open(Path(root).parent / "BENCHMARK.json") as f:
        return json.load(f)


def _by_name(entries: list[dict], name: str, what: str) -> dict:
    for entry in entries:
        if entry["name"] == name:
            return entry
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def _json(root: Path, folder: str, name: str) -> dict[str, Any]:
    path = Path(root) / folder / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"{folder}/{name}.json is missing under {root}")
    with open(path) as f:
        return json.load(f)


def workload(bench: dict, name: str) -> dict[str, Any]:
    return _by_name(bench["workloads"], name, "workload")


def config(name: str, root: Path = ROOT) -> dict[str, Any]:
    return _json(root, "configs", name)


def traffic(name: str, root: Path = ROOT) -> dict[str, Any]:
    return _json(root, "traffic", name)


def check(workload_name: str, root: Path = ROOT) -> dict[str, Any]:
    return _json(root, "checks", workload_name)


def _load(path: Path, prefix: str) -> ModuleType:
    if not path.is_file():
        raise FileNotFoundError(f"{path} is missing")
    mod_name = prefix + re.sub(r"\W", "_", path.stem)
    spec = importlib.util.spec_from_file_location(mod_name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def metric_reader(name: str, root: Path = ROOT) -> Callable[[Any], float | None]:
    """``metrics/<name>.py``'s ``read``: the metric from a finished run, or
    None where the run has nothing to read it from."""
    return _load(Path(root) / "metrics" / f"{name}.py", "chipbench_metric_").read


def family(name: str, root: Path = ROOT) -> ModuleType:
    """``families/<name>.py``: the layer stacks, weight layout, request work
    and published keys of the configurations whose ``model["family"]`` is
    ``name``."""
    return _load(Path(root) / "families" / f"{name}.py", "chipbench_family_")


def reference(family: str, root: Path = ROOT) -> ModuleType:
    return _load(Path(root) / "reference" / f"{family}.py", "chipbench_reference_")


def metrics_for(bench: dict, workload_name: str, trace: bool) -> list[dict[str, Any]]:
    """The metrics a run of the cell prints: its end-to-end metrics without
    the trace, its per-layer metrics with it; an entry without a
    ``workloads`` list belongs to every cell."""
    entries = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in entries if workload_name in m.get("workloads", [workload_name])]
