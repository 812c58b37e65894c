"""Fixtures of the benchmark's CPU tests: a copy of ``chipbench`` with tiny
cells added as files, as a later change would add them.

Run from the repository's root: ``python -m pytest chipbench/tests -q``.
Tests marked ``card`` need a CUDA device and skip without one.
"""

from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
for p in (str(REPO), str(REPO / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

#: tiny sizes of the two families (the port's smoke shapes)
TINY_MODELS = {
    "phi4-mini-3.8b": {"num_layers": 2, "d_model": 64, "num_heads": 4, "num_kv_heads": 2,
                       "head_dim": 16, "d_ff": 128, "vocab_size": 256},
    "hymba-1.5b": {"num_layers": 4, "d_model": 64, "num_heads": 4, "num_kv_heads": 2,
                   "head_dim": 16, "d_ff": 128, "vocab_size": 256, "sliding_window": 16,
                   "global_layers": [0, 3],
                   "ssm": {"d_state": 8, "d_conv": 4, "expand": 2, "head_dim": 16,
                           "chunk": 16}},
}
TINY_TRAFFIC = {"loop": "closed", "batch": 2, "clients": 4, "prompt_len": 40, "gen": 6,
                "max_wait_ms": 20}
#: the tiny cells' logit-gap limits.  Float32: program and reference agree to
#: rounding, so any fault shows.  Bfloat16, from CPU readings on seeds 0-3:
#: the program's widest gaps 0.0031-0.0055 (dense) and 0.0037-0.025 (hybrid),
#: the fp8 control's 0.049-0.098 and 0.28-1.08.
TINY_GAP_LIMIT = {"float32": {"phi4-mini-3.8b": 1e-3, "hymba-1.5b": 1e-3},
                  "bfloat16": {"phi4-mini-3.8b": 0.015, "hymba-1.5b": 0.1}}


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA device (skips without one)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; this machine has none")
    return torch.device("cuda", 0)


def add_tiny_cells(root: Path, dtype: str = "float32") -> list[str]:
    """Add a tiny configuration per family, a tiny traffic mix, their checks
    and their cells to the copy at ``root`` (its ``chipbench`` folder)."""
    bench = json.loads((root.parent / "BENCHMARK.json").read_text())
    names = []
    for arch, sizes in TINY_MODELS.items():
        spec = json.loads((root / "configs" / f"{arch}.json").read_text())
        cname = f"tiny-{arch}-{dtype}"
        spec["name"] = cname
        spec["param_dtype"] = spec["compute_dtype"] = dtype
        spec["model"].update(sizes)
        (root / "configs" / f"{cname}.json").write_text(json.dumps(spec))
        cell = f"{cname}-cell"
        bench["workloads"].append({"name": cell, "config": cname, "traffic": "tiny",
                                   "chips": 1, "why": "test"})
        for m in bench["end_to_end"] + bench["per_layer"]:
            if m["name"] in ("output_tok_s", "setup_s", "latency_p95_ms", "prefill_ms",
                             "decode_step_ms", "mfu", "queue_ms.p50") and "workloads" in m:
                m["workloads"].append(cell)
        (root / "checks" / f"{cell}.json").write_text(json.dumps(
            {"sample_requests": 64, "limits": {"logit_gap": TINY_GAP_LIMIT[dtype][arch]}}))
        names.append(cell)
    (root / "traffic" / "tiny.json").write_text(json.dumps(TINY_TRAFFIC))
    (root.parent / "BENCHMARK.json").write_text(json.dumps(bench))
    return names


def shapes(tree, prefix=""):
    """{path: shape} of a tensor tree, in the tree's order."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out |= shapes(v, f"{prefix}{k}/")
        else:
            out[prefix + k] = tuple(v.shape)
    return out


def published_gaps(root: Path, entry: dict) -> dict:
    """The keys of configuration ``entry``'s ``published`` block that the
    port's config built from its file does not run, outside its
    ``reduced``: ``{key: (published, run)}``, read by the family file's
    ``PUBLISHED``.  A key the family does not read, or reads and the block
    lacks, is a gap too."""
    from repro_torch.configs import get_config

    from chipbench import registry, run

    spec = registry.config(entry["name"], root)
    cfg = run.port_config(get_config, spec)
    reads = registry.family(spec["model"]["family"], root).PUBLISHED
    block = spec["published"]
    gaps = {}
    for key in sorted((set(block) | set(reads)) - set(entry["reduced"])):
        have = reads[key](cfg) if key in reads else "not read"
        if key not in block or block[key] != have:
            gaps[key] = (block.get(key, "not stated"), have)
    return gaps


@pytest.fixture
def bench_copy(tmp_path) -> Path:
    """A copy of ``chipbench`` and ``BENCHMARK.json``; returns its
    ``chipbench`` folder."""
    root = tmp_path / "chipbench"
    shutil.copytree(REPO / "chipbench", root,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(REPO / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    return root
