"""Cells, configurations, traffic, checks, metrics and references are found
by name, and a new one is taken up by adding files alone."""

from __future__ import annotations

import json

import torch

from chipbench import registry, run
from chipbench.loadgen import Traffic
from conftest import add_tiny_cells


def test_every_cell_resolves():
    bench = registry.benchmark()
    names = {m["name"] for m in bench["end_to_end"] + bench["per_layer"]}
    for m in names:
        assert callable(registry.metric_reader(m)), m
    for cell in bench["workloads"]:
        spec = registry.config(cell["config"])
        Traffic.from_file(cell["traffic"], registry.traffic(cell["traffic"]))
        assert registry.check(cell["name"])["limits"]["logit_gap"] > 0
        assert hasattr(registry.reference(spec["reference"]), "logits")
        for trace in (False, True):
            assert registry.metrics_for(bench, cell["name"], trace), (cell["name"], trace)


def test_setup_s_belongs_to_every_cell_and_every_later_one():
    """``setup_s`` names no cells, so a cell that a later entry adds
    reports it without an edit of the entry."""
    bench = registry.benchmark()
    (setup,) = [m for m in bench["end_to_end"] if m["name"] == "setup_s"]
    assert "workloads" not in setup
    later = {"name": "a-later-cell"}
    for cell in bench["workloads"] + [later]:
        names = [m["name"] for m in registry.metrics_for(bench, cell["name"], False)]
        assert "setup_s" in names, cell["name"]


#: the sources' widths and depths, by their config.json keys (HF
#: microsoft/Phi-4-mini-instruct and nvidia/Hymba-1.5B-Base)
PUBLISHED = {
    "phi4-mini-3.8b": {"num_hidden_layers": 32, "hidden_size": 3072,
                       "num_attention_heads": 24, "num_key_value_heads": 8,
                       "intermediate_size": 8192, "vocab_size": 200064,
                       "tie_word_embeddings": True, "rope_theta": 10000.0},
    "hymba-1.5b": {"num_hidden_layers": 32, "hidden_size": 1600,
                   "num_attention_heads": 25, "num_key_value_heads": 5,
                   "intermediate_size": 5504, "vocab_size": 32001,
                   "tie_word_embeddings": False, "rope_theta": 10000.0,
                   "sliding_window": 1024, "global_attn_idx": [0, 15, 31],
                   "mamba_expand": 2, "mamba_d_state": 16, "mamba_d_conv": 4},
}


def test_config_files_state_the_published_widths():
    """What runs has the sources' widths and depth: the port's config built
    from each file, not the port's model zoo, is held to the published keys."""
    from repro_torch.configs import get_config

    for entry in registry.benchmark()["configs"]:
        spec = registry.config(entry["name"])
        cfg = run.port_config(get_config, spec)
        pub = PUBLISHED[entry["name"]]
        assert entry["reduced"] == []
        assert (cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.d_ff,
                cfg.vocab_size, cfg.tie_embeddings, cfg.rope_theta) == (
            pub["num_hidden_layers"], pub["hidden_size"], pub["num_attention_heads"],
            pub["num_key_value_heads"], pub["intermediate_size"], pub["vocab_size"],
            pub["tie_word_embeddings"], pub["rope_theta"])
        assert cfg.head_dim == pub["hidden_size"] // pub["num_attention_heads"]
        if "mamba_expand" in pub:
            assert cfg.sliding_window == pub["sliding_window"]
            assert list(cfg.global_layers) == pub["global_attn_idx"]
            assert cfg.ssm.d_inner(cfg.d_model) == pub["mamba_expand"] * pub["hidden_size"]
            assert (cfg.ssm.d_state, cfg.ssm.d_conv) == (pub["mamba_d_state"],
                                                         pub["mamba_d_conv"])
        else:
            assert cfg.ssm is None and not cfg.sliding_window
        dt = run.DTYPES[spec["param_dtype"]]
        assert cfg.param_dtype == cfg.compute_dtype == dt == torch.bfloat16
        assert cfg.attention_impl == "pallas"
        assert entry["file"] == f"chipbench/configs/{entry['name']}.json"


def test_new_cell_taken_up_from_files(bench_copy, monkeypatch):
    """A configuration, traffic mix, check, per-layer metric and cell added as
    files and entries in a copy run with no edit of the harness."""
    cells = add_tiny_cells(bench_copy)
    (bench_copy / "metrics" / "batches_seen.py").write_text(
        "def read(run):\n    return float(len(run.batches))\n")
    bench_file = bench_copy.parent / "BENCHMARK.json"
    bench = json.loads(bench_file.read_text())
    bench["per_layer"].append({"name": "batches_seen", "unit": "batches", "better": "higher",
                               "source": "host_clock", "layer": "driver",
                               "moves": "output_tok_s", "workloads": [cells[0]]})
    bench_file.write_text(json.dumps(bench))
    assert registry.config("tiny-phi4-mini-3.8b-float32", bench_copy)["model"]["d_model"] == 64
    out = run.run_cell(cells[0], 11, 1.0, True, torch.device("cpu"), root=bench_copy)
    assert out["correct"], out["check"]
    assert out["metrics"]["batches_seen"]["value"] >= 1
    assert out["metrics"]["batches_seen"]["unit"] == "batches"
    assert list(out)[-1] == "check"
