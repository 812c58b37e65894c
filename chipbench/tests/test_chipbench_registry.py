"""Cells, configurations, traffic, checks, metrics and references are found
by name, and a new one is taken up by adding files alone."""

from __future__ import annotations

import json

import pytest
import torch
from repro_torch.configs import get_config
from repro_torch.models import transformer
from repro_torch.models.common import MLAConfig, MoEConfig, SSMConfig

from chipbench import registry, run
from chipbench.loadgen import Traffic
from conftest import REPO, add_tiny_cells, published_gaps


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


def test_config_files_state_the_published_widths():
    """What runs has the sources' widths and depth: the port's config built
    from each file, not the port's model zoo, is held to the file's own
    ``published`` block, each key read off the config by the family's
    ``PUBLISHED``; every nested group of the port's config is the file's."""
    for entry in registry.benchmark()["configs"]:
        spec = registry.config(entry["name"])
        assert entry["reduced"] == []
        assert published_gaps(REPO / "chipbench", entry) == {}, entry["name"]
        cfg = run.port_config(get_config, spec)
        groups = registry.family(spec["model"]["family"]).layer_groups(spec["model"])
        assert groups == [(g.name, g.count, g.window) for g in transformer.layer_groups(cfg)]
        assert {w for _, _, w in groups} - {0} == {cfg.sliding_window} - {0}
        for nested in ("moe", "ssm", "mla"):
            assert (getattr(cfg, nested) is None) == (nested not in spec["model"]), nested
        dt = run.DTYPES[spec["param_dtype"]]
        assert cfg.param_dtype == cfg.compute_dtype == dt == torch.bfloat16
        assert cfg.attention_impl == "pallas"
        assert entry["file"] == f"chipbench/configs/{entry['name']}.json"


#: the first benchmark's configs as its ``port_config`` built them, field by field
PARENT_PORT_CONFIGS = {
    "phi4-mini-3.8b": dict(
        name="phi4-mini-3.8b", family="dense", num_layers=32, d_model=3072, num_heads=24,
        num_kv_heads=8, d_ff=8192, vocab_size=200064, head_dim=128, qkv_bias=False,
        rope_theta=10000.0, tie_embeddings=True, moe=None, ssm=None, mla=None,
        sliding_window=0, global_layers=(), param_dtype=torch.bfloat16,
        compute_dtype=torch.bfloat16, attention_impl="pallas"),
    "hymba-1.5b": dict(
        name="hymba-1.5b", family="hybrid", num_layers=32, d_model=1600, num_heads=25,
        num_kv_heads=5, d_ff=5504, vocab_size=32001, head_dim=64, qkv_bias=False,
        rope_theta=10000.0, tie_embeddings=False, moe=None, ssm=SSMConfig(16, 4, 2, 64, 128),
        mla=None, sliding_window=1024, global_layers=(0, 15, 31), param_dtype=torch.bfloat16,
        compute_dtype=torch.bfloat16, attention_impl="pallas"),
}


@pytest.mark.parametrize("name", sorted(PARENT_PORT_CONFIGS))
def test_port_config_is_the_first_benchmarks(name):
    """The files' port configs are what they were before ``port_config`` took
    nested groups by the port's field types: every field of the port's
    ``ModelConfig``, those the file leaves out at the zoo's value."""
    want = get_config(name).replace(**PARENT_PORT_CONFIGS[name])
    assert run.port_config(get_config, registry.config(name)) == want


def test_port_config_takes_nested_groups_by_field_type():
    """An object becomes the dataclass the port's field declares, over the
    zoo's own, and a list a tuple where the field is one."""
    spec = registry.config("hymba-1.5b")
    spec["port_arch"] = "deepseek-v2-lite-16b"
    spec["model"] = {"norm_eps": 1e-6, "family": "moe", "global_layers": [2],
                     "moe": {"top_k": 3}, "mla": {"kv_lora_rank": 64}, "ssm": {"d_state": 8}}
    cfg = run.port_config(get_config, spec)
    zoo = get_config("deepseek-v2-lite-16b")
    assert cfg.global_layers == (2,)
    assert cfg.moe == MoEConfig(**{**vars(zoo.moe), "top_k": 3})
    assert cfg.mla == MLAConfig(**{**vars(zoo.mla), "kv_lora_rank": 64})
    assert cfg.ssm == SSMConfig(d_state=8)   # the zoo has none: the class's defaults
    spec["model"]["norm_eps"] = 1e-5
    with pytest.raises(ValueError, match="norm_eps"):
        run.port_config(get_config, spec)


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
