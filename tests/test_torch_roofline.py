"""The H100 roofline of the dry-run (``repro_torch.launch.roofline``).

* Its terms are the counts over the stated rates (989 TF/s, 3.35 TB/s, 50
  GB/s or NVLink's 450 GB/s), and the verdict between the two programs is
  compute + collective time.
* Over the committed artifacts: every cell the reference's rule keeps (64)
  has the reference's cell beside it, and in none is the reference's
  compute + collective time smaller than the port's by more than 1.25x
  (ROADMAP §3's dry-run fault stays closed); the same-work cells of the
  band are named.
"""

from __future__ import annotations

import json

import pytest
import torch

from repro_torch.launch import roofline

torch.set_num_threads(1)


def _cell(flops: float, nbytes: float, coll: float, args: int = 1000, **kw) -> dict:
    return {"arch": "a", "shape": "decode_32k", "mesh": "single",
            "hlo_analysis": {"flops": flops, "bytes": nbytes,
                             "collectives": {"total": coll}},
            "memory_analysis": {"argument_size_in_bytes": args}, **kw}


def test_terms_are_the_counts_over_the_rates():
    t = roofline.terms(_cell(989e12, 3.35e12, 50e9))
    assert t["compute"] == pytest.approx(1.0)
    assert t["memory"] == pytest.approx(1.0)
    assert t["collective"] == pytest.approx(1.0)
    assert t["step_seconds"] == pytest.approx(2.0)  # the memory term is left out
    assert roofline.terms(_cell(0, 0, 450e9), roofline.NVLINK_BW)["collective"] == \
        pytest.approx(1.0)
    assert roofline.terms(_cell(1, 1, 1e12))["dominant"] == "collective"
    assert roofline.bound_seconds(989e12, 6.7e12) == pytest.approx(2.0)


@pytest.mark.parametrize("port_coll, verdict", [(1e9, "port faster"), (1.2e9, "within 1.25x"),
                                                (1.3e9, "reference faster")])
def test_the_verdict_reads_compute_plus_collective(port_coll, verdict):
    row = roofline.compare(_cell(1e12, 1e15, port_coll), _cell(1e12, 1e9, 1e9))
    assert row["verdict"] == verdict
    assert row["same_work"]  # equal FLOPs and arguments


def test_the_band_needs_flops_and_arguments():
    ref = _cell(1e12, 0, 1e9)
    assert roofline.compare(_cell(1.09e12, 0, 1e9, args=1049), ref)["same_work"]
    assert not roofline.compare(_cell(1.11e12, 0, 1e9), ref)["same_work"]
    assert not roofline.compare(_cell(1e12, 0, 1e9, args=1051), ref)["same_work"]


def test_table_skips_skipped_and_failed_cells(tmp_path):
    port, ref = tmp_path / "port", tmp_path / "ref"
    port.mkdir()
    ref.mkdir()
    (port / "a__decode_32k__single.json").write_text(json.dumps(_cell(1, 1, 1)))
    (port / "b__long_500k__single.json").write_text(json.dumps({"skipped": "why"}))
    (port / "c__decode_32k__single.error.json").write_text(json.dumps({"error": "x"}))
    (port / "d__decode_32k__single.json").write_text(json.dumps(_cell(1, 1, 1)))
    (ref / "a__decode_32k__single.json").write_text(json.dumps(_cell(1, 1, 1)))
    rows = roofline.table(port, ref)
    assert len(rows) == 2 and "ref" in rows[0] and "ref" not in rows[1]
    assert "no reference cell" in roofline.format_row(rows[1])


def test_committed_artifacts_hold_no_cell_where_the_reference_is_faster():
    rows = roofline.table()
    assert len(rows) == 64 and all("ref" in r for r in rows)
    slower = [(r["arch"], r["shape"], r["mesh"], round(r["time_ratio"], 3))
              for r in rows if r["verdict"] == "reference faster"]
    assert not slower
    # the dense decoders' prefill cells do the reference's work
    for arch in ("qwen2.5-3b", "granite-20b", "starcoder2-15b", "phi4-mini-3.8b"):
        row = next(r for r in rows if (r["arch"], r["shape"], r["mesh"])
                   == (arch, "prefill_32k", "single"))
        assert row["same_work"], arch
    skipped = [p for p in roofline.PORT.glob("*.json") if "skipped" in json.loads(p.read_text())]
    assert len(skipped) == 16


def test_main_prints_the_markdown_table(capsys):
    assert roofline.main(["--markdown"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("H100 rates")
    assert lines[1].startswith("| cell |") and lines[2].startswith("| --- |")
    assert len([ln for ln in lines[3:] if ln.startswith("| ")]) == 64
