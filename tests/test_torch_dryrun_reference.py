"""The port's dry-run held to the reference's per-device work.

``scripts/reference_dryrun.py`` runs the JAX package's dry-run (its own
``run_cell``, on 256 forced host devices, with ``Auto`` mesh axes) once, in
a subprocess, for every cell below; the port's ``dryrun.run_cell`` runs the
same cells here on a fake process group of 256 ranks.  Both sides count
the same things: matrix-product FLOPs only (``hlo_analysis.py`` counts
``dot``/``convolution``, ``op_analysis.py`` mm/bmm/addmm/baddbmm/
convolution), and collective output bytes from each side's
trip-count-corrected ``hlo_analysis["collectives"]``, where an async
``-start``/``-done`` pair counts once (``test_an_async_pair_counts_once``;
the reference's own ``collective_bytes`` counts both halves).

The cells: ``decode_32k single`` of qwen2.5-3b (the control), mamba2-130m,
hymba-1.5b and internvl2-2b at full shape; mamba2-130m ``prefill_32k
single`` and qwen2.5-3b ``train_4k single`` (2 microbatches) with both
sides' sequences cut 8-fold, as ``tests/test_torch_dryrun.py`` cuts them.
Each cell either does the reference's work (per-device FLOPs within
``FLOP_BAND``, argument bytes within 5 %) or is a ``REFERENCE_DIFFERENCES``
entry: then its FLOPs must lie outside the band (a stale entry fails) and
the port's compute + collective time at ``repro_torch.launch.roofline``'s
H100 rates must be at most 1.25x the reference's.  The two sides count
bytes with different tools (eager ATen ops, XLA's CPU HLO), so a tighter
bound would judge the counters rather than the layouts.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.launch import dryrun, roofline, specs

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]

# (arch, shape, the cut of its sequence, config overrides)
CELLS = [
    ("qwen2.5-3b", "decode_32k", 1, {}),
    ("mamba2-130m", "decode_32k", 1, {}),
    ("hymba-1.5b", "decode_32k", 1, {}),
    ("internvl2-2b", "decode_32k", 1, {}),
    ("mamba2-130m", "prefill_32k", 8, {}),
    ("qwen2.5-3b", "train_4k", 8, {"num_microbatches": 2}),
]

# cells whose per-device work differs from the reference's, and why the
# port's layout stays: its compute + collective time is the smaller
REFERENCE_DIFFERENCES = {
    ("mamba2-130m", "decode_32k"): (
        "in_proj's 3352 outputs and the 50,280-row LM head do not divide the "
        "16 model ranks: the reference pads and splits them over model "
        "(all-gathering each layer's (768, 210) weight slice over data); the "
        "port runs them whole over model on its tokens gathered over data: "
        "12x the FLOPs, microseconds at 989 TF/s, and fewer collective bytes"),
    ("hymba-1.5b", "decode_32k"): (
        "25 heads, 5 kv heads, 3257 in_proj outputs and the 32,776 cache "
        "slots do not divide the 16 model ranks; the reference pads and "
        "splits them, the port runs them whole over model on its tokens "
        "gathered over data: 1.7x the FLOPs, half the collective bytes"),
    ("internvl2-2b", "decode_32k"): (
        "the 92,553-row LM head runs whole over model on the tokens gathered "
        "over data (1.9x the FLOPs, microseconds); the reference gathers its "
        "context-parallel KV cache whole, some 1000x the port's bytes"),
    ("mamba2-130m", "prefill_32k"): (
        "in_proj (768 x 3352) runs whole over model: splitting it would need "
        "its (tokens, 3352) output gathered for the conv and the scan, whose "
        "24 heads do not divide 16 either; 12x the FLOPs, while the "
        "reference's collectives are 12x the port's bytes"),
}


def _plan() -> list[dict]:
    return [{"arch": a, "shape": s, "mesh": "single", "cut": cut, "overrides": over}
            for a, s, cut, over in CELLS]


@pytest.fixture(scope="module")
def reference(tmp_path_factory) -> dict:
    """The reference's artifacts, from one subprocess for every cell."""
    out = tmp_path_factory.mktemp("reference")
    plan = out / "plan.json"
    plan.write_text(json.dumps(_plan()))
    # one compute thread: the suite's other workers share the cores
    env = {**os.environ, "JAX_PLATFORMS": "cpu", "PYTHONPATH": str(ROOT / "src"),
           "XLA_FLAGS": "--xla_cpu_multi_thread_eigen=false", "OMP_NUM_THREADS": "1"}
    res = subprocess.run([sys.executable, str(ROOT / "scripts" / "reference_dryrun.py"),
                          "--cells", str(plan), "--out", str(out)],
                         capture_output=True, text=True, env=env, timeout=600)
    assert res.returncode == 0, res.stderr[-4000:]
    return {(a, s): json.loads((out / f"{a}__{s}__single.json").read_text())
            for a, s, _, _ in CELLS}


@pytest.fixture(scope="module")
def port() -> dict:
    """The port's cells, in this process, on the same cuts."""
    cells = {}
    for arch, shape, cut, over in CELLS:
        info = specs.SHAPES[shape]
        specs.SHAPES[shape] = {**info, "seq": info["seq"] // cut}
        try:
            cells[(arch, shape)] = dryrun.run_cell(arch, shape, "single", over)
        finally:
            specs.SHAPES[shape] = info
    return cells


def test_the_cells_are_the_cut_shapes(reference, port):
    for arch, shape, cut, over in CELLS:
        ref, mine = reference[(arch, shape)], port[(arch, shape)]
        assert ref["meta"] == mine["meta"]
        assert mine["meta"]["seq"] == specs.SHAPES[shape]["seq"] // cut
        assert ref["devices"] == mine["devices"] == 256
        assert ref.get("cut", 1) == cut


@pytest.mark.parametrize("arch, shape", [(a, s) for a, s, _, _ in CELLS])
def test_port_does_the_reference_work_or_is_no_slower(arch, shape, reference, port):
    row = roofline.compare(port[(arch, shape)], reference[(arch, shape)])
    if (arch, shape) in REFERENCE_DIFFERENCES:
        assert not row["same_work"], f"stale entry: {row['flop_ratio']:.3f}"
        assert row["time_ratio"] <= roofline.SLOWER_LIMIT, row
    else:
        assert row["same_work"], row
    assert abs(row["arg_ratio"] - 1) <= roofline.ARG_BAND, row


def test_the_control_cell_is_in_the_band(reference, port):
    """qwen2.5-3b decode: heads and vocab divide the model ranks, so the
    same work on both sides, whatever either side moves."""
    row = roofline.compare(port[("qwen2.5-3b", "decode_32k")],
                           reference[("qwen2.5-3b", "decode_32k")])
    lo, hi = roofline.FLOP_BAND
    assert lo <= row["flop_ratio"] <= hi


def test_decode_cells_move_tokens_not_layers(port):
    """In a decode step the layers' params stay in their FSDP shards: no
    collective gathers a weight, so the bytes moved are the tokens': under
    20 MB a device for mamba2-130m, where gathering its layers and its
    embedding moved 564 MB."""
    coll = port[("mamba2-130m", "decode_32k")]["hlo_analysis"]["collectives"]
    assert coll["total"] < 20e6


def test_an_async_pair_counts_once():
    """``hlo_analysis.analyze`` (both sides' ``collectives``) counts an
    ``all-gather-start``/``-done`` pair once; the reference dry-run's
    ``collective_bytes`` matches ``-done`` through ``rstrip`` and counts it
    twice.  No cell of the reference's CPU HLO holds an async pair."""
    from repro.launch import hlo_analysis

    flags = os.environ.get("XLA_FLAGS")
    from repro.launch import dryrun as jdryrun  # sets XLA_FLAGS at import

    if flags is None:
        os.environ.pop("XLA_FLAGS", None)
    else:
        os.environ["XLA_FLAGS"] = flags

    hlo = "\n".join([
        "HloModule m",
        "ENTRY %main (p: f32[8,16]) -> f32[128,16] {",
        "  %p = f32[8,16]{1,0} parameter(0)",
        "  %ags = f32[128,16]{1,0} all-gather-start(%p), dimensions={0}",
        "  %agd = f32[128,16]{1,0} all-gather-done(%ags)",
        "  ROOT %out = f32[128,16]{1,0} copy(%agd)",
        "}",
    ])
    assert hlo_analysis.analyze(hlo)["collectives"]["all-gather"] == 128 * 16 * 4
    assert hlo_analysis.analyze(hlo)["collective_count"] == 1
    assert jdryrun.collective_bytes(hlo)["all-gather"] == 2 * 128 * 16 * 4


def test_reference_cells_hold_no_async_collective(reference):
    for cell in reference.values():
        assert cell["async_collective_starts"] == 0
