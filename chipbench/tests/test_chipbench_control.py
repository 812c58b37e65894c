"""The control, the reference in float8 products put in the program's place,
comes out not correct, while the program comes out correct: at a tiny
bfloat16 size on the CPU, and at each cell's own size on the card."""

from __future__ import annotations

import pytest
import torch

from chipbench import registry, run
from conftest import add_tiny_cells


@pytest.mark.parametrize("family", [0, 1], ids=["dense", "hybrid"])
def test_control_fails_at_a_tiny_size(bench_copy, family):
    cell = add_tiny_cells(bench_copy, "bfloat16")[family]
    for seed in (0, 1, 2):
        out = run.run_cell(cell, seed, 0.5, False, torch.device("cpu"), root=bench_copy,
                           control="fp8")
        limit = out["check"]["logit_gap"]["limit"]
        assert out["correct"], out["check"]
        assert out["control_gap"] > limit, (seed, out["control_gap"], limit)


@pytest.mark.card
@pytest.mark.parametrize("cell", [w["name"] for w in registry.benchmark()["workloads"]])
def test_control_fails_at_the_cells_size(card, cell):
    for seed in (101, 202, 303):
        out = run.run_cell(cell, seed, 8.0, False, card, control="fp8")
        assert out["correct"], out["check"]
        assert out["control_gap"] > out["check"]["logit_gap"]["limit"], (seed, out)
