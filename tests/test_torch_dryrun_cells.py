"""The dry-run's cells of the SSM, hybrid and encoder-decoder families.

The companion of ``tests/test_torch_dryrun.py`` (which says how the cells
are cut for the tests), in a file of its own so that the two run on two
workers: mamba2-130m (the SSD scan on each rank's batch rows, the conv
cache and state layout), hymba-1.5b (attention beside the SSM, ring caches)
and whisper-tiny (the encoder, cross attention, the cross K/V cache).
"""

from __future__ import annotations

import json

import pytest
import torch

from repro_torch.launch import dryrun
from test_torch_dryrun import CELLS, cell_overrides, short_shapes  # noqa: F401 (a fixture)

torch.set_num_threads(1)

FAMILIES = {"ssm": "mamba2-130m", "hybrid": "hymba-1.5b", "enc-dec": "whisper-tiny"}


@pytest.mark.parametrize("shape, mesh, mesh_shape", CELLS)
@pytest.mark.parametrize("family", list(FAMILIES))
def test_family_cells_write_an_artifact(family, shape, mesh, mesh_shape, tmp_path, monkeypatch,
                                       short_shapes):
    arch = FAMILIES[family]
    monkeypatch.setattr(dryrun, "ARTIFACTS", tmp_path)
    rc = dryrun._run_and_write(arch, shape, mesh, cell_overrides(arch, shape), "t",
                               mesh_shape=mesh_shape, smoke=True)
    assert rc == 0
    res = json.loads((tmp_path / f"{arch}__{shape}__{mesh}__t.json").read_text())
    assert res["devices"] == (4 if len(mesh_shape) == 2 else 8)
    assert res["cost_analysis"]["flops"] > 0
    assert res["collectives"]["all-reduce"] + res["collectives"]["reduce-scatter"] > 0
    assert res["collectives"]["all-to-all"] == 0  # no MoE layer
