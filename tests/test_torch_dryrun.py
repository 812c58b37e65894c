"""The port's dry-run: its cell specs against the JAX package's, its op
counter, and the cells of the dense, MoE, MLA and VLM families on fake meshes.

* ``SHAPES``, ``SUBQUADRATIC``, ``cell_skip_reason``, every input stand-in
  (shape and dtype), the cell configs' train overrides and ``meta`` equal
  the JAX package's, for every arch x shape.
* ``OpCounter`` counts the same ops (names and operand shapes), FLOPs and
  bytes under ``FakeTensorMode`` as on real CPU tensors, and an unrolled
  layer loop counts L layers as L times one (no trip count to correct).
* At smoke configs on fake (2, 2) and (2, 2, 2) meshes (a fake process
  group of 4 or 8 ranks in this process, torn down by ``run_cell``), a
  train, a prefill and a decode cell of each family write an artifact;
  the MoE archs run with ``moe_impl="ep"`` (their smoke configs say
  "dense").  To keep the files short the cells' sequences are cut 8-fold
  (``short_shapes``: train 512, prefill and decode 4096 tokens; the batch
  as it is) and the train cells take 2 microbatches: the code paths are
  those of the full cells, with fewer turns of the chunk loops.  A TP-sharded
  cell reports a nonzero all-reduce or reduce-scatter, an EP prefill a
  nonzero all-to-all, and ``CommDebugMode`` counts as many collectives as
  the counter.  ``tests/test_torch_dryrun_cells.py`` runs the SSM, hybrid
  and encoder-decoder families.
"""

from __future__ import annotations

import json

import jax.numpy as jnp
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.launch import specs as jspecs
from repro_torch.configs import get_smoke_config, list_archs
from repro_torch.launch import dryrun
from repro_torch.launch import specs
from repro_torch.launch.op_analysis import OpCounter
from repro_torch.models import transformer as tx

torch.set_num_threads(1)

CELLS = [("train_4k", "single", (2, 2)), ("prefill_32k", "multi", (2, 2, 2)),
         ("decode_32k", "multi", (2, 2, 2))]
FAMILIES = {"dense": "qwen2.5-3b", "moe": "kimi-k2-1t-a32b",
            "mla": "deepseek-v2-lite-16b", "vlm": "internvl2-2b"}


def cell_overrides(arch: str, shape: str) -> dict:
    over = {"moe_impl": "ep"} if arch in ("kimi-k2-1t-a32b", "deepseek-v2-lite-16b") else {}
    if specs.SHAPES[shape]["kind"] == "train":
        over["num_microbatches"] = 2
    return over


@pytest.fixture
def short_shapes(monkeypatch):
    """The cells' sequences cut 8-fold for the tests (see the docstring)."""
    for name, info in specs.SHAPES.items():
        monkeypatch.setitem(specs.SHAPES, name, {**info, "seq": info["seq"] // 8})


# -- specs against the JAX package's -------------------------------------------------------


def test_shapes_and_subquadratic_equal_jax():
    assert specs.SHAPES == jspecs.SHAPES
    assert specs.SUBQUADRATIC == jspecs.SUBQUADRATIC


@pytest.mark.parametrize("shape", list(specs.SHAPES))
@pytest.mark.parametrize("arch", list_archs())
def test_cell_specs_equal_jax(arch, shape):
    assert specs.cell_skip_reason(arch, shape) == jspecs.cell_skip_reason(arch, shape)
    cfg, jcfg = specs._cell_config(arch, shape), jspecs._cell_config(arch, shape)
    for field in ("remat", "num_microbatches", "logits_chunk", "attention_chunk",
                  "max_target_len", "moe_impl", "attention_impl"):
        assert getattr(cfg, field) == getattr(jcfg, field), field
    got = specs.input_specs(arch, shape, cfg)
    want = jspecs.input_specs(arch, shape, jcfg)
    assert got.keys() == want.keys()
    for name, stand_in in got.items():
        assert stand_in.device.type == "meta"
        assert tuple(stand_in.shape) == tuple(want[name].shape), name
        assert str(stand_in.dtype).split(".")[-1] == jnp.dtype(want[name].dtype).name, name
    counts = jcfg.param_counts()
    info = jspecs.SHAPES[shape]
    assert specs.cell_meta(arch, shape, cfg) == {
        "arch": arch, "shape": shape, "kind": info["kind"], "batch": info["batch"],
        "seq": info["seq"], "params_total": counts["total"],
        "params_active": counts["active"],
    }


def test_dtype_overrides_are_named_as_in_jax():
    cfg = specs._cell_config("qwen2.5-3b", "decode_32k", {"compute_dtype": "float32"})
    jcfg = jspecs._cell_config("qwen2.5-3b", "decode_32k", {"compute_dtype": "float32"})
    assert cfg.compute_dtype == torch.float32 and jcfg.compute_dtype == jnp.float32


# -- the counter ----------------------------------------------------------------------------


def _prefill_count(cfg, *, fake: bool) -> OpCounter:
    from repro_torch.models import layers

    layers._rope_freqs.cache_clear()  # a cached table is made once per mode
    counter = OpCounter(log=True)

    def run():
        params = tx.init_params(cfg, torch.Generator().manual_seed(0))
        cache = tx.init_cache(cfg, 2, 24, device="cpu")
        tokens = torch.zeros((2, 16), dtype=torch.int64)
        with counter, torch.no_grad():
            tx.prefill(cfg, params, tokens, cache, tx.RunCtx())

    if fake:
        with FakeTensorMode():
            run()
    else:
        run()
    layers._rope_freqs.cache_clear()
    return counter


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "mamba2-130m"])
def test_counter_under_fake_tensors_equals_a_real_run(arch):
    cfg = get_smoke_config(arch, attention_chunk=8)
    real, fake = _prefill_count(cfg, fake=False), _prefill_count(cfg, fake=True)
    assert real.log == fake.log
    assert real.flops == fake.flops > 0
    assert real.bytes == fake.bytes > 0
    assert real.analyze() == fake.analyze()


def test_layers_count_as_many_times_one_layer():
    flops, nbytes = {}, {}
    for n in (1, 2, 4):
        cfg = get_smoke_config("qwen2.5-3b", num_layers=n, attention_chunk=8)
        c = _prefill_count(cfg, fake=True)
        flops[n], nbytes[n] = c.flops, c.bytes
    assert flops[4] - flops[2] == 2 * (flops[2] - flops[1]) > 0
    assert nbytes[4] - nbytes[2] == 2 * (nbytes[2] - nbytes[1]) > 0


def test_counter_formulas():
    a, b = torch.zeros(3, 5), torch.zeros(5, 7)
    with OpCounter() as c:
        torch.mm(a, b)
        torch.exp(a)
        a.view(15)
    assert c.flops == 2 * 3 * 5 * 7
    assert c.transcendental_elems == 15
    assert c.bytes == (15 + 35 + 21) * 4 + (15 + 15) * 4  # the view moves nothing
    top = c.top_contributors(1)[0]
    assert top["op"] == "aten.mm.default" and top["count"] == 1


# -- cells on fake meshes -------------------------------------------------------------------


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
    assert res["cost_analysis"]["flops"] > 0 and res["memory_analysis"]["argument_size_in_bytes"] > 0
    assert res["hlo_analysis"]["collectives"]["total"] == sum(
        v for k, v in res["collectives"].items() if k != "count")
    tp = res["collectives"]["all-reduce"] + res["collectives"]["reduce-scatter"]
    assert tp > 0  # the model axis shards heads, MLP hidden and vocab
    # the EP exchange, where the MoE layers take the EP form (not in decode)
    ep = family in ("moe", "mla") and shape != "decode_32k"
    assert (res["collectives"]["all-to-all"] > 0) == ep


def test_comm_debug_mode_counts_the_same_collectives(short_shapes):
    res = dryrun.run_cell("deepseek-v2-lite-16b", "prefill_32k", "single",
                          cell_overrides("deepseek-v2-lite-16b", "prefill_32k"),
                          mesh_shape=(2, 2), smoke=True, comm_debug=True)
    assert sum(res["comm_counts"].values()) == res["collectives"]["count"] > 0
    assert any("alltoall" in k or "all_to_all" in k for k in res["comm_counts"])


def test_a_failing_cell_writes_an_error_artifact(tmp_path, monkeypatch):
    monkeypatch.setattr(dryrun, "ARTIFACTS", tmp_path)
    rc = dryrun._run_and_write("qwen2.5-3b", "decode_32k", "single", {"no_such_field": 1}, "",
                               mesh_shape=(2, 2), smoke=True)
    err = json.loads((tmp_path / "qwen2.5-3b__decode_32k__single.error.json").read_text())
    assert rc == 1 and "no_such_field" in err["error"]
    skip = dryrun._run_and_write("qwen2.5-3b", "long_500k", "single", None, "")
    assert skip == 0 and "skipped" in json.loads(
        (tmp_path / "qwen2.5-3b__long_500k__single.json").read_text())
