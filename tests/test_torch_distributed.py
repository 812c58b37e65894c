"""The port's distribution layer in a world of two over ``gloo``.

Each case spawns two processes that join one ``gloo`` process group on
localhost and lay out the same seeded state on a ``DeviceMesh`` by the
port's ``ShardingRules``:

* ``repro_torch.launch.train`` at mesh (2, 1), the JAX driver's layout
  (FSDP over ``data``, the batch over ``data``), takes the same 3 steps as
  the driver at world size 1: losses within 1e-5 (float32 reductions
  split across two ranks);
* deepseek-v2-lite's prefill at mesh (1, 2): the MoE layers take the EP
  form through ``local_map`` over ``model`` (the sequence and the experts
  split in two; capacity factor 8, so nothing drops), the latent cache is
  context-parallel (its slots split over ``model``), the embedding is
  looked up vocab-parallel; then two decode steps, whose MoE layers take
  the dense form on each rank's experts.  The logits, every cache leaf and
  the decode logits must equal the dense form's on one process within
  1e-5.
* the serve driver at mesh (2, 1) gives one process's greedy tokens.
"""

from __future__ import annotations

import dataclasses
import json
import multiprocessing
import socket

import numpy as np
import pytest
import torch

from repro_torch import bridge
from repro_torch.configs import get_smoke_config
from repro_torch.launch import train as train_mod
from repro_torch.models import transformer as tx

torch.set_num_threads(1)

WORLD = 2
TRAIN_ARGS = ["--smoke", "--steps", "3", "--log-every", "1", "--ckpt-every", "0",
              "--batch", "4", "--seq", "32", "--device", "cpu"]
B, S = 2, 16


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawn(target, *args) -> None:
    port = _free_port()
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=target, args=(r, port, *args)) for r in range(WORLD)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=240)
    alive = [p for p in procs if p.is_alive()]
    for p in alive:
        p.kill()
    assert not alive and all(p.exitcode == 0 for p in procs), [p.exitcode for p in procs]


def _join(rank: int, port: int) -> None:
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=WORLD)


# -- the train driver at mesh (2, 1) -----------------------------------------------------


def _train_rank(rank: int, port: int, run_dir: str, out_path: str) -> None:
    import torch.distributed as dist

    _join(rank, port)
    try:
        res = train_mod.train(train_mod.parse_args(TRAIN_ARGS + ["--run-dir", run_dir]))
        if rank == 0:
            with open(out_path, "w") as f:
                json.dump([(e["step"], e["loss"]) for e in res["log"]], f)
    finally:
        dist.destroy_process_group()


def test_train_driver_at_mesh_2x1_matches_world_size_1(tmp_path):
    _spawn(_train_rank, str(tmp_path / "mesh"), str(tmp_path / "losses.json"))
    got = json.loads((tmp_path / "losses.json").read_text())
    one = train_mod.train(train_mod.parse_args(TRAIN_ARGS + ["--run-dir",
                                                             str(tmp_path / "one")]))
    want = [(e["step"], e["loss"]) for e in one["log"]]
    assert [s for s, _ in got] == [s for s, _ in want] == [0, 1, 2]
    np.testing.assert_allclose([v for _, v in got], [v for _, v in want], rtol=1e-5)
    # rank 0 saved the gathered state under the same manifest as one process
    index = json.loads((tmp_path / "mesh" / "ckpt_index.json").read_text())
    assert index["checkpoints"][-1]["paths"] == json.loads(
        (tmp_path / "one" / "ckpt_index.json").read_text())["checkpoints"][-1]["paths"]


# -- EP prefill at mesh (1, 2) ---------------------------------------------------------


def _ep_cfg(impl: str):
    cfg = get_smoke_config("deepseek-v2-lite-16b")
    return cfg.replace(moe_impl=impl, moe=dataclasses.replace(cfg.moe, capacity_factor=8.0))


def _tokens(cfg) -> torch.Tensor:
    return torch.from_numpy(np.random.default_rng(5).integers(0, cfg.vocab_size, (B, S)))


def _decode(cfg, params, cache, logits, ctx) -> dict:
    """Two greedy decode steps after the prefill: the dense form of the MoE
    layers (each rank its own experts) and the latent cache's slot writes."""
    steps = {}
    tok = logits[:, -1:].argmax(-1)
    for i in range(2):
        pos = torch.full((B, 1), S + i, dtype=torch.int64)
        logits, cache = tx.decode_step(cfg, params, cache, tok, pos, ctx)
        steps[str(i)] = logits
        tok = logits[:, -1:].argmax(-1)
    return steps


def _ep_rank(rank: int, port: int, out_path: str, mesh_shape: tuple = (1, WORLD)) -> None:
    import torch.distributed as dist
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.distributed.sharding import ShardingRules, distribute, gather_full
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models import moe

    _join(rank, port)
    try:
        in_shards = []
        real = moe._routed_experts_in_shards
        moe._routed_experts_in_shards = lambda *a: in_shards.append(1) or real(*a)
        cfg = _ep_cfg("ep")
        mesh = make_debug_mesh(*mesh_shape)
        rules = ShardingRules(mesh)
        params = tx.init_params(cfg, torch.Generator().manual_seed(0))
        cache = tx.init_cache(cfg, B, S + 8, device="cpu")
        cache_sh = rules.cache_shardings(cache)
        assert cache_sh["moe"]["c"][2] == "model"  # the slots split: context-parallel
        params = distribute(params, rules.state_shardings(params), mesh)
        cache = distribute(cache, cache_sh, mesh)
        tokens = distribute(_tokens(cfg), rules.batch_spec(2), mesh)
        ctx = tx.RunCtx(mesh=mesh, dp_axes=rules.dp_axes, ep_axis="model")
        with torch.no_grad(), implicit_replication():
            logits, cache = tx.prefill(cfg, params, tokens, cache, ctx)
            steps = _decode(cfg, params, cache, logits, ctx)
        out = gather_full({"logits": logits, "cache": cache, "steps": steps})
        if rank == 0:
            np.savez(out_path, **{"/".join(p): t.float().numpy()
                                  for p, t in bridge.flatten(out)})
            with open(out_path + ".json", "w") as f:
                json.dump(len(in_shards), f)
    finally:
        dist.destroy_process_group()


def test_ep_prefill_at_mesh_1x2_matches_the_dense_form(tmp_path, monkeypatch):
    from repro_torch.models import moe

    _spawn(_ep_rank, str(tmp_path / "ep.npz"))
    got = np.load(tmp_path / "ep.npz")
    cfg = _ep_cfg("dense")
    params = tx.init_params(cfg, torch.Generator().manual_seed(0))
    cache = tx.init_cache(cfg, B, S + 8, device="cpu")
    taken = []
    real = moe.apply_moe_dense
    monkeypatch.setattr(moe, "apply_moe_dense", lambda *a, **k: taken.append(1) or real(*a, **k))
    with torch.no_grad():
        logits, cache = tx.prefill(cfg, params, _tokens(cfg), cache, tx.RunCtx())
        steps = _decode(cfg, params, cache, logits, tx.RunCtx(decode=True))
    assert taken  # the reference run took the dense form
    want = {"/".join(p): t.float().numpy()
            for p, t in bridge.flatten({"logits": logits, "cache": cache, "steps": steps})}
    assert sorted(got.files) == sorted(want)
    for name, w in want.items():
        np.testing.assert_allclose(got[name], w, rtol=1e-5, atol=1e-5, err_msg=name)


def test_moe_decode_at_mesh_2x1_moves_tokens_and_matches_the_dense_form(tmp_path):
    """deepseek-v2-lite at mesh (2, 1): the decode steps leave the layers'
    params in their FSDP shards over ``data``, so the dense MoE form runs
    on every token with each rank's slice of the experts' hidden dim
    (``_routed_experts_in_shards``).  Its prefill runs MLA with a head dim
    of one over a ``model`` dim of size 1, which ``_sharded_attention`` once
    marked sharded and the reshape after it refused.  Everything equals one
    process's dense form within 1e-5."""
    _spawn(_ep_rank, str(tmp_path / "ep.npz"), (WORLD, 1))
    got = np.load(tmp_path / "ep.npz")
    cfg = _ep_cfg("dense")
    params = tx.init_params(cfg, torch.Generator().manual_seed(0))
    cache = tx.init_cache(cfg, B, S + 8, device="cpu")
    with torch.no_grad():
        logits, cache = tx.prefill(cfg, params, _tokens(cfg), cache, tx.RunCtx())
        steps = _decode(cfg, params, cache, logits, tx.RunCtx(decode=True))
    want = {"/".join(p): t.float().numpy()
            for p, t in bridge.flatten({"logits": logits, "cache": cache, "steps": steps})}
    assert sorted(got.files) == sorted(want)
    for name, w in want.items():
        np.testing.assert_allclose(got[name], w, rtol=1e-5, atol=1e-5, err_msg=name)
    # every MoE layer of both decode steps took the experts in their shards
    n_moe = cfg.num_layers - cfg.moe.first_dense
    assert json.loads((tmp_path / "ep.npz.json").read_text()) == 2 * n_moe


@pytest.mark.parametrize("impl, form", [("ep", "_ep_block"), ("dense", "apply_moe_dense")])
def test_a_mesh_routes_moe_by_the_jax_rule(impl, form, monkeypatch):
    """With a ``DeviceMesh``, EP iff ``moe_impl == "ep"`` and not a decode;
    a decode step takes the dense form (a one-rank mesh over gloo)."""
    import torch.distributed as dist
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models import moe

    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{_free_port()}",
                            rank=0, world_size=1)
    try:
        mesh = make_debug_mesh(1, 1)
        cfg = _ep_cfg(impl)
        p = moe.init_moe(cfg, torch.Generator().manual_seed(1))
        x = torch.randn(B, S, cfg.d_model, generator=torch.Generator().manual_seed(2))
        taken = []
        for name in ("_ep_block", "apply_moe_dense"):
            real = getattr(moe, name)
            monkeypatch.setattr(moe, name,
                                lambda *a, _n=name, _r=real, **k: taken.append(_n) or _r(*a, **k))
        with implicit_replication():
            moe.apply_moe(cfg, p, x, world=mesh)
            moe.apply_moe(cfg, p, x, world=mesh, decode=True)
        assert taken == [form, "apply_moe_dense"]
    finally:
        dist.destroy_process_group()


# -- mamba2-130m's layouts at mesh (2, 1) and (1, 2) ----------------------------------------

MAMBA_S = 64


def _mamba_cfg():
    """The smoke config at widths that do not divide 2: in_proj's 2 * 192 +
    2 * 16 + 3 = 419 outputs (3 heads of 64) and a vocabulary of 257, so
    over ``model`` they stay whole on each rank."""
    cfg = get_smoke_config("mamba2-130m")
    return cfg.replace(d_model=96, vocab_size=257,
                       ssm=dataclasses.replace(cfg.ssm, head_dim=64))


def _mamba_run(cfg, params, cache, tokens, ctx) -> dict:
    """The prompt's prefill, then two greedy decode steps."""
    logits, cache = tx.prefill(cfg, params, tokens, cache, ctx)
    steps, tok = {}, logits[:, -1:].argmax(-1)
    for i in range(2):
        pos = torch.full((B, 1), MAMBA_S + i, dtype=torch.int64)
        step_logits, cache = tx.decode_step(cfg, params, cache, tok, pos, ctx)
        steps[str(i)] = step_logits
        tok = step_logits[:, -1:].argmax(-1)
    return {"logits": logits, "cache": cache, "steps": steps}


def _mamba_inputs(cfg):
    params = tx.init_params(cfg, torch.Generator().manual_seed(0))
    cache = tx.init_cache(cfg, B, MAMBA_S + 8, device="cpu")
    tokens = torch.from_numpy(np.random.default_rng(7).integers(0, cfg.vocab_size,
                                                                (B, MAMBA_S)))
    return params, cache, tokens


def _mamba_rank(rank: int, port: int, mesh_shape: tuple, out_path: str) -> None:
    import torch.distributed as dist
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.distributed.sharding import ShardingRules, distribute, gather_full
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models import common

    _join(rank, port)
    try:
        cfg = _mamba_cfg()
        mesh = make_debug_mesh(*mesh_shape)
        rules = ShardingRules(mesh)
        params, cache, tokens = _mamba_inputs(cfg)
        params = distribute(params, rules.state_shardings(params), mesh)
        cache = distribute(cache, rules.cache_shardings(cache), mesh)
        tokens = distribute(tokens, rules.batch_spec(2), mesh)
        ctx = tx.RunCtx(mesh=mesh, dp_axes=rules.dp_axes, ep_axis="model")
        moved = []
        real = common.moves_tokens
        tx.moves_tokens = lambda *a: moved.append(real(*a)) or moved[-1]
        with torch.no_grad(), implicit_replication():
            out = _mamba_run(cfg, params, cache, tokens, ctx)
        out = gather_full(out)
        if rank == 0:
            np.savez(out_path, moved=np.array(moved),
                     **{"/".join(p): t.float().numpy() for p, t in bridge.flatten(out)})
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("mesh_shape", [(2, 1), (1, 2)])
def test_mamba_prefill_and_decode_on_a_mesh_match_one_process(mesh_shape, tmp_path):
    """At (2, 1) the layers' params are FSDP shards over ``data``: the
    prefill gathers them, each decode step leaves them in place and moves
    its tokens (``moves_tokens``), the embedding looked up and the logits
    taken on each rank's slice of the hidden dim.  At (1, 2) in_proj and the
    vocabulary do not divide ``model`` and stay whole on each rank.  The
    logits, every cache leaf and both decode steps' logits equal one
    process's within 1e-5."""
    _spawn(_mamba_rank, mesh_shape, str(tmp_path / "out.npz"))
    got = np.load(tmp_path / "out.npz")
    cfg = _mamba_cfg()
    params, cache, tokens = _mamba_inputs(cfg)
    with torch.no_grad():
        out = _mamba_run(cfg, params, cache, tokens, tx.RunCtx())
    want = {"/".join(p): t.float().numpy() for p, t in bridge.flatten(out)}
    assert sorted(f for f in got.files if f != "moved") == sorted(want)
    for name, w in want.items():
        np.testing.assert_allclose(got[name], w, rtol=1e-5, atol=1e-5, err_msg=name)
    # each step asks for its embedding, each layer and its last logits: the
    # prefill's 64 tokens gather the table and the layers, its last row and
    # the decode steps move; over ``model`` alone nothing moves
    L = cfg.num_layers
    expect = [False] * (L + 1) + [True] + [True] * (L + 2) * 2
    assert got["moved"].tolist() == (expect if mesh_shape[0] > 1 else [False] * len(expect))


# -- the serve driver at mesh (2, 1) ------------------------------------------------------

SERVE_ARGS = ["--smoke", "--device", "cpu", "--batch", "2", "--prompt-len", "12", "--gen", "5",
              "--requests", "3", "--max-wait-ms", "20"]


def _serve_rank(rank: int, port: int, out_path: str) -> None:
    import torch.distributed as dist

    from repro_torch.launch import serve as serve_mod

    _join(rank, port)
    try:
        res = serve_mod.serve(serve_mod.parse_args(SERVE_ARGS))
        if rank == 0:
            np.save(out_path, np.stack(res["outputs"]))
        else:
            assert res["prefills"] >= 2  # it ran every batch rank 0 served
    finally:
        dist.destroy_process_group()


def test_serve_at_mesh_2x1_matches_world_size_1(tmp_path):
    """The serving layout (``fsdp_params=False``) on a (2, 1) mesh: rank 0
    serves and hands each padded batch to rank 1; the flash wrapper runs on
    each rank's rows.  The greedy tokens equal one process's."""
    from repro_torch.launch import serve as serve_mod

    _spawn(_serve_rank, str(tmp_path / "tokens.npy"))
    one = serve_mod.serve(serve_mod.parse_args(SERVE_ARGS))
    np.testing.assert_array_equal(np.load(tmp_path / "tokens.npy"), np.stack(one["outputs"]))
