"""The port's training driver on the CPU, against the JAX driver.

``repro_torch.launch.train`` and ``repro.launch.train`` run the same smoke
arguments (mamba2-130m, 6 steps, a checkpoint every 2, then a second run of
each that resumes from its own checkpoints to step 8).  The two RNGs cannot
agree, so the JAX driver's ``init_train_state`` is patched, in this test
only, to return the port's initial state carried across with the bridge;
the batches already agree (numpy's ``default_rng`` on both sides).  Its
``build_mesh`` is patched too, to the same (n, 1) mesh with ``Auto`` axes:
``jax.make_mesh`` makes ``Explicit`` axes by default in the installed JAX,
and the driver's embedding gather then raises ``ShardingTypeError``.  Per-step
losses must agree within rtol 1e-4 (float32 reductions in another order,
compounded over 8 AdamW steps).  Then ``serve --run-dir --device cpu``
serves the port's checkpoint, and its greedy tokens must equal a JAX greedy
loop on the restored params.
"""

from __future__ import annotations

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AxisType

from repro.configs import get_smoke_config as jax_smoke
from repro.launch import train as jax_train
from repro.models import transformer as jtx
from repro_torch import bridge
from repro_torch.configs import get_smoke_config
from repro_torch.launch import serve as serve_mod
from repro_torch.launch import train as train_mod
from repro_torch.train.train_step import init_train_state

torch.set_num_threads(1)

ARGS = ["--smoke", "--ckpt-every", "2", "--log-every", "1"]
SERVE_ARGS = ["--smoke", "--device", "cpu", "--arch", "mamba2-130m", "--batch", "2",
              "--prompt-len", "12", "--gen", "5", "--requests", "3", "--max-wait-ms", "20"]


def _losses(res):
    return [(e["step"], e["loss"]) for e in res["log"]]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both drivers: 6 steps, then a resumed run to step 8."""
    root = tmp_path_factory.mktemp("train")
    cfg = get_smoke_config("mamba2-130m")
    state0 = bridge.params_to_numpy(init_train_state(cfg, torch.Generator().manual_seed(0)))
    port, ref, printed = {}, {}, {}
    mp = pytest.MonkeyPatch()
    mp.setattr(jax_train, "init_train_state",
               lambda cfg, rng: jax.tree.map(jnp.asarray, state0))
    mp.setattr(jax_train, "build_mesh", lambda args: jax.make_mesh(
        (len(jax.devices()), 1), ("data", "model"), axis_types=(AxisType.Auto,) * 2))
    try:
        for steps in (6, 8):
            argv = ARGS + ["--steps", str(steps)]
            port[steps] = train_mod.train(train_mod.parse_args(
                argv + ["--device", "cpu", "--run-dir", str(root / "port")]))
            ref[steps] = jax_train.train(jax_train.parse_args(
                argv + ["--run-dir", str(root / "jax")]))
    finally:
        mp.undo()
    return {"root": root, "port": port, "jax": ref, "state0": state0, "printed": printed}


def test_driver_losses_equal_the_jax_driver(runs):
    for steps, first in ((6, 0), (8, 6)):
        got, want = _losses(runs["port"][steps]), _losses(runs["jax"][steps])
        assert [s for s, _ in got] == [s for s, _ in want] == list(range(first, steps))
        np.testing.assert_allclose([loss for _, loss in got], [loss for _, loss in want],
                                   rtol=1e-4)
        assert all(np.isfinite(loss) for _, loss in got)


def test_restart_resumes_from_the_latest_checkpoint(runs):
    """The resumed run starts from the first run's final checkpoint (step 6),
    begins its batches again at 0 as the JAX driver does, and ends with a
    step-8 checkpoint; keep-last-3 holds."""
    index = json.loads((runs["root"] / "port" / "ckpt_index.json").read_text())
    steps = [m["step"] for m in index["checkpoints"]]
    assert steps == [6, 6, 8]  # run 2 saves at step 6 again, as the JAX driver does
    want = json.loads((runs["root"] / "jax" / "ckpt_index.json").read_text())
    assert [m["step"] for m in want["checkpoints"]] == steps
    manifest = index["checkpoints"][-1]
    nbytes = sum(x.nbytes for _, x in bridge.flatten(runs["state0"]))
    assert manifest["nbytes"] == nbytes and manifest["save_seconds"] >= 0
    metrics = json.loads((runs["root"] / "port" / "metrics.json").read_text())
    assert [e["step"] for e in metrics] == [6, 7]


def test_resumed_state_is_the_checkpoint(runs, monkeypatch, tmp_path, capsys):
    """A run over the same run dir restores the latest checkpoint bit for bit
    and prints the JAX driver's line."""
    from repro_torch.api import ConnectorSpec, StoreConfig
    from repro_torch.train.checkpoint import CheckpointManager

    run_dir = runs["root"] / "port"
    store = StoreConfig("train-mamba2-130m", ConnectorSpec(
        "sharded", store_dir=str(run_dir / "objects"), num_shards=8)).build(register=True)
    step, saved = CheckpointManager(store, str(run_dir / "ckpt_index.json")).restore()
    assert step == 8
    seen = {}
    real = train_mod.make_train_step

    def spy(cfg, opt_cfg, ctx):
        fn = real(cfg, opt_cfg, ctx)

        def step_fn(state, batch):
            if "state" not in seen:  # a copy: the step updates the state in place
                seen["state"] = [(p, bridge.to_numpy(t).copy()) for p, t in bridge.flatten(state)]
            return fn(state, batch)

        return step_fn

    monkeypatch.setattr(train_mod, "make_train_step", spy)
    train_mod.train(train_mod.parse_args(
        ARGS + ["--steps", "9", "--device", "cpu", "--run-dir", str(run_dir)]))
    assert "[restore] resumed from step 8" in capsys.readouterr().out
    for (p, a), (_, b) in zip(seen["state"], bridge.flatten(saved)):
        assert a.dtype == b.dtype, p
        np.testing.assert_array_equal(a, b)


def test_serve_run_dir_serves_the_checkpoint(runs, capsys):
    run_dir = runs["root"] / "port"
    args = serve_mod.parse_args(SERVE_ARGS + ["--run-dir", str(run_dir)])
    res = serve_mod.serve(args)
    out = capsys.readouterr().out
    assert "[restore] lazily resolved step-" in out
    assert res["requests"] == 3 and len(res["outputs"]) == 3

    from repro_torch.api import ConnectorSpec, StoreConfig
    from repro_torch.train.checkpoint import CheckpointManager

    store = StoreConfig("train-mamba2-130m", ConnectorSpec(
        "sharded", store_dir=str(run_dir / "objects"), num_shards=8)).build(register=True)
    _, restored = CheckpointManager(store, str(run_dir / "ckpt_index.json")).restore()
    cfg = jax_smoke("mamba2-130m")
    params = jax.tree.map(jnp.asarray, restored["params"])
    toks = jnp.asarray(np.stack(res["prompts"]))
    B, S = toks.shape
    logits, cache = jtx.prefill(cfg, params, toks, jtx.init_cache(cfg, B, S + args.gen + 1))
    tok = jnp.argmax(logits[:, -1:], axis=-1).astype(jnp.int32)
    expect = [tok]
    for i in range(args.gen - 1):
        pos = jnp.full((B, 1), S + i, jnp.int32)
        logits, cache = jtx.decode_step(cfg, params, cache, tok, pos)
        tok = jnp.argmax(logits[:, -1:], axis=-1).astype(jnp.int32)
        expect.append(tok)
    np.testing.assert_array_equal(np.stack(res["outputs"]),
                                  np.asarray(jnp.concatenate(expect, axis=1)))


def test_serve_run_dir_without_a_checkpoint_exits(tmp_path):
    with pytest.raises(SystemExit, match="no checkpoint under"):
        serve_mod.serve(serve_mod.parse_args(SERVE_ARGS + ["--run-dir", str(tmp_path)]))


def test_parse_args_keeps_the_jax_flags_and_defaults():
    port, ref = vars(train_mod.parse_args([])), vars(jax_train.parse_args([]))
    assert port.pop("device") == "cuda"
    assert port == ref


def test_train_without_cuda_raises_unless_device_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_mod.train(train_mod.parse_args(["--smoke", "--run-dir", str(tmp_path)]))
    assert not any(tmp_path.iterdir())


@pytest.mark.parametrize("flags, ranks", [
    (["--production"], 256),
    (["--production", "--multi-pod"], 512),
    (["--production", "--fsdp-pod"], 256),
])
def test_mesh_flags_raise(flags, ranks, tmp_path):
    """At world size 1 the production mesh raises with the ranks it needs,
    as ``jax.make_mesh`` raises with too few devices."""
    args = train_mod.parse_args(["--smoke", "--device", "cpu", "--run-dir", str(tmp_path),
                                 *flags])
    with pytest.raises(ValueError, match=f"needs {ranks} ranks"):
        train_mod.train(args)
