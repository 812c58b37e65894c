"""The port's train step and optimizer against the JAX package.

One step from the same state (``init_train_state`` of the JAX package,
carried across with ``repro_torch.bridge``) on the same numpy batch, for
smoke configs of qwen2.5-3b, mamba2-130m, hymba-1.5b, kimi-k2 and
deepseek-v2-lite in float32, then for the microbatch, remat and
chunked-logits variants.  Then one step of each training driver
(``repro_torch.launch.train`` and ``repro.launch.train``) on kimi-k2's
smoke config with ``moe_impl="ep"``: both drivers pass a one-device mesh
(the port a world of one), so both take the EP form and drop the same
tokens; their losses must agree within rtol 1e-4.  Tolerances, each with the
gap observed on the CPU:

* ``loss`` rtol 1e-5 (observed <= 2e-7), ``grad_norm`` rtol 1e-4 (<= 3e-7):
  float32 reductions taken in another order;
* ``lr`` within 1e-7 relative of JAX's float32 value (observed: equal);
* both moments, per leaf, within 1e-5 relative L2 (<= 3e-6).  ``m`` is
  (1 - b1) times the clipped gradient, so this holds every gradient;
* the update ``p_new - p_old``, per leaf, within 1e-2 relative L2 (<= 2e-3).
  Adam's first update is g / (|g| + eps) per element, so where |g| sits at
  float noise the two frameworks may round it either way: qwen's ``b_k``
  has a gradient that is 0 in exact arithmetic (softmax ignores a shift
  shared by every key).  The other leaves agree to <= 1e-4.

Then the reference's own model smoke tests (``tests/test_models_smoke.py``)
and optimizer tests (``tests/test_train_infra.py``) run against the port,
for every arch the port supports; whisper-tiny's batches carry frame
embeddings, as the reference's do.  (whisper's step against the JAX step is
in ``tests/test_torch_whisper.py``.)
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke
from repro.models import transformer as jtx
from repro.train import optimizer as jopt
from repro.train.train_step import init_train_state as jax_init_train_state
from repro.train.train_step import make_train_step as jax_make_train_step
from repro_torch import bridge
from repro_torch.configs import get_smoke_config
from repro_torch.models import transformer as tx
from repro_torch.train.optimizer import (
    AdamWConfig,
    apply_updates,
    global_norm,
    init_opt_state,
    schedule,
)
from repro_torch.train.train_step import init_train_state, make_train_step

torch.set_num_threads(1)

DENSE = ["qwen2.5-3b", "phi4-mini-3.8b", "granite-20b", "starcoder2-15b", "internvl2-2b"]
SSM = ["mamba2-130m"]
HYBRID = ["hymba-1.5b"]
MOE = ["kimi-k2-1t-a32b", "deepseek-v2-lite-16b"]
ENCDEC = ["whisper-tiny"]
B, S = 2, 32
LOSS_RTOL, GNORM_RTOL, LR_RTOL = 1e-5, 1e-4, 1e-7
MOMENT_REL_L2, UPDATE_REL_L2 = 1e-5, 1e-2


def _rel_l2(a, b) -> float:
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _batch(cfg, rng: np.random.Generator, batch: int = B) -> dict[str, np.ndarray]:
    out = {"tokens": rng.integers(0, cfg.vocab_size, (batch, S)).astype(np.int32)}
    if cfg.family == "vlm":
        out["patch_embeds"] = rng.normal(
            size=(batch, cfg.num_image_tokens, cfg.d_model)).astype(np.float32)
    if cfg.is_encdec:
        out["frame_embeds"] = rng.normal(
            size=(batch, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    return out


def _tensors(batch: dict[str, np.ndarray]) -> dict[str, torch.Tensor]:
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@functools.lru_cache(maxsize=None)
def _jax_state(arch: str):
    return jax.tree.map(np.asarray, jax_init_train_state(jax_smoke(arch), jax.random.PRNGKey(0)))


CASES = [
    ("qwen2.5-3b", {}),
    ("mamba2-130m", {}),
    ("hymba-1.5b", {}),
    ("kimi-k2-1t-a32b", {}),
    ("deepseek-v2-lite-16b", {}),
    ("qwen2.5-3b", {"num_microbatches": 2}),
    ("mamba2-130m", {"num_microbatches": 2}),
    ("qwen2.5-3b", {"remat": "full"}),
    ("mamba2-130m", {"remat": "full"}),
    ("qwen2.5-3b", {"remat": "dots"}),
    ("qwen2.5-3b", {"logits_chunk": 8}),
]


@pytest.mark.parametrize("arch, over", CASES, ids=lambda x: str(x) if x else "base")
def test_one_step_matches_jax(arch, over):
    jcfg = jax_smoke(arch).replace(**over)
    tcfg = get_smoke_config(arch).replace(**over)
    state0 = _jax_state(arch)
    batch = _batch(jcfg, np.random.default_rng(0), batch=4)
    opt = dict(warmup_steps=0)  # lr through the cosine branch

    jstate, jm = jax.jit(jax_make_train_step(jcfg, jopt.AdamWConfig(**opt)))(state0, batch)
    tstate, tm = make_train_step(tcfg, AdamWConfig(**opt))(
        bridge.params_from_jax(state0, device="cpu"), _tensors(batch))

    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=GNORM_RTOL)
    np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]), rtol=LR_RTOL)
    assert tm["lr"].dtype == torch.float32
    got, want = bridge.params_to_numpy(tstate), jax.tree.map(np.asarray, jstate)
    assert got["opt"]["step"].dtype == np.int32 and int(got["opt"]["step"]) == 1
    for part in ("m", "v"):
        for (path, t), (_, j) in zip(bridge.flatten(got["opt"][part]),
                                     bridge.flatten(want["opt"][part])):
            assert _rel_l2(t, j) <= MOMENT_REL_L2, (part, path, _rel_l2(t, j))
    for (path, t), (_, j), (_, p0) in zip(bridge.flatten(got["params"]),
                                          bridge.flatten(want["params"]),
                                          bridge.flatten(state0["params"])):
        assert t.dtype == j.dtype and t.shape == j.shape
        assert _rel_l2(t - p0, j - p0) <= UPDATE_REL_L2, (path, _rel_l2(t - p0, j - p0))


def test_train_state_bridges_both_ways():
    """A whole train state, with its 0-d int32 step, through the bridge."""
    state = _jax_state("qwen2.5-3b")
    back = bridge.params_to_numpy(bridge.params_from_jax(state, device="cpu"))
    pairs, back_pairs = bridge.flatten(state), bridge.flatten(back)
    assert [p for p, _ in pairs] == [p for p, _ in back_pairs]
    assert [p for p, _ in pairs] == [
        tuple(k.key for k in path) for path, _ in jax.tree_util.tree_flatten_with_path(state)[0]]
    for (_, a), (_, b) in zip(pairs, back_pairs):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    assert back["opt"]["step"].shape == () and back["opt"]["step"].dtype == np.int32
    assert bridge.unflatten(back_pairs).keys() == {"params", "opt"}


def test_encoder_decoder_train_step_raises():
    """whisper's step dispatches to ``repro_torch.models.whisper`` (held to
    JAX in ``tests/test_torch_whisper.py``); a batch without frame
    embeddings raises there, as the JAX step's ``batch["frame_embeds"]``
    does, and leaves the state alone."""
    cfg = get_smoke_config("whisper-tiny")
    state = init_train_state(cfg, torch.Generator().manual_seed(0))
    assert {"encoder", "decoder", "enc_pos", "dec_pos"} <= set(state["params"])
    before = state["params"]["final_norm"]["scale"].clone()
    step = make_train_step(cfg, AdamWConfig())
    with pytest.raises(KeyError, match="frame_embeds"):
        step(state, {"tokens": torch.zeros((1, 4), dtype=torch.int32)})
    assert int(state["opt"]["step"]) == 0
    assert torch.equal(state["params"]["final_norm"]["scale"], before)


# -- the reference's model smoke tests, against the port --------------------------------


@pytest.mark.parametrize("arch", DENSE + SSM + HYBRID + MOE + ENCDEC)
def test_train_step_runs(arch):
    cfg = get_smoke_config(arch)
    state = init_train_state(cfg, torch.Generator().manual_seed(0))
    state, metrics = make_train_step(cfg, AdamWConfig())(
        state, _tensors(_batch(cfg, np.random.default_rng(0))))
    loss = float(metrics["loss"])
    assert np.isfinite(loss)
    # roughly at-init cross-entropy: ln(V) +- slack
    assert 0.2 * np.log(cfg.vocab_size) < loss < 3.0 * np.log(cfg.vocab_size)
    assert all(bool(torch.isfinite(x).all()) for _, x in bridge.flatten(state["params"]))


@pytest.mark.parametrize("arch", DENSE + SSM + MOE + ENCDEC)
def test_loss_decreases(arch):
    """Five steps on the same batch must reduce the loss (optimizer sanity)."""
    cfg = get_smoke_config(arch)
    state = init_train_state(cfg, torch.Generator().manual_seed(1))
    step = make_train_step(cfg, AdamWConfig(lr=3e-3, warmup_steps=0))
    batch = _tensors(_batch(cfg, np.random.default_rng(1)))
    losses = []
    for _ in range(5):
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
    assert losses[-1] < losses[0]


def _clone(state):
    return {k: _clone(v) for k, v in state.items()} if isinstance(state, dict) else state.clone()


@pytest.mark.parametrize("arch", DENSE + SSM + ENCDEC)
def test_microbatched_train_step_matches_single(arch):
    cfg = get_smoke_config(arch)
    batch = _tensors(_batch(cfg, np.random.default_rng(9), batch=4))
    s1 = init_train_state(cfg, torch.Generator().manual_seed(9))
    s2 = _clone(s1)
    s1, m1 = make_train_step(cfg.replace(num_microbatches=1), AdamWConfig())(s1, batch)
    s2, m2 = make_train_step(cfg.replace(num_microbatches=2), AdamWConfig())(s2, batch)
    np.testing.assert_allclose(float(m1["loss"]), float(m2["loss"]), rtol=1e-4)
    w1 = bridge.flatten(s1["params"])[0][1]
    w2 = bridge.flatten(s2["params"])[0][1]
    np.testing.assert_allclose(w1.numpy(), w2.numpy(), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("arch", DENSE + SSM + HYBRID + MOE)
@pytest.mark.parametrize("remat", ["full", "dots"])
def test_remat_matches_no_remat(arch, remat):
    cfg = get_smoke_config(arch)
    batch = _tensors(_batch(cfg, np.random.default_rng(10)))
    s1 = init_train_state(cfg, torch.Generator().manual_seed(10))
    s2 = _clone(s1)
    _, m1 = make_train_step(cfg.replace(remat="none"), AdamWConfig())(s1, batch)
    _, m2 = make_train_step(cfg.replace(remat=remat), AdamWConfig())(s2, batch)
    np.testing.assert_allclose(float(m1["loss"]), float(m2["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(m1["grad_norm"]), float(m2["grad_norm"]), rtol=1e-5)


@pytest.mark.parametrize("arch", DENSE + SSM)
def test_logits_chunk_matches_full(arch):
    cfg = get_smoke_config(arch)
    batch = _tensors(_batch(cfg, np.random.default_rng(11)))
    state = init_train_state(cfg, torch.Generator().manual_seed(11))
    _, m1 = make_train_step(cfg.replace(logits_chunk=0), AdamWConfig())(_clone(state), batch)
    _, m2 = make_train_step(cfg.replace(logits_chunk=8), AdamWConfig())(_clone(state), batch)
    np.testing.assert_allclose(float(m1["loss"]), float(m2["loss"]), rtol=1e-4)


def test_vlm_patch_embedding_injection():
    """Patches change the result, and the port's forward with patches equals
    the JAX package's on the same weights (tolerance 1e-4, as the model
    parity tests)."""
    arch = "internvl2-2b"
    cfg = get_smoke_config(arch)
    assert cfg.num_image_tokens > 0
    rng = np.random.default_rng(6)
    tokens = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    patches = rng.normal(size=(B, cfg.num_image_tokens, cfg.d_model)).astype(np.float32)
    jparams = jtx.init_params(jax_smoke(arch), jax.random.PRNGKey(6))
    params = bridge.params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    with torch.no_grad():
        with_p, _, _ = tx.forward(cfg, params, torch.from_numpy(tokens),
                                  patch_embeds=torch.from_numpy(patches))
        without, _, _ = tx.forward(cfg, params, torch.from_numpy(tokens))
    # patches must actually change the result
    assert not np.allclose(with_p.numpy(), without.numpy())
    want, _, _ = jtx.forward(jax_smoke(arch), jparams, jnp.asarray(tokens),
                             patch_embeds=jnp.asarray(patches))
    np.testing.assert_allclose(with_p.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)


# -- the reference's optimizer tests, against the port ----------------------------------


def test_schedule_warmup_and_decay():
    cfg = AdamWConfig(lr=1e-3, warmup_steps=10, total_steps=100, min_lr_ratio=0.1)
    lr0 = float(schedule(cfg, torch.tensor(0)))
    lr_mid = float(schedule(cfg, torch.tensor(10)))
    lr_end = float(schedule(cfg, torch.tensor(100)))
    assert lr0 < lr_mid
    assert abs(lr_mid - 1e-3) < 1e-9
    assert abs(lr_end - 1e-4) < 1e-8


@pytest.mark.parametrize("step", [0, 3, 10, 55, 100, 130])
def test_schedule_matches_jax(step):
    """At step 0, in the warmup, at its end, mid-decay, the end and past it:
    float32 values within 1e-6 relative (a cosine may round either way)."""
    kw = dict(lr=1e-3, warmup_steps=10, total_steps=100, min_lr_ratio=0.1)
    got = schedule(AdamWConfig(**kw), torch.tensor(step, dtype=torch.int32))
    want = jopt.schedule(jopt.AdamWConfig(**kw), jnp.asarray(step, jnp.int32))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def test_global_norm():
    tree = {"a": torch.tensor([3.0]), "b": torch.tensor([4.0])}
    assert abs(float(global_norm(tree)) - 5.0) < 1e-6


def test_gradient_clipping_applied():
    params = {"w": torch.ones(4)}
    opt = init_opt_state(params)
    huge = {"w": torch.full((4,), 1e6)}
    cfg = AdamWConfig(clip_norm=1.0, warmup_steps=0)
    _, opt, metrics = apply_updates(cfg, params, huge, opt)
    assert float(metrics["grad_norm"]) > 1.0  # pre-clip norm reported
    # the clipped gradient reaches the first moment: (1 - b1) * g * scale
    np.testing.assert_allclose(opt["m"]["w"].numpy(), np.full(4, 0.1 * 0.5), rtol=1e-6)
    assert torch.equal(huge["w"], torch.full((4,), 1e6))  # grads are left as they are


def test_adamw_quadratic_convergence():
    """AdamW drives a quadratic toward its minimum."""
    params = {"x": torch.tensor([5.0])}
    opt = init_opt_state(params)
    cfg = AdamWConfig(lr=0.5, warmup_steps=0, weight_decay=0.0,
                      total_steps=200, min_lr_ratio=1.0)
    x_hist = []
    for _ in range(100):
        grads = {"x": 2 * params["x"]}
        params, opt, _ = apply_updates(cfg, params, grads, opt)
        x_hist.append(float(params["x"][0]))
    assert abs(x_hist[-1]) < 0.5


def test_apply_updates_works_in_place():
    """Parameters and moments are written into the tensors passed in (the
    counterpart of JAX's donation); the step is a new int32 tensor."""
    params = {"a": {"w": torch.randn(3, 2)}, "b": torch.randn(5)}
    opt = init_opt_state(params)
    ids = [id(t) for _, t in bridge.flatten(params) + bridge.flatten(opt)]
    grads = {"a": {"w": torch.randn(3, 2)}, "b": torch.randn(5)}
    new_params, new_opt, _ = apply_updates(AdamWConfig(warmup_steps=0), params, grads, opt)
    assert new_params is params
    assert [id(t) for _, t in bridge.flatten(new_params) + bridge.flatten(
        {"m": new_opt["m"], "v": new_opt["v"], "step": opt["step"]})] == ids
    assert new_opt["step"].dtype == torch.int32 and int(new_opt["step"]) == 1
    assert not any(t.requires_grad for _, t in bridge.flatten(new_params))


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "mamba2-130m"])
def test_stacked_leaves_are_split_once(arch):
    """Each stacked layer leaf reaches the layers through one ``unbind``,
    whose backward stacks the layers' gradients once; indexing layer by
    layer would give each layer's backward a zero buffer of the whole stack."""
    cfg = get_smoke_config(arch)
    params = bridge.params_from_jax(_jax_state(arch)["params"], device="cpu")
    stacked = {path: t.requires_grad_() for path, t in bridge.flatten(params)
               if path[0] == "layers"}
    loss = tx.loss_fn(cfg, params, _tensors(_batch(cfg, np.random.default_rng(0))))
    consumers: dict[int, list[str]] = {}
    seen, todo = set(), [loss.grad_fn]
    while todo:
        node = todo.pop()
        if node is None or node in seen:
            continue
        seen.add(node)
        for nxt, _ in node.next_functions:
            if nxt is not None and hasattr(nxt, "variable"):
                consumers.setdefault(id(nxt.variable), []).append(type(node).__name__)
            todo.append(nxt)
    for path, t in stacked.items():
        assert consumers[id(t)] == ["UnbindBackward0"], (path, consumers.get(id(t)))


# -- the EP form through both training drivers -------------------------------------------


def test_ep_driver_step_matches_the_jax_driver(tmp_path, monkeypatch):
    """kimi-k2's smoke config with ``moe_impl="ep"`` (capacity factor 1.25),
    two steps of batch 8 x seq 256 through each driver from the port's
    initial state; the JAX driver runs on an ``Auto``-axis (1, 1) mesh (see
    ``tests/test_torch_launch_train.py``).  The port's EP form must run,
    and drop tokens."""
    from jax.sharding import AxisType

    from repro.launch import train as jax_train
    from repro_torch.launch import train as train_mod
    from repro_torch.models import moe

    arch = "kimi-k2-1t-a32b"
    state0 = bridge.params_to_numpy(init_train_state(
        get_smoke_config(arch), torch.Generator().manual_seed(0)))
    monkeypatch.setattr(jax_train, "init_train_state",
                        lambda cfg, rng: jax.tree.map(jnp.asarray, state0))
    monkeypatch.setattr(jax_train, "build_mesh", lambda args: jax.make_mesh(
        (1, 1), ("data", "model"), axis_types=(AxisType.Auto,) * 2))
    monkeypatch.setattr(jax_train, "get_smoke_config",
                        lambda a: jax_smoke(a).replace(moe_impl="ep"))
    monkeypatch.setattr(train_mod, "get_smoke_config",
                        lambda a: get_smoke_config(a).replace(moe_impl="ep"))
    dropped = []
    real_pack = moe._dispatch_pack

    def pack(cfg, x2, top_i, top_w, capacity):
        send, book = real_pack(cfg, x2, top_i, top_w, capacity)
        dropped.append(int((book[1] == capacity).sum()))
        return send, book

    monkeypatch.setattr(moe, "_dispatch_pack", pack)
    argv = ["--smoke", "--arch", arch, "--steps", "2", "--log-every", "1", "--ckpt-every", "0"]
    port = train_mod.train(train_mod.parse_args(
        argv + ["--device", "cpu", "--run-dir", str(tmp_path / "port")]))
    ref = jax_train.train(jax_train.parse_args(argv + ["--run-dir", str(tmp_path / "jax")]))
    got = [(e["step"], e["loss"]) for e in port["log"]]
    want = [(e["step"], e["loss"]) for e in ref["log"]]
    assert [s for s, _ in got] == [s for s, _ in want] == [0, 1]
    np.testing.assert_allclose([v for _, v in got], [v for _, v in want], rtol=1e-4)
    n_moe = get_smoke_config(arch).num_layers - 1
    assert len(dropped) == 2 * n_moe and sum(dropped) > 0
