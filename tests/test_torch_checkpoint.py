"""The port's checkpoint manager and data pipeline over the port's Store.

The reference's own tests (``tests/test_train_infra.py``: checkpoint round
trip, restart, async save, retention, lazy restore; synthetic batches and
the proxy prefetcher) against ``repro_torch.train``, plus what the port adds:
the snapshot of an async save is a copy that the next in-place step cannot
change, bfloat16 leaves travel as their raw bits, evicted keys leave the
store, and manifests list key paths in ``jax.tree.flatten``'s order.
"""

from __future__ import annotations

import threading
import time
import uuid

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke
from repro.train.train_step import init_train_state as jax_init_train_state
from repro_torch import bridge
from repro_torch.api import ConnectorSpec, StoreConfig
from repro_torch.configs import get_smoke_config
from repro_torch.core import is_proxy, is_resolved
from repro_torch.core.connectors.base import Key
from repro_torch.core.store import unregister_store
from repro_torch.train import CheckpointManager, ProxyPrefetcher, synthetic_batch
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.train_step import init_train_state, make_train_step

torch.set_num_threads(1)


@pytest.fixture
def store():
    """A registered in-memory store of the port on a fresh segment."""
    name = f"test-torch-store-{uuid.uuid4().hex[:8]}"
    s = StoreConfig(name, ConnectorSpec("memory", segment=name)).build(register=True)
    yield s
    s.connector.clear()
    s.close()
    unregister_store(name)


def _tokens(cfg, seed=0, shape=(2, 16)):
    rng = np.random.default_rng(seed)
    return {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab_size, shape).astype(np.int32))}


def _leaves(tree):
    return [leaf for _, leaf in bridge.flatten(tree)]


# -- checkpoint/restart (fault tolerance) ---------------------------------------


def test_checkpoint_roundtrip(store, tmp_path):
    cfg = get_smoke_config("qwen2.5-3b")
    state = init_train_state(cfg, torch.Generator().manual_seed(0))
    mgr = CheckpointManager(store, str(tmp_path / "index.json"), keep=2)
    mgr.save(3, state, blocking=True)
    assert mgr.latest_step() == 3
    step, restored = mgr.restore()
    assert step == 3
    assert [p for p, _ in bridge.flatten(restored)] == [p for p, _ in bridge.flatten(state)]
    for a, b in zip(_leaves(state), _leaves(restored)):
        assert isinstance(b, np.ndarray) and b.dtype == bridge.to_numpy(a).dtype
        np.testing.assert_array_equal(bridge.to_numpy(a), b)


def test_manifest_paths_follow_the_jax_leaf_order(store, tmp_path):
    state = jax_init_train_state(jax_smoke("mamba2-130m"), jax.random.PRNGKey(0))
    mgr = CheckpointManager(store, str(tmp_path / "o.json"))
    mgr.save(1, jax.tree.map(np.asarray, state), blocking=True)
    manifest = mgr._manifest(None)
    want = [[k.key for k in path] for path, _ in jax.tree_util.tree_flatten_with_path(state)[0]]
    assert manifest["paths"] == want
    assert manifest["dtypes"][want.index(["opt", "step"])] == "int32"
    assert manifest["nbytes"] == sum(x.nbytes for x in jax.tree.leaves(state))


def test_checkpoint_restart_resumes_training(store, tmp_path):
    """Full restart loop: train, save, 'crash', restore, keep training."""
    cfg = get_smoke_config("mamba2-130m")
    batch = _tokens(cfg)
    step_fn = make_train_step(cfg, AdamWConfig())

    state = init_train_state(cfg, torch.Generator().manual_seed(0))
    for _ in range(3):
        state, _ = step_fn(state, batch)
    mgr = CheckpointManager(store, str(tmp_path / "idx.json"), keep=3)
    mgr.save(3, state, blocking=True)

    # "crash": new manager over the same index + store
    mgr2 = CheckpointManager(store, str(tmp_path / "idx.json"), keep=3)
    step, restored = mgr2.restore()
    assert step == 3
    state2, m2 = step_fn(bridge.params_from_jax(restored, device="cpu"), batch)
    state_ref, m_ref = step_fn(state, batch)
    np.testing.assert_allclose(float(m2["loss"]), float(m_ref["loss"]), rtol=1e-6)
    for a, b in zip(_leaves(state2), _leaves(state_ref)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_checkpoint_async_save(store, tmp_path):
    cfg = get_smoke_config("qwen2.5-3b")
    state = init_train_state(cfg, torch.Generator().manual_seed(1))
    mgr = CheckpointManager(store, str(tmp_path / "a.json"))
    mgr.save(1, state, blocking=False)  # returns immediately
    mgr.wait()
    assert mgr.latest_step() == 1


def test_async_save_is_not_changed_by_the_next_step(store, tmp_path, monkeypatch):
    """Step k+1 updates the state in place while step k's save is still on
    its thread: the save holds the state of step k."""
    cfg = get_smoke_config("qwen2.5-3b")
    batch = _tokens(cfg)
    step_fn = make_train_step(cfg, AdamWConfig(warmup_steps=0))
    state, _ = step_fn(init_train_state(cfg, torch.Generator().manual_seed(2)), batch)
    before = [bridge.to_numpy(t).copy() for t in _leaves(state)]

    release = threading.Event()
    put_batch = store.put_batch

    def held_put_batch(objs):
        assert release.wait(timeout=60)
        return put_batch(objs)

    monkeypatch.setattr(store, "put_batch", held_put_batch)
    mgr = CheckpointManager(store, str(tmp_path / "c.json"))
    mgr.save(1, state)  # the save thread now waits inside put_batch
    state, _ = step_fn(state, batch)  # in place, while the save is in flight
    assert any(not np.array_equal(bridge.to_numpy(t), b) for t, b in zip(_leaves(state), before))
    release.set()
    _, saved = mgr.restore(step=1)
    for got, want in zip(_leaves(saved), before):
        np.testing.assert_array_equal(got, want)


def test_checkpoint_retention_evicts(store, tmp_path):
    mgr = CheckpointManager(store, str(tmp_path / "r.json"), keep=2)
    keys = []
    for s in range(4):
        mgr.save(s, {"w": np.full(100, s)}, blocking=True)
        keys.append(mgr._manifest(s)["keys"])
    steps = [m["step"] for m in mgr._index["checkpoints"]]
    assert steps == [2, 3]
    # evicted checkpoints are gone from the connector
    assert mgr.restore(step=0) is None
    for s, ks in enumerate(keys):
        present = [store.exists(Key(k["object_id"], k["size"], k["tag"])) for k in ks]
        assert present == [s >= 2] * len(ks)
    got = mgr.restore(step=2)
    assert got is not None and float(np.asarray(got[1]["w"])[0]) == 2.0


def test_lazy_restore_returns_proxies(store, tmp_path):
    mgr = CheckpointManager(store, str(tmp_path / "l.json"))
    state = {"layer": {"w": np.ones((64, 64)), "b": np.zeros(64)}}
    mgr.save(7, state, blocking=True)
    step, lazy = mgr.restore_lazy()
    leaves = _leaves(lazy)
    assert all(is_proxy(leaf) for leaf in leaves)
    assert all(not is_resolved(leaf) for leaf in leaves)
    # resolving one shard does not resolve the others
    np.testing.assert_array_equal(np.asarray(leaves[1]), np.ones((64, 64)))
    assert is_resolved(leaves[1]) and not is_resolved(leaves[0])
    t = bridge.to_tensor(leaves[0], device="cpu")
    assert t.dtype == torch.float64 and torch.equal(t, torch.zeros(64, dtype=torch.float64))


def test_to_tensor_takes_a_proxy_of_a_tensor(store):
    """The store decodes a tensor as an ndarray; the proxy's class still
    reads as the tensor's."""
    t = torch.arange(12.0).reshape(3, 4)
    p = store.proxy(t)
    assert is_proxy(p) and isinstance(p, torch.Tensor) and not is_resolved(p)
    got = bridge.to_tensor(p, device="cpu")
    assert type(got) is torch.Tensor and torch.equal(got, t)


def test_bfloat16_leaves_travel_as_raw_bits(store, tmp_path):
    w = torch.randn(5, 7, generator=torch.Generator().manual_seed(3)).to(torch.bfloat16)
    mgr = CheckpointManager(store, str(tmp_path / "b.json"))
    mgr.save(1, {"w": w, "x": torch.ones(3)}, blocking=True)
    manifest = mgr._manifest(1)
    assert manifest["dtypes"] == ["bfloat16", "float32"]
    k = manifest["keys"][0]
    stored = store.get(Key(k["object_id"], k["size"], k["tag"]))
    assert stored.dtype == np.uint16 and stored.shape == (5, 7)
    _, eager = mgr.restore()
    assert eager["w"].dtype == torch.bfloat16 and torch.equal(eager["w"], w)
    _, lazy = mgr.restore_lazy()
    assert is_proxy(lazy["w"]) and not is_resolved(lazy["w"])
    assert torch.equal(bridge.to_tensor(lazy["w"], device="cpu"), w)


def test_dtypes_numpy_cannot_hold_are_refused(store, tmp_path):
    mgr = CheckpointManager(store, str(tmp_path / "f.json"))
    with pytest.raises(ValueError, match="cannot store"):
        mgr.save(1, {"w": torch.zeros(4, dtype=torch.float8_e4m3fn)}, blocking=True)
    assert mgr.latest_step() is None


# -- data pipeline -----------------------------------------------------------------


def test_synthetic_batch_shapes():
    rng = np.random.default_rng(0)
    b = synthetic_batch(rng, 4, 16, 100, extras={"emb": (4, 8, 32)})
    assert b["tokens"].shape == (4, 16) and b["tokens"].dtype == np.int32
    assert b["tokens"].max() < 100
    assert b["emb"].shape == (4, 8, 32)


def test_prefetcher_yields_proxies(store):
    rng = np.random.default_rng(0)

    def make(i):
        return synthetic_batch(rng, 2, 8, 50)

    with ProxyPrefetcher(store, make, depth=2) as pf:
        seen = 0
        for p in pf:
            assert is_proxy(p)
            tokens = p["tokens"]
            assert tokens.shape == (2, 8)
            # a resolved batch is read-only: the bridge copies it into a tensor
            t = bridge.to_tensor(tokens, device="cpu")
            assert t.dtype == torch.int32 and np.array_equal(t.numpy(), np.asarray(tokens))
            seen += 1
            if seen >= 4:
                break
    assert seen == 4


def test_prefetcher_overlaps_production(store):
    """While the consumer works, the producer fills the queue (double-buffer)."""
    calls = []

    def make(i):
        calls.append(i)
        return {"x": np.zeros(10)}

    with ProxyPrefetcher(store, make, depth=3) as pf:
        next(pf)
        time.sleep(0.3)  # consumer "computes"; producer should run ahead
        assert len(calls) >= 3
