"""The port's sharding rules against the JAX package's, leaf for leaf.

Every leaf of each arch's full-size train state (built once per arch, the
port's under ``FakeTensorMode`` and the JAX package's under
``jax.eval_shape``) must get the same spec from the port's
``ShardingRules`` over an ``abstract_mesh`` as from the JAX package's over
its ``AbstractMesh``: on the (16, 16) and (2, 16, 16) production meshes,
with and without ``fsdp_pod``, and with ``fsdp_params=False`` (the serving
layout).  The same for the decode caches of the five archs that
``tests/test_sharding.py`` checks, at batch 128 and 1024 slots.  Then the
properties of the eight JAX sharding tests, on the port's rules, and the
mapping of a spec to DTensor placements on a fake 512-rank mesh.
"""

from __future__ import annotations

import functools
import math

import jax
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.configs import get_config as jax_config
from repro.distributed.sharding import ShardingRules as JaxRules
from repro.distributed.sharding import abstract_mesh as jax_abstract_mesh
from repro.models import transformer as jtx
from repro.models import whisper as jwh
from repro.train.train_step import init_train_state as jax_init_state
from repro_torch.bridge import flatten
from repro_torch.configs import get_config, list_archs
from repro_torch.distributed.sharding import ShardingRules, abstract_mesh, placements
from repro_torch.models import transformer as tx
from repro_torch.models import whisper as wh
from repro_torch.train.train_step import init_train_state

torch.set_num_threads(1)

MESHES = {"single": ((16, 16), ("data", "model")),
          "multi": ((2, 16, 16), ("pod", "data", "model"))}
OPTIONS = [("single", {}), ("single", {"fsdp_params": False}),
           ("multi", {}), ("multi", {"fsdp_pod": True}), ("multi", {"fsdp_params": False})]
CACHE_ARCHS = ["granite-20b", "deepseek-v2-lite-16b", "mamba2-130m", "hymba-1.5b",
               "whisper-tiny"]


def _fake(fn):
    with FakeTensorMode(allow_non_fake_inputs=True):
        return fn()


@functools.lru_cache(maxsize=None)
def _states(arch: str):
    port = _fake(lambda: init_train_state(get_config(arch), torch.Generator().manual_seed(0)))
    ref = jax.eval_shape(lambda: jax_init_state(jax_config(arch), jax.random.PRNGKey(0)))
    return port, ref


@functools.lru_cache(maxsize=None)
def _caches(arch: str):
    cfg, jcfg = get_config(arch), jax_config(arch)
    if cfg.is_encdec:
        port = _fake(lambda: wh.init_cache(cfg, 128, 1024, cfg.encoder_seq, device="cpu"))
        ref = jax.eval_shape(lambda: jwh.init_cache(jcfg, 128, 1024, jcfg.encoder_seq))
    else:
        port = _fake(lambda: tx.init_cache(cfg, 128, 1024, device="cpu"))
        ref = jax.eval_shape(lambda: jtx.init_cache(jcfg, 128, 1024))
    return port, ref


def _by_path_port(specs) -> dict[str, tuple]:
    return {"/".join(p): s for p, s in flatten(specs)}


def _by_path_jax(shardings) -> dict[str, tuple]:
    from jax.sharding import NamedSharding

    leaves = jax.tree_util.tree_flatten_with_path(
        shardings, is_leaf=lambda x: isinstance(x, NamedSharding))[0]
    return {"/".join(str(getattr(k, "key", k)) for k in p): tuple(sh.spec) for p, sh in leaves}


def _rules(kind: str, opts: dict):
    shape, names = MESHES[kind]
    return (ShardingRules(abstract_mesh(shape, names), **opts),
            JaxRules(jax_abstract_mesh(shape, names), **opts))


@pytest.mark.parametrize("kind, opts", OPTIONS, ids=lambda o: str(o))
@pytest.mark.parametrize("arch", list_archs())
def test_state_specs_equal_jax(arch, kind, opts):
    port_state, jax_state = _states(arch)
    rules, jrules = _rules(kind, opts)
    got = _by_path_port(rules.state_shardings(port_state))
    want = _by_path_jax(jrules.state_shardings(jax_state))
    assert got.keys() == want.keys()
    bad = {p: (got[p], want[p]) for p in got if got[p] != want[p]}
    assert not bad, bad


@pytest.mark.parametrize("kind, opts", OPTIONS, ids=lambda o: str(o))
@pytest.mark.parametrize("arch", CACHE_ARCHS)
def test_cache_specs_equal_jax(arch, kind, opts):
    port_cache, jax_cache = _caches(arch)
    rules, jrules = _rules(kind, opts)
    got = _by_path_port(rules.cache_shardings(port_cache))
    want = _by_path_jax(jrules.cache_shardings(jax_cache))
    assert got.keys() == want.keys()
    assert got == want


@pytest.mark.parametrize("kind", ["single", "multi"])
def test_batch_specs_equal_jax(kind):
    rules, jrules = _rules(kind, {})
    for ndim in (1, 2, 3):
        assert rules.batch_spec(ndim) == tuple(jrules.batch_spec(ndim).spec)
    assert rules.batch_sharding() == tuple(jrules.batch_sharding().spec)


# -- the JAX sharding tests' properties, on the port ---------------------------------------


def _axis_size(mesh, axis) -> int:
    if axis is None:
        return 1
    if isinstance(axis, tuple):
        return math.prod(mesh.shape[a] for a in axis)
    return mesh.shape[axis]


def _assert_spec_divides(mesh, spec, shape, path=""):
    assert len(spec) <= len(shape), f"{path}: spec longer than shape"
    for dim, axis in zip(shape, tuple(spec) + (None,) * len(shape)):
        n = _axis_size(mesh, axis)
        assert dim % n == 0, f"{path}: dim {dim} not divisible by {axis}={n}"


@pytest.mark.parametrize("kind", ["single", "multi"])
@pytest.mark.parametrize("arch", list_archs())
def test_state_shardings_divide(arch, kind):
    """Every full-config param/opt leaf gets a spec whose axes divide it."""
    rules, _ = _rules(kind, {})
    state = _states(arch)[0]
    specs = dict(flatten(rules.state_shardings(state)))
    leaves = flatten(state)
    assert len(leaves) == len(specs)
    for path, leaf in leaves:
        _assert_spec_divides(rules.mesh, specs[path], tuple(leaf.shape), "/".join(path))


@pytest.mark.parametrize("arch", CACHE_ARCHS)
def test_cache_shardings_divide(arch):
    rules, _ = _rules("single", {})
    cache = _caches(arch)[0]
    specs = dict(flatten(rules.cache_shardings(cache)))
    for path, leaf in flatten(cache):
        _assert_spec_divides(rules.mesh, specs[path], tuple(leaf.shape), "/".join(path))


def test_scalars_get_empty_spec():
    rules, _ = _rules("single", {})
    tree = {"opt": {"step": torch.empty((), dtype=torch.int32, device="meta")}}
    assert rules.state_shardings(tree)["opt"]["step"] == ()


def test_moments_shard_like_params():
    """ZeRO invariant: Adam moments inherit the param's spec exactly."""
    rules, _ = _rules("single", {})
    sh = rules.state_shardings(_states("granite-20b")[0])
    assert _by_path_port(sh["params"]) == _by_path_port(sh["opt"]["m"])
    assert _by_path_port(sh["params"]) == _by_path_port(sh["opt"]["v"])


def test_big_weights_are_sharded_not_replicated():
    """Large matrices must not silently fall back to replication."""
    rules, _ = _rules("single", {})
    state = _states("kimi-k2-1t-a32b")[0]
    specs = dict(flatten(rules.state_shardings(state)))
    replicated_big = [("/".join(p), tuple(leaf.shape)) for p, leaf in flatten(state)
                      if leaf.numel() >= (1 << 22) and all(a is None for a in specs[p])]
    assert not replicated_big, f"replicated big tensors: {replicated_big}"


def test_mqa_single_kv_head_replicates():
    """granite kv=1: the KV head dim must not be sharded 16-way."""
    rules, _ = _rules("single", {})
    assert rules.param_spec("layers/attn/w_k", (6144, 1, 128))[1] is None


def test_pod_axis_only_in_multipod():
    assert _rules("multi", {})[0].dp_axes == ("pod", "data")
    assert _rules("single", {})[0].dp_axes == ("data",)


def test_fsdp_pod_option_widens_fsdp():
    rules, _ = _rules("multi", {"fsdp_pod": True})
    # embed (V, d): fsdp over (pod, data) = 32-way when it divides
    spec = rules.param_spec("embedding/embed", (163840, 7168))
    assert spec[0] == "model" and spec[1] == ("pod", "data")


# -- specs as DTensor placements -----------------------------------------------------------


@pytest.fixture
def fake_mesh_512():
    """The (2, 16, 16) mesh over a fake process group of 512 ranks, torn
    down after the test (the group is global to the process)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", rank=0, world_size=512, store=FakeStore())
    try:
        yield init_device_mesh("cpu", (2, 16, 16), mesh_dim_names=("pod", "data", "model"))
    finally:
        dist.destroy_process_group()


def test_specs_map_to_placements(fake_mesh_512):
    from torch.distributed.tensor import Replicate, Shard

    mesh = fake_mesh_512
    cases = {
        (("pod", "data"), "model"): [Shard(0), Shard(0), Shard(1)],
        (None, "model", None): [Replicate(), Replicate(), Shard(1)],
        ("data", None): [Replicate(), Shard(0), Replicate()],
        (): [Replicate(), Replicate(), Replicate()],
        (None, None, ("pod", "data")): [Shard(2), Shard(2), Replicate()],
    }
    for spec, want in cases.items():
        assert placements(spec, mesh) == want, spec
    # every spec of the rules maps: each named axis shards its dim once
    rules = ShardingRules(mesh, fsdp_pod=True)
    names = list(mesh.mesh_dim_names)
    for path, spec in flatten(rules.state_shardings(_states("deepseek-v2-lite-16b")[0])):
        pl = placements(spec, mesh)
        for dim, axis in enumerate(spec):
            for name in (axis if isinstance(axis, tuple) else (axis,) if axis else ()):
                assert pl[names.index(name)] == Shard(dim), path
        assert sum(p.is_shard() for p in pl) == sum(
            len(a) if isinstance(a, tuple) else 1 for a in spec if a), path
