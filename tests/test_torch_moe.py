"""The port's MoE module against the JAX package's, on bridged weights.

Smoke MoE configs of kimi-k2 and deepseek-v2-lite (d_model 64, 8 experts,
top-2, one shared expert), float32 on the CPU, tolerance 1e-4 (float32
reductions in another order; observed a few 1e-7).  The dense form runs
its slab loop at several slab sizes (1, a size that leaves a ragged last
slab, and all experts at once).  The expert-parallel form is held to the
JAX package's ``apply_moe_ep`` on a one-device mesh with ``Auto`` axes at
capacity factor 1.25, where tokens are dropped, gradients included; and at
world size 2 over ``gloo`` (two spawned processes, each with its half of
the sequence and of the experts) to the port's dense form at capacity
factor 8, where nothing drops: the output, the aux loss (averaged over the
ranks, as ``pmean`` averages it) and the expert weights' gradients.
``_dispatch_pack`` and ``_combine_unpack`` must equal the JAX functions
exactly, the dropped slot included.
"""

from __future__ import annotations

import dataclasses
import functools
import multiprocessing
import socket

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AxisType

from repro.configs import get_smoke_config as jax_smoke
from repro.models import moe as jmoe
from repro_torch import bridge
from repro_torch.configs import get_smoke_config
from repro_torch.models import moe

torch.set_num_threads(1)

ARCHS = ["kimi-k2-1t-a32b", "deepseek-v2-lite-16b"]
TOL = dict(rtol=1e-4, atol=1e-4)
B, S = 2, 24
EP_WORLD = 2


@functools.lru_cache(maxsize=None)
def _jax_params(arch):
    return jmoe.init_moe(jax_smoke(arch), jax.random.PRNGKey(3))


def _setup(arch, **moe_over):
    jcfg, tcfg = jax_smoke(arch), get_smoke_config(arch)
    if moe_over:
        jcfg = jcfg.replace(moe=dataclasses.replace(jcfg.moe, **moe_over))
        tcfg = tcfg.replace(moe=dataclasses.replace(tcfg.moe, **moe_over))
    jp = _jax_params(arch)
    tp = bridge.params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, tcfg, jp, tp


def _x(cfg, seed=0, shape=(B, S)):
    return np.random.default_rng(seed).normal(size=(*shape, cfg.d_model)).astype(np.float32)


def _close(t, j, **tol):
    np.testing.assert_allclose(t.detach().float().numpy(), np.asarray(j, np.float32),
                               **(tol or TOL))


def _one_device_mesh():
    return jax.make_mesh((1, 1), ("data", "model"), axis_types=(AxisType.Auto,) * 2)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_moe_has_the_jax_layout(arch, monkeypatch):
    """Keys, shapes and dtypes of the JAX tree; the expert leaves, drawn in
    f32 a slab at a time (3 experts a slab, a ragged last slab), are
    N(0, std^2) with the JAX package's std."""
    monkeypatch.setattr(moe, "EXPERTS_PER_SLAB", 3)
    cfg = get_smoke_config(arch)
    tp = moe.init_moe(cfg, torch.Generator().manual_seed(0))
    jp = jax.tree.map(np.asarray, _jax_params(arch))
    assert [p for p, _ in bridge.flatten(tp)] == [p for p, _ in bridge.flatten(jp)]
    for (path, t), (_, j) in zip(bridge.flatten(tp), bridge.flatten(jp)):
        assert tuple(t.shape) == j.shape and str(t.dtype) == f"torch.{j.dtype}", path
    d, f = cfg.d_model, cfg.moe.expert_d_ff
    for name, std in (("w_gate", d**-0.5), ("w_up", d**-0.5), ("w_down", f**-0.5)):
        w = tp[name]
        assert abs(w.std().item() / std - 1) < 0.02 and abs(w.mean().item()) < 0.02 * std
        assert w[-1].std().item() > 0.9 * std  # the ragged last slab is drawn too
    bf = moe.init_moe(cfg.replace(param_dtype=torch.bfloat16), torch.Generator().manual_seed(0))
    assert all(t.dtype == torch.bfloat16 for _, t in bridge.flatten(bf))


@pytest.mark.parametrize("arch", ARCHS)
def test_router_matches_jax(arch):
    jcfg, tcfg, jp, tp = _setup(arch)
    x2 = _x(jcfg).reshape(-1, jcfg.d_model)
    jprobs, jtop_i, jtop_w = jmoe._router(jcfg, jp, jnp.asarray(x2))
    probs, top_i, top_w = moe._router(tcfg, tp, torch.from_numpy(x2))
    _close(probs, jprobs)
    np.testing.assert_array_equal(top_i.numpy(), np.asarray(jtop_i))
    _close(top_w, jtop_w)
    np.testing.assert_allclose(top_w.sum(-1).numpy(), 1.0, rtol=1e-6)


@pytest.mark.parametrize("arch", ARCHS)
def test_aux_loss_matches_jax(arch):
    """The same probs and picks into both: the load-balance loss."""
    jcfg, tcfg, _, _ = _setup(arch)
    rng = np.random.default_rng(4)
    E, k = jcfg.moe.num_experts, jcfg.moe.top_k
    probs = rng.dirichlet(np.ones(E), size=B * S).astype(np.float32)
    top_i = np.argsort(-probs, axis=-1)[:, :k].astype(np.int32)
    want = jmoe._aux_loss(jcfg, jnp.asarray(probs), jnp.asarray(top_i))
    got = moe._aux_loss(tcfg, torch.from_numpy(probs), torch.from_numpy(top_i).long())
    assert got.dtype == torch.float32 and got.shape == ()
    _close(got, want)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("slab", [1, 3, 8])
def test_apply_moe_dense_matches_jax(arch, slab, monkeypatch):
    """The slab loop at 1 expert a slab, 3 (a ragged last slab of 2) and all 8."""
    monkeypatch.setattr(moe, "EXPERTS_PER_SLAB", slab)
    jcfg, tcfg, jp, tp = _setup(arch)
    x = _x(jcfg, seed=1)
    jy, jaux = jmoe.apply_moe_dense(jcfg, jp, jnp.asarray(x))
    y, aux = moe.apply_moe_dense(tcfg, tp, torch.from_numpy(x))
    assert y.shape == (B, S, tcfg.d_model) and y.dtype == tcfg.compute_dtype
    _close(y, jy)
    _close(aux, jaux)


def _routing(cfg, seed, n):
    """top-k picks and weights made with numpy, the same for both packages;
    weighted towards expert 0, so that capacity drops."""
    rng = np.random.default_rng(seed)
    E, k = cfg.moe.num_experts, cfg.moe.top_k
    p = np.full(E, 1.0)
    p[0] = 4.0
    top_i = np.stack([rng.choice(E, size=k, replace=False, p=p / p.sum()) for _ in range(n)])
    top_w = rng.dirichlet(np.ones(k), size=n).astype(np.float32)
    return top_i.astype(np.int32), top_w


@pytest.mark.parametrize("capacity", [3, 7, 48])
def test_dispatch_pack_matches_jax_exactly(capacity):
    """The send buffer and the bookkeeping, overflow to slot C included."""
    jcfg, tcfg, _, _ = _setup("kimi-k2-1t-a32b")
    n = 20
    x2 = _x(jcfg, seed=2, shape=(n,))
    top_i, top_w = _routing(jcfg, capacity, n)
    jsend, jbook = jmoe._dispatch_pack(jcfg, jnp.asarray(x2), jnp.asarray(top_i),
                                       jnp.asarray(top_w), capacity)
    send, book = moe._dispatch_pack(tcfg, torch.from_numpy(x2), torch.from_numpy(top_i).long(),
                                    torch.from_numpy(top_w), capacity)
    np.testing.assert_array_equal(send.numpy(), np.asarray(jsend))
    for got, want in zip(book, jbook):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    counts = np.bincount(top_i.reshape(-1), minlength=jcfg.moe.num_experts)
    dropped = int((book[1] == capacity).sum())
    assert dropped == np.maximum(counts - capacity, 0).sum()
    assert (dropped > 0) == (capacity < counts.max())


@pytest.mark.parametrize("capacity", [3, 48])
def test_combine_unpack_matches_jax_exactly(capacity):
    jcfg, tcfg, _, _ = _setup("kimi-k2-1t-a32b")
    n = 20
    x2 = _x(jcfg, seed=3, shape=(n,))
    top_i, top_w = _routing(jcfg, 10 + capacity, n)
    recv = _x(jcfg, seed=5, shape=(jcfg.moe.num_experts, capacity))
    jbook = jmoe._dispatch_pack(jcfg, jnp.asarray(x2), jnp.asarray(top_i), jnp.asarray(top_w),
                                capacity)[1]
    book = moe._dispatch_pack(tcfg, torch.from_numpy(x2), torch.from_numpy(top_i).long(),
                              torch.from_numpy(top_w), capacity)[1]
    want = jmoe._combine_unpack(jcfg, jnp.asarray(recv), jbook, n, capacity)
    got = moe._combine_unpack(tcfg, torch.from_numpy(recv), book, n, capacity)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("arch", ARCHS)
def test_apply_moe_ep_at_ep1_matches_jax(arch):
    """A world of one against the JAX package's shard_map on a one-device
    mesh, at capacity factor 1.25 (tokens dropped): output, aux, and the
    expert and router weights' gradients of a fixed projection of the output."""
    jcfg, tcfg, jp, tp = _setup(arch)
    # a direction shared by every token skews the routing, so that capacity drops
    x = _x(jcfg, seed=6) + 1.5 * _x(jcfg, seed=12, shape=())
    cot = _x(jcfg, seed=7)
    mesh = _one_device_mesh()

    def jloss(params):
        y, aux = jmoe.apply_moe_ep(jcfg, params, jnp.asarray(x), mesh=mesh)
        return jnp.sum(y * cot), (y, aux)

    jgrads, (jy, jaux) = jax.grad(jloss, has_aux=True)(jp)
    leaves = {k: v.detach().clone().requires_grad_() for k, v in tp.items() if k != "shared"}
    params = {**leaves, "shared": tp["shared"]}
    y, aux = moe.apply_moe_ep(tcfg, params, torch.from_numpy(x), world=moe.ExpertWorld())
    (y * torch.from_numpy(cot)).sum().backward()
    _close(y, jy)
    _close(aux, jaux)
    for name, leaf in leaves.items():
        _close(leaf.grad, jgrads[name])
    # tokens were dropped: the EP form is not the dense one here
    capacity = int(np.ceil(B * S * jcfg.moe.top_k / jcfg.moe.num_experts * 1.25))
    picks = moe._router(tcfg, tp, torch.from_numpy(x).reshape(-1, tcfg.d_model))[1]
    counts = torch.bincount(picks.reshape(-1), minlength=tcfg.moe.num_experts)
    assert int(counts.max()) > capacity
    dense, _ = moe.apply_moe_dense(tcfg, tp, torch.from_numpy(x))
    assert (dense - y).abs().max() > 1e-2


def test_apply_moe_ep_without_drops_is_the_dense_form():
    """Capacity factor 8 at ep = 1: every token keeps all its experts."""
    _, tcfg, _, tp = _setup("deepseek-v2-lite-16b", capacity_factor=8.0)
    x = torch.from_numpy(_x(tcfg, seed=8))
    y, aux = moe.apply_moe_ep(tcfg, tp, x, world=moe.ExpertWorld())
    dy, daux = moe.apply_moe_dense(tcfg, tp, x)
    torch.testing.assert_close(y, dy, **TOL)
    torch.testing.assert_close(aux, daux, **TOL)


@pytest.mark.parametrize("impl, world, decode, form", [
    ("ep", moe.ExpertWorld(), False, "ep"),
    ("ep", moe.ExpertWorld(), True, "dense"),
    ("ep", None, False, "dense"),
    ("dense", moe.ExpertWorld(), False, "dense"),
])
def test_apply_moe_dispatch_rule(impl, world, decode, form, monkeypatch):
    """The JAX package's rule: EP iff moe_impl is "ep", a world is named
    and the call is not a decode."""
    _, tcfg, _, tp = _setup("kimi-k2-1t-a32b")
    taken = []
    for name in ("ep", "dense"):
        real = getattr(moe, f"apply_moe_{name}")
        monkeypatch.setattr(moe, f"apply_moe_{name}",
                            lambda *a, _n=name, _r=real, **kw: taken.append(_n) or _r(*a, **kw))
    x = torch.from_numpy(_x(tcfg, seed=9))
    moe.apply_moe(tcfg.replace(moe_impl=impl), tp, x, world=world, decode=decode)
    assert taken == [form]


def test_apply_moe_ep_rejects_a_world_experts_do_not_divide():
    _, tcfg, _, tp = _setup("kimi-k2-1t-a32b")
    half = {**tp, **{k: tp[k][:3] for k in ("w_gate", "w_up", "w_down")}}
    with pytest.raises(ValueError, match="must divide"):
        moe.apply_moe_ep(tcfg, half, torch.zeros(1, 4, tcfg.d_model), world=moe.ExpertWorld())


# -- world size 2 over gloo ----------------------------------------------------------------

EXPERT_LEAVES = ("w_gate", "w_up", "w_down")


def _ep_rank(rank: int, port: int, arrays: dict, out_path: str) -> None:
    """One rank of the EP world: its half of the sequence and of the experts."""
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=EP_WORLD)
    try:
        cfg = get_smoke_config("kimi-k2-1t-a32b")
        cfg = cfg.replace(moe_impl="ep", moe=dataclasses.replace(cfg.moe, capacity_factor=8.0))
        s_loc = arrays["x"].shape[1] // EP_WORLD
        e_loc = cfg.moe.num_experts // EP_WORLD
        tokens = slice(rank * s_loc, (rank + 1) * s_loc)
        experts = slice(rank * e_loc, (rank + 1) * e_loc)
        mine = {k: torch.from_numpy(arrays[k][experts]).requires_grad_() for k in EXPERT_LEAVES}
        params = {"router": torch.from_numpy(arrays["router"]), **mine,
                  "shared": {k: torch.from_numpy(arrays[f"shared_{k}"]) for k in EXPERT_LEAVES}}
        y, aux = moe.apply_moe_ep(cfg, params, torch.from_numpy(arrays["x"][:, tokens]),
                                  world=moe.ExpertWorld(dist.group.WORLD))
        (y * torch.from_numpy(arrays["cot"][:, tokens])).sum().backward()
        np.savez(out_path, y=y.detach().numpy(), aux=aux.detach().numpy(),
                 **{f"grad_{k}": mine[k].grad.numpy() for k in EXPERT_LEAVES})
    finally:
        dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_apply_moe_ep_world2_matches_dense(tmp_path):
    _, tcfg, _, tp = _setup("kimi-k2-1t-a32b")
    x, cot = _x(tcfg, seed=10), _x(tcfg, seed=11)
    arrays = {"x": x, "cot": cot, "router": tp["router"].numpy(),
              **{k: tp[k].numpy() for k in EXPERT_LEAVES},
              **{f"shared_{k}": tp["shared"][k].numpy() for k in EXPERT_LEAVES}}
    port = _free_port()
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_ep_rank, args=(r, port, arrays, str(tmp_path / f"rank{r}.npz")))
             for r in range(EP_WORLD)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=240)
    alive = [p for p in procs if p.is_alive()]
    for p in alive:
        p.kill()
    assert not alive and all(p.exitcode == 0 for p in procs), [p.exitcode for p in procs]
    ranks = [np.load(tmp_path / f"rank{r}.npz") for r in range(EP_WORLD)]

    dense = {k: tp[k].clone().requires_grad_() for k in EXPERT_LEAVES}
    y, _ = moe.apply_moe_dense(tcfg, {**tp, **dense}, torch.from_numpy(x))
    (y * torch.from_numpy(cot)).sum().backward()
    s_loc, e_loc = S // EP_WORLD, tcfg.moe.num_experts // EP_WORLD
    local_aux = [moe.apply_moe_dense(tcfg, tp, torch.from_numpy(x[:, r * s_loc:(r + 1) * s_loc]))[1]
                 for r in range(EP_WORLD)]
    for r, got in enumerate(ranks):
        np.testing.assert_allclose(got["y"], y[:, r * s_loc:(r + 1) * s_loc].detach().numpy(),
                                   **TOL)
        np.testing.assert_allclose(got["aux"], float(sum(local_aux)) / EP_WORLD, **TOL)
        for k in EXPERT_LEAVES:
            np.testing.assert_allclose(got[f"grad_{k}"],
                                       dense[k].grad[r * e_loc:(r + 1) * e_loc].numpy(), **TOL)
