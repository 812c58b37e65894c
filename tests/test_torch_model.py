"""The port's dense decoder, Mamba-2, hybrid (hymba) and MoE (kimi-k2,
deepseek-v2-lite) models against the JAX package on bridged weights.

Smoke configs of the dense archs, of mamba2-130m, of hymba-1.5b (4 layers,
window 16, global layers 0 and 3) and of the two MoE archs (a dense layer
of width (top_k + shared) * expert_d_ff, then two MoE layers; kimi's
attention is GQA, deepseek's MLA), float32 on the CPU.
The JAX package makes the weights (``jax.random``), ``repro_torch.bridge``
carries them leaf by leaf, and both frameworks run the same tokens.
Tolerance 1e-4: float32 reductions taken in another order through two
layers (the observed gap is a few 1e-6).  Where the port's ``pallas``
prefill of mamba2 (the SSD kernel's plain version, the sequential
recurrence) meets the JAX reference prefill (the chunked form), the
tolerance is the JAX in-model kernel test's 3e-3.  Greedy tokens must be
identical.  hymba's prompts (24 tokens) are longer than its window, and its
decode runs long enough that every local layer's ring cache wraps.  The
MoE archs' aux loss, ``loss_fn`` with it, and the gradients are held to
the JAX package's too.  Two configs reach the kernels' wider contract:
mamba2-130m at mamba_ssm's default chunk of 256 with prompts of 300 steps
(the SSD kernel's sub-chunks), and qwen2.5-3b with float16 compute (the
flash kernel's f16 instance), held at 1e-2: float16 activations of a few
units round at 2^-10 relative at every cast, and the two frameworks round
in other places.
"""

from __future__ import annotations

import dataclasses
import functools
import uuid

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke
from repro.models import transformer as jtx
from repro_torch import bridge
from repro_torch.configs import get_smoke_config
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.models import attention as tattn
from repro_torch.models import transformer as tx
from repro_torch.runtime import trace

torch.set_num_threads(1)

DENSE = ["qwen2.5-3b", "phi4-mini-3.8b", "granite-20b", "starcoder2-15b", "internvl2-2b"]
SSM = ["mamba2-130m"]
HYBRID = ["hymba-1.5b"]
MOE = ["kimi-k2-1t-a32b", "deepseek-v2-lite-16b"]
TOL = dict(rtol=1e-4, atol=1e-4)
KERNEL_TOL = dict(rtol=3e-3, atol=3e-3)
F16_TOL = dict(rtol=1e-2, atol=1e-2)
B, S, GEN = 2, 24, 4


@functools.lru_cache(maxsize=None)
def _jax_params(arch):
    return jtx.init_params(jax_smoke(arch), jax.random.PRNGKey(0))


def _setup(arch, impl="reference", **over):
    jcfg = jax_smoke(arch).replace(**over)
    tcfg = get_smoke_config(arch).replace(attention_impl=impl, **over)
    jp = _jax_params(arch)
    tp = bridge.params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, tcfg, jp, tp


def _tokens(cfg, seed=0, shape=(B, S)):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, shape).astype(np.int32)


def _close(t, j, **tol):
    np.testing.assert_allclose(t.detach().float().numpy(), np.asarray(j, np.float32),
                               **(tol or TOL))


def _paths(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _paths(v, prefix + (k,))
    else:
        yield prefix, tree


@pytest.mark.parametrize("arch", DENSE)
def test_init_params_has_the_jax_layout(arch):
    cfg = get_smoke_config(arch)
    tp = tx.init_params(cfg, torch.Generator().manual_seed(0))
    jshapes = {p: (tuple(v.shape), np.dtype(v.dtype).name) for p, v in _paths(_jax_params(arch))}
    tshapes = {p: (tuple(v.shape), str(v.dtype).removeprefix("torch."))
               for p, v in _paths(tp)}
    assert tshapes == jshapes
    n = sum(v.numel() for _, v in _paths(tp))
    assert n == cfg.param_counts()["total"] + sum(
        v.numel() for p, v in _paths(tp) if p[-1] in ("scale", "bias") or p[-1].startswith("b_")
    )


@pytest.mark.parametrize("arch", DENSE + SSM + HYBRID + MOE)
@pytest.mark.parametrize("impl", ["reference", "pallas"])
def test_forward_matches_jax(arch, impl):
    jcfg, tcfg, jp, tp = _setup(arch, impl)
    toks = _tokens(jcfg)
    jout, _, jaux = jtx.forward(jcfg.replace(attention_impl=impl), jp, jnp.asarray(toks))
    trace.reset_counts(fa_ops.LAUNCHES, ssd_ops.LAUNCHES)
    tout, cache, aux = tx.forward(tcfg, tp, torch.from_numpy(toks).long())
    assert cache is None and aux.shape == () and aux.dtype == torch.float32
    assert (float(aux) == 0.0) == (tcfg.moe is None)  # the MoE layers' router loss
    # CPU: the plain versions
    assert trace.counter(fa_ops.LAUNCHES) == trace.counter(ssd_ops.LAUNCHES) == 0
    _close(tout, jout)
    _close(aux, jaux)


@pytest.mark.parametrize("arch", DENSE)
@pytest.mark.parametrize("impl", ["reference", "pallas"])
def test_prefill_logits_and_cache_match_jax_reference(arch, impl):
    """With ``pallas`` the port sends prompt attention to the flash path; it
    is held against the JAX package's reference prefill (kv_len over the
    cache's zero tail)."""
    jcfg, tcfg, jp, tp = _setup(arch, impl)
    toks = _tokens(jcfg, seed=1)
    jl, jcache = jtx.prefill(jcfg, jp, jnp.asarray(toks), jtx.init_cache(jcfg, B, S + 8))
    tcache = tx.init_cache(tcfg, B, S + 8, device="cpu")
    tl, tcache2 = tx.prefill(tcfg, tp, torch.from_numpy(toks).long(), tcache)
    assert tcache2 is tcache  # updated in place
    _close(tl, jl)
    for name in ("k", "v"):
        _close(tcache["layers"][name], jcache["layers"][name])
    np.testing.assert_array_equal(tcache["layers"]["length"].numpy(),
                                  np.asarray(jcache["layers"]["length"]))


@pytest.mark.parametrize("arch", DENSE)
@pytest.mark.parametrize("aligned", [False, True])
def test_multi_step_decode_matches_jax(arch, aligned):
    jcfg, tcfg, jp, tp = _setup(arch, "pallas", aligned_decode=aligned)
    toks = _tokens(jcfg, seed=2)
    jl, jcache = jtx.prefill(jcfg, jp, jnp.asarray(toks), jtx.init_cache(jcfg, B, S + GEN + 1))
    tcache = tx.init_cache(tcfg, B, S + GEN + 1, device="cpu")
    tl, tcache = tx.prefill(tcfg, tp, torch.from_numpy(toks).long(), tcache)
    for i in range(GEN):
        jt = jnp.argmax(jl[:, -1:], axis=-1).astype(jnp.int32)
        tt = tl[:, -1:].argmax(-1)
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
        pos = np.full((B, 1), S + i, np.int32)
        jl, jcache = jtx.decode_step(jcfg, jp, jcache, jt, jnp.asarray(pos))
        tl, tcache = tx.decode_step(tcfg, tp, tcache, tt, torch.from_numpy(pos).long())
        _close(tl, jl)
    for name in ("k", "v"):
        _close(tcache["layers"][name], jcache["layers"][name])
    assert tcache["layers"]["length"].eq(S + GEN).all()


def test_prefill_then_decode_matches_forward():
    """Decoding token by token reproduces the cache-free forward's logits."""
    _, tcfg, _, tp = _setup("qwen2.5-3b", "pallas")
    toks = torch.from_numpy(_tokens(tcfg, seed=3, shape=(B, S + 3))).long()
    hidden, _, _ = tx.forward(tcfg, tp, toks)
    from repro_torch.models.layers import logits_matmul

    full = logits_matmul(tcfg, tp["embedding"], hidden)
    cache = tx.init_cache(tcfg, B, S + 8, device="cpu")
    logits, cache = tx.prefill(tcfg, tp, toks[:, :S], cache)
    torch.testing.assert_close(logits[:, 0], full[:, S - 1], **TOL)
    for i in range(3):
        pos = torch.full((B, 1), S + i, dtype=torch.long)
        logits, cache = tx.decode_step(tcfg, tp, cache, toks[:, S + i:S + i + 1], pos)
        torch.testing.assert_close(logits[:, 0], full[:, S + i], **TOL)


def test_init_cache_matches_jax_layout():
    jcfg, tcfg = jax_smoke("qwen2.5-3b"), get_smoke_config("qwen2.5-3b")
    jc = jtx.init_cache(jcfg, 3, 40)
    tc = tx.init_cache(tcfg, 3, 40, device="cpu")
    for name in ("k", "v", "length"):
        assert tuple(tc["layers"][name].shape) == tuple(jc["layers"][name].shape)
        assert not tc["layers"][name].any()
    assert tc["layers"]["length"].dtype == torch.int32


def test_mamba_init_params_has_the_jax_layout():
    cfg = get_smoke_config("mamba2-130m")
    tp = tx.init_params(cfg, torch.Generator().manual_seed(0))
    jshapes = {p: (tuple(v.shape), np.dtype(v.dtype).name)
               for p, v in _paths(_jax_params("mamba2-130m"))}
    tshapes = {p: (tuple(v.shape), str(v.dtype).removeprefix("torch.")) for p, v in _paths(tp)}
    assert tshapes == jshapes
    assert ("layers", "mamba", "w_in") in tshapes and ("layers", "attn", "w_q") not in tshapes
    assert "unembed" not in tp["embedding"]  # tied embeddings


@pytest.mark.parametrize("impl", ["reference", "pallas"])
def test_mamba_prefill_logits_and_cache_match_jax_reference(impl):
    """With ``pallas`` the port sends the prompt's SSD scan to the kernel's
    path from the cache's (zero) state; it is held against the JAX package's
    reference prefill (``ssd_chunked`` from the same state)."""
    jcfg, tcfg, jp, tp = _setup("mamba2-130m", impl)
    tol = TOL if impl == "reference" else KERNEL_TOL
    toks = _tokens(jcfg, seed=1)
    jl, jcache = jtx.prefill(jcfg, jp, jnp.asarray(toks), jtx.init_cache(jcfg, B, S + 8))
    tcache = tx.init_cache(tcfg, B, S + 8, device="cpu")
    trace.reset_counts(ssd_ops.LAUNCHES)
    tl, tcache2 = tx.prefill(tcfg, tp, torch.from_numpy(toks).long(), tcache)
    assert tcache2 is tcache and trace.counter(ssd_ops.LAUNCHES) == 0
    _close(tl, jl, **tol)
    for name in ("conv", "state"):
        assert tcache["layers"][name].shape == jcache["layers"][name].shape
        _close(tcache["layers"][name], jcache["layers"][name], **tol)


def test_mamba_multi_step_decode_matches_jax():
    """The serve path: the port's ``pallas`` prefill, then greedy decode
    steps, against the JAX reference prefill and decode."""
    jcfg, tcfg, jp, tp = _setup("mamba2-130m", "pallas")
    toks = _tokens(jcfg, seed=2)
    jl, jcache = jtx.prefill(jcfg, jp, jnp.asarray(toks), jtx.init_cache(jcfg, B, S + GEN + 1))
    tcache = tx.init_cache(tcfg, B, S + GEN + 1, device="cpu")
    tl, tcache = tx.prefill(tcfg, tp, torch.from_numpy(toks).long(), tcache)
    for i in range(GEN):
        jt = jnp.argmax(jl[:, -1:], axis=-1).astype(jnp.int32)
        tt = tl[:, -1:].argmax(-1)
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
        pos = np.full((B, 1), S + i, np.int32)
        jl, jcache = jtx.decode_step(jcfg, jp, jcache, jt, jnp.asarray(pos))
        tl, tcache = tx.decode_step(tcfg, tp, tcache, tt, torch.from_numpy(pos).long())
        _close(tl, jl, **KERNEL_TOL)
    for name in ("conv", "state"):
        _close(tcache["layers"][name], jcache["layers"][name], **KERNEL_TOL)


def test_mamba_prefill_then_decode_matches_forward():
    """Decoding token by token reproduces the cache-free forward's logits."""
    _, tcfg, _, tp = _setup("mamba2-130m", "pallas")
    toks = torch.from_numpy(_tokens(tcfg, seed=3, shape=(B, S + 3))).long()
    hidden, _, _ = tx.forward(tcfg, tp, toks)
    from repro_torch.models.layers import logits_matmul

    full = logits_matmul(tcfg, tp["embedding"], hidden)
    cache = tx.init_cache(tcfg, B, S + 8, device="cpu")
    logits, cache = tx.prefill(tcfg, tp, toks[:, :S], cache)
    torch.testing.assert_close(logits[:, 0], full[:, S - 1], **TOL)
    for i in range(3):
        pos = torch.full((B, 1), S + i, dtype=torch.long)
        logits, cache = tx.decode_step(tcfg, tp, cache, toks[:, S + i:S + i + 1], pos)
        torch.testing.assert_close(logits[:, 0], full[:, S + i], **TOL)


def test_mamba_init_cache_matches_jax_layout():
    jcfg, tcfg = jax_smoke("mamba2-130m"), get_smoke_config("mamba2-130m")
    jc = jtx.init_cache(jcfg, 3, 40)
    tc = tx.init_cache(tcfg, 3, 40, device="cpu")
    assert set(tc["layers"]) == set(jc["layers"]) == {"conv", "state"}
    for name in ("conv", "state"):
        assert tuple(tc["layers"][name].shape) == tuple(jc["layers"][name].shape)
        assert not tc["layers"][name].any()
    assert tc["layers"]["state"].dtype == torch.float32


def test_bridge_carries_mamba2_params():
    """The bridge is generic over nested dicts: the mamba block's leaves
    cross with their stacked layer dim, shapes, dtypes and values."""
    jp = jax.tree.map(np.asarray, _jax_params("mamba2-130m"))
    tp = bridge.params_from_jax(jp, device="cpu")
    names = {"w_in", "conv_w", "conv_b", "a_log", "dt_bias", "d_skip", "norm_scale", "w_out"}
    assert set(tp["layers"]) == {"ln1", "mamba"} and set(tp["layers"]["mamba"]) == names
    n_layers = jax_smoke("mamba2-130m").num_layers
    for (pa, a), (pb, b) in zip(_paths(jp), _paths(tp)):
        assert pa == pb and tuple(b.shape) == a.shape
        if pa[0] == "layers":
            assert b.shape[0] == n_layers
        np.testing.assert_array_equal(b.numpy(), a)


# -- hymba: the hybrid layer, ring and windowed caches ---------------------------------

HYMBA = "hymba-1.5b"
RING_GEN = 10  # decode steps after a 24-token prompt: the 16-slot rings wrap at step 9


def _close_cache(tcache, jcache, **tol):
    """Every group's {"attn", "ssm"} cache: the buffers within ``tol`` (a
    ring's slots included), the lengths equal."""
    assert set(tcache) == set(jcache)
    for g in tcache:
        assert set(tcache[g]) == set(jcache[g]) == {"attn", "ssm"}
        for part in ("attn", "ssm"):
            for name, t in tcache[g][part].items():
                j = jcache[g][part][name]
                assert tuple(t.shape) == tuple(j.shape), (g, part, name)
                if name == "length":
                    np.testing.assert_array_equal(t.numpy(), np.asarray(j))
                else:
                    _close(t, j, **tol)


def test_hymba_init_params_has_the_jax_layout():
    cfg = get_smoke_config(HYMBA)
    tp = tx.init_params(cfg, torch.Generator().manual_seed(0))
    jp = _jax_params(HYMBA)
    jshapes = {p: (tuple(v.shape), np.dtype(v.dtype).name) for p, v in _paths(jp)}
    tshapes = {p: (tuple(v.shape), str(v.dtype).removeprefix("torch.")) for p, v in _paths(tp)}
    assert tshapes == jshapes
    assert [p for p, _ in bridge.flatten(tp)] == [p for p, _ in bridge.flatten(jp)]
    assert list(tp) == ["embedding", "global0", "local1", "global1", "final_norm"]
    assert list(tp["local1"]) == ["ln1", "attn", "ln2", "mamba", "beta_attn", "beta_ssm", "mlp"]
    assert tp["local1"]["beta_attn"].shape == (2, cfg.d_model)
    for name in ("beta_attn", "beta_ssm"):
        assert tp["global0"][name].eq(1).all()


def test_hymba_init_cache_matches_jax_layout():
    """Each group's window sets its ring size; global layers keep a linear cache."""
    jcfg, tcfg = jax_smoke(HYMBA), get_smoke_config(HYMBA)
    jc = jtx.init_cache(jcfg, 3, 40)
    tc = tx.init_cache(tcfg, 3, 40, device="cpu")
    for g in tc:
        for part in ("attn", "ssm"):
            for name, t in tc[g][part].items():
                assert tuple(t.shape) == tuple(jc[g][part][name].shape)
                assert not t.any()
    assert tc["local1"]["attn"]["k"].shape[2] == tcfg.sliding_window
    assert tc["global0"]["attn"]["k"].shape[2] == 40


@pytest.mark.parametrize("impl", ["reference", "pallas"])
def test_hymba_prefill_logits_and_cache_match_jax_reference(impl):
    """A 24-token prompt into the 16-slot rings: the local layers attend
    through the window and keep the prompt's last 16 keys; with ``pallas``
    the global layers' prompt attention and every SSD scan take the kernels'
    paths (their plain versions here)."""
    jcfg, tcfg, jp, tp = _setup(HYMBA, impl)
    tol = TOL if impl == "reference" else KERNEL_TOL
    toks = _tokens(jcfg, seed=1)
    jl, jcache = jtx.prefill(jcfg, jp, jnp.asarray(toks), jtx.init_cache(jcfg, B, S + 8))
    tcache = tx.init_cache(tcfg, B, S + 8, device="cpu")
    trace.reset_counts(fa_ops.LAUNCHES, ssd_ops.LAUNCHES)
    tl, tcache2 = tx.prefill(tcfg, tp, torch.from_numpy(toks).long(), tcache)
    assert tcache2 is tcache
    assert trace.counter(fa_ops.LAUNCHES) == trace.counter(ssd_ops.LAUNCHES) == 0
    _close(tl, jl, **tol)
    _close_cache(tcache, jcache, **tol)
    assert tcache["local1"]["attn"]["length"].eq(S).all()


@pytest.mark.parametrize("impl, aligned", [("reference", False), ("pallas", False),
                                           ("pallas", True)])
def test_hymba_multi_step_decode_matches_jax(impl, aligned):
    """Greedy decode through the rings' wrap against the JAX package; the
    aligned write applies to the global layers' linear caches only."""
    jcfg, tcfg, jp, tp = _setup(HYMBA, impl, aligned_decode=aligned)
    tol = TOL if impl == "reference" else KERNEL_TOL
    toks = _tokens(jcfg, seed=2)
    max_len = S + RING_GEN + 1
    jl, jcache = jtx.prefill(jcfg, jp, jnp.asarray(toks), jtx.init_cache(jcfg, B, max_len))
    tcache = tx.init_cache(tcfg, B, max_len, device="cpu")
    tl, tcache = tx.prefill(tcfg, tp, torch.from_numpy(toks).long(), tcache)
    for i in range(RING_GEN):
        jt = jnp.argmax(jl[:, -1:], axis=-1).astype(jnp.int32)
        tt = tl[:, -1:].argmax(-1)
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
        pos = np.full((B, 1), S + i, np.int32)
        jl, jcache = jtx.decode_step(jcfg, jp, jcache, jt, jnp.asarray(pos))
        tl, tcache = tx.decode_step(tcfg, tp, tcache, tt, torch.from_numpy(pos).long())
        _close(tl, jl, **tol)
    _close_cache(tcache, jcache, **tol)
    size = tcfg.sliding_window
    assert (S + RING_GEN) // size > S // size  # the write slot went past the ring's end
    assert tcache["local1"]["attn"]["length"].eq(S + RING_GEN).all()


def test_hymba_prefill_then_decode_matches_forward():
    """Decoding through the rings reproduces the cache-free forward, whose
    local layers mask to the window."""
    _, tcfg, _, tp = _setup(HYMBA, "pallas")
    toks = torch.from_numpy(_tokens(tcfg, seed=3, shape=(B, S + RING_GEN))).long()
    hidden, _, _ = tx.forward(tcfg, tp, toks)
    from repro_torch.models.layers import logits_matmul

    full = logits_matmul(tcfg, tp["embedding"], hidden)
    cache = tx.init_cache(tcfg, B, S + RING_GEN, device="cpu")
    logits, cache = tx.prefill(tcfg, tp, toks[:, :S], cache)
    torch.testing.assert_close(logits[:, 0], full[:, S - 1], **TOL)
    for i in range(RING_GEN):
        pos = torch.full((B, 1), S + i, dtype=torch.long)
        logits, cache = tx.decode_step(tcfg, tp, cache, toks[:, S + i:S + i + 1], pos)
        torch.testing.assert_close(logits[:, 0], full[:, S + i], **TOL)


def test_sliding_window_restricts_context():
    """Hymba local layers: a token far outside the window must not affect
    the current position (full-attention layers excluded); the port's
    forwards equal the JAX package's on the same weights."""
    jcfg = jax_smoke(HYMBA).replace(global_layers=())
    cfg = get_smoke_config(HYMBA).replace(global_layers=())
    rng = np.random.default_rng(7)
    n = cfg.sliding_window * 3
    toks = rng.integers(0, cfg.vocab_size, (1, n)).astype(np.int32)
    toks2 = toks.copy()
    toks2[0, 0] = (toks2[0, 0] + 1) % cfg.vocab_size  # perturb far-past token
    jp = jtx.init_params(jcfg, jax.random.PRNGKey(7))
    params = bridge.params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    a, _, _ = tx.forward(cfg, params, torch.from_numpy(toks).long())
    b, _, _ = tx.forward(cfg, params, torch.from_numpy(toks2).long())
    # SSM heads carry unbounded state, so only *attention* is windowed;
    # final positions still differ through the mamba path -- instead check
    # the perturbation influence decays to numerical noise by the end.
    diff = (a[0, -1] - b[0, -1]).abs().max().item()
    near = (a[0, 1] - b[0, 1]).abs().max().item()
    assert near > diff  # influence decays with distance
    for t, tk in ((a, toks), (b, toks2)):
        _close(t, jtx.forward(jcfg, jp, jnp.asarray(tk))[0])


def _ring_cache(rng, size, length, B=2, KV=2, hd=4):
    """A ring cache of random contents (np arrays), ``length`` tokens seen."""
    return {"k": rng.normal(size=(B, size, KV, hd)).astype(np.float32),
            "v": rng.normal(size=(B, size, KV, hd)).astype(np.float32),
            "length": np.asarray(length, np.int32)}


def _torch_cache(c):
    return {name: torch.from_numpy(a.copy()) for name, a in c.items()}


@pytest.mark.parametrize("S_new", [10, 16, 40])  # below, at and past the ring's size
def test_fill_ring_cache_matches_jax(S_new):
    from repro.models.attention import _fill_ring_cache as jax_fill

    rng = np.random.default_rng(S_new)
    size = 16
    c = _ring_cache(rng, size, [0, 0])
    k = rng.normal(size=(2, S_new, 2, 4)).astype(np.float32)
    v = rng.normal(size=(2, S_new, 2, 4)).astype(np.float32)
    want = jax_fill({n: jnp.asarray(a) for n, a in c.items()}, jnp.asarray(k), jnp.asarray(v))
    tc = _torch_cache(c)
    buffers = (tc["k"], tc["v"], tc["length"])
    got = tattn._fill_ring_cache(tc, torch.from_numpy(k), torch.from_numpy(v))
    assert got is tc and all(a is b for a, b in zip(buffers, (tc["k"], tc["v"], tc["length"])))
    for name in ("k", "v", "length"):
        np.testing.assert_array_equal(tc[name].numpy(), np.asarray(want[name]))
    # slot pos % size holds absolute position pos for the prompt's last min(size, S) tokens
    last = S_new - 1
    np.testing.assert_array_equal(tc["k"][:, last % size].numpy(), k[:, last])


@pytest.mark.parametrize("aligned", [False, True])
def test_ring_update_matches_jax_across_the_wrap(aligned):
    """A ring write of 3 steps from lengths 14 and 40 (slots 14, 15, 0 and
    8, 9, 10): buffers, kv_len capped at the size, q_offset 0 and no causal
    mask, as the JAX function gives them; ``aligned`` does not apply."""
    from repro.models.attention import _update_kv_cache as jax_update

    rng = np.random.default_rng(11)
    size = 16
    c = _ring_cache(rng, size, [14, 40])
    k = rng.normal(size=(2, 3, 2, 4)).astype(np.float32)
    v = rng.normal(size=(2, 3, 2, 4)).astype(np.float32)
    jk, jv, jc, jlen, joff, jcausal = jax_update(
        {n: jnp.asarray(a) for n, a in c.items()}, jnp.asarray(k), jnp.asarray(v),
        None, size, aligned=aligned)
    tc = _torch_cache(c)
    tk, tv, tc2, tlen, toff, tcausal = tattn._update_kv_cache(
        tc, torch.from_numpy(k), torch.from_numpy(v), None, size, aligned=aligned)
    assert tc2 is tc and tk is tc["k"] and tcausal is jcausal is False
    for got, want in ((tk, jk), (tv, jv), (tc["length"], jc["length"]), (tlen, jlen),
                      (toff, joff)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(tlen.numpy(), [size, size])
    np.testing.assert_array_equal(tk[0, [14, 15, 0]].numpy(), k[0])


# -- MoE: kimi-k2 (GQA attention) and deepseek-v2-lite (MLA) ---------------------------

def _close_groups(tcache, jcache, **tol):
    """Every group's cache: buffers within ``tol``, lengths equal."""
    assert set(tcache) == set(jcache)
    for g in tcache:
        assert set(tcache[g]) == set(jcache[g]), g
        for name, t in tcache[g].items():
            j = jcache[g][name]
            assert tuple(t.shape) == tuple(j.shape), (g, name)
            if name == "length":
                np.testing.assert_array_equal(t.numpy(), np.asarray(j))
            else:
                _close(t, j, **tol)


@pytest.mark.parametrize("arch", MOE)
def test_moe_init_params_has_the_jax_layout(arch):
    """Key paths, shapes and dtypes of the JAX tree, leaf for leaf; the
    leading dense layer is (top_k + shared) * expert_d_ff wide."""
    cfg = get_smoke_config(arch)
    tp = tx.init_params(cfg, torch.Generator().manual_seed(0))
    jpairs = bridge.flatten(jax.tree.map(np.asarray, _jax_params(arch)))
    tpairs = bridge.flatten(tp)
    assert [p for p, _ in tpairs] == [p for p, _ in jpairs]
    for (path, t), (_, j) in zip(tpairs, jpairs):
        assert tuple(t.shape) == j.shape and str(t.dtype) == f"torch.{j.dtype}", path
    assert list(tp) == ["embedding", "dense0", "moe", "final_norm"]
    f = (cfg.moe.top_k + cfg.moe.num_shared) * cfg.moe.expert_d_ff
    assert tx._dense_ff_for_moe(cfg) == f != cfg.d_ff
    assert tp["dense0"]["mlp"]["w_gate"].shape == (1, cfg.d_model, f)
    assert tp["moe"]["moe"]["w_gate"].shape == (cfg.num_layers - 1, cfg.moe.num_experts,
                                                cfg.d_model, cfg.moe.expert_d_ff)


def test_init_params_of_a_one_layer_group_is_the_layer_itself():
    """A group of one layer is its layer with a stacked dim of 1, not a copy."""
    cfg = get_smoke_config("kimi-k2-1t-a32b")
    tp = tx.init_params(cfg, torch.Generator().manual_seed(0))
    w = tp["dense0"]["mlp"]["w_gate"]
    assert w._base is not None and w._base.shape == w.shape[1:]
    assert tp["moe"]["moe"]["w_gate"]._base is None  # two layers: one stack


@pytest.mark.parametrize("arch", MOE)
def test_moe_loss_and_grads_match_jax(arch):
    """``loss_fn`` with the router aux term, and every leaf's gradient."""
    jcfg, tcfg, jp, tp = _setup(arch)
    batch = {"tokens": _tokens(jcfg, seed=4)}
    jloss, jgrads = jax.value_and_grad(lambda p: jtx.loss_fn(jcfg, p, batch))(jp)
    pairs = [(path, t.requires_grad_()) for path, t in bridge.flatten(tp)]
    loss = tx.loss_fn(tcfg, bridge.unflatten(pairs), {"tokens": torch.from_numpy(batch["tokens"])})
    loss.backward()
    _close(loss, jloss)
    _, _, aux = jtx.forward(jcfg, jp, jnp.asarray(batch["tokens"]))
    assert float(aux) > 0.0  # the aux term is in the loss
    for (path, t), (_, g) in zip(pairs, bridge.flatten(jax.tree.map(np.asarray, jgrads))):
        _close(t.grad, g, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("arch", MOE)
@pytest.mark.parametrize("impl", ["reference", "pallas"])
def test_moe_prefill_logits_and_cache_match_jax_reference(arch, impl):
    """kimi's prompt attention takes the flash path with ``pallas`` (its plain
    version here); deepseek's MLA writes the latent cache either way."""
    jcfg, tcfg, jp, tp = _setup(arch, impl)
    toks = _tokens(jcfg, seed=1)
    jl, jcache = jtx.prefill(jcfg, jp, jnp.asarray(toks), jtx.init_cache(jcfg, B, S + 8))
    tcache = tx.init_cache(tcfg, B, S + 8, device="cpu")
    trace.reset_counts(fa_ops.LAUNCHES)
    tl, tcache2 = tx.prefill(tcfg, tp, torch.from_numpy(toks).long(), tcache)
    assert tcache2 is tcache and trace.counter(fa_ops.LAUNCHES) == 0
    _close(tl, jl)
    _close_groups(tcache, jcache)
    assert tcache["moe"]["length"].eq(S).all()


@pytest.mark.parametrize("arch", MOE)
def test_moe_multi_step_decode_matches_jax(arch):
    """The serve path: ``pallas`` prefill, then greedy decode steps, each
    MoE layer in its dense form, against the JAX package."""
    jcfg, tcfg, jp, tp = _setup(arch, "pallas")
    toks = _tokens(jcfg, seed=2)
    jl, jcache = jtx.prefill(jcfg, jp, jnp.asarray(toks), jtx.init_cache(jcfg, B, S + GEN + 1))
    tcache = tx.init_cache(tcfg, B, S + GEN + 1, device="cpu")
    tl, tcache = tx.prefill(tcfg, tp, torch.from_numpy(toks).long(), tcache)
    for i in range(GEN):
        jt = jnp.argmax(jl[:, -1:], axis=-1).astype(jnp.int32)
        tt = tl[:, -1:].argmax(-1)
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
        pos = np.full((B, 1), S + i, np.int32)
        jl, jcache = jtx.decode_step(jcfg, jp, jcache, jt, jnp.asarray(pos))
        tl, tcache = tx.decode_step(tcfg, tp, tcache, tt, torch.from_numpy(pos).long())
        _close(tl, jl)
    _close_groups(tcache, jcache)
    assert tcache["moe"]["length"].eq(S + GEN).all()


@pytest.mark.parametrize("arch", MOE)
def test_moe_prefill_then_decode_matches_forward(arch):
    """Decoding token by token (deepseek: the absorbed form against the
    latent cache) reproduces the cache-free forward's (expanded) logits."""
    _, tcfg, _, tp = _setup(arch, "pallas")
    toks = torch.from_numpy(_tokens(tcfg, seed=3, shape=(B, S + 3))).long()
    hidden, _, _ = tx.forward(tcfg, tp, toks)
    from repro_torch.models.layers import logits_matmul

    full = logits_matmul(tcfg, tp["embedding"], hidden)
    cache = tx.init_cache(tcfg, B, S + 8, device="cpu")
    logits, cache = tx.prefill(tcfg, tp, toks[:, :S], cache)
    torch.testing.assert_close(logits[:, 0], full[:, S - 1], **TOL)
    for i in range(3):
        pos = torch.full((B, 1), S + i, dtype=torch.long)
        logits, cache = tx.decode_step(tcfg, tp, cache, toks[:, S + i:S + i + 1], pos)
        torch.testing.assert_close(logits[:, 0], full[:, S + i], **TOL)


@pytest.mark.parametrize("arch", MOE)
def test_moe_init_cache_matches_jax_layout(arch):
    """kimi: a KV cache per group; deepseek: the latent cache (c, k_rope)."""
    jcfg, tcfg = jax_smoke(arch), get_smoke_config(arch)
    jc = jtx.init_cache(jcfg, 3, 40)
    tc = tx.init_cache(tcfg, 3, 40, device="cpu")
    assert set(tc) == set(jc) == {"dense0", "moe"}
    for g in tc:
        assert set(tc[g]) == set(jc[g])
        for name, t in tc[g].items():
            assert tuple(t.shape) == tuple(jc[g][name].shape) and not t.any()
            assert str(t.dtype) == f"torch.{np.dtype(jc[g][name].dtype).name}"
    assert set(tc["moe"]) == ({"c", "k_rope", "length"} if tcfg.mla else {"k", "v", "length"})


def test_transformer_refuses_an_encoder_decoder_config():
    """whisper-tiny has its own module; the decoder-only one refuses it."""
    cfg = get_smoke_config("whisper-tiny")
    with pytest.raises(ValueError, match="repro_torch.models.whisper"):
        tx.init_params(cfg, torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="repro_torch.models.whisper"):
        tx.init_cache(cfg, 1, 8, device="cpu")
    with pytest.raises(ValueError, match="repro_torch.models.whisper"):
        tx.forward(cfg, {}, torch.zeros((1, 4), dtype=torch.long))


def test_chunked_attention_matches_jax_with_offsets():
    """Ragged chunks, per-row kv_len and q_offset, and a window, in f32."""
    from repro.models.attention import chunked_attention as jax_chunked

    rng = np.random.default_rng(5)
    q = rng.normal(size=(2, 37, 2, 3, 16)).astype(np.float32)
    k = rng.normal(size=(2, 50, 2, 16)).astype(np.float32)
    v = rng.normal(size=(2, 50, 2, 16)).astype(np.float32)
    kv_len = np.array([50, 41], np.int32)
    q_off = np.array([13, 4], np.int32)
    kw = dict(causal=True, window=20, chunk=16)
    jout = jax_chunked(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                       q_offset=jnp.asarray(q_off), kv_len=jnp.asarray(kv_len), **kw)
    tout = tattn.chunked_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        q_offset=torch.from_numpy(q_off), kv_len=torch.from_numpy(kv_len), **kw)
    _close(tout, jout)


def test_bridge_round_trip_is_exact():
    jp = jax.tree.map(np.asarray, _jax_params("starcoder2-15b"))
    back = bridge.params_to_numpy(bridge.params_from_jax(jp, device="cpu"))
    for (pa, a), (pb, b) in zip(_paths(jp), _paths(back)):
        assert pa == pb
        np.testing.assert_array_equal(a, b)
    with pytest.raises(TypeError):
        bridge.params_from_jax(jp)  # the device is always named
    bf = np.asarray(jnp.linspace(-3, 3, 11, dtype=jnp.bfloat16))
    t = bridge.to_tensor(bf, device="cpu")
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(bridge.to_numpy(t), bf)


def test_to_tensor_resolves_a_proxy_of_the_ports_store():
    from repro_torch.api import ConnectorSpec, StoreConfig
    from repro_torch.core.store import unregister_store

    seg = f"torch-{uuid.uuid4().hex[:8]}"
    store = StoreConfig("torch-bridge", ConnectorSpec("memory", segment=seg)).build(register=True)
    try:
        arr = np.arange(12, dtype=np.float32).reshape(3, 4)
        proxy = store.proxy(arr)
        t = bridge.to_tensor(proxy, device="cpu")
        torch.testing.assert_close(t, torch.from_numpy(arr))
        t += 1  # a writable copy, not a view of the store's read-only buffer
    finally:
        store.connector.clear()
        store.close()
        unregister_store("torch-bridge")


@pytest.mark.parametrize("path", ["forward", "prefill"])
def test_mamba_at_chunk_256_matches_jax_through_the_kernel_path(path):
    """mamba_ssm's default chunk of 256 over prompts of 300 steps, with
    ``pallas`` on both sides: the JAX kernel (interpret mode) at chunk 256
    in the forward, the port's kernel path (its plain version here) against
    the JAX reference prefill from the cache's zero state."""
    jcfg, tcfg, jp, tp = _setup("mamba2-130m", "pallas")
    jcfg = jcfg.replace(ssm=dataclasses.replace(jcfg.ssm, chunk=256), attention_impl="pallas")
    tcfg = tcfg.replace(ssm=dataclasses.replace(tcfg.ssm, chunk=256))
    assert tcfg.ssm.chunk == 256
    toks = _tokens(jcfg, seed=3, shape=(B, 300))
    trace.reset_counts(ssd_ops.LAUNCHES)
    if path == "forward":
        jout, _, _ = jtx.forward(jcfg, jp, jnp.asarray(toks))
        tout, _, _ = tx.forward(tcfg, tp, torch.from_numpy(toks).long())
        _close(tout, jout)
    else:
        jl, jcache = jtx.prefill(jcfg, jp, jnp.asarray(toks), jtx.init_cache(jcfg, B, 308))
        tcache = tx.init_cache(tcfg, B, 308, device="cpu")
        tl, tcache = tx.prefill(tcfg, tp, torch.from_numpy(toks).long(), tcache)
        _close(tl, jl)
        for name in ("conv", "state"):
            _close(tcache["layers"][name], jcache["layers"][name])
    assert trace.counter(ssd_ops.LAUNCHES) == 0  # CPU: the plain version


@pytest.mark.parametrize("path", ["forward", "prefill"])
def test_qwen_in_float16_matches_jax_through_the_flash_path(path):
    """float16 compute with ``pallas`` on both sides: the JAX flash kernel
    (interpret mode) in float16 against the port's flash path (its plain
    version here); the prefill's cache too."""
    jcfg, tcfg, jp, tp = _setup("qwen2.5-3b", "pallas")
    jcfg = jcfg.replace(compute_dtype=jnp.float16, attention_impl="pallas")
    tcfg = tcfg.replace(compute_dtype=torch.float16)
    toks = _tokens(jcfg, seed=4)
    trace.reset_counts(fa_ops.LAUNCHES)
    if path == "forward":
        jout, _, _ = jtx.forward(jcfg, jp, jnp.asarray(toks))
        tout, _, _ = tx.forward(tcfg, tp, torch.from_numpy(toks).long())
        assert tout.dtype == torch.float16 and jout.dtype == jnp.float16
        _close(tout, jout, **F16_TOL)
    else:
        jl, jcache = jtx.prefill(jcfg, jp, jnp.asarray(toks), jtx.init_cache(jcfg, B, S + 8))
        tcache = tx.init_cache(tcfg, B, S + 8, device="cpu")
        tl, tcache = tx.prefill(tcfg, tp, torch.from_numpy(toks).long(), tcache)
        _close(tl, jl, **F16_TOL)
        for name in ("k", "v"):
            assert tcache["layers"][name].dtype == torch.float16
            _close(tcache["layers"][name], jcache["layers"][name], **F16_TOL)
    assert trace.counter(fa_ops.LAUNCHES) == 0
