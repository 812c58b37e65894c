"""The port's dense decoder against the JAX package on bridged weights.

Smoke configs of the dense archs, float32 on the CPU.  The JAX package makes
the weights (``jax.random``), ``repro_torch.bridge`` carries them leaf by
leaf, and both frameworks run the same tokens.  Tolerance 1e-4: float32
reductions taken in another order through two layers (the observed gap is
a few 1e-6).  Greedy tokens must be identical.
"""

from __future__ import annotations

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
from repro_torch.models import attention as tattn
from repro_torch.models import transformer as tx

torch.set_num_threads(1)

DENSE = ["qwen2.5-3b", "phi4-mini-3.8b", "granite-20b", "starcoder2-15b", "internvl2-2b"]
NOT_PORTED = ["mamba2-130m", "hymba-1.5b", "deepseek-v2-lite-16b", "kimi-k2-1t-a32b",
              "whisper-tiny"]
TOL = dict(rtol=1e-4, atol=1e-4)
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


@pytest.mark.parametrize("arch", DENSE)
@pytest.mark.parametrize("impl", ["reference", "pallas"])
def test_forward_matches_jax(arch, impl):
    jcfg, tcfg, jp, tp = _setup(arch, impl)
    toks = _tokens(jcfg)
    jout, _, _ = jtx.forward(jcfg.replace(attention_impl=impl), jp, jnp.asarray(toks))
    fa_ops.launch_count = 0
    tout, cache, aux = tx.forward(tcfg, tp, torch.from_numpy(toks).long())
    assert cache is None and float(aux) == 0.0
    assert fa_ops.launch_count == 0  # CPU: the plain version, no launch
    _close(tout, jout)


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


@pytest.mark.parametrize("arch", NOT_PORTED)
def test_unported_families_raise(arch):
    cfg = get_smoke_config(arch)
    with pytest.raises(NotImplementedError):
        tx.init_params(cfg, torch.Generator().manual_seed(0))
    with pytest.raises(NotImplementedError):
        tx.init_cache(cfg, 1, 8, device="cpu")


def test_ring_cache_and_cross_attention_raise():
    _, tcfg, _, tp = _setup("qwen2.5-3b")
    p = {k: v[0] for k, v in tp["layers"]["attn"].items()}
    x = torch.zeros(1, 4, tcfg.d_model)
    pos = torch.arange(4)[None]
    cache = tattn.init_kv_cache(tcfg, 1, 8, window=4, device="cpu")
    with pytest.raises(NotImplementedError, match="ring"):
        tattn.apply_attention(tcfg, p, x, positions=pos, window=4, cache=cache)
    with pytest.raises(NotImplementedError, match="cross"):
        tattn.apply_attention(tcfg, p, x, positions=pos, cross_kv=(x, x))


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
