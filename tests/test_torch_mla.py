"""The port's MLA (multi-head latent attention) against the JAX package's.

deepseek-v2-lite's smoke config (d_model 64, 4 heads, kv_lora_rank 32,
rope 8, nope 16, v 16), float32 on the CPU, weights from the JAX package's
``init_attention`` carried across with ``repro_torch.bridge``; tolerance
1e-4 (float32 reductions in another order).  Both forms: expanded without a
cache, absorbed against the latent cache (a prefill into an empty cache,
decode steps, and a write that wraps the buffer).  MLA reaches no kernel:
``attention_impl="pallas"`` changes nothing and launches nothing.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke
from repro.models import attention as jattn
from repro_torch import bridge
from repro_torch.configs import get_smoke_config
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.models import attention as tattn
from repro_torch.runtime import trace

torch.set_num_threads(1)

ARCH = "deepseek-v2-lite-16b"
TOL = dict(rtol=1e-4, atol=1e-4)
B, S = 2, 24


@functools.lru_cache(maxsize=None)
def _jax_params():
    return jattn.init_attention(jax_smoke(ARCH), jax.random.PRNGKey(1))


def _setup(impl="reference"):
    jcfg = jax_smoke(ARCH)
    tcfg = get_smoke_config(ARCH).replace(attention_impl=impl)
    jp = _jax_params()
    return jcfg, tcfg, jp, bridge.params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")


def _x(cfg, seed, s=S):
    return np.random.default_rng(seed).normal(size=(B, s, cfg.d_model)).astype(np.float32)


def _positions(start, s=S):
    return np.broadcast_to(np.arange(start, start + s, dtype=np.int32), (B, s)).copy()


def _close(t, j):
    np.testing.assert_allclose(t.detach().float().numpy(), np.asarray(j, np.float32), **TOL)


def _jcache(c):
    return {k: jnp.asarray(v) for k, v in c.items()}


def test_init_attention_mla_has_the_jax_layout():
    cfg = get_smoke_config(ARCH)
    tp = tattn.init_attention(cfg, torch.Generator().manual_seed(0))
    jp = jax.tree.map(np.asarray, _jax_params())
    assert list(tp) == ["w_q", "w_dkv", "w_uk", "w_uv", "w_o"] and set(tp) == set(jp)
    for name, t in tp.items():
        assert tuple(t.shape) == jp[name].shape and t.dtype == torch.float32, name
    m = cfg.mla
    assert abs(tp["w_uk"].std().item() * m.kv_lora_rank**0.5 - 1) < 0.1


@pytest.mark.parametrize("impl", ["reference", "pallas"])
@pytest.mark.parametrize("start", [0, 5])
def test_apply_mla_expanded_matches_jax(impl, start):
    """No cache: keys and values expanded per head, causal over the S tokens."""
    jcfg, tcfg, jp, tp = _setup(impl)
    x, pos = _x(jcfg, 0), _positions(start)
    jy, jc = jattn.apply_mla(jcfg, jp, jnp.asarray(x), positions=jnp.asarray(pos))
    trace.reset_counts(fa_ops.LAUNCHES)
    ty, tc = tattn.apply_mla(tcfg, tp, torch.from_numpy(x), positions=torch.from_numpy(pos).long())
    assert jc is None and tc is None and trace.counter(fa_ops.LAUNCHES) == 0
    _close(ty, jy)


def test_apply_mla_absorbed_prefill_and_decode_match_jax():
    """A prefill into an empty latent cache, then three one-token decode
    steps: outputs, both latent buffers and the lengths."""
    jcfg, tcfg, jp, tp = _setup("pallas")
    size = S + 6
    jcache = jattn.init_mla_cache(jcfg, B, size)
    tcache = tattn.init_mla_cache(tcfg, B, size, device="cpu")
    buffers = dict(tcache)
    steps = [(0, S)] + [(S + i, 1) for i in range(3)]
    trace.reset_counts(fa_ops.LAUNCHES)
    for i, (start, s) in enumerate(steps):
        x, pos = _x(jcfg, 10 + i, s), _positions(start, s)
        jy, jcache = jattn.apply_mla(jcfg, jp, jnp.asarray(x), positions=jnp.asarray(pos),
                                     cache=jcache)
        ty, tc = tattn.apply_mla(tcfg, tp, torch.from_numpy(x),
                                 positions=torch.from_numpy(pos).long(), cache=tcache)
        assert tc is tcache and all(tcache[k] is buffers[k] for k in buffers)  # in place
        _close(ty, jy)
        for name in ("c", "k_rope"):
            _close(tcache[name], jcache[name])
        np.testing.assert_array_equal(tcache["length"].numpy(), np.asarray(jcache["length"]))
    assert trace.counter(fa_ops.LAUNCHES) == 0
    np.testing.assert_array_equal(tcache["length"].numpy(), [S + 3] * B)
    assert not tcache["c"][:, S + 3:].any()


def test_latent_cache_write_wraps_like_jax():
    """Rows at lengths 8 and 3 of a 10-slot cache take 4 tokens: slots
    (length + i) % 10, so the first row wraps to slots 0 and 1."""
    jcfg, tcfg, jp, tp = _setup()
    size, s = 10, 4
    rng = np.random.default_rng(3)
    m = jcfg.mla
    c0 = {"c": rng.normal(size=(B, size, m.kv_lora_rank)).astype(np.float32),
          "k_rope": rng.normal(size=(B, size, m.qk_rope_dim)).astype(np.float32),
          "length": np.array([8, 3], np.int32)}
    x = _x(jcfg, 4, s)
    pos = np.stack([np.arange(8, 12), np.arange(3, 7)]).astype(np.int32)
    jy, jc = jattn.apply_mla(jcfg, jp, jnp.asarray(x), positions=jnp.asarray(pos),
                             cache=_jcache(c0))
    tcache = {k: torch.from_numpy(v.copy()) for k, v in c0.items()}
    ty, _ = tattn.apply_mla(tcfg, tp, torch.from_numpy(x), positions=torch.from_numpy(pos).long(),
                            cache=tcache)
    _close(ty, jy)
    for name in ("c", "k_rope"):
        _close(tcache[name], jc[name])
    np.testing.assert_array_equal(tcache["length"].numpy(), [12, 7])
    assert not np.array_equal(tcache["c"][0, [8, 9, 0, 1]].numpy(), c0["c"][0, [8, 9, 0, 1]])
    np.testing.assert_array_equal(tcache["c"][0, 2:8].numpy(), c0["c"][0, 2:8])


def test_absorbed_prefill_equals_the_expanded_form():
    """The two forms compute one function: a prefill into an empty cache
    against the cache-free forward, on the port alone."""
    _, tcfg, _, tp = _setup()
    x = torch.from_numpy(_x(tcfg, 6))
    pos = torch.from_numpy(_positions(0)).long()
    expanded, _ = tattn.apply_mla(tcfg, tp, x, positions=pos)
    cache = tattn.init_mla_cache(tcfg, B, S + 4, device="cpu")
    absorbed, _ = tattn.apply_mla(tcfg, tp, x, positions=pos, cache=cache)
    torch.testing.assert_close(absorbed, expanded, **TOL)


def test_init_mla_cache_matches_jax_layout():
    jc = jattn.init_mla_cache(jax_smoke(ARCH), 3, 40)
    tc = tattn.init_mla_cache(get_smoke_config(ARCH), 3, 40, device="cpu")
    assert list(tc) == list(jc) == ["c", "k_rope", "length"]
    for name, t in tc.items():
        assert tuple(t.shape) == tuple(jc[name].shape) and not t.any()
        assert str(t.dtype) == f"torch.{np.dtype(jc[name].dtype).name}"
