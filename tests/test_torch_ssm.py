"""The port's Mamba-2 block against ``repro.models.ssm``, on the CPU.

The mamba2-130m smoke config in float32.  The JAX package makes the weights
(``init_mamba``), ``repro_torch.bridge`` carries them across, and both
frameworks run the same numpy inputs.  Tolerance 1e-4: float32 sums taken in
another order (the observed gap is a few 1e-6).  The port's ``pallas`` path
takes the kernel's plain version here, the sequential recurrence; the JAX
reference path is the chunked form, so where the two meet the tolerance is
the JAX in-model kernel test's 3e-3.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke
from repro.models import ssm as jssm
from repro_torch import bridge
from repro_torch.configs import get_smoke_config
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.models import ssm
from repro_torch.runtime import trace

torch.set_num_threads(1)

TOL = dict(rtol=1e-4, atol=1e-4)
KERNEL_TOL = dict(rtol=3e-3, atol=3e-3)
ARCH = "mamba2-130m"


def _close(t, j, **tol):
    np.testing.assert_allclose(t.detach().float().numpy(), np.asarray(j, np.float32),
                               **(tol or TOL))


def _setup(impl="reference"):
    jcfg = jax_smoke(ARCH)
    tcfg = get_smoke_config(ARCH).replace(attention_impl=impl)
    jp = jssm.init_mamba(jcfg, jax.random.PRNGKey(8))
    tp = bridge.params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, tcfg, jp, tp


def _scan_inputs(B=2, S=40, H=3, P=8, N=8, seed=0):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(B, S, H, P)) * 0.5).astype(np.float32)
    a = (-np.abs(rng.normal(size=(B, S, H))) * 0.3).astype(np.float32)
    b = (rng.normal(size=(B, S, H, N)) * 0.5).astype(np.float32)
    c = (rng.normal(size=(B, S, H, N)) * 0.5).astype(np.float32)
    s0 = (rng.normal(size=(B, H, P, N)) * 0.2).astype(np.float32)
    return x, a, b, c, s0


def _t(*arrs):
    return [torch.from_numpy(v) for v in arrs]


def _j(*arrs):
    return [jnp.asarray(v) for v in arrs]


def test_segsum_matches_jax():
    a = -np.abs(np.random.default_rng(1).normal(size=(2, 3, 16))).astype(np.float32)
    out = ssm.segsum(torch.from_numpy(a))
    ref = np.asarray(jssm.segsum(jnp.asarray(a)))
    assert np.isneginf(ref).sum() == 2 * 3 * 16 * 15 // 2
    np.testing.assert_allclose(out.numpy(), ref, **TOL)  # -inf where j > i on both


@pytest.mark.parametrize("chunk", [8, 16, 64])
def test_ssd_chunked_matches_jax(chunk):
    x, a, b, c, _ = _scan_inputs(seed=2)
    out = ssm.ssd_chunked(*_t(x, a, b, c), chunk=chunk)
    _close(out, jssm.ssd_chunked(*_j(x, a, b, c), chunk=chunk))


def test_ssd_chunked_with_initial_state_matches_jax():
    x, a, b, c, s0 = _scan_inputs(seed=3)
    y, sf = ssm.ssd_chunked(*_t(x, a, b, c), chunk=16, initial_state=torch.from_numpy(s0),
                            return_final_state=True)
    jy, jsf = jssm.ssd_chunked(*_j(x, a, b, c), chunk=16, initial_state=jnp.asarray(s0),
                               return_final_state=True)
    assert sf.dtype == torch.float32
    _close(y, jy)
    _close(sf, jsf)


def test_ssd_decode_step_matches_jax():
    x, a, b, c, s0 = _scan_inputs(S=1, seed=4)
    y, st = ssm.ssd_decode_step(*_t(s0, x[:, 0], a[:, 0], b[:, 0], c[:, 0]))
    jy, jst = jssm.ssd_decode_step(*_j(s0, x[:, 0], a[:, 0], b[:, 0], c[:, 0]))
    _close(y, jy)
    _close(st, jst)


def test_causal_conv_matches_jax():
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 19, 12)).astype(np.float32)
    w = rng.normal(size=(12, 4)).astype(np.float32)
    b = rng.normal(size=(12,)).astype(np.float32)
    _close(ssm._causal_conv(*_t(x, w, b)), jssm._causal_conv(*_j(x, w, b)))


def test_init_mamba_has_the_jax_layout():
    jcfg, tcfg, jp, _ = _setup()
    tp = ssm.init_mamba(tcfg, torch.Generator().manual_seed(0))
    assert {k: (tuple(v.shape), str(v.dtype).removeprefix("torch.")) for k, v in tp.items()} == {
        k: (tuple(v.shape), np.dtype(v.dtype).name) for k, v in jp.items()}
    for name in ("conv_b", "a_log", "dt_bias", "d_skip", "norm_scale"):
        _close(tp[name], jp[name], rtol=1e-6, atol=1e-6)  # deterministic leaves


@pytest.mark.parametrize("impl", ["reference", "pallas"])
def test_apply_mamba_without_cache_matches_jax(impl):
    jcfg, tcfg, jp, tp = _setup(impl)
    x = np.random.default_rng(6).normal(size=(2, 24, jcfg.d_model)).astype(np.float32)
    trace.reset_counts(ssd_ops.LAUNCHES)
    out, cache = ssm.apply_mamba(tcfg, tp, torch.from_numpy(x))
    jout, _ = jssm.apply_mamba(jcfg, jp, jnp.asarray(x))
    assert cache is None and trace.counter(ssd_ops.LAUNCHES) == 0
    _close(out, jout)


@pytest.mark.parametrize("impl", ["reference", "pallas"])
def test_apply_mamba_prefill_cache_matches_jax(impl):
    """S > 4 with a cache: the chunked form (``reference``) or the kernel's
    path (``pallas``) from the cache's state, against the JAX reference."""
    jcfg, tcfg, jp, tp = _setup(impl)
    tol = TOL if impl == "reference" else KERNEL_TOL
    rng = np.random.default_rng(7)
    x = rng.normal(size=(2, 37, jcfg.d_model)).astype(np.float32)
    jcache = jssm.init_mamba_cache(jcfg, 2)
    jcache = {"conv": jnp.asarray(rng.normal(size=jcache["conv"].shape).astype(np.float32)),
              "state": jnp.asarray(rng.normal(size=jcache["state"].shape).astype(np.float32))}
    tcache = ssm.init_mamba_cache(tcfg, 2, device="cpu")
    for name in tcache:
        tcache[name].copy_(bridge.to_tensor(jcache[name], device="cpu"))
    out, tnew = ssm.apply_mamba(tcfg, tp, torch.from_numpy(x), cache=tcache)
    jout, jnew = jssm.apply_mamba(jcfg, jp, jnp.asarray(x), cache=jcache)
    assert tnew is tcache  # updated in place
    _close(out, jout, **tol)
    _close(tcache["conv"], jnew["conv"], **tol)
    _close(tcache["state"], jnew["state"], **tol)


def test_apply_mamba_decode_matches_jax():
    jcfg, tcfg, jp, tp = _setup("pallas")
    rng = np.random.default_rng(8)
    jcache = jssm.init_mamba_cache(jcfg, 2)
    tcache = ssm.init_mamba_cache(tcfg, 2, device="cpu")
    for t in range(3):  # S = 1, 1, then 4: every step takes ssd_decode_step
        x = rng.normal(size=(2, 4 if t == 2 else 1, jcfg.d_model)).astype(np.float32)
        out, _ = ssm.apply_mamba(tcfg, tp, torch.from_numpy(x), cache=tcache)
        jout, jcache = jssm.apply_mamba(jcfg, jp, jnp.asarray(x), cache=jcache)
        _close(out, jout)
    _close(tcache["conv"], jcache["conv"])
    _close(tcache["state"], jcache["state"])


def test_init_mamba_cache_matches_jax_layout():
    jcfg, tcfg = jax_smoke(ARCH), get_smoke_config(ARCH)
    jc = jssm.init_mamba_cache(jcfg, 3)
    tc = ssm.init_mamba_cache(tcfg, 3, device="cpu")
    for name in ("conv", "state"):
        assert tuple(tc[name].shape) == tuple(jc[name].shape)
        assert str(tc[name].dtype).removeprefix("torch.") == np.dtype(jc[name].dtype).name
        assert not tc[name].any()


@pytest.mark.parametrize("impl", ["reference", "pallas"])
def test_mamba_ssd_chunked_vs_decode(impl):
    """SSD chunked scan equals step-by-step recurrence (state-space duality);
    the port of ``tests/test_models_smoke.py::test_mamba_ssd_chunked_vs_decode``."""
    cfg = get_smoke_config(ARCH).replace(attention_impl=impl)
    rng = np.random.default_rng(8)
    T = 24
    x = torch.from_numpy(rng.normal(size=(1, T, cfg.d_model)).astype(np.float32))
    params = ssm.init_mamba(cfg, torch.Generator().manual_seed(8))
    full, _ = ssm.apply_mamba(cfg, params, x)
    cache = ssm.init_mamba_cache(cfg, 1, device="cpu")
    outs = []
    for t in range(T):
        y, cache = ssm.apply_mamba(cfg, params, x[:, t : t + 1], cache=cache)
        outs.append(y[:, 0])
    stepwise = torch.stack(outs, dim=1)
    torch.testing.assert_close(stepwise, full, rtol=2e-2, atol=2e-2)
