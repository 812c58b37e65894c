"""Shared layers of the PyTorch port against the JAX package, on the CPU.

The same numpy inputs and parameters go through ``repro.models.layers`` and
``repro_torch.models.layers``; both compute in float32 here, so the
tolerance is 1e-5 (float32 rounding of a few reductions).
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as jl
from repro_torch.models import layers as tl

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)


@dataclasses.dataclass
class Cfg:
    """The config fields the layers read."""

    norm: str = "rmsnorm"
    mlp: str = "swiglu"
    compute_dtype: object = None
    param_dtype: object = None
    vocab_size: int = 64
    d_model: int = 32
    tie_embeddings: bool = True


def _cfgs(**kw):
    return (Cfg(compute_dtype=jnp.float32, param_dtype=jnp.float32, **kw),
            Cfg(compute_dtype=torch.float32, param_dtype=torch.float32, **kw))


def _close(t, j):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), **TOL)


def _both(*arrs):
    return [jnp.asarray(a) for a in arrs], [torch.from_numpy(a) for a in arrs]


@pytest.mark.parametrize("norm", ["rmsnorm", "layernorm"])
def test_norm_matches_jax(norm):
    rng = np.random.default_rng(0)
    x = (3 * rng.normal(size=(2, 5, 32)) + 1).astype(np.float32)
    p = {"scale": rng.normal(size=32).astype(np.float32),
         "bias": rng.normal(size=32).astype(np.float32)}
    if norm == "rmsnorm":
        del p["bias"]
    jc, tc = _cfgs(norm=norm)
    out = tl.apply_norm(tc, {k: torch.from_numpy(v) for k, v in p.items()}, torch.from_numpy(x))
    _close(out, jl.apply_norm(jc, {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x)))


def test_norm_keeps_input_dtype_and_inits():
    _, tc = _cfgs(norm="layernorm")
    p = tl.init_norm(tc, 8, "cpu")
    assert set(p) == {"scale", "bias"} and p["scale"].dtype == torch.float32
    x = torch.randn(2, 8, dtype=torch.bfloat16)
    assert tl.apply_norm(tc, p, x).dtype == torch.bfloat16


@pytest.mark.parametrize("theta", [10_000.0, 1_000_000.0])
def test_rope_matches_jax(theta):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 7, 3, 16)).astype(np.float32)
    pos = rng.integers(0, 4096, size=(2, 7)).astype(np.int32)
    (jx, jp), (tx, tp) = _both(x, pos)
    _close(tl.apply_rope(tx, tp.long(), theta), jl.apply_rope(jx, jp, theta))


def test_rope_frequencies_equal():
    np.testing.assert_array_equal(tl.rope_frequencies(64, 1e6), jl.rope_frequencies(64, 1e6))


@pytest.mark.parametrize("mlp", ["swiglu", "gelu"])
def test_mlp_matches_jax(mlp):
    rng = np.random.default_rng(2)
    d, f = 32, 48
    x = rng.normal(size=(2, 5, d)).astype(np.float32)
    if mlp == "swiglu":
        shapes = {"w_gate": (d, f), "w_up": (d, f), "w_down": (f, d)}
    else:
        shapes = {"w_in": (d, f), "b_in": (f,), "w_out": (f, d), "b_out": (d,)}
    p = {k: (0.2 * rng.normal(size=s)).astype(np.float32) for k, s in shapes.items()}
    jc, tc = _cfgs(mlp=mlp)
    out = tl.apply_mlp(tc, {k: torch.from_numpy(v) for k, v in p.items()}, torch.from_numpy(x))
    _close(out, jl.apply_mlp(jc, {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x)))


def test_gelu_is_the_tanh_form():
    """``jax.nn.gelu`` defaults to the tanh approximation; the exact erf form
    differs from it by more than the tolerance on large inputs."""
    rng = np.random.default_rng(3)
    x = (4 * rng.normal(size=(4, 32))).astype(np.float32)
    jc, tc = _cfgs(mlp="gelu")
    eye = np.eye(32, dtype=np.float32)
    zeros = np.zeros(32, np.float32)
    p = {"w_in": eye, "b_in": zeros, "w_out": eye, "b_out": zeros}
    out = tl.apply_mlp(tc, {k: torch.from_numpy(v) for k, v in p.items()}, torch.from_numpy(x))
    _close(out, jl.apply_mlp(jc, {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x)))
    exact = torch.nn.functional.gelu(torch.from_numpy(x))
    assert (out - exact).abs().max() > 1e-4


@pytest.mark.parametrize("tied", [True, False])
def test_embed_and_logits_match_jax(tied):
    rng = np.random.default_rng(4)
    jc, tc = _cfgs(tie_embeddings=tied)
    p = {"embed": rng.normal(size=(64, 32)).astype(np.float32)}
    if not tied:
        p["unembed"] = rng.normal(size=(64, 32)).astype(np.float32)
    tokens = rng.integers(0, 64, size=(2, 9)).astype(np.int32)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    emb = tl.embed_tokens(tc, tp, torch.from_numpy(tokens).long())
    _close(emb, jl.embed_tokens(jc, jp, jnp.asarray(tokens)))
    x = rng.normal(size=(2, 3, 32)).astype(np.float32)
    _close(tl.logits_matmul(tc, tp, torch.from_numpy(x)), jl.logits_matmul(jc, jp, jnp.asarray(x)))


def test_embed_indexes_before_casting():
    _, tc = _cfgs()
    tc.compute_dtype = torch.bfloat16
    p = {"embed": torch.randn(64, 32)}
    tokens = torch.tensor([[1, 5, 63]])
    torch.testing.assert_close(
        tl.embed_tokens(tc, p, tokens), p["embed"].to(torch.bfloat16)[tokens], rtol=0, atol=0
    )


def test_init_is_seeded_and_scaled():
    _, tc = _cfgs(tie_embeddings=False)
    a = tl.init_embedding(tc, torch.Generator().manual_seed(7))
    b = tl.init_embedding(tc, torch.Generator().manual_seed(7))
    assert set(a) == {"embed", "unembed"}
    torch.testing.assert_close(a["embed"], b["embed"], rtol=0, atol=0)
    w = tl.normal_init(torch.Generator().manual_seed(0), (256, 256), 0.02, torch.float32)
    assert abs(w.std().item() - 0.02) < 1e-3 and abs(w.mean().item()) < 1e-3
    m = tl.init_mlp(tc, torch.Generator().manual_seed(0), 32, 48)
    assert {k: tuple(v.shape) for k, v in m.items()} == {
        "w_gate": (32, 48), "w_up": (32, 48), "w_down": (48, 32)
    }
