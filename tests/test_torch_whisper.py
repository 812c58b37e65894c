"""The port's encoder-decoder (whisper-tiny) against the JAX package.

whisper-tiny's smoke config (2 encoder and 2 decoder layers, d_model 64, 4
heads of 16, 32 frames, vocab 256), float32 on the CPU.  The JAX package
makes the weights, ``repro_torch.bridge`` carries them leaf by leaf, and
both frameworks run the same frames and tokens, made with numpy from a
seed.  Tolerances: 1e-4 where both run the reference path (float32
reductions in another order; the observed gap is a few 1e-7); 3e-3 where
the port's kernel path (the flash kernel's plain version on CPU tensors)
meets the JAX Pallas kernel in interpret mode or the JAX reference prefill,
as the JAX package's in-model kernel test allows; 2e-2 for a prefill and its
decode steps against the cache-free forward, as ``tests/test_models_smoke.py``
allows.  Greedy tokens must be identical.  Gradients at rtol 1e-4 and atol
1e-5, and one train step at the tolerances of ``tests/test_torch_train.py``.
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
from repro.models import whisper as jwh
from repro.train import optimizer as jopt
from repro.train.train_step import init_train_state as jax_init_train_state
from repro.train.train_step import make_train_step as jax_make_train_step
from repro_torch import bridge
from repro_torch.configs import get_smoke_config
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.launch import serve as serve_mod
from repro_torch.launch import train as train_mod
from repro_torch.models import attention as tattn
from repro_torch.models import whisper as wh
from repro_torch.runtime import trace
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.train_step import make_train_step

torch.set_num_threads(1)

ARCH = "whisper-tiny"
TOL = dict(rtol=1e-4, atol=1e-4)
KERNEL_TOL = dict(rtol=3e-3, atol=3e-3)
CACHE_FREE_TOL = dict(rtol=2e-2, atol=2e-2)
IMPLS = ["reference", "pallas"]
B, S, STEPS = 2, 12, 5


@functools.lru_cache(maxsize=None)
def _jax_params():
    return jwh.init_params(jax_smoke(ARCH), jax.random.PRNGKey(0))


def _setup(impl="reference", **over):
    jcfg = jax_smoke(ARCH).replace(**over)
    tcfg = get_smoke_config(ARCH).replace(attention_impl=impl, **over)
    jp = _jax_params()
    tp = bridge.params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, tcfg, jp, tp


def _frames(cfg, seed=0, batch=B):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(batch, cfg.encoder_seq, cfg.d_model)).astype(np.float32)


def _tokens(cfg, seed=1, shape=(B, S)):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, shape).astype(np.int32)


def _close(t, j, **tol):
    np.testing.assert_allclose(t.detach().float().numpy(), np.asarray(j, np.float32),
                               **(tol or TOL))


def _t(a):
    return torch.from_numpy(np.array(a))


def test_init_params_has_the_jax_layout():
    cfg = get_smoke_config(ARCH)
    tp = wh.init_params(cfg, torch.Generator().manual_seed(0))
    want = [(p, tuple(v.shape), np.dtype(v.dtype).name)
            for p, v in bridge.flatten(jax.tree.map(np.asarray, _jax_params()))]
    got = [(p, tuple(v.shape), str(v.dtype).removeprefix("torch."))
           for p, v in bridge.flatten(tp)]
    assert got == want
    assert tp["encoder"]["attn"]["w_q"].shape[0] == cfg.encoder_layers
    assert tp["decoder"]["cross_attn"]["w_k"].shape[0] == cfg.num_layers


def test_bridge_carries_the_jax_tree_as_it_stands():
    jp = jax.tree.map(np.asarray, _jax_params())
    tp = bridge.params_from_jax(jp, device="cpu")
    assert [p for p, _ in bridge.flatten(tp)] == [
        tuple(k.key for k in path) for path, _ in jax.tree_util.tree_flatten_with_path(jp)[0]]
    for (_, t), (_, j) in zip(bridge.flatten(tp), bridge.flatten(jp)):
        np.testing.assert_array_equal(t.numpy(), j)


@pytest.mark.parametrize("impl", IMPLS)
def test_encode_matches_jax(impl):
    """``pallas``: the JAX Pallas kernel in interpret mode against the
    port's flash wrapper (its plain version on CPU tensors), non-causal."""
    jcfg, tcfg, jp, tp = _setup(impl)
    frames = _frames(jcfg)
    jout = jwh.encode(jcfg.replace(attention_impl=impl), jp, jnp.asarray(frames))
    trace.reset_counts(fa_ops.LAUNCHES)
    tout = wh.encode(tcfg, tp, _t(frames))
    assert trace.counter(fa_ops.LAUNCHES) == 0  # CPU: the plain version
    assert tout.shape == (B, tcfg.encoder_seq, tcfg.d_model)
    _close(tout, jout, **(TOL if impl == "reference" else KERNEL_TOL))


def test_encode_casts_frames_before_adding_positions():
    """bf16 compute: frames are rounded to bf16 before the positions are
    added, as in the JAX package.  With every encoder layer's output
    projections zeroed, the encoder is the final LayerNorm of that sum, so
    the two frameworks give the same bf16 numbers; rounding the sum once
    instead changes about a third of them."""
    jcfg = jax_smoke(ARCH).replace(compute_dtype=jnp.bfloat16)
    tcfg = get_smoke_config(ARCH).replace(compute_dtype=torch.bfloat16)
    jp = jax.tree.map(np.array, _jax_params())
    for leaf in (jp["encoder"]["attn"]["w_o"], jp["encoder"]["mlp"]["w_out"]):
        leaf[...] = 0
    frames = _frames(jcfg, seed=3) * 3
    jout = np.asarray(jwh.encode(jcfg, jp, jnp.asarray(frames)), np.float32)
    tout = wh.encode(tcfg, bridge.params_from_jax(jp, device="cpu"), _t(frames))
    assert tout.dtype == torch.bfloat16
    assert np.mean(tout.float().numpy() != jout) < 0.01


@pytest.mark.parametrize("sq, chunk", [(1, 1024), (3, 1024), (9, 1024), (9, 12)])
def test_cross_attention_matches_jax(sq, chunk):
    """Cross ``apply_attention``: q only projected, every key attended; one
    to three queries take the decode form, nine the chunked one, whose last
    key chunk is ragged at chunk 12."""
    jcfg, tcfg, jp, tp = _setup(attention_chunk=chunk)
    rng = np.random.default_rng(7)
    x = rng.normal(size=(B, sq, jcfg.d_model)).astype(np.float32)
    enc = rng.normal(size=(B, jcfg.encoder_seq, jcfg.d_model)).astype(np.float32)
    jl = jax.tree.map(lambda a: a[0], jp["decoder"])
    tl = jax.tree.map(lambda a: a[0], tp["decoder"])
    jk, jv = jwh._cross_kv(jcfg, jl, jnp.asarray(enc))
    tk, tv = wh._cross_kv(tcfg, tl, _t(enc))
    _close(tk, jk)
    _close(tv, jv)
    pos = np.zeros((B, sq), np.int32)
    jy, jc = jattn.apply_attention(jcfg, jl["cross_attn"], jnp.asarray(x),
                                   positions=jnp.asarray(pos), cross_kv=(jk, jv))
    ty, tc = tattn.apply_attention(tcfg, tl["cross_attn"], _t(x), positions=_t(pos),
                                   cross_kv=(tk, tv))
    assert jc is None and tc is None
    _close(ty, jy)


def test_decode_forward_matches_jax():
    jcfg, tcfg, jp, tp = _setup()
    frames, toks = _frames(jcfg), _tokens(jcfg)
    enc = jwh.encode(jcfg, jp, jnp.asarray(frames))
    jx, jc = jwh.decode_forward(jcfg, jp, jnp.asarray(toks), enc)
    tx_, tc = wh.decode_forward(tcfg, tp, _t(toks), _t(enc))
    assert jc is None and tc is None
    _close(tx_, jx)


def _jax_prefill(jcfg, jp, toks, frames, max_len):
    cache = jwh.init_cache(jcfg, B, max_len, jcfg.encoder_seq)
    return jwh.prefill(jcfg, jp, jnp.asarray(toks), jnp.asarray(frames), cache)


@pytest.mark.parametrize("impl", IMPLS)
def test_prefill_logits_and_cache_match_jax_reference(impl):
    """Every cache leaf, the cross K/V included; with ``pallas`` the port's
    encoder and prompt self-attention take the flash path, held to the JAX
    reference prefill."""
    jcfg, tcfg, jp, tp = _setup(impl)
    frames, toks = _frames(jcfg), _tokens(jcfg)
    jl, jcache = _jax_prefill(jcfg, jp, toks, frames, S + 4)
    cache = wh.init_cache(tcfg, B, S + 4, tcfg.encoder_seq, device="cpu")
    buffers = [t for _, t in bridge.flatten(cache)]
    tl, cache = wh.prefill(tcfg, tp, _t(toks), _t(frames), cache)
    tol = TOL if impl == "reference" else KERNEL_TOL
    _close(tl, jl, **tol)
    got, want = bridge.flatten(cache), bridge.flatten(jax.tree.map(np.asarray, jcache))
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, t), (_, j), buf in zip(got, want, buffers):
        assert t is buf, path  # updated in place
        assert tuple(t.shape) == j.shape and str(t.dtype) == f"torch.{j.dtype}", path
        if path[-1] == "length":
            np.testing.assert_array_equal(t.numpy(), j)
        else:
            _close(t, j, **tol)
    assert cache["cross_k"].abs().sum() > 0


def _decode_loop(step, cache, fed, start):
    """Logits (B, steps, V) of decode steps fed ``fed``'s tokens one by one."""
    out = []
    for i in range(fed.shape[1]):
        logits, cache = step(cache, fed[:, i:i + 1], np.full((B, 1), start + i, np.int32))
        out.append(np.asarray(logits[:, 0], np.float32))
    return np.stack(out, axis=1)


def _port_run(tcfg, tp, toks, frames, fed, fault=None):
    """The port's prefill and decode steps; ``fault`` is called on the cache
    between them."""
    cache = wh.init_cache(tcfg, B, toks.shape[1] + fed.shape[1] + 2, tcfg.encoder_seq,
                          device="cpu")
    logits, cache = wh.prefill(tcfg, tp, _t(toks), _t(frames), cache)
    if fault is not None:
        fault(cache)

    def step(c, tok, pos):
        lg, c = wh.decode_step(tcfg, tp, c, _t(tok), _t(pos))
        return lg.numpy(), c

    return logits, _decode_loop(step, cache, fed, toks.shape[1])


@pytest.mark.parametrize("impl", IMPLS)
def test_prefill_then_decode_matches_jax_and_the_cache_free_forward(impl):
    jcfg, tcfg, jp, tp = _setup(impl)
    frames, toks = _frames(jcfg), _tokens(jcfg, shape=(B, S + STEPS))
    prompt, fed = toks[:, :S], toks[:, S:]
    _, jcache = _jax_prefill(jcfg, jp, prompt, frames, S + STEPS + 2)

    def jstep(c, tok, pos):
        return jwh.decode_step(jcfg, jp, c, jnp.asarray(tok), jnp.asarray(pos))

    jlogits = _decode_loop(jstep, jcache, fed, S)
    tl, tlogits = _port_run(tcfg, tp, prompt, frames, fed)
    _close(_t(tlogits), jlogits, **(TOL if impl == "reference" else KERNEL_TOL))
    # the cache-free forward over prompt and fed tokens at once
    enc = wh.encode(tcfg, tp, _t(frames))
    x, _ = wh.decode_forward(tcfg, tp, _t(toks), enc)
    full = (x @ tp["embedding"]["embed"].T).numpy()
    _close(tl[:, 0], full[:, S - 1], **CACHE_FREE_TOL)
    _close(_t(tlogits[:, :-1]), full[:, S:-1], **CACHE_FREE_TOL)


def test_decode_with_the_cross_cache_left_empty_differs():
    """A prefill that left ``init_cache``'s zeros in the cross buffers gives
    the same prefill logits but other decode logits: the decode check sees
    the fault."""
    _, tcfg, _, tp = _setup()
    frames, toks = _frames(tcfg), _tokens(tcfg, shape=(B, S + STEPS))

    def zero_cross(cache):
        cache["cross_k"].zero_()
        cache["cross_v"].zero_()

    good = _port_run(tcfg, tp, toks[:, :S], frames, toks[:, S:])
    bad = _port_run(tcfg, tp, toks[:, :S], frames, toks[:, S:], fault=zero_cross)
    torch.testing.assert_close(bad[0], good[0], rtol=0, atol=0)
    assert np.abs(bad[1] - good[1]).max() > 1e-2


def test_greedy_tokens_equal_a_jax_loop():
    """Serving: the port's kernel path (prefill, greedy decode) against the
    JAX reference loop, token for token."""
    jcfg, tcfg, jp, tp = _setup("pallas")
    frames, prompt = _frames(jcfg, seed=4), _tokens(jcfg, seed=5)
    gen = 8

    jl, jcache = _jax_prefill(jcfg, jp, prompt, frames, S + gen + 1)
    jtok = jnp.argmax(jl[:, -1:], -1)
    jout = [np.asarray(jtok)]
    for i in range(gen - 1):
        jl, jcache = jwh.decode_step(jcfg, jp, jcache, jtok, jnp.full((B, 1), S + i, jnp.int32))
        jtok = jnp.argmax(jl[:, -1:], -1)
        jout.append(np.asarray(jtok))

    cache = wh.init_cache(tcfg, B, S + gen + 1, tcfg.encoder_seq, device="cpu")
    with torch.inference_mode():
        tl, cache = wh.prefill(tcfg, tp, _t(prompt), _t(frames), cache)
        ttok = tl[:, -1:].argmax(-1)
        tout = [ttok]
        for i in range(gen - 1):
            pos = torch.full((B, 1), S + i, dtype=torch.int64)
            tl, cache = wh.decode_step(tcfg, tp, cache, ttok, pos)
            ttok = tl[:, -1:].argmax(-1)
            tout.append(ttok)
    np.testing.assert_array_equal(torch.cat(tout, 1).numpy(), np.concatenate(jout, 1))


def test_pallas_prefill_takes_the_flash_path_once_a_layer():
    """Every encoder layer non-causal, every decoder layer's prompt causal;
    the decode steps and cross attention never."""
    _, tcfg, _, tp = _setup("pallas")
    frames, toks = _frames(tcfg), _tokens(tcfg)
    calls = []
    real = tattn._flash

    def spy(q, k, v, *, causal):
        calls.append((causal, q.shape[1]))
        return real(q, k, v, causal=causal)

    tattn._flash = spy
    try:
        cache = wh.init_cache(tcfg, B, S + 2, tcfg.encoder_seq, device="cpu")
        logits, cache = wh.prefill(tcfg, tp, _t(toks), _t(frames), cache)
        n_prefill = len(calls)
        wh.decode_step(tcfg, tp, cache, logits.argmax(-1), torch.full((B, 1), S))
    finally:
        tattn._flash = real
    assert calls == ([(False, tcfg.encoder_seq)] * tcfg.encoder_layers
                     + [(True, S)] * tcfg.num_layers)
    assert n_prefill == len(calls)


def test_prefill_refuses_frames_of_another_length():
    _, tcfg, _, tp = _setup()
    cache = wh.init_cache(tcfg, B, S + 2, tcfg.encoder_seq - 1, device="cpu")
    with pytest.raises(ValueError, match="encoder positions"):
        wh.prefill(tcfg, tp, _t(_tokens(tcfg)), _t(_frames(tcfg)), cache)


def _train_batch(cfg, seed=0, batch=4):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, cfg.vocab_size, (batch, S)).astype(np.int32),
            "frame_embeds": rng.normal(size=(batch, cfg.encoder_seq, cfg.d_model)
                                       ).astype(np.float32)}


def test_loss_and_grads_match_jax():
    jcfg, tcfg, jp, tp = _setup()
    batch = _train_batch(jcfg)
    jloss, jgrads = jax.value_and_grad(lambda p: jwh.loss_fn(jcfg, p, batch))(jp)
    pairs = [(path, t.requires_grad_()) for path, t in bridge.flatten(tp)]
    loss = wh.loss_fn(tcfg, bridge.unflatten(pairs), {k: _t(v) for k, v in batch.items()})
    loss.backward()
    _close(loss, jloss)
    for (path, t), (_, g) in zip(pairs, bridge.flatten(jax.tree.map(np.asarray, jgrads))):
        assert t.grad is not None, path
        _close(t.grad, g, rtol=1e-4, atol=1e-5)


@functools.lru_cache(maxsize=None)
def _jax_state():
    return jax.tree.map(np.asarray, jax_init_train_state(jax_smoke(ARCH), jax.random.PRNGKey(0)))


def _rel_l2(a, b) -> float:
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.mark.parametrize("nmb", [1, 2])
def test_one_train_step_matches_jax(nmb):
    """``make_train_step`` with and without microbatches (``frame_embeds``
    split with the tokens), at ``tests/test_torch_train.py``'s tolerances."""
    jcfg = jax_smoke(ARCH).replace(num_microbatches=nmb)
    tcfg = get_smoke_config(ARCH).replace(num_microbatches=nmb)
    state0 = _jax_state()
    batch = _train_batch(jcfg, seed=2)
    opt = dict(warmup_steps=0)
    jstate, jm = jax.jit(jax_make_train_step(jcfg, jopt.AdamWConfig(**opt)))(state0, batch)
    tstate, tm = make_train_step(tcfg, AdamWConfig(**opt))(
        bridge.params_from_jax(state0, device="cpu"), {k: _t(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-4)
    got, want = bridge.params_to_numpy(tstate), jax.tree.map(np.asarray, jstate)
    for part in ("m", "v"):
        for (path, t), (_, j) in zip(bridge.flatten(got["opt"][part]),
                                     bridge.flatten(want["opt"][part])):
            assert _rel_l2(t, j) <= 1e-5, (part, path, _rel_l2(t, j))
    for (path, t), (_, j), (_, p0) in zip(bridge.flatten(got["params"]),
                                          bridge.flatten(want["params"]),
                                          bridge.flatten(state0["params"])):
        assert t.dtype == j.dtype and t.shape == j.shape
        assert _rel_l2(t - p0, j - p0) <= 1e-2, (path, _rel_l2(t - p0, j - p0))


@pytest.mark.parametrize("driver", ["serve", "train"])
def test_drivers_refuse_an_encoder_decoder_arch(driver, tmp_path):
    """Neither JAX driver runs whisper, so neither port driver does; the
    refusal comes before the device is resolved."""
    if driver == "serve":
        args = serve_mod.parse_args(["--arch", ARCH, "--smoke"])
        run = serve_mod.serve
    else:
        args = train_mod.parse_args(["--arch", ARCH, "--smoke", "--run-dir", str(tmp_path)])
        run = train_mod.train
    with pytest.raises(ValueError, match=f"JAX driver repro.launch.{driver}"):
        run(args)
    assert not any(tmp_path.iterdir())
