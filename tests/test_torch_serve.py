"""The port's serving entry point on the CPU, against a JAX greedy loop.

``repro_torch.launch.serve`` answers every request through the port's own
``Session``/``ModelServer``; its greedy tokens must equal those of a JAX
``prefill``/``decode_step`` loop on the same weights (carried across with
``repro_torch.bridge``) and the same prompts.  Smoke configs of qwen2.5-3b,
mamba2-130m and hymba-1.5b, float32.  For mamba2 and hymba the port's
prefill takes the SSD kernel's plain version (the sequential recurrence) and
the JAX loop its reference (the chunked form): the same function, so the
tokens are equal.  hymba's prompts (28 tokens) are longer than its window
(16), and its decode's write slot runs past the end of the local layers'
rings and back to slot 0.  kimi-k2 and deepseek-v2-lite prefill through the
MoE layers' routed form (the JAX serve driver's ``decode=True`` context
makes it take the dense form: the same function) and decode through the
dense form; deepseek's MLA prefills on the flash kernel's route (its plain
version here) and decodes through its latent cache.  The other
dense archs (phi4-mini-3.8b's tied head, internvl2-2b's VLM family served
on tokens alone, as the JAX driver serves it, starcoder2-15b's LayerNorm and
GELU with biases, granite-20b's single K/V head) serve as qwen2.5-3b does.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke
from repro.models import transformer as jtx
from repro_torch import bridge
from repro_torch.configs import get_smoke_config
from repro_torch.launch.serve import parse_args, serve
from repro_torch.models import transformer as tx

torch.set_num_threads(1)

ARGS = ["--smoke", "--device", "cpu", "--batch", "2", "--prompt-len", "12",
        "--gen", "6", "--requests", "5", "--max-wait-ms", "20"]


def _jax_greedy(arch, prompts, gen):
    """The serve driver's weights (generator seeded with 0) through JAX."""
    cfg = jax_smoke(arch)
    tparams = tx.init_params(get_smoke_config(arch), torch.Generator().manual_seed(0))
    params = jax.tree.map(jnp.asarray, bridge.params_to_numpy(tparams))
    toks = jnp.asarray(np.stack(prompts))
    B, S = toks.shape
    logits, cache = jtx.prefill(cfg, params, toks, jtx.init_cache(cfg, B, S + gen + 1))
    tok = jnp.argmax(logits[:, -1:], axis=-1).astype(jnp.int32)
    out = [tok]
    for i in range(gen - 1):
        pos = jnp.full((B, 1), S + i, jnp.int32)
        logits, cache = jtx.decode_step(cfg, params, cache, tok, pos)
        tok = jnp.argmax(logits[:, -1:], axis=-1).astype(jnp.int32)
        out.append(tok)
    return np.asarray(jnp.concatenate(out, axis=1))


@pytest.fixture(scope="module")
def served():
    args = parse_args(ARGS)
    return args, serve(args)


@pytest.fixture(scope="module")
def served_mamba():
    args = parse_args(ARGS + ["--arch", "mamba2-130m"])
    return args, serve(args)


@pytest.fixture(scope="module", params=["kimi-k2-1t-a32b", "deepseek-v2-lite-16b"])
def served_moe(request):
    args = parse_args(ARGS + ["--arch", request.param])
    return args, serve(args)


DENSE_ARCHS = ["phi4-mini-3.8b", "internvl2-2b", "starcoder2-15b", "granite-20b"]


@pytest.fixture(scope="module", params=DENSE_ARCHS)
def served_dense(request):
    args = parse_args(ARGS + ["--arch", request.param])
    return args, serve(args)


@pytest.fixture(scope="module")
def served_hymba():
    args = parse_args(ARGS + ["--arch", "hymba-1.5b", "--prompt-len", "28"])
    return args, serve(args)


def test_serve_answers_every_request(served):
    args, res = served
    assert res["requests"] == 5 and len(res["outputs"]) == 5
    assert res["server"]["batches"] >= 3  # at most 2 per batch
    assert res["prefills"] == res["server"]["batches"]
    for out in res["outputs"]:
        assert out.shape == (args.gen,) and out.dtype == np.int32
        assert 0 <= out.min() and out.max() < get_smoke_config(args.arch).vocab_size


def test_serve_reports_the_jax_serve_fields(served):
    _, res = served
    for key in ("prefill_s", "decode_tok_s", "requests", "wall_s", "server", "stream"):
        assert key in res
    assert res["flash_launches"] == 0  # CPU tensors take the plain version
    assert res["kernel_launches"] == {"flash_attention": 0, "ssd_scan": 0}
    assert res["device"] == "cpu"


def test_serve_tokens_equal_a_jax_greedy_loop(served):
    args, res = served
    expect = _jax_greedy(args.arch, res["prompts"], args.gen)
    np.testing.assert_array_equal(np.stack(res["outputs"]), expect)


def test_serve_mamba_answers_every_request(served_mamba):
    args, res = served_mamba
    assert args.arch == "mamba2-130m" and len(res["outputs"]) == 5
    assert res["prefills"] == res["server"]["batches"] >= 3
    assert res["kernel_launches"] == {"flash_attention": 0, "ssd_scan": 0}  # CPU
    vocab = get_smoke_config(args.arch).vocab_size
    for out in res["outputs"]:
        assert out.shape == (args.gen,) and 0 <= out.min() and out.max() < vocab


def test_serve_mamba_tokens_equal_a_jax_greedy_loop(served_mamba):
    args, res = served_mamba
    expect = _jax_greedy(args.arch, res["prompts"], args.gen)
    np.testing.assert_array_equal(np.stack(res["outputs"]), expect)


def test_serve_hymba_answers_every_request(served_hymba):
    args, res = served_hymba
    cfg = get_smoke_config(args.arch)
    assert args.arch == "hymba-1.5b" and len(res["outputs"]) == 5
    assert args.prompt_len > cfg.sliding_window
    # the decode steps write positions PL .. PL + gen - 2, across a multiple of the ring's size
    assert (args.prompt_len + args.gen - 2) // cfg.sliding_window > \
        args.prompt_len // cfg.sliding_window
    assert res["prefills"] == res["server"]["batches"] >= 3
    assert res["kernel_launches"] == {"flash_attention": 0, "ssd_scan": 0}  # CPU
    for out in res["outputs"]:
        assert out.shape == (args.gen,) and 0 <= out.min() and out.max() < cfg.vocab_size


def test_serve_hymba_tokens_equal_a_jax_greedy_loop(served_hymba):
    args, res = served_hymba
    expect = _jax_greedy(args.arch, res["prompts"], args.gen)
    np.testing.assert_array_equal(np.stack(res["outputs"]), expect)


def test_serve_defaults_to_cuda():
    assert parse_args([]).device == "cuda"
    assert parse_args([]).arch == "qwen2.5-3b"


def test_serve_moe_answers_every_request(served_moe):
    args, res = served_moe
    cfg = get_smoke_config(args.arch)
    assert cfg.family == "moe" and len(res["outputs"]) == 5
    assert res["prefills"] == res["server"]["batches"] >= 3
    assert res["kernel_launches"] == {"flash_attention": 0, "ssd_scan": 0}  # CPU
    for out in res["outputs"]:
        assert out.shape == (args.gen,) and 0 <= out.min() and out.max() < cfg.vocab_size


def test_serve_moe_tokens_equal_a_jax_greedy_loop(served_moe):
    args, res = served_moe
    expect = _jax_greedy(args.arch, res["prompts"], args.gen)
    np.testing.assert_array_equal(np.stack(res["outputs"]), expect)


def test_serve_dense_answers_every_request(served_dense):
    args, res = served_dense
    cfg = get_smoke_config(args.arch)
    assert args.arch in DENSE_ARCHS and len(res["outputs"]) == 5
    assert res["prefills"] == res["server"]["batches"] >= 3
    assert res["kernel_launches"] == {"flash_attention": 0, "ssd_scan": 0}  # CPU
    for out in res["outputs"]:
        assert out.shape == (args.gen,) and 0 <= out.min() and out.max() < cfg.vocab_size


def test_serve_dense_tokens_equal_a_jax_greedy_loop(served_dense):
    args, res = served_dense
    expect = _jax_greedy(args.arch, res["prompts"], args.gen)
    np.testing.assert_array_equal(np.stack(res["outputs"]), expect)
