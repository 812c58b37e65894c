"""The port's serving entry point on the CPU, against a JAX greedy loop.

``repro_torch.launch.serve`` answers every request through the port's own
``Session``/``ModelServer``; its greedy tokens must equal those of a JAX
``prefill``/``decode_step`` loop on the same weights (carried across with
``repro_torch.bridge``) and the same prompts.  Smoke config, float32.
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
    assert res["device"] == "cpu"


def test_serve_tokens_equal_a_jax_greedy_loop(served):
    args, res = served
    expect = _jax_greedy(args.arch, res["prompts"], args.gen)
    np.testing.assert_array_equal(np.stack(res["outputs"]), expect)


def test_run_dir_restore_is_not_ported_yet():
    with pytest.raises(NotImplementedError, match="run-dir"):
        serve(parse_args(ARGS + ["--run-dir", "/nonexistent"]))


def test_serve_defaults_to_cuda():
    assert parse_args([]).device == "cuda"
    assert parse_args([]).arch == "qwen2.5-3b"
