"""The port's two examples on the CPU at smoke size.

* ``examples/serve_batched_torch.py`` restores a checkpoint lazily through
  the port's ``CheckpointManager`` (every leaf a proxy), serves 8 requests
  through ``Session.serve`` and ``ModelServer``, and its tokens equal a
  direct greedy ``generate`` on the restored params, batch by batch.
* ``examples/train_lm_torch.py`` drives ``repro_torch.launch.train`` on
  Zipf-distributed tokens, and its loss falls, as the JAX example asserts;
  here over 16 steps at a learning rate that the 100-step warmup leaves
  large enough to show it (the example's defaults take 200 steps).

Both run on the card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import bridge
from repro_torch.models import transformer as tx

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]


def _load(name: str):
    spec = importlib.util.spec_from_file_location(name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_serve_example_serves_every_request_as_a_direct_generate():
    ex = _load("serve_batched_torch")
    res = ex.main(["--device", "cpu"])
    assert len(res["outputs"]) == ex.REQUESTS == 8
    assert all(out.shape == (ex.GEN_TOKENS,) for out in res["outputs"])
    # the same prompts, padded to the serving width, on the restored params
    cfg, params = res["cfg"], res["params"]
    got = dict(bridge.flatten(params))
    want = dict(bridge.flatten(tx.init_params(cfg, torch.Generator().manual_seed(0))))
    assert got.keys() == want.keys()
    for path, t in want.items():  # the checkpoint restored bit for bit
        assert isinstance(got[path], torch.Tensor) and torch.equal(got[path], t), path
    generate = ex.make_generate(cfg, params, torch.device("cpu"))
    want = []
    for i in range(0, ex.REQUESTS, ex.BATCH):
        want += generate(res["prompts"][i:i + ex.BATCH])
    np.testing.assert_array_equal(np.stack(res["outputs"]), np.stack(want))


def test_train_example_loss_falls():
    ex = _load("train_lm_torch")
    out = ex.main(["--device", "cpu", "--steps", "16", "--log-every", "1", "--lr", "3e-2",
                   "--batch", "4", "--seq", "64"])
    losses = [e["loss"] for e in out["log"]]
    assert len(losses) == 16 and all(np.isfinite(losses))
    assert max(losses[-4:]) < min(losses[:4])


def test_examples_refuse_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        _load("serve_batched_torch").main([])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        _load("train_lm_torch").main(["--steps", "1"])
