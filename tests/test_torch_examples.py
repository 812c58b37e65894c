"""The port's two examples on the CPU at smoke size.

* ``examples/serve_batched_torch.py`` restores a checkpoint lazily through
  the port's ``CheckpointManager`` (every leaf a proxy), serves 8 requests
  through ``Session.serve`` and ``ModelServer``, and its tokens equal a
  direct greedy ``generate`` on the restored params, batch by batch.
* ``examples/train_lm_torch.py`` drives ``repro_torch.launch.train`` on
  Zipf-distributed tokens, and its loss falls, as the JAX example asserts;
  here over 16 steps at a learning rate that the 100-step warmup leaves
  large enough to show it (the example's defaults take 200 steps).
* ``examples/quickstart_torch.py`` and ``examples/active_learning_torch.py``
  are the twins of the JAX examples ``quickstart.py`` and
  ``active_learning.py`` on the port's middleware, with tensors for arrays:
  they print the JAX examples' sums and store bytes, and select the same
  candidates with the same scores (f32 rounding: ``SCORE_RTOL``,
  ``SCORE_ATOL``) as the JAX
  example's own ``run`` on the JAX package's middleware.

All run on the card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import ast
import importlib.util
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import bridge
from repro_torch.models import transformer as tx

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
# the twin's scores and surrogate mean against the JAX example's: the same f32
# products, summed in another order.  A score sums 256 x 256 products of
# order one, so its rounding is absolute, some 1e-6, whatever the score's size
SCORE_RTOL, SCORE_ATOL = 1e-5, 1e-5


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


@pytest.mark.parametrize("name", ["quickstart_torch", "active_learning_torch",
                                  "serve_batched_torch", "train_lm_torch"])
def test_torch_examples_import_neither_jax_nor_repro(name):
    tree = ast.parse((ROOT / "examples" / f"{name}.py").read_text())
    names = {a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names}
    names |= {n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)}
    assert not {m for m in names if m.split(".")[0] in ("jax", "jaxlib", "repro")}


def test_quickstart_twin_prints_the_jax_examples_results(monkeypatch, tmp_path, capsys):
    jax_ex = _load("quickstart")
    real = jax_ex.ConnectorSpec  # its pool's store under tmp_path, not a fixed /tmp path
    monkeypatch.setattr(jax_ex, "ConnectorSpec", lambda kind, **kw: real(
        kind, **{**kw, "store_dir": str(tmp_path)} if "store_dir" in kw else kw))
    jax_ex.main()
    lines = capsys.readouterr().out.splitlines()
    value = lambda tag: next(ln for ln in lines if ln.startswith(tag)).split(":")[1].strip()  # noqa: E731
    out = _load("quickstart_torch").main(["--device", "cpu"])
    assert round(out["a"], 3) == round(out["b"], 3) == float(value("(a)")) == float(value("(b)"))
    assert out["store_bytes"] == int(value("    store bytes"))
    want = [ln for ln in lines if ln.startswith("(c)")]
    assert len(want) == len(out["c"]) == 2
    assert all(re.search(r"proxy = True \| shape = \(512, 512\)", ln) for ln in want)
    data = np.random.default_rng(0).normal(size=(512, 512))
    for (i, proxied, shape, gram), x in zip(out["c"], (data, data * 2)):
        assert proxied and shape == (512, 512)
        np.testing.assert_allclose(gram, x @ x.T, rtol=1e-12, atol=1e-9)


class _Recorder:
    """The JAX example's client, recording what each ``gather`` returns."""

    def __init__(self, session):
        self.session, self.gathered = session, []

    def submit(self, *args, **kwargs):
        return self.session.submit(*args, **kwargs)

    def gather(self, futures):
        out = self.session.gather(futures)
        self.gathered.append(out)
        return out


def test_active_learning_twin_selects_the_jax_examples_candidates():
    from repro.api import Session as JaxSession
    from repro.runtime.client import LocalCluster as JaxCluster

    jax_ex = _load("active_learning")
    with JaxCluster(n_workers=2) as cluster:
        with JaxSession(cluster=cluster, policy="never", proxy_results=False) as s:
            client = _Recorder(s)
            _, jax_mean = jax_ex.run(client)
    jax_scores = client.gathered[0::2]  # then each round's labels
    jax_selected = [np.argsort(sc)[-4:].tolist() for sc in jax_scores]

    twin = _load("active_learning_torch")
    out = twin.main(["--device", "cpu"])
    assert (twin.DIM, twin.N_CANDIDATES, twin.ROUNDS) == (
        jax_ex.DIM, jax_ex.N_CANDIDATES, jax_ex.ROUNDS)
    for run in (out["baseline"], out["proxied"]):
        assert run["selected"] == jax_selected
        np.testing.assert_allclose(run["scores"], jax_scores, rtol=SCORE_RTOL,
                                   atol=SCORE_ATOL)
        assert run["weights_mean"] == pytest.approx(jax_mean, rel=SCORE_RTOL)
    assert out["proxied"]["scheduler_bytes"] * 10 < out["baseline"]["scheduler_bytes"]


def test_twins_refuse_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for name in ("quickstart_torch", "active_learning_torch"):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            _load(name).main([])
