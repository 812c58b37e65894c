"""Active learning across a worker fleet, on the PyTorch port -- the paper's
motivating pattern.

The counterpart of ``examples/active_learning.py`` on ``repro_torch``.  A
surrogate model, a torch tensor on the device, lives on the client; each
round it is shipped to many short screening tasks, the best candidates are
"labelled" (simulated), and the surrogate is retrained.  This frequent
client<->worker movement of a large object is exactly the Dask
anti-pattern the paper targets: with proxying the surrogate crosses the
scheduler as a reference of a few hundred bytes instead of its bytes per
task.  Proxying it costs one device-to-host copy when the store takes it
(``core/serialize.py``); each task takes what it is given back onto the
device.  Both sessions select the same candidates and end with the same
surrogate.

Runs on the GPU unless ``--device cpu`` is given:

    PYTHONPATH=src python examples/active_learning_torch.py
    PYTHONPATH=src python examples/active_learning_torch.py --device cpu
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import bridge
from repro_torch.api import PolicySpec, Session
from repro_torch.launch.serve import resolve_device
from repro_torch.runtime.client import LocalCluster

DIM = 256
N_CANDIDATES = 48
ROUNDS = 3
TOP = 4  # candidates labelled a round


def featurize(seed: int, device: torch.device) -> torch.Tensor:
    x = np.random.default_rng(seed).normal(size=DIM).astype(np.float32)
    return torch.from_numpy(x).to(device)


def surrogate_score(weights, x, device) -> float:
    """Short task consuming the big surrogate (the anti-pattern)."""
    x = bridge.to_tensor(x, device=device)
    return float(x @ bridge.to_tensor(weights, device=device) @ x)


def simulate(x, device) -> float:
    """'Ground truth' for the selected candidate (expensive in real life)."""
    return float(torch.tanh(bridge.to_tensor(x, device=device)).sum())


def retrain(weights, xs, ys, device) -> torch.Tensor:
    w = bridge.to_tensor(weights, device=device).clone()
    for x, y in zip(xs, ys):
        x = bridge.to_tensor(x, device=device)
        pred = x @ w @ x
        w += 1e-4 * (y - pred) * torch.outer(x, x)
    return w


def run(client, device: torch.device) -> dict:
    """ROUNDS rounds of screening, labelling and retraining through
    ``client``; returns the seconds, the scores and the selected candidates
    of each round, and the final surrogate's mean."""
    rng = np.random.default_rng(0)
    weights = torch.from_numpy(
        rng.normal(size=(DIM, DIM)).astype(np.float32) / DIM).to(device)  # ~256 kB
    scores_by_round, selected = [], []
    t0 = time.perf_counter()
    for r in range(ROUNDS):
        xs = [featurize(r * 1000 + i, device=device) for i in range(N_CANDIDATES)]
        scores = client.gather(
            [client.submit(surrogate_score, weights, x, device, pure=False) for x in xs]
        )
        top = np.argsort(scores)[-TOP:]
        labels = client.gather(
            [client.submit(simulate, xs[i], device, pure=False) for i in top]
        )
        weights = bridge.to_tensor(client.submit(
            retrain, weights, [xs[i] for i in top], labels, device, pure=False
        ).result(), device=device)
        scores_by_round.append(scores)
        selected.append(top.tolist())
    return {"seconds": time.perf_counter() - t0, "scores": scores_by_round,
            "selected": selected, "weights_mean": float(weights.mean())}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    device = resolve_device(ap.parse_args(argv).device)
    with LocalCluster(n_workers=4) as cluster:
        # policy="never": nothing is proxied -> the pure-Dask anti-pattern
        with Session(cluster=cluster, policy="never", proxy_results=False) as base:
            baseline = run(base, device=device)
            baseline["scheduler_bytes"] = cluster.scheduler.bytes_through()["in_bytes"]

    with LocalCluster(n_workers=4) as cluster:
        # the same session API, now routing >=50 kB objects via the store
        with Session(
            cluster=cluster, policy=PolicySpec("size", threshold=50_000)
        ) as session:
            proxied = run(session, device=device)
            proxied["scheduler_bytes"] = cluster.scheduler.bytes_through()["in_bytes"]

    assert baseline["selected"] == proxied["selected"], "proxying changed the selection!"
    assert abs(baseline["weights_mean"] - proxied["weights_mean"]) < 1e-6, \
        "proxying changed the result!"
    b, p = baseline, proxied
    print(f"baseline : {b['seconds']:.2f}s, {b['scheduler_bytes'] / 1e6:.1f} MB through "
          f"scheduler")
    print(f"proxy    : {p['seconds']:.2f}s, {p['scheduler_bytes'] / 1e6:.1f} MB through "
          f"scheduler")
    print(f"speedup  : {b['seconds'] / p['seconds']:.2f}x | scheduler bytes "
          f"reduced {b['scheduler_bytes'] / max(p['scheduler_bytes'], 1):.0f}x | on {device}")
    return {"baseline": baseline, "proxied": proxied, "device": str(device)}


if __name__ == "__main__":
    main()
