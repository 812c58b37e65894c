"""Quickstart on the PyTorch port: the paper's three integration patterns
(Fig 2) through the single unified ``repro_torch.api.Session`` facade.

The counterpart of ``examples/quickstart.py`` on ``repro_torch``.  The data
is a torch tensor on the device; each task takes its argument onto the
device, whether it arrives as the tensor itself, as the ndarray the store
decodes a tensor into, or as a proxy of one.  A tensor that crosses the
store pays one device-to-host copy (``core/serialize.py``); a proxy of it
crosses the scheduler as a reference of a few hundred bytes.  Session exit
evicts all session-owned proxies, so nothing leaks.

Runs on the GPU unless ``--device cpu`` is given:

    PYTHONPATH=src python examples/quickstart_torch.py
    PYTHONPATH=src python examples/quickstart_torch.py --device cpu
"""

from __future__ import annotations

import argparse
import tempfile
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from repro_torch import bridge
from repro_torch.api import ClusterSpec, ConnectorSpec, PolicySpec, Session, StoreConfig
from repro_torch.core import is_proxy
from repro_torch.launch.serve import resolve_device
from repro_torch.runtime.client import LocalCluster


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    device = resolve_device(ap.parse_args(argv).device)
    # the JAX example's ~2 MB float64 array, on the device
    data = torch.from_numpy(np.random.default_rng(0).normal(size=(512, 512))).to(device)
    total = lambda x: float(bridge.to_tensor(x, device=device).sum())  # noqa: E731
    out = {}

    # ---- (a) manual proxies: scatter once, pass references -------------------
    # policy="never" disables auto-proxying; you decide what is a reference.
    # backend="cluster" makes the session build (and own) the distributed
    # runtime from a declarative ClusterSpec -- the one-knob backend flip.
    with Session(
        backend="cluster", cluster=ClusterSpec(n_workers=2), policy="never"
    ) as s:
        proxy = s.scatter(data)            # cheap wide-area reference
        out["a"] = s.submit(total, proxy).result()
        print("(a) manual proxy     :", round(out["a"], 3))
    # <- session exit evicted the scattered object and closed the cluster

    # ---- (b) drop-in client: auto-proxy above a size threshold ---------------
    with LocalCluster(n_workers=2) as cluster:
        with Session(
            cluster=cluster,
            policy=PolicySpec("size", threshold=1000),
        ) as s:
            out["b"] = s.submit(total, data).result()
            out["scheduler_bytes"] = cluster.scheduler.bytes_through()["in_bytes"]
            out["store_bytes"] = s.stats()["bytes_put"]
            print("(b) auto-proxy submit:", round(out["b"], 3))
            print("    scheduler bytes  :", out["scheduler_bytes"])
            print("    store bytes      :", out["store_bytes"])

    # ---- (c) policies + any executor: composable data flow -------------------
    # Same Session facade over a stdlib pool; a declarative composite policy
    # proxies only large tensors, and large results return as proxies.
    big_tensor = PolicySpec("all", policies=[
        PolicySpec("type", types=["torch.Tensor"]),
        PolicySpec("size", threshold=1000),
    ])
    def gram(x):
        t = bridge.to_tensor(x, device=device)
        return t @ t.T

    out["c"] = []
    with tempfile.TemporaryDirectory(prefix="quickstart-pool-") as pool_dir:
        store_cfg = StoreConfig(
            name="quickstart-pool-torch",
            connector=ConnectorSpec("sharded", store_dir=pool_dir, num_shards=4),
        )
        with ThreadPoolExecutor(2) as pool:
            with Session(executor=pool, store=store_cfg, policy=big_tensor) as s:
                futures = s.map(gram, [data, data * 2])
                for f in s.as_completed(futures):
                    r = f.result()
                    print("(c) executor+policy  : result is proxy =", is_proxy(r),
                          "| shape =", tuple(r.shape))
                    out["c"].append((futures.index(f), is_proxy(r), tuple(r.shape),
                                     bridge.to_tensor(r, device="cpu").numpy()))
    out["c"].sort(key=lambda entry: entry[0])
    out["device"] = str(device)
    return out


if __name__ == "__main__":
    main()
