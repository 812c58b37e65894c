"""Checkpointing through the ProxyStore layer -- the paper's technique as a
first-class training feature.

The PyTorch counterpart of ``repro/train/checkpoint.py``:

* Each leaf of the train state is ``put`` into the Store through its
  connector -- the coordinator and the scheduler never see the bytes.
* The manifest is tiny: the leaves' key paths (in the sorted-key order of
  ``jax.tree.flatten``), their dtypes and their store keys.  The JAX manifest
  pickles a treedef instead.
* **Async**: the snapshot is a host *copy* taken on the step path (the next
  step updates the parameters and moments in place); serialization happens
  on a background thread off it, at most one save in flight.
* **Lazy restore**: ``restore_lazy`` returns a tree of *proxies* -- a reader
  resolves only the leaves it needs, just-in-time.
* Retention: keep-last-k with automatic eviction (ownership semantics).

Leaves go through the store as numpy arrays.  A bfloat16 leaf, which numpy
cannot hold without ``ml_dtypes``, goes as its raw 16-bit pattern with its
dtype recorded, and comes back as a CPU ``torch.bfloat16`` tensor; a tensor
dtype numpy cannot hold otherwise is refused.
"""

from __future__ import annotations

import functools
import json
import threading
import time
from pathlib import Path
from typing import Any

import numpy as np
import torch

from repro_torch.bridge import flatten, unflatten
from repro_torch.core.connectors.base import Key
from repro_torch.core.proxy import LambdaFactory, Proxy, extract
from repro_torch.core.store import Store

_BITS = "bfloat16"  # the one dtype stored as its raw bits


def _snapshot(leaf: Any) -> tuple[np.ndarray, str]:
    """A host copy of ``leaf`` as a numpy array, and the dtype to restore."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), _BITS
        try:
            arr = t.numpy()
        except TypeError as exc:
            raise ValueError(f"checkpoint: cannot store a {t.dtype} tensor") from exc
        return arr, arr.dtype.name
    arr = np.array(leaf, copy=True)
    if arr.dtype.name == _BITS:  # an ml_dtypes array
        return arr.view(np.uint16), _BITS
    if arr.dtype == object:
        raise ValueError(f"checkpoint: cannot store a leaf of type {type(leaf).__name__}")
    return arr, arr.dtype.name


def _bits_to_bfloat16(bits: Any) -> torch.Tensor:
    return torch.from_numpy(np.array(bits, dtype=np.uint16).view(np.int16)).view(torch.bfloat16)


class CheckpointManager:
    def __init__(
        self,
        store: Store,
        index_path: str,
        *,
        keep: int = 3,
    ):
        self.store = store
        self.index_path = Path(index_path)
        self.index_path.parent.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self._thread: threading.Thread | None = None
        self._index: dict[str, Any] = {"checkpoints": []}
        if self.index_path.exists():
            self._index = json.loads(self.index_path.read_text())

    # -- save ------------------------------------------------------------------

    def save(self, step: int, state: Any, *, blocking: bool = False) -> None:
        """Snapshot (a copy) on the step path, serialize off it."""
        self.wait()  # at most one in-flight save (double buffer)
        host_state = [(path, *_snapshot(leaf)) for path, leaf in flatten(state)]

        if blocking:
            self._do_save(step, host_state)
            return
        self._thread = threading.Thread(
            target=self._do_save, args=(step, host_state), daemon=True
        )
        self._thread.start()

    def _do_save(self, step: int, host_state: list) -> None:
        t0 = time.monotonic()
        keys = self.store.put_batch([arr for _, arr, _ in host_state])
        manifest = {
            "step": step,
            "paths": [list(path) for path, _, _ in host_state],
            "dtypes": [dtype for _, _, dtype in host_state],
            "keys": [
                {"object_id": k.object_id, "size": k.size, "tag": k.tag}
                for k in keys
            ],
            "nbytes": int(sum(arr.nbytes for _, arr, _ in host_state)),
            "save_seconds": 0.0,
        }
        manifest["save_seconds"] = time.monotonic() - t0
        self._index["checkpoints"].append(manifest)
        self._gc()
        self.index_path.write_text(json.dumps(self._index))

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self) -> None:
        while len(self._index["checkpoints"]) > self.keep:
            old = self._index["checkpoints"].pop(0)
            for k in old["keys"]:
                self.store.evict(Key(k["object_id"], k["size"], k["tag"]))

    # -- restore -----------------------------------------------------------------

    def latest_step(self) -> int | None:
        cps = self._index["checkpoints"]
        return cps[-1]["step"] if cps else None

    def _manifest(self, step: int | None) -> dict[str, Any] | None:
        self.wait()
        cps = self._index["checkpoints"]
        if not cps:
            return None
        if step is None:
            return cps[-1]
        for m in cps:
            if m["step"] == step:
                return m
        return None

    def restore(self, step: int | None = None) -> tuple[int, Any] | None:
        """Eager restore: fetch every leaf now (numpy arrays; bfloat16 leaves
        as CPU tensors)."""
        out = self.restore_lazy(step)
        if out is None:
            return None
        s, tree = out
        leaves = [(path, extract(leaf)) for path, leaf in flatten(tree)]
        return s, unflatten([
            (path, v if isinstance(v, torch.Tensor) else np.asarray(v)) for path, v in leaves
        ])

    def restore_lazy(self, step: int | None = None) -> tuple[int, Any] | None:
        """Tree of proxies: each reader resolves only what it needs."""
        m = self._manifest(step)
        if m is None:
            return None
        leaves = []
        for k, dtype in zip(m["keys"], m["dtypes"]):
            proxy = self.store.proxy_from_key(Key(k["object_id"], k["size"], k["tag"]))
            if dtype == _BITS:
                proxy = Proxy(LambdaFactory(functools.partial(_bits_to_bfloat16, proxy)))
            leaves.append(proxy)
        return m["step"], unflatten([(tuple(p), leaf) for p, leaf in zip(m["paths"], leaves)])
