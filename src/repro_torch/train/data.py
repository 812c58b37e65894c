"""Data pipeline: proxy-fed prefetching.

Producer tasks materialize batches into the Store; the training loop holds
only a queue of *proxies* (cheap) and resolves each batch just-in-time at
dispatch.  With a real corpus the producer would read+tokenize; here it
synthesizes tokens (the systems behavior -- bytes through mediated storage,
double buffering, backpressure -- is identical).
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterator

import numpy as np

from repro_torch.core.proxy import Proxy
from repro_torch.core.store import Store


def synthetic_batch(
    rng: np.random.Generator,
    batch: int,
    seq: int,
    vocab: int,
    extras: dict[str, tuple] | None = None,
) -> dict[str, np.ndarray]:
    out = {"tokens": rng.integers(0, vocab, (batch, seq), dtype=np.int32)}
    for name, shape in (extras or {}).items():
        out[name] = rng.standard_normal(shape, dtype=np.float32)
    return out


def zipf_batch(
    rng: np.random.Generator,
    batch: int,
    seq: int,
    vocab: int,
    alpha: float = 1.2,
) -> dict[str, np.ndarray]:
    """Tokens drawn independently from a Zipf law over the vocabulary
    (p(k) ~ 1 / (k + 1)^alpha): a unigram distribution that a model learns
    within a few steps, so a short run's loss visibly falls.  Uniform tokens
    (``synthetic_batch``) leave nothing to learn: a fresh model's loss is
    already within about 0.01 of log V."""
    p = 1.0 / np.arange(1, vocab + 1, dtype=np.float64) ** alpha
    return {"tokens": rng.choice(vocab, size=(batch, seq), p=p / p.sum()).astype(np.int32)}


class ProxyPrefetcher:
    """Background producer; consumer iterates proxies of ready batches."""

    def __init__(
        self,
        store: Store,
        make_batch: Callable[[int], dict[str, np.ndarray]],
        *,
        depth: int = 2,
        evict_after_use: bool = True,
    ):
        self.store = store
        self.make_batch = make_batch
        self.depth = depth
        self.evict_after_use = evict_after_use
        self._q: queue.Queue[Proxy] = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._idx = 0
        self._thread = threading.Thread(target=self._produce, daemon=True)
        self._thread.start()

    def _produce(self) -> None:
        while not self._stop.is_set():
            batch = self.make_batch(self._idx)
            proxy = self.store.proxy(batch, evict=self.evict_after_use)
            self._idx += 1
            while not self._stop.is_set():
                try:
                    self._q.put(proxy, timeout=0.2)
                    break
                except queue.Full:
                    continue

    def __iter__(self) -> Iterator[Proxy]:
        return self

    def __next__(self) -> Proxy:
        while True:
            try:
                return self._q.get(timeout=1.0)
            except queue.Empty:
                if self._stop.is_set():
                    raise StopIteration from None

    def stop(self) -> None:
        self._stop.set()

    def __enter__(self) -> "ProxyPrefetcher":
        return self

    def __exit__(self, *exc) -> None:
        self.stop()
