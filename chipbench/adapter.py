"""The batch function the server runs: the steps of ``launch/serve.py``'s
``generate`` through ``repro_torch``'s public model API.

``generate`` is a closure inside ``serve()``, so it cannot be imported; this
adapter does what it does on one card, and copies no model code: pad the
rows to the serving width B, ``init_cache(cfg, B, PL + G + 1)``,
``prefill``, G - 1 greedy ``decode_step`` calls, ``torch.cuda.synchronize()``.
It records, per batch, the host clock at entry, around the prefill, after
the decode loop and at return, and which prompts the batch held, for the
per-layer metrics.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable

import numpy as np
import torch

from chipbench.loadgen import content_key


@dataclasses.dataclass
class Batch:
    t_enter: float
    t_prefill: float      # prefill called
    t_prefilled: float    # prefill synchronized
    t_decoded: float      # decode loop synchronized
    t_exit: float
    rows: int             # requests in the batch (the rest is padding)
    contents: list[bytes]


class BatchFn:
    def __init__(self, tx: Any, cfg: Any, params: Any, *, batch: int, prompt_len: int,
                 gen: int, device: torch.device,
                 clock: Callable[[], float] = time.perf_counter):
        self.tx, self.cfg, self.params = tx, cfg, params
        self.B, self.PL, self.G = batch, prompt_len, gen
        self.device = device
        self.clock = clock
        self.ctx = tx.RunCtx(decode=True)
        self.batches: list[Batch] = []

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def __call__(self, prompts: list) -> list:
        clock, tx, cfg = self.clock, self.tx, self.cfg
        t_enter = clock()
        B, PL, G = self.B, self.PL, self.G
        k = len(prompts)
        toks = np.stack([np.asarray(p, np.int64) for p in prompts])
        if toks.shape[1] != PL:
            raise ValueError(f"prompt of {toks.shape[1]} tokens; this server takes {PL}")
        if k < B:
            toks = np.concatenate([toks, np.zeros((B - k, PL), np.int64)])
        with torch.inference_mode():
            cache = tx.init_cache(cfg, B, PL + G + 1, device=self.device)
            tokens = torch.from_numpy(toks).to(self.device)
            t_prefill = clock()
            logits, cache = tx.prefill(cfg, self.params, tokens, cache, self.ctx)
            self._sync()
            t_prefilled = clock()
            tok = logits[:, -1:].argmax(-1)
            out = [tok]
            for i in range(G - 1):
                pos = torch.full((B, 1), PL + i, dtype=torch.int64, device=self.device)
                logits, cache = tx.decode_step(cfg, self.params, cache, tok, pos, self.ctx)
                tok = logits[:, -1:].argmax(-1)
                out.append(tok)
            self._sync()
            t_decoded = clock()
            full = torch.cat(out, dim=1).to(torch.int32).cpu().numpy()
            del cache, logits
        contents = [content_key(p) for p in prompts]
        self.batches.append(Batch(t_enter, t_prefill, t_prefilled, t_decoded, clock(), k,
                                  contents))
        return [full[i] for i in range(k)]
