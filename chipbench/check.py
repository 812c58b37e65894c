"""Whether the served tokens are right: the widest logit gap over a sample.

Once the window has closed, a sample of the finished requests drawn from the
seed (the longest first) is run through the plain reference, each prompt
followed by the tokens it was served.  A served token's gap is how far the
reference's logit of that token lies below the reference's best logit at
its position; the run's reading is the widest gap over the sample.  Greedy
decoding in the program's precision keeps that gap near rounding; a token
decoded from a wrong cache, a dropped row or an altered token lands far
below.  The control (``control_gap``) reads the same gap for the tokens a
lower-precision reference puts first at the same positions.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch


def sample(requests: list, n: int, seed: int) -> list:
    """Up to ``n`` finished requests drawn from the seed, the longest among
    them, in send order."""
    done = [r for r in requests if r.ok]
    if len(done) <= n:
        return done
    longest = max(range(len(done)), key=lambda i: len(done[i].tokens))
    rng = np.random.default_rng([seed % (1 << 63), 17])
    rest = [i for i in range(len(done)) if i != longest]
    pick = {longest, *rng.choice(rest, size=n - 1, replace=False).tolist()}
    return [done[i] for i in sorted(pick)]


def _inputs(prompts: list[np.ndarray], served: list[np.ndarray], device) -> tuple:
    lengths = {(len(p), len(s)) for p, s in zip(prompts, served)}
    if len(lengths) != 1:
        raise ValueError(f"one prompt and answer length per check, got {sorted(lengths)}")
    (PL, G), = lengths
    seqs = np.stack([np.concatenate([p, s[:-1]]) for p, s in zip(prompts, served)])
    tokens = torch.from_numpy(seqs.astype(np.int64)).to(device)
    positions = list(range(PL - 1, PL + G - 1))
    target = torch.from_numpy(np.stack(served).astype(np.int64)).to(device)
    return tokens, positions, target


def served_gap(ref: Any, model: dict, weights: dict, prompts: list, served: list,
               device, *, control: str | None = None) -> dict[str, float]:
    """``{"logit_gap": widest gap of the served tokens}``, and with
    ``control`` (a precision of the reference, "fp8") the widest gap of the
    tokens that precision puts first: ``{"control_gap": ...}``."""
    tokens, positions, target = _inputs(prompts, served, device)
    out: dict[str, float] = {}
    want = ref.logits(model, weights, tokens, positions, "f32")       # (n, G, V)
    best = want.max(dim=-1).values
    out["logit_gap"] = float((best - want.gather(-1, target[..., None])[..., 0]).max())
    if control is not None:
        low = ref.logits(model, weights, tokens, positions, control)
        first = low.argmax(dim=-1, keepdim=True)
        out["control_gap"] = float((best - want.gather(-1, first)[..., 0]).max())
    return out
