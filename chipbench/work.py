"""The work a request needs, counted from the configuration file's sizes.

The counts that are a model family's (its layers' products, its request)
live in ``families/<family>.py``; this module keeps the arithmetic they
share, the peaks, the prompt kernels' work, and the names the metric files
read for the dense and hybrid families.

Frozen here so that the yardstick does not move with the program: these
formulas count what the requests need, not what the program happens to
launch (``launch/op_analysis.py`` counts the program's own operations).
FLOPs count a multiply and an add as two.

* Linear layers: every weight matrix once per token that passes the layer
  (the prompt, then each decode step's one token).
* Attention: each (query, key) pair the causal mask keeps costs 4 hd per
  head (scores and values); a windowed layer counts only the keys inside
  its window.
* The LM head at the last prompt position and at every decode step.
* The SSD scan in its chunked form (the form K2 computes): per chunk of q
  rows and per head, q(q+1)/2 pairs for C Bᵀ (2N each) and for the masked
  product with X (2P each), and 2NP per row for the carried-in state and
  2NP per row for the state's update; a decode step's update and read-out
  4NP; the causal convolution 2K per channel and token.

Peaks are NVIDIA's data-sheet values for one H100 SXM (dense), the same as
``chip_smoke.py``'s ``PEAK_FLOPS`` and ``PEAK_BYTES``.
"""

from __future__ import annotations

from types import ModuleType
from typing import Any

PEAK_FLOPS = {"bfloat16": 989e12, "float16": 989e12, "float32": 67e12}
PEAK_BYTES = 3.35e12
ITEM_BYTES = {"bfloat16": 2, "float16": 2, "float32": 4}


def causal_pairs(S: int, window: int = 0) -> int:
    """(query, key) pairs of an S-token prompt under the causal mask, each
    query seeing at most ``window`` keys (0: all before it)."""
    if window <= 0 or window >= S:
        return S * (S + 1) // 2
    return window * (window + 1) // 2 + (S - window) * window


def decode_keys(prompt_len: int, gen: int, window: int = 0) -> int:
    """Keys the G - 1 decode steps attend over: step j sits at position
    prompt_len + j and sees every key up to it (at most ``window``)."""
    n = 0
    for j in range(gen - 1):
        keys = prompt_len + j + 1
        n += min(keys, window) if window > 0 else keys
    return n


def group_windows(groups: list[tuple[str, int, int]]) -> list[int]:
    """Each layer's window, in order, from (name, layers, window) stacks (0:
    full attention)."""
    return [window for _, count, window in groups for _ in range(count)]


def ssd_chunk_flops(S: int, s: dict[str, int]) -> int:
    """One row's SSD scan over S steps, all heads, in the chunked form."""
    Q, N, P, H = s["chunk"], s["N"], s["P"], s["H"]
    total = 0
    for start in range(0, S, Q):
        q = min(Q, S - start)
        total += q * (q + 1) * (N + P) + 4 * q * N * P
    return total * H


def least_seconds(flops: float, nbytes: float, dtype: str = "bfloat16") -> float:
    """The roofline's least time: the larger of the compute and byte terms."""
    return max(flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES)


# -- the prompt kernels' work, and the names the metric files read, for the dense and
# hybrid families

def _family(model: dict[str, Any]) -> ModuleType:
    """The family file of a dense or hybrid model (imported here when first
    asked for: the family files import this module's arithmetic)."""
    from chipbench.families import dense, hybrid

    return {"dense": dense, "hybrid": hybrid}[model["family"]]


def layer_windows(model: dict[str, Any]) -> list[int]:
    return group_windows(_family(model).layer_groups(model))


def linear_weights(model: dict[str, Any]) -> int:
    """Weight elements of one layer's products (norms and gates aside)."""
    return _family(model).linear_weights(model)


def request_flops(model: dict[str, Any], prompt_len: int, gen: int) -> float:
    """FLOPs one request of ``prompt_len`` tokens and ``gen`` answer tokens
    needs: a prefill and G - 1 decode steps (``families/<family>.py``)."""
    return _family(model).request_flops(model, prompt_len, gen)


def attn_prefill_work(model: dict[str, Any], rows: int, S: int,
                      dtype: str = "bfloat16") -> tuple[float, float]:
    """(FLOPs, bytes) of the prompt attention of the full-attention layers
    (the ones K1 runs) over ``rows`` prompts of S tokens: q, k, v and o
    each counted once."""
    H, KV, hd = model["num_heads"], model["num_kv_heads"], model["head_dim"]
    full = sum(1 for w in layer_windows(model) if w == 0)
    flops = 4 * H * hd * causal_pairs(S) * rows * full
    nbytes = (2 * H + 2 * KV) * S * hd * ITEM_BYTES[dtype] * rows * full
    return float(flops), float(nbytes)


def ssd_prefill_work(model: dict[str, Any], rows: int, S: int,
                     dtype: str = "bfloat16") -> tuple[float, float]:
    """(FLOPs, bytes) of the prompt's SSD scans in every layer over ``rows``
    prompts: x and y once, the decay in f32, B and C once per row (one
    group, broadcast over the heads), the f32 state in and out."""
    if model["family"] != "hybrid":
        return 0.0, 0.0
    s = _family(model).ssm_sizes(model)
    L = model["num_layers"]
    e = ITEM_BYTES[dtype]
    H, P, N = s["H"], s["P"], s["N"]
    per_row = 2 * S * H * P * e + S * H * 4 + 2 * S * N * e + 2 * H * P * N * 4
    return float(ssd_chunk_flops(S, s) * rows * L), float(per_row * rows * L)
