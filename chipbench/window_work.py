"""The work of the windowed layers' prompt attention, counted from the
configuration file's sizes (``chipbench.work`` counts the full-attention
layers' and the SSD scans').

Each (query, key) pair the causal mask and the window keep costs 4 hd FLOPs
per head (scores and values); q, k, v and o are each counted once.
"""

from __future__ import annotations

from typing import Any

from chipbench.work import ITEM_BYTES, causal_pairs, layer_windows


def window_attn_prefill_work(model: dict[str, Any], rows: int, S: int,
                             dtype: str = "bfloat16") -> tuple[float, float]:
    """(FLOPs, bytes) of the prompt attention of the windowed layers over
    ``rows`` prompts of S tokens; (0, 0) for a model without them."""
    H, KV, hd = model["num_heads"], model["num_kv_heads"], model["head_dim"]
    windows = [w for w in layer_windows(model) if w > 0]
    flops = 4 * H * hd * sum(causal_pairs(S, w) for w in windows) * rows
    nbytes = (2 * H + 2 * KV) * S * hd * ITEM_BYTES[dtype] * rows * len(windows)
    return float(flops), float(nbytes)
