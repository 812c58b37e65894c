"""Shared layers: norms, RoPE, MLPs, embeddings (plain functions on tensors)."""

from __future__ import annotations

import functools
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor

Params = dict[str, Any]


def normal_init(gen: torch.Generator, shape, std, dtype) -> torch.Tensor:
    """N(0, std^2) drawn in f32 on the generator's device, then cast."""
    x = torch.randn(tuple(shape), generator=gen, device=gen.device, dtype=torch.float32)
    return (x * std).to(dtype)


# -- norms --------------------------------------------------------------------

def init_norm(cfg, d: int, device) -> Params:
    p = {"scale": torch.ones((d,), dtype=cfg.param_dtype, device=device)}
    if cfg.norm == "layernorm":
        p["bias"] = torch.zeros((d,), dtype=cfg.param_dtype, device=device)
    return p


def apply_norm(cfg, p: Params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x32 = x.float()
    if cfg.norm == "layernorm":
        mu = x32.mean(-1, keepdim=True)
        var = ((x32 - mu) ** 2).mean(-1, keepdim=True)
        y = (x32 - mu) * torch.rsqrt(var + eps)
        return (y * p["scale"] + p["bias"]).to(dt)
    var = (x32 * x32).mean(-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * p["scale"]).to(dt)


# -- rotary embeddings ----------------------------------------------------------

def rope_frequencies(head_dim: int, theta: float) -> np.ndarray:
    return 1.0 / (theta ** (np.arange(0, head_dim, 2) / head_dim))


@functools.lru_cache(maxsize=None)
def _rope_freqs(head_dim: int, theta: float, device: torch.device) -> torch.Tensor:
    # cached per device: a host-to-device copy from pageable memory on every
    # call would wait for the stream to drain.  Made outside inference mode
    # so that autograd may use it later.
    with torch.inference_mode(False):
        return torch.as_tensor(
            rope_frequencies(head_dim, theta), dtype=torch.float32, device=device
        )


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., S, H, hd); positions: broadcastable to (..., S).

    Split-halves rotation computed in f32.
    """
    freqs = _rope_freqs(x.shape[-1], theta, x.device)
    angles = positions[..., None].float() * freqs  # (..., S, hd/2)
    cos = torch.cos(angles)[..., None, :]  # (..., S, 1, hd/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# -- mlp -------------------------------------------------------------------------

def init_mlp(cfg, gen: torch.Generator, d: int, f: int) -> Params:
    std_in = d**-0.5
    std_out = f**-0.5
    dt = cfg.param_dtype
    if cfg.mlp == "swiglu":
        return {
            "w_gate": normal_init(gen, (d, f), std_in, dt),
            "w_up": normal_init(gen, (d, f), std_in, dt),
            "w_down": normal_init(gen, (f, d), std_out, dt),
        }
    return {
        "w_in": normal_init(gen, (d, f), std_in, dt),
        "b_in": torch.zeros((f,), dtype=dt, device=gen.device),
        "w_out": normal_init(gen, (f, d), std_out, dt),
        "b_out": torch.zeros((d,), dtype=dt, device=gen.device),
    }


def apply_mlp(cfg, p: Params, x: torch.Tensor) -> torch.Tensor:
    ct = cfg.compute_dtype
    x = x.to(ct)
    if cfg.mlp == "swiglu":
        gate = x @ p["w_gate"].to(ct)
        up = x @ p["w_up"].to(ct)
        return (F.silu(gate) * up) @ p["w_down"].to(ct)
    # jax.nn.gelu defaults to the tanh approximation
    h = F.gelu(x @ p["w_in"].to(ct) + p["b_in"].to(ct), approximate="tanh")
    return h @ p["w_out"].to(ct) + p["b_out"].to(ct)


# -- embedding / logits -------------------------------------------------------------

def init_embedding(cfg, gen: torch.Generator) -> Params:
    p = {
        "embed": normal_init(gen, (cfg.vocab_size, cfg.d_model), 0.02, cfg.param_dtype)
    }
    if not cfg.tie_embeddings:
        p["unembed"] = normal_init(
            gen, (cfg.vocab_size, cfg.d_model), cfg.d_model**-0.5, cfg.param_dtype
        )
    return p


def embed_tokens(cfg, p: Params, tokens: torch.Tensor) -> torch.Tensor:
    # index first, then cast: the same numbers without casting the whole table
    if isinstance(p["embed"], DTensor):
        return _embed_sharded(p["embed"], tokens).to(cfg.compute_dtype)
    return p["embed"][tokens].to(cfg.compute_dtype)


def _embed_sharded(table: DTensor, tokens: torch.Tensor) -> DTensor:
    """The lookup on a ``DTensor`` table, vocab-parallel: each rank looks up
    the tokens of its batch rows in its own slice of the vocabulary (zero
    rows for the others'), and the rows are a partial sum over the mesh
    dims that slice the vocabulary (exact: one addend is the row).  Over a
    mesh dim that splits the table's hidden dim (its FSDP shards, left in
    place while the tokens move), the tokens are whole and each rank looks
    up its slice of every row.  DTensor has no strategy for an index with
    the batch over two mesh dims."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    from repro_torch.models.common import as_dtensor, relayout

    mesh = table.device_mesh
    tokens = as_dtensor(tokens, mesh)
    cols = [i for i, q in enumerate(table.placements) if q.is_shard() and q.dim == 1]
    rows = [i for i, q in enumerate(tokens.placements)
            if q.is_shard() and q.dim == 0 and i not in cols]
    vocab = [i for i, q in enumerate(table.placements)
             if q.is_shard() and q.dim == 0 and i not in rows]
    tok_pl = [Shard(0) if i in rows else Replicate() for i in range(mesh.ndim)]
    tab_pl = [Shard(0) if i in vocab else Shard(1) if i in cols else Replicate()
              for i in range(mesh.ndim)]
    out_pl = [Shard(0) if i in rows else Partial() if i in vocab
              else Shard(tokens.ndim) if i in cols else Replicate()
              for i in range(mesh.ndim)]
    coord = mesh.get_coordinate()
    shard = 0
    for i in vocab:
        shard = shard * mesh.size(i) + coord[i]

    def lookup(tok, tab):
        n = tab.shape[0]
        ids = tok.long() - shard * n
        mine = (ids >= 0) & (ids < n)
        return tab[ids.clamp(0, n - 1)] * mine[..., None].to(tab.dtype)

    return local_map(lookup, out_placements=out_pl, in_placements=(tok_pl, tab_pl))(
        relayout(tokens, tok_pl), relayout(table, tab_pl))


def logits_matmul(cfg, p: Params, x: torch.Tensor) -> torch.Tensor:
    w = p.get("unembed", p["embed"]).to(cfg.compute_dtype)
    return x @ w.T
