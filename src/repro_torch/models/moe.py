"""Mixture-of-Experts: ``repro/models/moe.py`` on tensors.

Two forms share the parameters, as in the JAX package:

* ``ep`` -- expert parallelism.  Each rank routes its local tokens, packs
  per-expert capacity buffers (GShard-style capacity with token dropping, a
  sort-based dispatch) and exchanges them with ``all_to_all_single`` over
  the expert-parallel world.  Torch's idiom is SPMD where the JAX package
  uses ``shard_map``: each rank passes its own tokens (the sequence-sharded
  slice ``x_spec`` gives it there) and its ``E / ep`` experts' weights, and
  the exchange is ``torch.distributed.nn.functional.all_to_all_single``, so
  gradients flow back through it.  In a world of one the exchange is the
  identity and no process group is needed.
* ``dense`` -- every expert on every token, weighted by the combine weights
  (zero off the top-k), plus the shared experts.  The JAX package builds
  the whole ``(E, N, d)`` expert output at once; here the experts run in
  slabs of ``EXPERTS_PER_SLAB``, each slab casting its own weights to the
  compute dtype, and the combine sum accumulates in f32 and is cast once.
  The same function in bounded memory: at kimi-k2's width one serving
  prefill's ``(E, N, d)`` buffers would be some 65 GB.  No expert is
  skipped.

On ``DTensor`` inputs laid out on a ``DeviceMesh`` the EP form runs its
body through ``local_map`` with the JAX package's ``shard_map`` specs
(``apply_moe_ep_sharded``), and the dense form runs each rank's own
experts and sums their f32 outputs across ranks.

``apply_moe`` takes the EP form iff ``cfg.moe_impl == "ep"``, the context
names an expert-parallel world and the call is not a decode, as the JAX
package's does; serving passes ``decode=True`` in prefill too, so it always
takes the dense form.  The router aux (load-balance) loss follows Switch:
``E * sum_e f_e * P_e``.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any

import torch
import torch.nn.functional as F
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from repro_torch.distributed.sharding import make_spec, placements
from repro_torch.models.common import as_dtensor, relayout
from repro_torch.models.layers import normal_init

Params = dict[str, Any]

# experts a slab of the dense form (and of init_moe's f32 draws): at kimi-k2's
# width a slab's f32 weights are 2.8 GB and its bf16 expert outputs for one
# serving prefill (N = 4096) about 1 GB
EXPERTS_PER_SLAB = 16


@dataclasses.dataclass(frozen=True)
class ExpertWorld:
    """The expert-parallel world that ``RunCtx.mesh`` names: the ranks of a
    ``torch.distributed`` process group, or a world of one (``group=None``),
    where the exchange is the identity."""

    group: Any = None

    @property
    def size(self) -> int:
        return 1 if self.group is None else torch.distributed.get_world_size(self.group)


def _normal_experts(gen: torch.Generator, shape, std, dtype) -> torch.Tensor:
    """``normal_init`` of an (E, ...) leaf, drawn in f32 a slab of experts at
    a time, so that no f32 copy of the whole leaf exists."""
    out = torch.empty(tuple(shape), dtype=dtype, device=gen.device)
    for e0 in range(0, shape[0], EXPERTS_PER_SLAB):
        part = out[e0:e0 + EXPERTS_PER_SLAB]
        part.copy_(normal_init(gen, part.shape, std, dtype))
    return out


def init_moe(cfg, gen: torch.Generator) -> Params:
    mo = cfg.moe
    d, f, E = cfg.d_model, mo.expert_d_ff, mo.num_experts
    std, std_out = d**-0.5, f**-0.5
    dt = cfg.param_dtype
    p = {
        "router": normal_init(gen, (d, E), std, dt),
        "w_gate": _normal_experts(gen, (E, d, f), std, dt),
        "w_up": _normal_experts(gen, (E, d, f), std, dt),
        "w_down": _normal_experts(gen, (E, f, d), std_out, dt),
    }
    if mo.num_shared > 0:
        fs = mo.num_shared * f
        p["shared"] = {
            "w_gate": normal_init(gen, (d, fs), std, dt),
            "w_up": normal_init(gen, (d, fs), std, dt),
            "w_down": normal_init(gen, (fs, d), fs**-0.5, dt),
        }
    return p


def _router(cfg, p: Params, x2: torch.Tensor):
    """x2: (N, d) -> probs (N, E), top-k ids and renormalised weights (f32 router)."""
    mo = cfg.moe
    logits = x2.float() @ p["router"].float()
    probs = torch.softmax(logits, dim=-1)
    top_w, top_i = torch.topk(probs, mo.top_k, dim=-1)
    top_w = top_w / torch.clamp(top_w.sum(-1, keepdim=True), min=1e-9)
    return probs, top_i, top_w


def _aux_loss(cfg, probs: torch.Tensor, top_i: torch.Tensor) -> torch.Tensor:
    mo = cfg.moe
    E = mo.num_experts
    # fraction of tokens routed to each expert (every one of the k choices
    # counts); a scatter, not bincount, which reads its max on the host
    flat = top_i.reshape(-1)
    routed = probs.new_zeros(E).scatter_add_(0, flat, probs.new_ones(flat.shape))
    f_e = routed / top_i.shape[0] / mo.top_k
    p_e = probs.mean(0)
    return E * torch.sum(f_e * p_e)


def _expert_ffn(cfg, w_gate, w_up, w_down, z: torch.Tensor) -> torch.Tensor:
    """z: (E_loc, T, d) -> (E_loc, T, d), swiglu per expert."""
    ct = cfg.compute_dtype
    g = torch.bmm(z, w_gate.to(ct))
    u = torch.bmm(z, w_up.to(ct))
    return torch.bmm(F.silu(g) * u, w_down.to(ct))


def _shared_ffn(cfg, p: Params, x: torch.Tensor) -> torch.Tensor:
    ct = cfg.compute_dtype
    sp = p["shared"]
    g = x @ sp["w_gate"].to(ct)
    u = x @ sp["w_up"].to(ct)
    return (F.silu(g) * u) @ sp["w_down"].to(ct)


# -- dense form (tests, decode, serving) ----------------------------------------

def apply_moe_dense(cfg, p: Params, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    mo = cfg.moe
    ct = cfg.compute_dtype
    B, S, d = x.shape
    x2 = x.reshape(-1, d).to(ct)
    N = x2.shape[0]
    probs, top_i, top_w = _router(cfg, p, x2)
    # combine weights over all experts: (N, E), zero off the top-k
    combine = torch.zeros_like(probs).scatter_add(1, top_i, top_w).to(ct)
    y = _routed_experts(cfg, x2, combine, p["w_gate"], p["w_up"], p["w_down"]).to(ct)
    if mo.num_shared > 0:
        y = y + _shared_ffn(cfg, p, x2)
    aux = _aux_loss(cfg, probs, top_i)
    return y.reshape(B, S, d), aux


def _expert_slabs(cfg, x2, combine, w_gate, w_up, w_down) -> torch.Tensor:
    """sum_e combine[:, e] * ffn_e(x2) over the experts held, in slabs: (N, d) f32."""
    N, d = x2.shape
    y = torch.zeros((N, d), dtype=torch.float32, device=x2.device)
    for e0 in range(0, w_gate.shape[0], EXPERTS_PER_SLAB):
        slab = slice(e0, e0 + EXPERTS_PER_SLAB)
        c = combine[:, slab]
        y_slab = _expert_ffn(
            cfg, w_gate[slab], w_up[slab], w_down[slab], x2[None].expand(c.shape[1], N, d),
        )  # (experts of the slab, N, d)
        # products of compute-dtype values, summed over the experts in f32
        y = y + torch.einsum("end,ne->nd", y_slab.float(), c.float())
    return y


def _routed_experts(cfg, x2, combine, w_gate, w_up, w_down) -> torch.Tensor:
    """The routed experts of the dense form.  On ``DTensor`` expert stacks
    sharded along E, each rank runs its own experts on its rows (slicing a
    slab across the shards would gather every stack whole), and the f32
    partial sums are reduced before the cast."""
    if not isinstance(w_gate, DTensor):
        return _expert_slabs(cfg, x2, combine, w_gate, w_up, w_down)
    mesh = w_gate.device_mesh
    x2 = as_dtensor(x2, mesh)
    experts = [i for i, q in enumerate(w_gate.placements) if q.is_shard() and q.dim == 0]
    rows = [i for i, q in enumerate(x2.placements)
            if q.is_shard() and q.dim == 0 and i not in experts]
    pick = lambda on_rows, on_experts, other: [  # noqa: E731
        on_rows if i in rows else on_experts if i in experts else other
        for i in range(mesh.ndim)]
    x_pl = pick(Shard(0), Replicate(), Replicate())
    c_pl = pick(Shard(0), Shard(1), Replicate())
    w_pl = pick(Replicate(), Shard(0), Replicate())
    y = local_map(
        functools.partial(_expert_slabs, cfg),
        out_placements=pick(Shard(0), Partial(), Replicate()),
        in_placements=(x_pl, c_pl, w_pl, w_pl, w_pl), redistribute_inputs=True,
    )(x2, as_dtensor(combine, mesh), w_gate, w_up, w_down)
    return relayout(y, pick(Shard(0), Replicate(), Replicate()))


# -- expert-parallel form ----------------------------------------------------------

def _dispatch_pack(cfg, x2: torch.Tensor, top_i: torch.Tensor, top_w: torch.Tensor,
                   capacity: int):
    """Sort-based capacity packing.

    Returns the send buffer (E, C, d), and what combining needs: sorted
    expert ids, destination slots (C = dropped), source token index and
    routing weights in sorted order.  The sort is stable, as
    ``jnp.argsort``: it decides which tokens capacity drops.
    """
    mo = cfg.moe
    E, k = mo.num_experts, mo.top_k
    N, d = x2.shape
    dev = x2.device
    flat_e = top_i.reshape(-1)                                  # (N*k,)
    flat_t = torch.arange(N, device=dev).repeat_interleave(k)   # source token per slot
    flat_w = top_w.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    se, st, sw = flat_e[order], flat_t[order], flat_w[order]
    counts = torch.zeros(E, dtype=flat_e.dtype, device=dev).scatter_add_(
        0, flat_e, torch.ones_like(flat_e))
    starts = torch.cumsum(counts, 0) - counts
    pos = torch.arange(N * k, device=dev) - starts[se]          # position within expert
    dest = torch.where(pos < capacity, pos, capacity)           # overflow -> slot C (dropped)
    send = x2.new_zeros((E, capacity + 1, d)).index_put((se, dest), x2[st])
    return send[:, :capacity], (se, dest, st, sw)


def _combine_unpack(cfg, recv: torch.Tensor, book, n_tokens: int, capacity: int) -> torch.Tensor:
    """Inverse of _dispatch_pack: weighted scatter-add back to tokens."""
    se, dest, st, sw = book
    # slot C reads are garbage; zero them via the keep mask
    keep = (dest < capacity).to(recv.dtype)
    recv_pad = F.pad(recv, (0, 0, 0, 1))
    contrib = recv_pad[se, dest] * (sw.to(recv.dtype) * keep)[:, None]
    return recv.new_zeros((n_tokens, recv.shape[-1])).index_add(0, st, contrib)


def _exchange(t: torch.Tensor, world: ExpertWorld) -> torch.Tensor:
    """all_to_all over dim 0 of (ep, ...): chunk j goes to rank j, and the
    chunks received are stacked by source rank.  The identity at ep = 1."""
    if world.size == 1:
        return t
    from torch.distributed.nn.functional import all_to_all_single

    t = t.contiguous()
    return all_to_all_single(torch.empty_like(t), t, group=world.group)


def apply_moe_ep(cfg, p: Params, x: torch.Tensor, *,
                 world: ExpertWorld) -> tuple[torch.Tensor, torch.Tensor]:
    """Expert-parallel MoE over ``world``, SPMD: ``x`` (B, S_loc, d) is this
    rank's tokens, ``p``'s expert leaves hold its ``E / ep`` experts (the
    router and the shared experts whole).  The aux loss is averaged over
    the world, as ``pmean`` averages it."""
    y, aux = _ep_block(cfg, p, x, world=world)
    if cfg.moe.num_shared > 0:
        y = y + _shared_ffn(cfg, p, x.to(cfg.compute_dtype))
    return y, aux


def _ep_block(cfg, p: Params, x: torch.Tensor, *,
              world: ExpertWorld) -> tuple[torch.Tensor, torch.Tensor]:
    """The routed experts of ``apply_moe_ep`` (the shard_map body of the JAX
    package): (y, aux averaged over ``world``)."""
    mo = cfg.moe
    ct = cfg.compute_dtype
    ep = world.size
    E = mo.num_experts
    if E % ep or p["w_gate"].shape[0] * ep != E:
        raise ValueError(f"experts {E} must divide the EP world {ep}, {E // ep} a rank; "
                         f"got {p['w_gate'].shape[0]}")
    B, S, d = x.shape
    x2 = x.reshape(-1, d).to(ct)
    # local token count -> capacity
    capacity = max(1, math.ceil(x2.shape[0] * mo.top_k / E * mo.capacity_factor))

    probs, top_i, top_w = _router(cfg, p, x2)
    aux = _aux_loss(cfg, probs, top_i)
    if ep > 1:
        from torch.distributed.nn.functional import all_reduce

        aux = all_reduce(aux, group=world.group) / ep

    send, book = _dispatch_pack(cfg, x2, top_i, top_w, capacity)
    # (E, C, d) -> (ep, E_loc, C, d) -> exchange -> (ep(src), E_loc, C, d)
    recv = _exchange(send.reshape(ep, E // ep, capacity, d), world)
    z = recv.transpose(0, 1).reshape(E // ep, ep * capacity, d)
    z = _expert_ffn(cfg, p["w_gate"], p["w_up"], p["w_down"], z)
    back = _exchange(z.reshape(E // ep, ep, capacity, d).transpose(0, 1), world)
    y = _combine_unpack(cfg, back.reshape(E, capacity, d), book, x2.shape[0], capacity)
    return y.reshape(B, S, d), aux


def apply_moe_ep_sharded(cfg, p: Params, x: torch.Tensor, *, mesh: DeviceMesh,
                         dp_axes: tuple[str, ...] = ("data",),
                         ep_axis: str = "model") -> tuple[torch.Tensor, torch.Tensor]:
    """``apply_moe_ep`` on ``DTensor`` inputs over ``mesh``, through
    ``local_map`` with the JAX package's ``shard_map`` specs: x over
    (dp, the sequence over ep when it divides, None), the expert stacks over
    ep, the router whole; the aux loss averaged over every axis."""
    ep = mesh.size(mesh.mesh_dim_names.index(ep_axis))
    if cfg.moe.num_experts % ep:
        raise ValueError(f"experts {cfg.moe.num_experts} must divide EP axis {ep}")
    B, S, d = x.shape
    seq = ep_axis if S % ep == 0 and S >= ep else None
    x_pl = placements(make_spec(dp_axes, seq, None), mesh)
    w_pl = placements((ep_axis, None, None), mesh)
    whole = [Replicate()] * mesh.ndim
    world = ExpertWorld(mesh.get_group(ep_axis))
    others = [mesh.get_group(a) for a in mesh.mesh_dim_names if a != ep_axis]

    def block(xb, router, w_gate, w_up, w_down):
        from torch.distributed.nn.functional import all_reduce

        y, aux = _ep_block(cfg, {"router": router, "w_gate": w_gate, "w_up": w_up,
                                 "w_down": w_down}, xb, world=world)
        for group in others:  # the pmean over the remaining axes
            n = torch.distributed.get_world_size(group)
            if n > 1:
                aux = all_reduce(aux, group=group) / n
        return y, aux

    args = [as_dtensor(t, mesh) for t in (x, p["router"], p["w_gate"], p["w_up"],
                                            p["w_down"])]
    y, aux = local_map(
        block, out_placements=(x_pl, whole),
        in_placements=(x_pl, whole, w_pl, w_pl, w_pl), redistribute_inputs=True,
    )(*args)
    if cfg.moe.num_shared > 0:
        y = y + _shared_ffn(cfg, p, x.to(cfg.compute_dtype))
    return y, aux


def apply_moe(cfg, p: Params, x: torch.Tensor, *,
              world: ExpertWorld | DeviceMesh | None = None, decode: bool = False,
              dp_axes: tuple[str, ...] = ("data",),
              ep_axis: str = "model") -> tuple[torch.Tensor, torch.Tensor]:
    """The JAX package's rule: EP iff ``moe_impl == "ep"``, there is a mesh
    (a ``DeviceMesh``, or an ``ExpertWorld`` for the world of one that the
    single-card driver names) and the call is not a decode."""
    if cfg.moe_impl == "ep" and world is not None and not decode:
        if isinstance(world, DeviceMesh):
            return apply_moe_ep_sharded(cfg, p, x, mesh=world, dp_axes=dp_axes,
                                        ep_axis=ep_axis)
        return apply_moe_ep(cfg, p, x, world=world)
    return apply_moe_dense(cfg, p, x)
