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

* ``routed`` -- a prefill's form on one device (the port's own; the JAX
  package serves prefill densely): the N * top_k token-expert pairs sorted
  by expert, no capacity and nothing dropped, each expert's SwiGLU on its
  own rows only, the weighted outputs summed per token in f32 and cast
  once.  The same function as the dense form, at top_k / E of its expert
  products.  Its buffers are sized by N * top_k, never by an expert's load,
  so its memory does not depend on the routing.

On ``DTensor`` inputs laid out on a ``DeviceMesh`` the EP form runs its
body through ``local_map`` with the JAX package's ``shard_map`` specs
(``apply_moe_ep_sharded``), and the dense form runs each rank's own
experts and sums their f32 outputs across ranks.

``apply_moe`` takes the EP form iff ``cfg.moe_impl == "ep"``, the context
names an expert-parallel world and the call is not a decode, as the JAX
package's does; else the routed form in a prefill on one device (no world,
plain tensors), else the dense form (decode: every expert, static shapes
for the decode graph).  The router aux (load-balance) loss follows Switch:
``E * sum_e f_e * P_e``.  The router weights the chosen experts by their
softmax probabilities, renormalised over the top k unless
``MoEConfig.norm_topk_prob`` is off.

Spans (``repro_torch.runtime.trace``) of the dense and routed forms:
``moe.route`` (router, top-k, the routed form's sort; ``form``, ``tokens``,
``pairs``), ``moe.experts`` (from the tokens to the combined output;
``form``, ``experts`` touched, ``largest`` load) and ``moe.shared``; the
counters ``ROUTED_PAIRS`` and ``DENSE_PAIRS`` add the token-expert pairs
each form computes, on the host as its code runs: a prefill, an eager
decode step and a decode graph's capture are counted, a graph's replay is
not (it runs no Python).  So ``DENSE_PAIRS`` inside a prefill says whether a
prefill still runs every expert; it is no count of a window's decode work.
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
from repro_torch.runtime import trace

Params = dict[str, Any]

# experts a slab of the dense form (and of init_moe's f32 draws): at kimi-k2's
# width a slab's f32 weights are 2.8 GB and its bf16 expert outputs for one
# serving prefill (N = 4096) about 1 GB
EXPERTS_PER_SLAB = 16
#: tokens a slice of the routed form's combine gathers at once
COMBINE_TOKENS = 4096

#: the tracer's counters of token-expert pairs computed by the routed form
#: (top_k a token) and by the dense form (every expert a token); a replayed
#: decode graph adds nothing to either
ROUTED_PAIRS = "moe.routed_pairs"
DENSE_PAIRS = "moe.dense_pairs"


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
    """x2: (N, d) -> probs (N, E), top-k ids and their weights (f32 router):
    the chosen probabilities, renormalised over the top k unless
    ``norm_topk_prob`` is off."""
    mo = cfg.moe
    logits = x2.float() @ p["router"].float()
    probs = torch.softmax(logits, dim=-1)
    top_w, top_i = torch.topk(probs, mo.top_k, dim=-1)
    if mo.norm_topk_prob:
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
    N, E = x2.shape[0], mo.num_experts
    with trace.span("moe.route", form="dense", tokens=N, pairs=N * E):
        probs, top_i, top_w = _router(cfg, p, x2)
        # combine weights over all experts: (N, E), zero off the top-k
        combine = torch.zeros_like(probs).scatter_add(1, top_i, top_w).to(ct)
        aux = _aux_loss(cfg, probs, top_i)
    trace.count(DENSE_PAIRS, N * E)
    with trace.span("moe.experts", form="dense", experts=E, largest=N):
        y = _routed_experts(cfg, x2, combine, p["w_gate"], p["w_up"], p["w_down"]).to(ct)
    return _with_shared(cfg, p, x2, y).reshape(B, S, d), aux


def _with_shared(cfg, p: Params, x2: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``y`` plus the shared experts' output on tokens ``x2``, if any."""
    if cfg.moe.num_shared == 0:
        return y
    with trace.span("moe.shared"):
        return y + _shared_ffn(cfg, p, x2)


# -- routed form (a prefill on one device) ----------------------------------------

def apply_moe_routed(cfg, p: Params, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Each expert on the tokens routed to it, and nothing dropped: the
    dense form's function (the same router and weights, products of
    compute-dtype values summed in f32) at top_k / E of its expert
    products.  The experts' loads are read on the host once, to slice the
    sorted rows."""
    mo = cfg.moe
    ct = cfg.compute_dtype
    B, S, d = x.shape
    x2 = x.reshape(-1, d).to(ct)
    N, k = x2.shape[0], mo.top_k
    with trace.span("moe.route", form="routed", tokens=N, pairs=N * k):
        probs, top_i, top_w = _router(cfg, p, x2)
        aux = _aux_loss(cfg, probs, top_i)
        flat = top_i.reshape(-1)
        order = torch.argsort(flat, stable=True)               # pairs by expert
        loads = torch.bincount(flat, minlength=mo.num_experts).tolist()
    trace.count(ROUTED_PAIRS, N * k)
    with trace.span("moe.experts", form="routed", experts=sum(1 for n in loads if n),
                    largest=max(loads)):
        out = _expert_rows(cfg, p, x2[order // k], loads)      # (N k, d), sorted
        slot = torch.empty_like(order)
        slot[order] = torch.arange(N * k, device=order.device)
        y = _combine_rows(out, slot.view(N, k), top_w.to(ct)).to(ct)
    return _with_shared(cfg, p, x2, y).reshape(B, S, d), aux


def _expert_rows(cfg, p: Params, rows: torch.Tensor, loads: list[int]) -> torch.Tensor:
    """Each expert's SwiGLU on its slice of ``rows`` (sorted by expert,
    ``loads[e]`` rows for expert e), written over ``rows`` in place: a
    slice is read by its gate and up products before its down product
    writes it."""
    ct = cfg.compute_dtype
    g = rows.new_empty((rows.shape[0], cfg.moe.expert_d_ff))
    u = torch.empty_like(g)
    start = 0
    for e, n in enumerate(loads):
        if n:
            r = slice(start, start + n)
            torch.mm(rows[r], p["w_gate"][e].to(ct), out=g[r])
            torch.mm(rows[r], p["w_up"][e].to(ct), out=u[r])
            h = F.silu(g[r], inplace=True).mul_(u[r])
            torch.mm(h, p["w_down"][e].to(ct), out=rows[r])
        start += n
    return rows


def _combine_rows(out: torch.Tensor, slot: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """sum_j w[t, j] * out[slot[t, j]] for each token t: (N, d) f32, the
    products of compute-dtype values summed in f32, over slices of
    ``COMBINE_TOKENS`` tokens."""
    N, k = slot.shape
    y = torch.empty((N, out.shape[-1]), dtype=torch.float32, device=out.device)
    for t0 in range(0, N, COMBINE_TOKENS):
        t = slice(t0, t0 + COMBINE_TOKENS)
        picked = out[slot[t].reshape(-1)].view(-1, k, out.shape[-1]).float()
        y[t] = (picked * w[t, :, None].float()).sum(1)
    return y


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
    if any(q.is_shard() and q.dim != 0 for q in w_gate.placements):
        return _routed_experts_in_shards(cfg, x2, combine, w_gate, w_up, w_down)
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


def _gate_up(cfg, x2, w_gate, w_up):
    ct = cfg.compute_dtype
    z = x2[None].expand(w_gate.shape[0], *x2.shape)
    return torch.bmm(z, w_gate.to(ct)), torch.bmm(z, w_up.to(ct))


def _down_combine(cfg, h, combine, w_down):
    y = torch.bmm(h, w_down.to(cfg.compute_dtype))      # (E_loc, N, d_loc)
    return torch.einsum("end,ne->nd", y.float(), combine.float())


def _routed_experts_in_shards(cfg, x2, combine, w_gate, w_up, w_down) -> torch.Tensor:
    """The dense form with the expert stacks left in their FSDP shards (the
    hidden dim d over data axes, the experts over others): the tokens are
    whole over the axes that split d, so each rank multiplies its rows by
    its slice of d and its experts.  The gate and up products' partial sums
    over those axes reduce, and the down product gives each rank its slice
    of d, summed over the experts in f32 and reduced over the expert
    shards.  A mesh dim that splits the rows and not the stacks (``pod``)
    keeps them split."""
    mesh = w_gate.device_mesh
    x2, combine = as_dtensor(x2, mesh), as_dtensor(combine, mesh)
    kind = []  # per mesh dim: "experts", "d", "rows" or None
    for wq, xq in zip(w_gate.placements, x2.placements):
        kind.append("experts" if wq.is_shard() and wq.dim == 0 else
                    "d" if wq.is_shard() else
                    "rows" if xq.is_shard() and xq.dim == 0 else None)
    pick = lambda **by: [by.get(k, Replicate()) for k in kind]  # noqa: E731
    w_pl = pick(experts=Shard(0), d=Shard(1))
    g, u = local_map(
        functools.partial(_gate_up, cfg),
        out_placements=(pick(experts=Shard(0), d=Partial(), rows=Shard(1)),) * 2,
        in_placements=(pick(d=Shard(1), rows=Shard(0)), w_pl, w_pl),
        redistribute_inputs=True,
    )(x2, w_gate, w_up)
    whole = pick(experts=Shard(0), rows=Shard(1))
    h = F.silu(relayout(g, whole)) * relayout(u, whole)
    y = local_map(
        functools.partial(_down_combine, cfg),
        out_placements=pick(experts=Partial(), d=Shard(1), rows=Shard(0)),
        in_placements=(whole, pick(experts=Shard(1), rows=Shard(0)),
                       pick(experts=Shard(0), d=Shard(2))),
        redistribute_inputs=True,
    )(h, combine, w_down)
    return relayout(y, pick(d=Shard(0), rows=Shard(0)))


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
              prefill: bool = False, dp_axes: tuple[str, ...] = ("data",),
              ep_axis: str = "model") -> tuple[torch.Tensor, torch.Tensor]:
    """The JAX package's rule: EP iff ``moe_impl == "ep"``, there is a mesh
    (a ``DeviceMesh``, or an ``ExpertWorld`` for the world of one that the
    single-card driver names) and the call is not a decode.  Otherwise a
    ``prefill`` on one device (no world, plain tensors) takes the routed
    form, and the rest the dense form."""
    if cfg.moe_impl == "ep" and world is not None and not decode:
        if isinstance(world, DeviceMesh):
            return apply_moe_ep_sharded(cfg, p, x, mesh=world, dp_axes=dp_axes,
                                        ep_axis=ep_axis)
        return apply_moe_ep(cfg, p, x, world=world)
    if prefill and world is None and not isinstance(x, DTensor):
        return apply_moe_routed(cfg, p, x)
    return apply_moe_dense(cfg, p, x)
