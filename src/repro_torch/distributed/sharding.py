"""Sharding rules: DP (+pod) x FSDP x TP x EP over the production mesh.

The PyTorch counterpart of ``repro/distributed/sharding.py``.  Rules map
parameter tree paths to specs:

* TP (``model`` axis): attention heads, MLP hidden, experts, vocab.
* FSDP (``data`` axis): the complementary big dimension of each weight
  (ZeRO-3 -- optimizer moments inherit the same specs).
* DP (``pod`` axis): pure replication + gradient all-reduce by default;
  ``fsdp_pod=True`` folds the pod axis into FSDP (hillclimb option).
* EP: expert dims ride the ``model`` axis (see ``repro_torch.models.moe``).

Dims that do not divide evenly by their axis size fall back to replication
(e.g. MQA's single KV head never shards over 16-way TP).

A spec is backend-neutral, as a ``PartitionSpec`` holds it: a tuple with
one entry per dim, each ``None``, an axis name or a tuple of names (a tuple
of one name is that name).  The rules read only the mesh's axis names and
sizes, so they run on an ``abstract_mesh`` with no process group, and
``placements`` turns a spec into DTensor placements on a ``DeviceMesh``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

Spec = tuple


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """Axis names and sizes of a mesh, with no devices behind them."""

    axis_names: tuple[str, ...]
    sizes: tuple[int, ...]

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        return math.prod(self.sizes)


def abstract_mesh(shape: tuple[int, ...], names: tuple[str, ...]) -> AbstractMesh:
    return AbstractMesh(tuple(names), tuple(shape))


def mesh_axes(mesh) -> dict[str, int]:
    """{axis name: size} of an ``AbstractMesh`` or a ``DeviceMesh``."""
    if isinstance(mesh, AbstractMesh):
        return mesh.shape
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def _axsize(axes: dict[str, int], axis) -> int:
    if axis is None:
        return 1
    if isinstance(axis, tuple):
        return math.prod(axes[a] for a in axis)
    return axes[axis]


def _entry(axis):
    """A tuple of one axis name is that name, as ``PartitionSpec`` keeps it."""
    if isinstance(axis, tuple) and len(axis) == 1:
        return axis[0]
    return axis


def make_spec(*entries) -> Spec:
    return tuple(_entry(e) for e in entries)


class ShardingRules:
    def __init__(
        self,
        mesh,
        *,
        fsdp_pod: bool = False,
        fsdp_params: bool = True,
    ):
        """``fsdp_params=False`` disables weight sharding over the data axis
        (TP-only + replication) -- the right choice for *serving*, where an
        FSDP layout would re-all-gather every weight on every decode step."""
        self.mesh = mesh
        self.axes = mesh_axes(mesh)
        names = tuple(self.axes)
        self.has_pod = "pod" in names
        self.tp = "model"
        if self.has_pod and fsdp_pod:
            self.fsdp: Any = ("pod", "data")
            self.dp_axes: tuple[str, ...] = ("pod", "data")
        elif self.has_pod:
            self.fsdp = "data"
            self.dp_axes = ("pod", "data")
        else:
            self.fsdp = "data"
            self.dp_axes = ("data",)
        if not fsdp_params:
            self.fsdp = None

    # -- helpers ---------------------------------------------------------------

    def _fits(self, dim: int, axis) -> bool:
        n = _axsize(self.axes, axis)
        return dim % n == 0 and dim >= n

    def _pick(self, shape: tuple[int, ...], prefs: list[tuple[int, Any]]) -> Spec:
        """Assign axes to dims in preference order, skipping non-dividing."""
        spec: list[Any] = [None] * len(shape)
        used: set[Any] = set()
        for dim_idx, axis in prefs:
            if axis is None or axis in used or dim_idx >= len(shape):
                continue
            if spec[dim_idx] is None and self._fits(shape[dim_idx], axis):
                spec[dim_idx] = axis
                used.add(axis)
        return make_spec(*spec)

    # -- the rule table -------------------------------------------------------------

    def param_spec(self, path: str, shape: tuple[int, ...]) -> Spec:
        """path: '/'-joined key names, WITHOUT the stacked-layer leading dim."""
        tp, fsdp = self.tp, self.fsdp
        leaf = path.split("/")[-1]

        if leaf in ("embed", "unembed"):           # (V, d)
            return self._pick(shape, [(0, tp), (1, fsdp)])
        if leaf in ("enc_pos", "dec_pos"):         # (T, d)
            return self._pick(shape, [(0, fsdp)])
        if leaf == "w_q":                          # (d, H, hd) or MLA (d,H,qd)
            return self._pick(shape, [(1, tp), (0, fsdp)])
        if leaf in ("w_k", "w_v"):                 # (d, KV, hd)
            return self._pick(shape, [(1, tp), (0, fsdp)])
        if leaf == "w_o":                          # (H, hd, d)
            return self._pick(shape, [(0, tp), (2, fsdp)])
        if leaf in ("b_q", "b_k", "b_v"):          # (H, hd)
            return self._pick(shape, [(0, tp)])
        if leaf == "w_dkv":                        # (d, r+rope)
            return self._pick(shape, [(0, fsdp)])
        if leaf in ("w_uk", "w_uv"):               # (r, H, hd)
            return self._pick(shape, [(1, tp), (0, fsdp)])
        if "moe" in path or "shared" in path:
            if leaf == "router":                   # (d, E)
                return self._pick(shape, [(0, fsdp)])
            if len(shape) == 3:                    # experts (E, d, f)/(E, f, d)
                big = 1 if shape[1] >= shape[2] else 2
                other = 2 if big == 1 else 1
                return self._pick(shape, [(0, tp), (big, fsdp), (other, None)])
            if leaf in ("w_gate", "w_up"):         # shared (d, fs)
                return self._pick(shape, [(1, tp), (0, fsdp)])
            if leaf == "w_down":                   # shared (fs, d)
                return self._pick(shape, [(0, tp), (1, fsdp)])
        if leaf in ("w_gate", "w_up", "w_in"):     # (d, f)
            return self._pick(shape, [(1, tp), (0, fsdp)])
        if leaf in ("w_down", "w_out") and len(shape) == 2:
            # mlp (f, d) / mamba out (din, d): TP on contraction dim
            return self._pick(shape, [(0, tp), (1, fsdp)])
        if leaf == "b_in":                         # (f,)
            return self._pick(shape, [(0, tp)])
        if leaf == "conv_w":                       # (C, K)
            return self._pick(shape, [(0, fsdp)])
        # norms, biases, scalars, A/D/dt params: replicate
        return make_spec(*([None] * len(shape)))

    # -- public API -------------------------------------------------------------------

    def state_shardings(self, state_shapes: Any) -> Any:
        """Specs for a {params, opt} train-state tree of tensors (or anything
        with a ``shape``), the same nesting.

        Stacked layer groups have a leading layer dim -> rules shift by one.
        """

        def spec_for(keys: list[str], leaf) -> Spec:
            # strip opt-state prefixes so moments shard like their params
            while keys and keys[0] in ("params", "opt", "m", "v"):
                keys = keys[1:]
            path = "/".join(keys)
            shape = tuple(leaf.shape)
            if len(shape) == 0:  # scalars (opt step counters etc.)
                return ()
            if _is_stacked(keys, shape):
                inner = self.param_spec(path, shape[1:])
                return (None, *inner)
            return self.param_spec(path, shape)

        return _map_with_path(spec_for, state_shapes)

    def batch_sharding(self) -> Spec:
        return make_spec(self.dp_axes)

    def batch_spec(self, ndim: int) -> Spec:
        return make_spec(self.dp_axes, *([None] * (ndim - 1)))

    def cache_shardings(self, cache_shapes: Any) -> Any:
        """KV/SSM caches: batch over DP axes, kv-heads over TP if they fit.

        Cache leaves are stacked (L, B, ...); batch is dim 1.
        """

        def spec_for(keys: list[str], leaf) -> Spec:
            shape = tuple(leaf.shape)
            name = keys[-1]
            spec: list[Any] = [None] * len(shape)
            if len(shape) >= 2:
                # dim 0 is the stacked layer dim; batch is dim 1
                if self._fits(shape[1], self.dp_axes):
                    spec[1] = self.dp_axes
                if name in ("k", "v", "cross_k", "cross_v") and len(shape) == 5:
                    # (L,B,S,KV,hd): TP on KV heads when they divide the axis,
                    # else context-parallel (sequence) sharding of the cache.
                    if self._fits(shape[3], self.tp):
                        spec[3] = self.tp
                    elif self._fits(shape[2], self.tp):
                        spec[2] = self.tp
                if name in ("c", "k_rope") and len(shape) == 4:
                    # MLA latent cache (L,B,S,r): context-parallel on S
                    if self._fits(shape[2], self.tp):
                        spec[2] = self.tp
                if name == "state" and len(shape) == 5:
                    # (L,B,H,P,N): prefer the state dim N (a power of two,
                    # always TP-divisible) over heads H (often not, e.g.
                    # 24 heads vs 16-way TP -> padded-H resharding with a
                    # per-step state all-gather in the reference's layout)
                    if self._fits(shape[4], self.tp):
                        spec[4] = self.tp
                    elif self._fits(shape[2], self.tp):
                        spec[2] = self.tp
                # NOTE: the conv cache (L,B,K-1,C) is deliberately NOT
                # C-sharded over TP.  It is tiny (~66 MB replicated for
                # mamba2-130m) but C-sharding it propagates a padded
                # H-sharding into the SSM state update, which the reference
                # resolves with a per-step state all-gather.
            return make_spec(*spec)

        return _map_with_path(spec_for, cache_shapes)


def _map_with_path(fn, tree, keys: tuple[str, ...] = ()) -> Any:
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, keys + (_key_str(k),)) for k, v in tree.items()}
    return fn(list(keys), tree)


def _key_str(k) -> str:
    return getattr(k, "key", getattr(k, "name", getattr(k, "idx", str(k))))


def _is_stacked(keys: list[str], shape: tuple[int, ...]) -> bool:
    """Layer-group params/caches carry a leading stacked-layer dim."""
    if not keys:
        return False
    head = keys[0]
    return head not in ("embedding", "final_norm", "enc_norm", "enc_pos", "dec_pos")


# -- DTensor placements ---------------------------------------------------------------

def placements(spec: Spec, mesh) -> list:
    """DTensor placements of ``spec`` on a ``DeviceMesh``: a dim sharded over
    ``("pod", "data")`` is ``Shard(d)`` on both mesh dims, in that order; a
    mesh dim that no tensor dim uses is ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(mesh.mesh_dim_names)
    out: list = [Replicate()] * len(names)
    for dim, axis in enumerate(spec):
        if axis is None:
            continue
        for name in (axis if isinstance(axis, tuple) else (axis,)):
            out[names.index(name)] = Shard(dim)
    return out


def distribute(tree: Any, specs: Any, mesh) -> Any:
    """A tree of whole tensors (the same on every rank) laid out on ``mesh``
    by a tree of specs: each rank keeps its shard, with no collective."""
    if isinstance(tree, dict):
        return {k: distribute(v, specs[k], mesh) for k, v in tree.items()}
    from torch.distributed.tensor import DTensor

    pl = placements(specs, mesh)
    local = tree
    for i, p in enumerate(pl):
        if p.is_shard():
            local = local.tensor_split(mesh.size(i), dim=p.dim)[mesh.get_local_rank(i)]
    return DTensor.from_local(local.contiguous(), mesh, pl, run_check=False,
                              shape=tree.shape, stride=tree.stride())


def gather_full(tree: Any) -> Any:
    """Every ``DTensor`` leaf of ``tree`` whole (a collective: every rank
    calls it); other leaves as they are."""
    if isinstance(tree, dict):
        return {k: gather_full(v) for k, v in tree.items()}
    from torch.distributed.tensor import DTensor

    return tree.full_tensor() if isinstance(tree, DTensor) else tree
