"""Per-device op counts of an eager step: the port's ``repro/launch/hlo_analysis.py``.

The JAX package re-walks compiled (post-SPMD) HLO text and multiplies each
computation by its loop trip counts.  An eager PyTorch step has no HLO: its
per-device program is the stream of ATen ops that reach the dispatcher
below DTensor, on each rank's local shards.  ``OpCounter`` is a
``TorchDispatchMode`` that counts that stream:

* a call with a ``DTensor`` among its types gives way (``NotImplemented``),
  so DTensor unwraps it and the local ops it issues (collectives included)
  come back through the mode with local shapes;
* the ops DTensor runs to propagate shardings (global shapes, on the fake
  tensors of its own ``FakeTensorMode``) are left out: with ``skip_fake``
  the counter counts only ops on and to real or meta tensors, which is
  what the dry-run's meta-device shards are.

Eager PyTorch unrolls every layer loop and every microbatch, so there is no
trip count to correct: L layers count L times one layer.

Outputs (``analyze``), under the reference's keys:

* ``flops``                -- mm, bmm, addmm, baddbmm and convolution
                              (forward and backward), with the formulas of
                              ``torch.utils.flop_counter``
* ``bytes``                -- operand + output bytes of every op that is
                              not a view, bookkeeping ops skipped
* ``transcendental_elems`` -- output elements of exp/tanh/log/rsqrt/sqrt/
                              pow/sigmoid/sin/cos/expm1/log1p (the
                              reference's list; a fused activation such as
                              ``silu`` is one op of its own and not counted)
* ``collectives``          -- output bytes by collective kind, plus total
* ``collective_count``

Meta-device runs are memoized: a functional op (no view, no mutation) on
meta tensors whose shapes, strides and dtypes were seen before returns
fresh meta tensors of the recorded layout instead of running the op's meta
function again (most of them run in Python).  It changes nothing that is
counted.  This is an analysis tool for the roofline -- a structural
profile of the program, not a timing model.
"""

from __future__ import annotations

import collections
import weakref
from typing import Any

import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

aten = torch.ops.aten

COLLECTIVES = (
    "all-gather", "all-reduce", "reduce-scatter", "all-to-all",
    "collective-permute",
)

# functional collectives (DTensor's redistributions) and the c10d ops of
# torch.distributed (the MoE exchange), by HLO collective kind
_COLLECTIVE_KIND = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "allgather_": "all-gather",
    "_allgather_base_": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "allreduce_": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "alltoall_base_": "all-to-all",
    "alltoall_": "all-to-all",
    "shard_dim_alltoall": "all-to-all",
    "broadcast": "collective-permute",
    "broadcast_": "collective-permute",
    "send": "collective-permute",
    "recv_": "collective-permute",
}
_COLLECTIVE_NAMESPACES = ("_c10d_functional", "_c10d_functional_autograd", "c10d",
                          "_dtensor")

_FLOP_OPS = {aten.mm, aten.bmm, aten.addmm, aten.baddbmm, aten.convolution,
             aten._convolution, aten.convolution_backward}

# ops that move no real bytes (HLO: parameter, constant, iota, bitcast, ...)
_BOOKKEEPING = {
    aten.empty, aten.empty_strided, aten.empty_like, aten.new_empty,
    aten.new_empty_strided, aten.arange, aten.detach, aten.alias,
    aten.lift_fresh, aten._unsafe_view, aten._local_scalar_dense,
    aten.sym_size, aten.sym_stride, aten.sym_numel, aten.set_,
}

_TRANSCENDENTAL = {aten.exp, aten.exp_, aten.tanh, aten.tanh_, aten.log,
                   aten.log_, aten.rsqrt, aten.rsqrt_, aten.sqrt, aten.sqrt_,
                   aten.pow, aten.pow_, aten.sigmoid, aten.sigmoid_, aten.sin,
                   aten.sin_, aten.cos, aten.cos_, aten.expm1, aten.expm1_,
                   aten.log1p, aten.log1p_}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(*trees: Any) -> list[torch.Tensor]:
    """The tensors of ATen call arguments or results (tensors, and lists,
    tuples and dicts of them)."""
    out: list[torch.Tensor] = []
    stack = list(trees)
    while stack:
        x = stack.pop()
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, (list, tuple)):
            stack.extend(x)
        elif isinstance(x, dict):
            stack.extend(x.values())
    return out


def _collective_kind(func) -> str | None:
    if func.namespace not in _COLLECTIVE_NAMESPACES:
        return None
    return _COLLECTIVE_KIND.get(func._schema.name.split("::")[-1])


def _memoizable(func) -> bool:
    schema = func._schema
    return func.namespace == "aten" and not (func.is_view or schema.is_mutable
                or any(a.alias_info is not None for a in schema.arguments)
                or any(r.alias_info is not None for r in schema.returns))


def _sig(x: Any):
    if isinstance(x, torch.Tensor):
        return ("T", tuple(x.shape), x.stride(), x.dtype, x.storage_offset())
    if isinstance(x, (list, tuple)):
        return tuple(_sig(v) for v in x)
    if isinstance(x, dict):
        return tuple(sorted((k, _sig(v)) for k, v in x.items()))
    if isinstance(x, (torch.dtype, torch.device, torch.layout, torch.memory_format)):
        return str(x)
    return x


class OpCounter(TorchDispatchMode):
    """Counts the per-device ATen program of the code run under it, and
    keeps the peak of the bytes held at once by the storages its ops made
    (``peak_bytes``).  ``log`` keeps each op's name and operand shapes."""

    def __init__(self, *, skip_fake: bool = False, log: bool = False):
        super().__init__()
        self.skip_fake = skip_fake
        self.memo: dict = {}
        self.live_bytes = 0
        self.peak_bytes = 0
        self._live: set[int] = set()
        self._info: dict = {}
        self.log: list[tuple[str, tuple]] | None = [] if log else None
        self.flops = 0.0
        self.bytes = 0.0
        self.transcendental_elems = 0.0
        self.collectives = {k: 0.0 for k in COLLECTIVES}
        self.collective_count = 0.0
        # (op, shapes) -> [calls, flops, bytes]
        self.rows: dict[tuple[str, tuple], list[float]] = collections.defaultdict(
            lambda: [0, 0.0, 0.0])

    # -- dispatch -----------------------------------------------------------------

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        ins = _tensors(args, kwargs)
        if func.namespace == "prim" or (  # metadata queries (a fake tensor's device)
                self.skip_fake and any(isinstance(t, FakeTensor) for t in ins)):
            return func(*args, **kwargs)
        info = self._info.get(func)
        if info is None:
            info = self._info[func] = (str(func), _memoizable(func), _collective_kind(func),
                                       func.overloadpacket)
        out = self._run(func, info[1], args, kwargs, ins)
        if self.skip_fake and not ins and any(isinstance(t, FakeTensor) for t in _tensors(out)):
            return out  # a factory of DTensor's propagation (its fake arguments)
        self._count(func, info, args, ins, out)
        return out

    def _run(self, func, memoizable: bool, args, kwargs, ins):
        if not memoizable:
            return func(*args, **kwargs)
        on_meta = (all(t.device.type == "meta" for t in ins) if ins
                   else str(kwargs.get("device")) == "meta")
        if not on_meta:
            return func(*args, **kwargs)
        try:
            key = (func, _sig(args), _sig(kwargs))
            layout = self.memo.get(key)
        except TypeError:  # an unhashable argument
            return func(*args, **kwargs)
        if layout is None:
            out = func(*args, **kwargs)
            outs = [out] if isinstance(out, torch.Tensor) else out
            if isinstance(outs, (list, tuple)) and all(
                    isinstance(t, torch.Tensor) and t.device.type == "meta" for t in outs):
                self.memo[key] = (isinstance(out, torch.Tensor), type(outs),
                                  [(tuple(t.shape), t.stride(), t.dtype) for t in outs])
            return out
        single, kind, metas = layout
        outs = [torch.empty_strided(s, st, dtype=dt, device="meta") for s, st, dt in metas]
        return outs[0] if single else kind(outs)

    def _hold(self, ts: list[torch.Tensor]) -> None:
        for t in ts:
            st = t.untyped_storage()
            key = st._cdata
            if key in self._live:
                continue
            n = st.nbytes()
            self._live.add(key)
            self.live_bytes += n
            self.peak_bytes = max(self.peak_bytes, self.live_bytes)
            weakref.finalize(st, self._free, key, n)

    def _free(self, key: int, n: int) -> None:
        if key in self._live:
            self._live.discard(key)
            self.live_bytes -= n

    def _count(self, func, info, args, ins, out) -> None:
        name, _, kind, packet = info
        outs = _tensors(out)
        if not (func.is_view or func._schema.is_mutable):
            self._hold(outs)  # an in-place or out= op returns storage it did not make
        shapes = tuple(tuple(t.shape) for t in ins)
        if self.log is not None:
            self.log.append((name, shapes))
        if kind is not None:
            # the reference counts a collective's result bytes; a c10d op
            # writes its first argument
            result = outs if func.namespace != "c10d" else _tensors(args[0])
            b = sum(_nbytes(t) for t in result)
            self.collectives[kind] += b
            self.collective_count += 1
            row = self.rows[(name, shapes)]
            row[0] += 1
            row[2] += b
            return
        flops = 0.0
        if packet in _FLOP_OPS:
            flops = float(flop_registry[packet](*args, out_val=out))
            self.flops += flops
        if packet in _TRANSCENDENTAL:
            self.transcendental_elems += sum(t.numel() for t in outs)
        if func.is_view or packet in _BOOKKEEPING or func.namespace != "aten":
            return
        b = float(sum(_nbytes(t) for t in ins) + sum(_nbytes(t) for t in outs))
        self.bytes += b
        row = self.rows[(name, shapes)]
        row[0] += 1
        row[1] += flops
        row[2] += b

    # -- results ---------------------------------------------------------------------

    def analyze(self) -> dict[str, Any]:
        coll = dict(self.collectives)
        coll["total"] = sum(self.collectives[k] for k in COLLECTIVES)
        return {
            "flops": self.flops,
            "bytes": self.bytes,
            "transcendental_elems": self.transcendental_elems,
            "collectives": coll,
            "collective_count": self.collective_count,
        }

    def top_contributors(self, n: int = 25) -> list[dict]:
        """Per (op, operand shapes): calls, flops and bytes, ranked."""
        rows = [{"op": op, "shapes": [list(s) for s in shapes], "count": int(c),
                 "flops": f, "bytes": b}
                for (op, shapes), (c, f, b) in self.rows.items()]
        rows.sort(key=lambda r: -(r["flops"] + r["bytes"]))
        return rows[:n]
