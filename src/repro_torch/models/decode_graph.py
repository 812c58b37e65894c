"""A decode step as the replay of a captured CUDA graph.

A decode step of ``transformer`` enqueues thousands of small kernels, and
the host's Python that launches them can take longer than the card takes to
run them.  Once a batch is prefilled, every shape a step touches is fixed,
so the step is captured into one ``torch.cuda.CUDAGraph`` and replayed: the
same kernels, dtypes and order, enqueued by one call.

**When.**  Only where the call can be captured, as it observes it: every
tensor on one CUDA device, no ``DeviceMesh`` in the context, no ``DTensor``
leaf, no leaf that autograd would record, and no dispatch mode active (an
op counter or fake tensors would see none of a replay's ops).  Everything
else (the CPU, meshes, the dry-run's meta tensors) runs eagerly.  Every
group kind of ``transformer`` captures: a decode step reads nothing back to
the host and has no shape that depends on data (the MoE layers' decode
takes the dense form).

**Key.**  The config, the context, the shapes and dtypes of the tokens and
positions, and the address, shape, strides and dtype of every cache and
parameter leaf: a graph only replays over the memory it was captured on.

**What the key does not see.**  A replay runs the kernels that were
captured, not the Python that enqueued them.  A caller that changes the
step's code or Python state between calls with one key (a function patched
in, a router that picks its own rows each step) gets the step captured
before the change.  Such a caller keeps its steps eager, by patching
``eager_reason`` to give a reason (as the card tests and ``chip_smoke.py``
do).

**Policy for each key.**  The first call runs eagerly: it is the step and
the warm-up (every kernel loaded, cuBLAS's handle, the cached RoPE
frequencies).  The second captures (``capture_error_mode="thread_local"``:
a server's other threads keep running) and replays once; capture executes
nothing, so the cache is written once a step.  Later calls copy the tokens
and positions into the graph's static buffers and replay.  Each call
returns a clone of the static logits, so logits a caller keeps never change
under it; the cache dict is the caller's own, updated in place by the
replay.

**Memory.**  At most ``KEPT`` keys are kept in the process, the least
recently used going first, with their graphs and the graphs' private pools.
A key is new for each new config, batch, cache length or cache address, and
costs one eager step and one capture; traffic that cycles through more than
``KEPT`` keys pays that at every turn.  Held besides: each graph's static
logits, and the capture stream's cuBLAS workspace, made at the first
capture.

The ``decode_step`` span carries ``graph`` ("eager", "capture" or
"replay"), and the counters ``decode_graph.eager``, ``decode_graph.capture``
and ``decode_graph.replay`` count the steps.  A replayed step runs no
Python inside it, so its module spans are not recorded; an eager or a
capturing step records them.
"""

from __future__ import annotations

import collections
import threading
from typing import Any, Callable, Iterator

import torch
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import _get_current_dispatch_mode

from repro_torch.runtime import trace

#: keys (each with its graph once captured) kept in the process
KEPT = 2

Key = tuple
Body = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def _leaves(tree: Any) -> Iterator[Any]:
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def eager_reason(params: Any, cache: Any, tokens: torch.Tensor, positions: torch.Tensor,
                 ctx: Any) -> str | None:
    """Why the step cannot be captured, or None where it can."""
    if ctx.mesh is not None:
        return "a mesh"
    if _get_current_dispatch_mode() is not None:
        return "a dispatch mode is active"
    leaves = [tokens, positions, *_leaves(params), *_leaves(cache)]
    if any(isinstance(t, DTensor) for t in leaves):
        return "a DTensor leaf"
    if torch.is_grad_enabled() and any(t.requires_grad for t in leaves):
        return "autograd records the step"
    device = tokens.device
    if device.type != "cuda" or any(t.device != device for t in leaves):
        return "not all on one CUDA device"
    return None


def _layout(t: torch.Tensor) -> tuple:
    return t.data_ptr(), t.shape, t.stride(), t.dtype


def key(cfg: Any, params: Any, cache: Any, tokens: torch.Tensor, positions: torch.Tensor,
        ctx: Any) -> Key:
    """The key of a step: its shapes and the addresses it runs over."""
    return (repr(cfg), ctx, tokens.device, tokens.shape, tokens.dtype, positions.shape,
            positions.dtype, tuple(map(_layout, _leaves(cache))),
            tuple(map(_layout, _leaves(params))))


class _Graph:
    """One captured step: static tokens and positions in, static logits out."""

    def __init__(self, body: Body, tokens: torch.Tensor, positions: torch.Tensor):
        # plain tensors, which a step in or out of inference mode may copy into
        with torch.inference_mode(False):
            self.tokens = torch.empty_like(tokens)
            self.positions = torch.empty_like(positions)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph, capture_error_mode="thread_local"):
            self.logits = body(self.tokens, self.positions)

    def __call__(self, tokens: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
        self.tokens.copy_(tokens)
        self.positions.copy_(positions)
        self.graph.replay()
        return self.logits.clone()


class DecodeGraphs:
    """The captured decode steps of a process, by key (see the module
    docstring)."""

    def __init__(self) -> None:
        self._kept: collections.OrderedDict[Key, _Graph | None] = collections.OrderedDict()
        self._lock = threading.Lock()

    def _plan(self, key: Key | None) -> tuple[str, _Graph | None]:
        if key is None:
            return "eager", None
        with self._lock:
            if key in self._kept:
                self._kept.move_to_end(key)
                graph = self._kept[key]
                return ("capture" if graph is None else "replay"), graph
            self._kept[key] = None  # seen once: the next call captures
            while len(self._kept) > KEPT:
                self._kept.popitem(last=False)
            return "eager", None

    def _capture(self, key: Key, body: Body, tokens: torch.Tensor,
                 positions: torch.Tensor) -> _Graph:
        with self._lock:  # one capture at a time in the process
            graph = _Graph(body, tokens, positions)
            if key in self._kept:  # not evicted meanwhile by another thread
                self._kept[key] = graph
        return graph

    def step(self, key: Key | None, body: Body, tokens: torch.Tensor,
             positions: torch.Tensor) -> torch.Tensor:
        """``body(tokens, positions)``'s logits: run eagerly, captured and
        replayed, or replayed, as ``key``'s history decides (None: eagerly)."""
        mode, graph = self._plan(key)
        trace.count(f"decode_graph.{mode}")
        with trace.span("decode_step", device=False, cpu=True, graph=mode):
            if mode == "eager":
                return body(tokens, positions)
            if graph is None:
                graph = self._capture(key, body, tokens, positions)
            return graph(tokens, positions)


#: the process's decode graphs, which ``transformer.decode_step`` uses
GRAPHS = DecodeGraphs()
