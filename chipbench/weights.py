"""Weights made from the seed, on the device, in the tree ``repro_torch.models.
transformer`` takes.

The layout, a tree of (shape, init) leaves, is the model family's
(``families/<family>.py``, worked out from the configuration file's sizes;
the CPU tests hold it to the port's own ``init_params``).  Every matrix is
drawn from one ``torch.Generator`` on the device in a few large ``randn``
calls into one flat buffer in the served dtype, in the layout's order, and
each leaf is a view of its slice scaled by the fan-in rule the port's
initialiser uses (``normal_`` in place, so no draw needs a second buffer);
norms and biases are set as the port sets them, and a family's own fills
(the SSM's decay tables) by the family.  The program and the reference are
handed these same tensors.
"""

from __future__ import annotations

import math
from typing import Any, Callable

import torch

#: elements per ``randn`` call: a few calls for a model of billions
DRAW = 1 << 30


def tree_map(fn, tree):
    """``fn`` of every (shape, init) leaf, in the tree's shape."""
    if isinstance(tree, tuple):
        return fn(tree)
    return {k: tree_map(fn, v) for k, v in tree.items()}


def _leaves(tree):
    if isinstance(tree, tuple):
        yield tree
    else:
        for v in tree.values():
            yield from _leaves(v)


def make(layout: dict[str, Any], seed: int, device: torch.device, dtype: torch.dtype,
         inits: dict[str, Callable[[torch.Tensor], torch.Tensor]] | None = None
         ) -> dict[str, Any]:
    """The weight tree of ``layout`` for ``seed``: the same seed gives the
    same weights.  An init ("normal", std) is drawn, ("ones",) and
    ("zeros",) are filled, and any other kind is ``inits[kind]``, which
    fills the empty leaf in place."""
    drawn = sum(math.prod(s) for s, init in _leaves(layout) if init[0] == "normal")
    gen = torch.Generator(device=device).manual_seed(seed % (1 << 63))
    flat = torch.empty(drawn, dtype=dtype, device=device)
    for start in range(0, drawn, DRAW):
        flat[start:start + DRAW].normal_(generator=gen)
    offset = 0

    def fill(leaf):
        nonlocal offset
        shape, init = leaf
        kind = init[0]
        if kind == "normal":
            n = math.prod(shape)
            t = flat[offset:offset + n].view(shape)
            offset += n
            return t.mul_(init[1])
        t = torch.empty(shape, dtype=dtype, device=device)
        if kind == "ones":
            return t.fill_(1.0)
        if kind == "zeros":
            return t.zero_()
        return (inits or {})[kind](t)

    return tree_map(fill, layout)
