"""Weight bridge between nested numpy param trees and torch tensors.

The JAX package's params are nested dicts of arrays with stacked layer dims
(``repro/models/transformer.py::init_params``).  ``params_from_jax`` maps
such a tree, already converted to numpy on the JAX side, onto tensors with
the same key paths, shapes and dtypes; ``params_to_numpy`` goes back.  The
tests feed both frameworks the same weights this way.  Both carry any nested
dict, a whole train state ``{"params", "opt": {"m", "v", "step"}}`` with its
0-d int32 step too.  ``flatten``/``unflatten`` list a tree's leaves in the
sorted-key order of ``jax.tree.flatten``.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch


def to_tensor(x: Any, *, device: Any) -> torch.Tensor:
    """An ndarray-like or a tensor (or a proxy of either) as a tensor on ``device``.

    A proxy is resolved first: its class reads as the tensor's it was made
    from, but a store decodes a tensor as an ndarray, so its target may be
    one.  ``np.array`` copies into a writable array: ``torch.as_tensor`` on a
    read-only array's ``__dlpack__`` raises ``BufferError``, and
    ``torch.from_numpy`` warns on read-only memory.
    """
    from repro_torch.core.proxy import extract

    x = extract(x)
    if isinstance(x, torch.Tensor):
        return x.detach().to(device)
    arr = np.array(x)
    if arr.dtype.name == "bfloat16":  # ml_dtypes: carry the bits across
        return torch.from_numpy(arr.view(np.uint16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(arr).to(device)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes

        return t.view(torch.uint16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def params_from_jax(tree: Any, *, device: Any) -> Any:
    """Nested dict of numpy arrays -> the same nesting of tensors on ``device``."""
    if isinstance(tree, dict):
        return {k: params_from_jax(v, device=device) for k, v in tree.items()}
    return to_tensor(tree, device=device)


def params_to_numpy(tree: Any) -> Any:
    """Nested dict of tensors -> the same nesting of numpy arrays."""
    if isinstance(tree, dict):
        return {k: params_to_numpy(v) for k, v in tree.items()}
    return to_numpy(tree)


def flatten(tree: Any, prefix: tuple[str, ...] = ()) -> list[tuple[tuple[str, ...], Any]]:
    """(key path, leaf) pairs of a nested dict, in sorted-key order.

    ``type`` rather than ``isinstance``: a proxy leaf answers ``isinstance``
    by resolving its target."""
    if issubclass(type(tree), dict):
        return [pair for k in sorted(tree) for pair in flatten(tree[k], prefix + (k,))]
    return [(prefix, tree)]


def unflatten(pairs: list[tuple[tuple[str, ...], Any]]) -> Any:
    """The nested dict that ``flatten`` listed (a lone leaf for the path ())."""
    if len(pairs) == 1 and pairs[0][0] == ():
        return pairs[0][1]
    tree: dict = {}
    for path, leaf in pairs:
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
    return tree
