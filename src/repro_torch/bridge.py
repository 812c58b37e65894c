"""Weight bridge between nested numpy param trees and torch tensors.

The JAX package's params are nested dicts of arrays with stacked layer dims
(``repro/models/transformer.py::init_params``).  ``params_from_jax`` maps
such a tree, already converted to numpy on the JAX side, onto tensors with
the same key paths, shapes and dtypes; ``params_to_numpy`` goes back.  The
tests feed both frameworks the same weights this way.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch


def to_tensor(x: Any, *, device: Any) -> torch.Tensor:
    """An ndarray-like (or a proxy of one) as a tensor on ``device``.

    ``np.array`` copies into a writable array first: ``torch.as_tensor`` on a
    proxy takes the forwarded ``__dlpack__`` of a read-only array and raises
    ``BufferError``, and ``torch.from_numpy`` warns on read-only memory.
    """
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
