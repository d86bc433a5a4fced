"""Weight bridge between the JAX package's param trees and the port's.

Both keep the same tree: dicts and lists of arrays with the same paths and
shapes, including the leading layer axis of ``params["blocks"][i]``. So the
bridge is a copy, leaf by leaf; an optimizer state (its ``step`` and moment
trees) crosses the same way. A JAX tree enters as numpy
(``jax.tree.map(np.asarray, params)``); bf16 leaves (``ml_dtypes.bfloat16``)
keep their bits.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from ._device import resolve_device
from .tree import tree_map


def _to_tensor(a: np.ndarray, device: torch.device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a.copy())
    return t.to(device)


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes  # the numpy bf16 dtype; only needed for bf16 trees

        return t.view(torch.uint16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def params_from_numpy(tree: Any, device=None) -> Any:
    """A param tree of numpy arrays becomes the port's tree of tensors."""
    dev = resolve_device(device)
    return tree_map(lambda a: _to_tensor(a, dev), tree)


def params_to_numpy(tree: Any) -> Any:
    """The port's tree of tensors as numpy arrays (for round-trip checks)."""
    return tree_map(_to_numpy, tree)


def opt_state_from_numpy(state: Any, device=None) -> Any:
    """An optimizer state as numpy (JAX's AdamW or Adafactor tree: the int32
    0-d ``step`` and the moment trees, bf16 moments included) becomes the
    port's tree of tensors, leaf by leaf as ``params_from_numpy``."""
    return params_from_numpy(state, device)


def opt_state_to_numpy(state: Any) -> Any:
    """The port's optimizer state as numpy arrays, the tree JAX's
    ``adamw_update`` / ``adafactor_update`` take (``jax.tree.map(jnp.asarray, ...)``)."""
    return params_to_numpy(state)
