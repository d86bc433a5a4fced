"""Trees of tensors as the port keeps them (params, caches, optimizer
state): nested dicts and lists (or tuples) with tensors at the leaves, walked
as ``jax.tree`` walks the JAX package's trees."""
from __future__ import annotations

from typing import Any, Callable


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree`` and, at the same places, of the
    trees in ``rest``; a tree in ``rest`` may hold a subtree where ``tree``
    has a leaf (an Adafactor state's ``{"vr", "vc"}``), which ``fn`` gets
    whole."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_leaves(tree: Any) -> list:
    """The leaves in the order ``tree_map`` visits them."""
    out: list = []
    tree_map(out.append, tree)
    return out


def tree_map_with_path(fn: Callable, tree: Any, path: str = "") -> Any:
    """``fn(path, leaf)`` over the leaves of ``tree``, ``path`` the keys and
    list indices from the root joined by ``/`` (``"blocks/0/attn/wq"``), as
    the JAX package's ``_path_str`` spells a ``jax.tree_util`` key path."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, f"{path}/{k}" if path else str(k))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map_with_path(fn, v, f"{path}/{i}" if path else str(i))
                          for i, v in enumerate(tree))
    return fn(path, tree)
