"""Weights and token ids made from the seed on the device, in the port's
parameter layout (the program's input; the reference reads the same values).

Every layer draws its leaves from a generator of its own, seeded from
(seed, layer), and the embedding, the final norm and the head each from
theirs, so a pipeline rank makes only its stage and the reference can make
any layer again. Scales are those of the port's own initialiser; the norm
scales (the port weights a norm by 1 + scale) are drawn too, so that a norm
the program gets wrong shows.
"""
from __future__ import annotations

import hashlib
import math

import torch

from .model_config import Dims

NORM_STD = 0.1


def mix(seed: int, *tags) -> int:
    """A 63-bit generator seed from the run's seed and a tag."""
    digest = hashlib.sha256(repr((int(seed), *tags)).encode()).digest()
    return int.from_bytes(digest[:8], "little") & ((1 << 63) - 1)


def generator(device, seed: int, *tags) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(mix(seed, *tags))
    return g


def layer_leaves(d: Dims) -> list[tuple[tuple[str, ...], tuple[int, ...], float]]:
    """(path in the port's layer tree, shape, std) of one layer's leaves, in
    the order they are drawn."""
    s_d = 1.0 / math.sqrt(d.d)
    leaves = [(("norm1",), (d.d,), NORM_STD),
              (("attn", "wq"), (d.d, d.heads, d.head_dim), s_d),
              (("attn", "wk"), (d.d, d.kv_heads, d.head_dim), s_d),
              (("attn", "wv"), (d.d, d.kv_heads, d.head_dim), s_d),
              (("attn", "wo"), (d.heads, d.head_dim, d.d), 1.0 / math.sqrt(d.heads * d.head_dim)),
              (("norm2",), (d.d,), NORM_STD),
              (("mlp", "w_in"), (d.d, d.d_ff), s_d)]
    if d.mlp == "swiglu":
        leaves.append((("mlp", "w_gate"), (d.d, d.d_ff), s_d))
    leaves.append((("mlp", "w_out"), (d.d_ff, d.d), 1.0 / math.sqrt(d.d_ff)))
    return leaves


def _set(tree: dict, path: tuple, value) -> None:
    for key in path[:-1]:
        tree = tree.setdefault(key, {})
    tree[path[-1]] = value


def stack(d: Dims, seed: int, layers: range, device, dtype=torch.float32) -> dict:
    """The port's block tree of ``layers``, each leaf stacked on a leading
    layer axis."""
    leaves = layer_leaves(d)
    full = [torch.empty((len(layers), *shape), dtype=dtype, device=device)
            for _, shape, _ in leaves]
    for i, layer in enumerate(layers):
        g = generator(device, seed, "layer", layer)
        for t, (_, _, std) in zip(full, leaves):
            t[i].normal_(0.0, std, generator=g)
    tree: dict = {}
    for t, (path, _, _) in zip(full, leaves):
        _set(tree, path, t)
    return tree


def layer(d: Dims, seed: int, index: int, device, dtype=torch.float32) -> dict:
    """One layer's leaves by their last name (``wq``, ``w_in``, ...), the
    same values ``stack`` gives that layer."""
    tree = stack(d, seed, range(index, index + 1), device, dtype)
    flat = {}
    for path, _, _ in layer_leaves(d):
        node = tree
        for key in path:
            node = node[key]
        flat[path[-1]] = node[0]
    return flat


def global_leaf(d: Dims, seed: int, name: str, device, dtype=torch.float32) -> torch.Tensor:
    """``embed`` (V, d), ``final_norm`` (d,) or ``lm_head`` (d, V)."""
    shape, std = {"embed": ((d.vocab, d.d), 1.0), "final_norm": ((d.d,), NORM_STD),
                  "lm_head": ((d.d, d.vocab), 1.0 / math.sqrt(d.d))}[name]
    t = torch.empty(shape, dtype=dtype, device=device)
    return t.normal_(0.0, std, generator=generator(device, seed, name))


def model(d: Dims, seed: int, device, dtype=torch.float32) -> dict:
    """The whole model in the port's layout (``transformer.init_params``'s tree)."""
    return {"embed": global_leaf(d, seed, "embed", device, dtype),
            "final_norm": global_leaf(d, seed, "final_norm", device, dtype),
            "lm_head": global_leaf(d, seed, "lm_head", device, dtype),
            "blocks": [stack(d, seed, range(d.layers), device, dtype)]}


def stage(d: Dims, seed: int, layers: range, device, *, first: bool, last: bool,
          dtype=torch.float32) -> dict:
    """One pipeline rank's params as ``pipeline_ranks.stage_slice`` lays them
    out: its layers, the embedding on the first rank, the final norm and the
    head on the last."""
    out = {"blocks": [stack(d, seed, layers, device, dtype)]}
    if first:
        out["embed"] = global_leaf(d, seed, "embed", device, dtype)
    if last:
        out["final_norm"] = global_leaf(d, seed, "final_norm", device, dtype)
        out["lm_head"] = global_leaf(d, seed, "lm_head", device, dtype)
    return out


def tokens(seed: int, tag, shape: tuple, vocab: int, device) -> torch.Tensor:
    """Token ids uniform over the vocabulary, from (seed, ``tag``)."""
    return torch.randint(0, vocab, shape, generator=generator(device, seed, "tokens", tag),
                         device=device)
