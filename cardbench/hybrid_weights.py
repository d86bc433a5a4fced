"""Zamba2's weights made from the seed on the device, in the port's parameter
layout (``transformer.init_params`` of a ``HybridConfig``): the program's
input, and what the reference (``reference/zamba2.py``) makes again.

Each mamba layer draws its leaves from a generator seeded from (seed,
"mamba", layer), each shared block from (seed, "shared", block), each call's
LoRA and projection from (seed, "call", call), and the embedding and the
final norm from their own, so the reference can make any of them again
after the program's are freed. Matrices take the port initialiser's scales
(1 / sqrt(fan-in)); the norm scales (the port weights a norm by 1 + scale),
the conv bias and D are drawn too, so that a part the program gets wrong
shows; A and dt's bias follow Mamba2's initialiser, A = -U[1, 16] and
softplus(dt_bias) log-uniform on [0.001, 0.1] (the config's time_step_min
and time_step_max), so that heads keep their state for tens to thousands of
steps and a scan that loses it shows too.
"""
from __future__ import annotations

import math

import torch

from .hybrid import HybridDims
from .weights import NORM_STD, generator

DT_MIN, DT_MAX = 1e-3, 1e-1
FP32 = ("A_log", "dt_bias", "D")  # fp32 whatever the dtype, as the port keeps them


def mamba_leaves(h: HybridDims) -> list[tuple[tuple[str, ...], tuple[int, ...], str, float]]:
    """(path in the port's layer tree, shape, draw, std) of a mamba layer's
    leaves, in the order they are drawn; draw is ``normal`` (N(0, std^2)),
    ``one`` (1 + N(0, std^2)), ``a_log`` or ``dt_bias``."""
    d, di, H = h.d, h.d_inner, h.ssm_heads
    return [(("norm",), (d,), "normal", NORM_STD),
            (("mamba", "w_in"), (d, di + h.conv_dim + H), "normal", 1.0 / math.sqrt(d)),
            (("mamba", "conv_w"), (h.d_conv, h.conv_dim), "normal", 0.5),
            (("mamba", "conv_b"), (h.conv_dim,), "normal", NORM_STD),
            (("mamba", "A_log"), (H,), "a_log", 0.0),
            (("mamba", "dt_bias"), (H,), "dt_bias", 0.0),
            (("mamba", "D"), (H,), "one", NORM_STD),
            (("mamba", "gate_norm"), (di,), "normal", NORM_STD),
            (("mamba", "w_out"), (di, d), "normal", 1.0 / math.sqrt(di))]


def shared_leaves(h: HybridDims):
    """A shared block's leaves, as ``mamba_leaves``: q, k and v read the
    concat's d_attn channels, the MLP's gate|up is one (d, 2 d_ff) matrix."""
    d, a, f, hd = h.d, h.d_attn, h.d_ff, h.head_dim
    return [(("norm1",), (a,), "normal", NORM_STD),
            (("attn", "wq"), (a, h.heads, hd), "normal", 1.0 / math.sqrt(a)),
            (("attn", "wk"), (a, h.kv_heads, hd), "normal", 1.0 / math.sqrt(a)),
            (("attn", "wv"), (a, h.kv_heads, hd), "normal", 1.0 / math.sqrt(a)),
            (("attn", "wo"), (h.heads, hd, d), "normal", 1.0 / math.sqrt(h.heads * hd)),
            (("norm2",), (d,), "normal", NORM_STD),
            (("mlp", "w_gate_up"), (d, 2 * f), "normal", 1.0 / math.sqrt(d)),
            (("mlp", "w_out"), (f, d), "normal", 1.0 / math.sqrt(f))]


def call_leaves(h: HybridDims):
    """One call's own leaves: the LoRA (A (d, r), B (r, 2 d_ff)) and the
    output projection."""
    d, r = h.d, h.adapter_rank
    return [(("adapter_a",), (d, r), "normal", 1.0 / math.sqrt(d)),
            (("adapter_b",), (r, 2 * h.d_ff), "normal", 1.0 / math.sqrt(r)),
            (("linear",), (d, d), "normal", 1.0 / math.sqrt(d))]


def _draw(t: torch.Tensor, kind: str, std: float, g: torch.Generator) -> None:
    if kind == "normal":
        t.normal_(0.0, std, generator=g)
    elif kind == "one":
        t.normal_(1.0, std, generator=g)
    elif kind == "a_log":  # A = -exp(A_log) uniform on [-16, -1]
        t.uniform_(1.0, 16.0, generator=g).log_()
    elif kind == "dt_bias":  # softplus(dt_bias) log-uniform on [DT_MIN, DT_MAX]
        t.uniform_(math.log(DT_MIN), math.log(DT_MAX), generator=g).exp_()
        t.add_(torch.log(-torch.expm1(-t)))  # the inverse of softplus
    else:
        raise ValueError(kind)


def _set(tree: dict, path: tuple, value) -> None:
    for key in path[:-1]:
        tree = tree.setdefault(key, {})
    tree[path[-1]] = value


def _tree(leaves, tags: list, device, dtype, lead: bool) -> dict:
    """Leaves drawn for each tag in ``tags`` (a generator a tag), stacked on a
    leading axis when ``lead``."""
    full = [torch.empty(((len(tags),) if lead else ()) + shape, device=device,
                        dtype=torch.float32 if path[-1] in FP32 else dtype)
            for path, shape, _, _ in leaves]
    for i, tag in enumerate(tags):
        g = generator(device, *tag)
        for t, (_, _, kind, std) in zip(full, leaves):
            _draw(t[i] if lead else t, kind, std, g)
    tree: dict = {}
    for t, (path, _, _, _) in zip(full, leaves):
        _set(tree, path, t)
    return tree


def _flat(tree: dict, leaves) -> dict:
    """A tree's leaves by their last name."""
    out = {}
    for path, _, _, _ in leaves:
        node = tree
        for key in path:
            node = node[key]
        out[path[-1]] = node
    return out


def mamba_layer(h: HybridDims, seed: int, i: int, device, dtype=torch.float32) -> dict:
    """Mamba layer i's leaves by last name (``norm``, ``w_in`` ... ``w_out``)."""
    leaves = mamba_leaves(h)
    return _flat(_tree(leaves, [(seed, "mamba", i)], device, dtype, False), leaves)


def shared_block(h: HybridDims, seed: int, b: int, device, dtype=torch.float32) -> dict:
    """Shared block b's leaves by last name (``w_out`` is the MLP's)."""
    leaves = shared_leaves(h)
    return _flat(_tree(leaves, [(seed, "shared", b)], device, dtype, False), leaves)


def call(h: HybridDims, seed: int, j: int, device, dtype=torch.float32) -> dict:
    """Call j's ``adapter_a``, ``adapter_b`` and ``linear``."""
    leaves = call_leaves(h)
    return _flat(_tree(leaves, [(seed, "call", j)], device, dtype, False), leaves)


def global_leaf(h: HybridDims, seed: int, name: str, device, dtype=torch.float32):
    """``embed`` (V, d), also the tied head, or ``final_norm`` (d,)."""
    shape, std = {"embed": ((h.vocab, h.d), 1.0), "final_norm": ((h.d,), NORM_STD)}[name]
    t = torch.empty(shape, dtype=dtype, device=device)
    return t.normal_(0.0, std, generator=generator(device, seed, name))


def model(h: HybridDims, seed: int, device, dtype=torch.float32) -> dict:
    """The whole model in the port's layout: ``blocks`` alternate mamba
    stacks (the layers between two calls) and calls (their own leaves, on a
    leading axis of 1); ``shared`` holds the shared blocks unstacked."""
    blocks, done = [], 0
    for j, i in enumerate(h.hybrid_ids + (h.layers,)):
        if i > done:
            blocks.append(_tree(mamba_leaves(h), [(seed, "mamba", k) for k in range(done, i)],
                                device, dtype, True))
        if i < h.layers:
            blocks.append(_tree(call_leaves(h), [(seed, "call", j)], device, dtype, True))
        done = i
    return {"embed": global_leaf(h, seed, "embed", device, dtype),
            "final_norm": global_leaf(h, seed, "final_norm", device, dtype),
            "blocks": blocks,
            "shared": [_tree(shared_leaves(h), [(seed, "shared", b)], device, dtype, False)
                       for b in range(h.blocks)]}
