"""Activation sharding-constraint hook, the twin of ``repro.runtime.pspec``.

Models are sharding-agnostic; the runtime installs a policy (named activation
points -> ``P`` specs on a device mesh) and models call ``constrain(x, name)``
at those points. Outside a policy, or on a plain tensor, ``constrain``
returns ``x`` itself, so unsharded models run exactly as before.

Inside a policy a DTensor is redistributed to the named spec (JAX's
``with_sharding_constraint``), after dropping the mesh axes that do not
divide the dimension. The context also lets plain tensors (positions, masks,
scalars) meet DTensors as replicated values (``implicit_replication``), as
a traced constant meets a sharded array in JAX.
"""
from __future__ import annotations

import contextlib
import contextvars
from typing import Optional

import torch

from ..kernels._sharded import is_dtensor as is_sharded
from .sharding import divides, placements

_POLICY: contextvars.ContextVar[Optional[dict]] = contextvars.ContextVar(
    "repro_torch_sharding_policy", default=None
)


@contextlib.contextmanager
def activation_policy(mesh, specs: dict):
    """Install named activation specs on ``mesh`` for the enclosed calls."""
    from torch.distributed.tensor.experimental import implicit_replication

    tok = _POLICY.set({"mesh": mesh, "specs": dict(specs)})
    try:
        with implicit_replication():
            yield
    finally:
        _POLICY.reset(tok)


def whole_rows(x: torch.Tensor) -> torch.Tensor:
    """``x`` with no dimension but the first (batch) and the last (features)
    split: what a product ``x @ w`` needs, since it flattens those
    dimensions (a DTensor refuses to flatten a split one). Under a
    sequence-parallel residual this is the all-gather of the sequence before
    a column-parallel product (Megatron's sequence parallelism; XLA inserts
    the same for JAX). A plain tensor is returned as it is."""
    if not is_sharded(x) or x.dim() < 3:
        return x
    from torch.distributed.tensor import Replicate, Shard

    want = tuple(Replicate() if isinstance(p, Shard) and 0 < p.dim < x.dim() - 1 else p
                 for p in x.placements)
    if want == tuple(x.placements):
        return x
    return x.redistribute(x.device_mesh, want)


class _WholeRowsGrad(torch.autograd.Function):
    """Identity forward; the gradient brought to ``whole_rows`` backward, so
    that the backward of the product it follows can flatten its rows."""

    @staticmethod
    def forward(ctx, y):
        return y.view_as(y)

    @staticmethod
    def backward(ctx, grad):
        return whole_rows(grad)


def product(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w``. For a DTensor ``x`` of three or more dimensions, over
    ``whole_rows(x)``, with the gradient of the result brought to whole rows
    too (its backward flattens them as well)."""
    if not is_sharded(x) or x.dim() < 3:
        return x @ w
    return rows_grad(whole_rows(x) @ w)


def rows_grad(y: torch.Tensor) -> torch.Tensor:
    """``y``, its gradient brought to ``whole_rows`` on the way back: for a
    result whose backward flattens its rows (a product's, a reshape's)."""
    if is_sharded(y) and torch.is_grad_enabled() and y.requires_grad:
        return _WholeRowsGrad.apply(y)
    return y


def fit_split(x: torch.Tensor, dim: int, n: int) -> torch.Tensor:
    """``x`` ready for a view that splits dimension ``dim`` into (n, rest):
    that dimension unsplit unless its shards divide ``n`` (DTensor can only
    keep a split on the leading part of such a view; GSPMD reshards). A
    plain tensor is returned as it is."""
    if not is_sharded(x):
        return x
    from torch.distributed.tensor import Replicate, Shard

    dim = dim % x.dim()
    mesh = x.device_mesh
    on = [i for i, p in enumerate(x.placements) if isinstance(p, Shard) and p.dim == dim]
    ways = 1
    for i in on:
        ways *= mesh.size(i)
    if n % ways == 0:
        return x
    want = tuple(Replicate() if i in on else p for i, p in enumerate(x.placements))
    return x.redistribute(mesh, want)


def settled(x):
    """``x`` with its pending sums or means (Partial placements) reduced, so
    that values of different reductions can be combined (torch 2.11's
    DTensor refuses to add a pending mean to a pending sum). Anything but a
    DTensor is returned as it is."""
    if not is_sharded(x):
        return x
    from torch.distributed.tensor import Replicate

    want = tuple(Replicate() if p.is_partial() else p for p in x.placements)
    return x if want == tuple(x.placements) else x.redistribute(x.device_mesh, want)


def fit_sum(x: torch.Tensor, n: int) -> torch.Tensor:
    """``x`` ready for a product that contracts a dimension of size ``n``
    and keeps the last: a pending sum (Partial) on a mesh dimension whose
    size does not divide ``n`` is reduced onto a split of the last dimension
    (a reduce-scatter) where no mesh dimension splits it yet and its size
    divides, else whole (an all-reduce of the local shard). DTensor would
    scatter the sum over the contracted dimension, which the product's view
    then cannot flatten (an MoE decode step's capacity of 40 over 16 ranks).
    Anything but a DTensor, or one whose sums divide ``n``, is returned as
    it is."""
    if not is_sharded(x):
        return x
    from torch.distributed.tensor import Replicate, Shard

    mesh, last = x.device_mesh, x.dim() - 1
    free = not any(isinstance(p, Shard) and p.dim == last for p in x.placements)
    want = list(x.placements)
    for i, p in enumerate(want):
        if p.is_partial() and n % mesh.size(i):
            fits = free and x.shape[last] % mesh.size(i) == 0
            want[i], free = (Shard(last), False) if fits else (Replicate(), free)
    return x if want == list(x.placements) else x.redistribute(mesh, tuple(want))


class _FitGrad(torch.autograd.Function):
    """Identity forward; ``fit_split`` of the gradient backward."""

    @staticmethod
    def forward(ctx, x, dim, n):
        ctx.fit = (dim, n)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return fit_split(grad, *ctx.fit), None, None


def fit_grad(x: torch.Tensor, dim: int, n: int) -> torch.Tensor:
    """``x``, its gradient made ready (``fit_split``) for the backward of a
    view that merged (n, rest) into dimension ``dim``: a weight flattened
    over its heads, whose gradient DTensor may split in a way the heads do
    not divide."""
    if is_sharded(x) and torch.is_grad_enabled() and x.requires_grad:
        return _FitGrad.apply(x, dim, n)
    return x


def constrain(x: torch.Tensor, name: str) -> torch.Tensor:
    pol = _POLICY.get()
    spec = None if pol is None else pol["specs"].get(name)
    if not is_sharded(x) or spec is None or len(spec) > x.dim():
        return x
    # drop mesh axes that do not divide the dimension (e.g. seq-parallel
    # specs against a decode step's length-1 sequence axis)
    want = placements(x.device_mesh, divides(pol["mesh"], spec, tuple(x.shape)))
    if tuple(x.placements) == want:
        return x
    return x.redistribute(x.device_mesh, want)
