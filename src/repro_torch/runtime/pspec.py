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
from ..kernels.gemm_f32.ops import matmul
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


class _OnGrad(torch.autograd.Function):
    """Identity forward; ``fn`` of the gradient backward."""

    @staticmethod
    def forward(ctx, x, fn):
        ctx.fn = fn
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return ctx.fn(grad), None


def _on_grad(x: torch.Tensor, fn) -> torch.Tensor:
    """``x``, with ``fn`` applied to its gradient on the way back, where
    ``x`` is a DTensor that takes a gradient; else ``x`` itself."""
    if is_sharded(x) and torch.is_grad_enabled() and x.requires_grad:
        return _OnGrad.apply(x, fn)
    return x


def product(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w``. For a DTensor ``x`` of three or more dimensions, over
    ``whole_rows(x)``, with the gradient of the result brought to whole rows
    too (its backward flattens them as well). Otherwise through
    ``gemm_f32.ops.matmul``, which sends prefill-sized fp32 products on the
    card to the 3xTF32 kernel and the rest to ``x @ w``."""
    if not is_sharded(x) or x.dim() < 3:
        return matmul(x, w)
    return rows_grad(whole_rows(x) @ w)


def rows_grad(y: torch.Tensor) -> torch.Tensor:
    """``y``, its gradient brought to ``whole_rows`` on the way back: for a
    result whose backward flattens its rows (a product's, a reshape's)."""
    return _on_grad(y, whole_rows)


def fit_split(x: torch.Tensor, dim: int, n: int) -> torch.Tensor:
    """``x`` ready for a view that splits dimension ``dim`` into (n, rest):
    of the mesh dimensions that split it (nested in mesh order), the
    longest leading run whose shards divide ``n`` is kept and the rest made
    whole (DTensor can only keep a split on the leading part of such a
    view; GSPMD reshards). A plain tensor is returned as it is."""
    if not is_sharded(x):
        return x
    from torch.distributed.tensor import Replicate, Shard

    dim = dim % x.dim()
    mesh = x.device_mesh
    on = [i for i, p in enumerate(x.placements) if isinstance(p, Shard) and p.dim == dim]
    ways, keep = 1, 0
    while keep < len(on) and n % (ways * mesh.size(on[keep])) == 0:
        ways *= mesh.size(on[keep])
        keep += 1
    if keep == len(on):
        return x
    want = tuple(Replicate() if i in on[keep:] else p for i, p in enumerate(x.placements))
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


def fit_grad(x: torch.Tensor, dim: int, n: int) -> torch.Tensor:
    """``x``, its gradient made ready (``fit_split``) for the backward of a
    view that merged (n, rest) into dimension ``dim``: a weight flattened
    over its heads, whose gradient DTensor may split in a way the heads do
    not divide."""
    return _on_grad(x, lambda g: fit_split(g, dim, n))


def laid_out(x: torch.Tensor) -> torch.Tensor:
    """``x`` with its local shard laid out in the order its global strides
    give. A redistribution can leave a contiguous local shard under the
    global strides of a permuted tensor (an expert product's output, whose
    batched matmul ran expert-major); a product that then views the global
    tensor as contiguous would view the local shard wrongly (torch 2.13's
    ``Cannot view a tensor ...``). Such a DTensor is copied contiguous, both
    sides then agreeing; a plain tensor, or a DTensor whose shard agrees, is
    returned as it is."""
    if not is_sharded(x):
        return x
    local = x._local_tensor

    def order(t):
        return [i for i in sorted(range(t.dim()), key=lambda i: -t.stride(i))
                if t.shape[i] > 1]

    if local.numel() == 0 or order(local) == order(x):
        return x
    return x.clone(memory_format=torch.contiguous_format)


def laid_out_grad(y: torch.Tensor) -> torch.Tensor:
    """``y``, its gradient brought to ``laid_out`` on the way back: for the
    output of a product whose backward views that gradient (an expert
    product's, whose gradient a redistribution may have made contiguous
    under permuted global strides)."""
    return _on_grad(y, laid_out)


def reduced_grad(x: torch.Tensor) -> torch.Tensor:
    """``x``, its gradient reduced to ``x``'s placements as soon as it
    arrives. For a layer's params, taken just before the layer runs: the
    autograd engine runs a node by the order it was made in, latest first,
    so the reduction of a gradient made at the start of the forward (where
    the layers are unbound) would wait for the end of the backward, every
    layer's unreduced gradient (the whole of an FSDP dimension) alive until
    then; made at the layer, it runs when the layer's backward is done, as
    XLA reduces a scanned layer's gradient. A plain tensor is returned as it
    is."""
    if not is_sharded(x):
        return x
    mesh, pl = x.device_mesh, tuple(x.placements)

    def reduce(grad):
        # redistributed to x's placements (a pending sum reduced: a
        # reduce-scatter onto an FSDP shard, else an all-reduce), waited for
        from torch.distributed._functional_collectives import AsyncCollectiveTensor
        from torch.distributed.tensor import DTensor

        if tuple(grad.placements) != pl:
            grad = grad.redistribute(mesh, pl)
        local = grad._local_tensor
        if isinstance(local, AsyncCollectiveTensor):
            grad = DTensor.from_local(local.wait(), mesh, pl, run_check=False,
                                      shape=grad.shape, stride=grad.stride())
        return grad

    return _on_grad(x, reduce)


def unbind_layers(x: torch.Tensor) -> tuple:
    """``x.unbind(0)``: the layers of a stacked leaf as views, whose backward
    stacks the layers' gradients once (``stack[i]`` a layer would make a
    zero stack for each). A DTensor is unbound shard by shard
    (``local_map``), its layer dimension whole (the policy never splits it;
    a split or a pending sum there is made whole first), so that no torch
    version's DTensor plan for ``unbind`` is needed."""
    if not is_sharded(x):
        return x.unbind(0)
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = x.device_mesh
    pl = tuple(Replicate() if p.is_partial() or (isinstance(p, Shard) and p.dim == 0) else p
               for p in x.placements)
    out = [Shard(p.dim - 1) if isinstance(p, Shard) else p for p in pl]
    parts = local_map(lambda t: t.unbind(0), out_placements=tuple([out] * x.shape[0]),
                      in_placements=(pl,), device_mesh=mesh, redistribute_inputs=True)(x)
    if any(tuple(p.shape) != tuple(x.shape[1:]) for p in parts):
        raise ValueError(f"unbind_layers: a layer of {tuple(x.shape)} on {pl} came out "
                         f"{tuple(parts[0].shape)}: its shards are uneven")
    return tuple(parts)


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
