"""What the kernels' dispatch (``ops.py``) does with tensors that are not
plain: DTensors of a sharded model, and the shape-only tensors of a dry run.

A DTensor goes through ``local_map``: each rank runs the kernel (or, on the
CPU, its plain version) on its own shard, here its own heads, and the
results form a DTensor of the same placements. ``head_split`` reads which
mesh dimension splits the heads and what every input must be redistributed
to; anything the kernel cannot take on a shard (a split head size, heads
split over two mesh dimensions, groups that do not line up with the local
heads, an in-place state output of other placements) raises. No
DTensor ever reaches a ``*_cuda`` wrapper: ``refuse_wrapped`` raises there.

A FakeTensor (``launch/dryrun.py``) never reaches ctypes or a plain
version's loops: ``ShapeOnly`` returns empty outputs of the right
shapes and tells the watchers ``watching`` installs of each call: the
kernel's operations and bytes, by the formulas of the kernels' bounds, and
what it writes (its outputs).
"""
from __future__ import annotations

import contextlib
import contextvars
from typing import Callable, Optional, Sequence

import torch

_WATCHERS: contextvars.ContextVar[tuple] = contextvars.ContextVar(
    "repro_torch_kernel_watchers", default=())

# a shape-only backward is counted as this many forwards (FlashAttention-2's
# convention for attention, five products for two; the recurrences' reverse
# scans as two)
BACKWARD_FACTOR = {"flash_attention": 2.5, "wkv6": 2.0, "ssd_scan": 2.0}


_DTENSOR = None  # torch.distributed.tensor.DTensor, imported at the first check


def is_dtensor(x) -> bool:
    global _DTENSOR
    if type(x) is torch.Tensor:  # the unsharded path: no import, no subclass check
        return False
    if _DTENSOR is None:
        from torch.distributed.tensor import DTensor

        _DTENSOR = DTensor
    return isinstance(x, _DTENSOR)


def is_shape_only(x) -> bool:
    """Whether ``x`` is a FakeTensor (a meta tensor is not: the dispatch
    refuses its device, as before)."""
    from torch._subclasses.fake_tensor import is_fake

    return isinstance(x, torch.Tensor) and is_fake(x)


def refuse_wrapped(name: str, *xs) -> None:
    """Raise if a tensor subclass (a DTensor, a FakeTensor, an async
    collective's pending result) reaches a ``*_cuda`` wrapper: only a plain
    tensor's pointer may reach ctypes."""
    for x in xs:
        if isinstance(x, torch.Tensor) and type(x) not in (torch.Tensor, torch.nn.Parameter):
            raise TypeError(f"{name}: a {type(x).__name__} reached the CUDA wrapper; sharded "
                            "and shape-only tensors go through the kernel's ops dispatch")


# ------------------------------------------------------------- accounting --
@contextlib.contextmanager
def watching(fn: Callable[[str, float, float, int], None]):
    """Call ``fn(name, flops, n_bytes, out_bytes)`` at each shape-only
    kernel call of the enclosed code, per device (local shapes): its
    operations and bytes moved, and what it writes (its outputs)."""
    tok = _WATCHERS.set(_WATCHERS.get() + (fn,))
    try:
        yield
    finally:
        _WATCHERS.reset(tok)


def _record(name: str, flops: float, n_bytes: float, outs: Sequence = ()) -> None:
    out_bytes = sum(o.numel() * o.element_size() for o in outs)
    for fn in _WATCHERS.get():
        fn(name, flops, n_bytes, out_bytes)


class ShapeOnly(torch.autograd.Function):
    """A kernel call on shape-only tensors: empty outputs shaped ``outs``
    (tensors to copy the shape and dtype of), its work recorded forward and,
    if autograd runs, backward (``BACKWARD_FACTOR`` times the forward's)."""

    @staticmethod
    def forward(ctx, name, flops, n_bytes, outs, *inputs):
        ctx.name, ctx.cost = name, (flops, n_bytes)
        ctx.shapes = [(x.shape, x.dtype) if isinstance(x, torch.Tensor) else None
                      for x in inputs]
        made = tuple(torch.empty_like(o) for o in outs)
        _record(name, flops, n_bytes, made)
        return made if len(made) > 1 else made[0]

    @staticmethod
    def backward(ctx, *grads):
        f = BACKWARD_FACTOR[ctx.name]
        ref = next(g for g in grads if g is not None)
        made = [None if s is None else ref.new_empty(s[0], dtype=s[1]) for s in ctx.shapes]
        _record(ctx.name + ".backward", f * ctx.cost[0], f * ctx.cost[1],
                [g for g in made if g is not None])
        return (None, None, None, None, *made)


def shape_only(name: str, flops: float, n_bytes: float, outs: Sequence[torch.Tensor],
               *inputs):
    return ShapeOnly.apply(name, flops, n_bytes, tuple(outs), *inputs)


# ---------------------------------------------------------------- sharding --
def head_split(x, head_dim: int, free_dims: Sequence[int], what: str):
    """For a DTensor ``x`` whose dimension ``head_dim`` holds heads: the
    placements the kernel takes it in, and the mesh dimension that splits
    the heads (or None). Batch-like dims in ``free_dims`` keep their
    shards; a head split is kept; a pending sum (Partial) and a split of any
    other dimension (the sequence a recurrence runs along) become Replicate
    on that mesh dimension, except the last dimension (the head size), whose
    split raises."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    want, heads_on = [], None
    for i, p in enumerate(x.placements):
        if isinstance(p, Shard) and p.dim in tuple(free_dims):
            want.append(p)
        elif isinstance(p, Shard) and p.dim == head_dim:
            if heads_on is not None:
                raise ValueError(f"{what}: heads split over two mesh dimensions "
                                 f"({x.placements}); the kernel takes one split")
            heads_on = i
            want.append(p)
        elif isinstance(p, Shard) and p.dim == x.dim() - 1:
            raise ValueError(f"{what}: the head size is split ({x.placements}); the kernel "
                             "computes whole heads")
        elif isinstance(p, (Shard, Partial, Replicate)):
            want.append(Replicate())
        else:
            raise ValueError(f"{what}: placement {p} on mesh dimension {i} is not one the "
                             "kernel takes")
    return tuple(want), heads_on


def group_placements(q_pl: tuple, heads_on: Optional[int], mesh, H: int, G: int,
                     head_dim: int):
    """Placements of k/v (G groups at ``head_dim``) for q's placements, and
    ``slicer(local_kv) -> local_kv`` that keeps the groups the local q heads
    read. Groups are split like q's heads where G divides by the mesh
    dimension's size; otherwise k/v stay whole on that dimension and each
    rank keeps its own groups."""
    from torch.distributed.tensor import Replicate, Shard

    if heads_on is None:
        return q_pl, None
    n = mesh.size(heads_on)
    if G % n == 0:
        return q_pl, None
    pl = list(q_pl)
    pl[heads_on] = Replicate()
    rank = mesh.get_local_rank(heads_on)
    H_l, rep = H // n, H // G
    lo = rank * H_l
    if H_l % rep == 0:
        g0, g1 = lo // rep, (lo + H_l) // rep
    elif rep % H_l == 0:
        g0 = lo // rep
        g1 = g0 + 1
    else:
        raise ValueError(f"{H} heads in {G} groups split {n} ways: a rank's heads do not "
                         "line up with whole groups")
    assert isinstance(q_pl[heads_on], Shard)
    return tuple(pl), lambda t: t.narrow(head_dim, g0, g1 - g0).contiguous()


class _Ready(torch.autograd.Function):
    """The identity on values. Forward, a local shard as a plain tensor: the
    result of an async collective waited for (NCCL writes it on its own
    stream, and view ops keep it pending, so a kernel reading its pointer
    would race the write). Backward, the gradient made contiguous: it leaves
    ``local_map`` as a DTensor's shard, which DTensor takes to be laid out as
    the whole, and a plain version's gradient of k or v need not be."""

    @staticmethod
    def forward(ctx, x):
        from torch.distributed._functional_collectives import AsyncCollectiveTensor

        if isinstance(x, AsyncCollectiveTensor):
            x = x.wait()
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return grad.contiguous()


def partial_on(pl: tuple, dims) -> tuple:
    """``pl`` with a pending sum (Partial) on each mesh dimension in ``dims``
    (an int, or several): the gradient placements of an input that every
    rank of such a dimension reads whole while each computes its own part
    of the output, so that each rank's gradient is a share. The heads' mesh
    dimension for k/v a rank narrows to its groups and for the SSD scan's B
    and C; the batch's mesh dimensions for a per-head parameter (the SSD
    scan's A, wkv6's u), read whole by every batch shard."""
    from torch.distributed.tensor import Partial

    dims = {dims} if isinstance(dims, int) else set(dims)
    return tuple(Partial() if i in dims else p for i, p in enumerate(pl))


def batch_dims(x_pl: tuple, heads_on: Optional[int]) -> list:
    """The mesh dimensions that split an input's batch (any split but the
    heads' in ``head_split``'s placements)."""
    from torch.distributed.tensor import Shard

    return [i for i, p in enumerate(x_pl) if isinstance(p, Shard) and i != heads_on]


def local_call(fn: Callable, args: Sequence, in_pl: Sequence, out_pl, mesh,
               grad_pl: Optional[Sequence] = None):
    """``fn`` on each rank's local shards of ``args`` (DTensors redistributed
    to ``in_pl``; None for a non-tensor argument), its result a DTensor of
    ``out_pl`` (one output's placements, or a tuple of them, one an
    output): ``torch.distributed.tensor.experimental.local_map``.
    ``grad_pl`` gives each input's gradient placements where they are not
    its ``in_pl`` (``partial_on``); None keeps ``in_pl``."""
    from torch.distributed.tensor import DTensor, Placement, Replicate
    from torch.distributed.tensor.experimental import local_map

    # a plain tensor (a zero state the model makes) is the same on every
    # rank: replicated, then cut to its placements like the DTensors
    args = [DTensor.from_local(a, mesh, [Replicate()] * mesh.ndim, run_check=False)
            if isinstance(a, torch.Tensor) and not is_dtensor(a) else a for a in args]

    # local_map reads a tuple as one entry an output, a list as one output
    if all(isinstance(p, Placement) for p in out_pl):
        out_pl = list(out_pl)
    else:
        out_pl = tuple(list(p) for p in out_pl)

    def run(*xs):
        return fn(*(_Ready.apply(x) if isinstance(x, torch.Tensor) else x for x in xs))

    return local_map(run, out_placements=out_pl, in_placements=tuple(in_pl),
                     in_grad_placements=None if grad_pl is None else tuple(grad_pl),
                     device_mesh=mesh, redistribute_inputs=True)(*args)
