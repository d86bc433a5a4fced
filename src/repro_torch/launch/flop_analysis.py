"""Per-device roofline counts of a step run on DTensors under a
``FakeTensorMode``, the twin of ``repro.launch.hlo_analysis``.

JAX reads its counts from the compiled per-shard HLO; the port counts the
ops each rank runs on its own shards while the step runs on shape-only
tensors:

  * FLOPs: ``LocalCounter`` passes every DTensor op on to DTensor (its
    ``__torch_dispatch__`` answers ``NotImplemented`` for them, as
    ``CommDebugMode`` does), so it sees the local ops DTensor runs on each
    shard and counts them with ``FlopCounterMode``'s formulas
    (``torch.utils.flop_counter.flop_registry``). A ``FlopCounterMode``
    above DTensor would count the global shapes. DTensor's own shape
    inference of an op (global shapes, run once a new op and placement) is
    not counted. The port's kernels add what their shape-only branch
    records (``kernels/_sharded.py``), by the formulas of their bounds.
  * HBM bytes: the step's arguments and outputs, each local shard read or
    written once (``local_bytes``): a lower bound, where JAX counts every
    fused op's output. An output that is an argument written in place (a
    decode step's cache) counts the bytes the step wrote into it
    (``output_bytes``), as JAX counts a donated buffer's
    dynamic-update-slice by its update: ``LocalCounter`` records, by
    storage, the bytes each local in-place op (``copy_``, ``index_put_``,
    ...) writes.
  * Collective wire bytes: every collective DTensor issues (those
    ``CommDebugMode`` counts), sized from its output tensor, with the
    ring factors of ``hlo_analysis.py``: all-gather and reduce-scatter
    (n-1)/n, all-reduce 2(n-1)/n, all-to-all (n-1)/n.

All quantities are per device.
"""
from __future__ import annotations

import contextlib
import sys
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Any

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from ..kernels import _sharded
from ..tree import tree_leaves

# native functional collectives -> the HLO opcode names of hlo_analysis.py
COLLECTIVES = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_to_all_single": "all-to-all",
    "broadcast": "broadcast",
}

_WIRE_FACTOR = {
    "all-gather": lambda n: (n - 1) / n,
    "reduce-scatter": lambda n: (n - 1) / n,
    "all-reduce": lambda n: 2 * (n - 1) / n,
    "all-to-all": lambda n: (n - 1) / n,
    "broadcast": lambda n: 1.0,
}


@dataclass
class RooflineCounts:
    """Per-device counts of one step."""
    flops: float = 0.0  # dot_flops + kernel_flops
    dot_flops: float = 0.0  # ops with a FlopCounterMode formula (matmuls, convolutions)
    kernel_flops: float = 0.0  # the port's kernels, forward and backward
    collective_wire_bytes: float = 0.0
    collective_bytes_by_type: dict = field(default_factory=lambda: defaultdict(float))
    collective_ops: int = 0
    comm_debug_ops: int = 0  # CommDebugMode's count of the same run
    kernels: dict = field(default_factory=dict)  # name -> {"calls", "flops", "bytes"}
    writes: dict = field(default_factory=lambda: defaultdict(float))  # storage -> bytes written


def _in_shape_inference() -> bool:
    """Whether the op runs inside DTensor's inference of an op's global
    output shape (not part of any rank's work)."""
    f = sys._getframe(2)
    while f is not None:
        if f.f_code.co_name.startswith("_propagate_tensor_meta"):
            return True
        f = f.f_back
    return False


def _group_size(args) -> int:
    from torch.distributed.distributed_c10d import _resolve_process_group

    name = next(a for a in reversed(args) if isinstance(a, str))
    return _resolve_process_group(name).size()


# in-place ops whose written elements are an update operand's (argument
# index), not the whole destination
_UPDATES = {"index_put_": 2, "index_copy_": 3, "index_add_": 3, "scatter_": 3,
            "scatter_add_": 3, "scatter_reduce_": 3, "masked_scatter_": 2}


def storage_key(x):
    """What two tensors that share memory have in common (a view and its
    base; a DTensor and its local shard)."""
    from torch.multiprocessing.reductions import StorageWeakRef

    if _sharded.is_dtensor(x):
        x = x.to_local()
    return StorageWeakRef(x.untyped_storage())


def _written(func, args, kwargs):
    """(destination, bytes) of each tensor a mutating op writes: an
    indexed write its update's elements, any other write its whole
    destination view."""
    out = []
    schema = func._schema
    for i, a in enumerate(schema.arguments):
        if a.alias_info is None or not a.alias_info.is_write:
            continue
        x = args[i] if i < len(args) else kwargs.get(a.name)
        if not isinstance(x, torch.Tensor):
            continue
        n = x.numel()
        u = _UPDATES.get(func._overloadpacket.__name__)
        if u is not None and u < len(args) and isinstance(args[u], torch.Tensor):
            n = min(n, args[u].numel())
        out.append((x, n * x.element_size()))
    return out


def _nbytes(x) -> int:
    return sum(t.numel() * t.element_size() for t in
               (x if isinstance(x, (list, tuple)) else [x]) if isinstance(t, torch.Tensor))


class LocalCounter(TorchDispatchMode):
    """Counts FLOPs and collectives of the local ops under DTensor."""

    def __init__(self, counts: RooflineCounts):
        super().__init__()
        self.counts = counts

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        from torch.utils.flop_counter import flop_registry

        if any(t is DTensor for t in types):
            return NotImplemented  # DTensor runs it; its local ops come back here
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        packet = func._overloadpacket
        if packet in flop_registry and not _in_shape_inference():
            f = float(flop_registry[packet](*args, **kwargs, out_val=out))
            self.counts.dot_flops += f
        if func._schema.is_mutable and not _in_shape_inference():
            for x, n in _written(func, args, kwargs):
                self.counts.writes[storage_key(x)] += n
        kind = COLLECTIVES.get(packet.__name__) if func.namespace == "_c10d_functional" else None
        if kind is not None:
            n = _group_size(args)
            data = _nbytes(out)
            wire = _WIRE_FACTOR[kind](max(n, 2)) * data
            self.counts.collective_wire_bytes += wire
            self.counts.collective_bytes_by_type[kind] += data
            self.counts.collective_ops += 1
        return out


@contextlib.contextmanager
def analyze():
    """Count the enclosed step: yields a ``RooflineCounts`` filled on exit
    (the HBM bytes are the caller's: ``local_bytes`` of the step's
    arguments and outputs)."""
    from torch.distributed.tensor.debug import CommDebugMode

    counts = RooflineCounts()
    with _sharded.counting() as kern, CommDebugMode() as comm, LocalCounter(counts):
        yield counts
    counts.kernels = {k: dict(v) for k, v in kern.items()}
    counts.kernel_flops = sum(v["flops"] for v in kern.values())
    counts.flops = counts.dot_flops + counts.kernel_flops
    counts.comm_debug_ops = comm.get_total_counts()
    counts.collective_bytes_by_type = dict(counts.collective_bytes_by_type)
    counts.writes = dict(counts.writes)


def local_bytes(tree: Any) -> int:
    """Bytes of the local shards of a tree's tensors (a DTensor's own shard,
    a plain tensor whole)."""
    total = 0
    for x in tree_leaves(tree):
        if not isinstance(x, torch.Tensor):
            continue
        if _sharded.is_dtensor(x):
            x = x.to_local()
        total += x.numel() * x.element_size()
    return total


def output_bytes(out: Any, args: Any, writes: dict) -> int:
    """Bytes a step writes into its outputs: a new tensor's local shard
    whole; an output that shares its storage with an argument (the same
    tensor, a view, written in place) the bytes the step wrote into that
    storage (``writes``, from ``analyze``), at most once a storage and at
    most its local size."""
    held = {storage_key(x) for x in tree_leaves(args) if isinstance(x, torch.Tensor)}
    total, seen = 0, set()
    for x in tree_leaves(out):
        if not isinstance(x, torch.Tensor):
            continue
        size = local_bytes(x)
        key = storage_key(x)
        if key not in held:
            total += size
        elif key not in seen:
            seen.add(key)
            total += min(int(writes.get(key, 0)), size)
    return total
