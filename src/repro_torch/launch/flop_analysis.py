"""Per-device roofline counts of a step run on DTensors under a
``FakeTensorMode``, the twin of ``repro.launch.hlo_analysis``.

JAX reads its counts from the compiled per-shard HLO; the port counts the
ops each rank runs on its own shards while the step runs on shape-only
tensors. ``LocalCounter`` passes every DTensor op on to DTensor (its
``__torch_dispatch__`` answers ``NotImplemented`` for them, as
``CommDebugMode`` does), so it sees the local ops DTensor runs on each
shard. DTensor's own shape inference of an op (global shapes, run once a
new op and placement) is counted nowhere.

  * FLOPs: the local ops by ``FlopCounterMode``'s formulas
    (``torch.utils.flop_counter.flop_registry``; a ``FlopCounterMode``
    above DTensor would count the global shapes), plus what the port's
    kernels record in their shape-only branch (``kernels/_sharded.py``), by
    the formulas of their bounds. ``flops_by_op`` splits them by aten op and
    kernel name (``top_flop_ops`` by op and output shape), ``flops_by_phase``
    into forward, backward and the remat recompute
    (``torch.utils.checkpoint``'s, which runs inside backward).
  * HBM bytes, producer-side as ``hlo_analysis.analyze`` counts them: every
    local op's output that is a new storage once (not a view, not an
    ``empty``, which writes nothing), an in-place op what it writes (an
    indexed write its update, as JAX counts a dynamic-update-slice), a
    collective its output, a shape-only kernel its outputs
    (``op_output_bytes``); the caller adds the step's arguments once
    (``local_bytes``), as the reference's docstring asks. Eager PyTorch runs
    unfused, so this is at or above what XLA's fused HLO counts for the same
    function (a chain of elementwise ops writes each output), as CPU HLO is
    above TPU HLO. ``writes`` records, by storage, what in-place ops wrote:
    ``output_bytes`` counts an output that is an argument written in place
    (a decode step's cache) by those bytes.
  * Temp bytes: the peak, over the step, of the live bytes of the new
    storages the step made (a storage's bytes from the op that makes it to
    the death of the last tensor on it; autograd's saved tensors keep
    theirs). The counterpart of XLA's ``temp_size_in_bytes`` (here with the
    outputs in it), and a lower bound on the caching allocator's peak: no
    rounding, no workspaces, no fragmentation. ``top_live_ops`` lists what
    is live at that peak (read when the live bytes first reach within
    ``PEAK_STEP`` of it), by the op and shape that made each storage. A
    collective's ``_wrap_tensor_autograd`` counts nothing: on a card it
    wraps the collective's output (an ``AsyncCollectiveTensor``), where its
    shape-only kernel makes a new storage; that output lives as long as the
    wrapper.
  * Collective wire bytes: every collective DTensor issues (those
    ``CommDebugMode`` counts), sized from its output tensor, with the ring
    factors of ``hlo_analysis.py``: all-gather and reduce-scatter (n-1)/n,
    all-reduce 2(n-1)/n, all-to-all (n-1)/n. A Shard-to-Shard move is one
    all-to-all of its local input, as DTensor plans it: on a CPU mesh
    ``shard_dim_alltoall`` falls back to an all-gather and a chunk, which
    are counted as that all-to-all and nothing else. A group whose ranks
    all lie on one NVLink board of ``hw.BOARD_CARDS`` cards is on the
    NVLink tier, any other on the network tier.

All quantities are per device (rank 0).
"""
from __future__ import annotations

import contextlib
import sys
import weakref
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Any

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from .. import hw
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

# ops whose output is a new storage that holds nothing yet
_EMPTY = {"empty", "empty_like", "empty_strided", "empty_permuted", "new_empty",
          "new_empty_strided"}

TOP_MIN_BYTES = 1 << 28  # top_hbm_ops keeps ops above 256 MiB, as hlo_analysis does
TOP_N = 8
PEAK_STEP = 0.01  # top_live_ops is read again when the peak grows by this share


@dataclass
class RooflineCounts:
    """Per-device counts of one step."""
    flops: float = 0.0  # dot_flops + kernel_flops
    dot_flops: float = 0.0  # ops with a FlopCounterMode formula (matmuls, convolutions)
    kernel_flops: float = 0.0  # the port's kernels, forward and backward
    flops_by_op: dict = field(default_factory=lambda: defaultdict(float))  # sums to flops
    flops_by_phase: dict = field(default_factory=lambda: defaultdict(float))
    op_output_bytes: float = 0.0  # producer-side HBM bytes, the arguments not in it
    temp_bytes: int = 0  # peak live bytes of the storages the step made
    collective_wire_bytes: float = 0.0
    collective_wire_bytes_nvlink: float = 0.0  # groups inside one board
    collective_wire_bytes_network: float = 0.0  # groups across boards
    collective_bytes_by_type: dict = field(default_factory=lambda: defaultdict(float))
    collective_ops: int = 0
    comm_debug_ops: int = 0  # CommDebugMode's count of the same run
    kernels: dict = field(default_factory=dict)  # name -> {"calls", "flops", "bytes"}
    writes: dict = field(default_factory=lambda: defaultdict(float))  # storage -> bytes written
    top_hbm_ops: list = field(default_factory=list)  # [{"op", "calls", "bytes"}]
    top_live_ops: list = field(default_factory=list)  # at the peak: [{"op", "calls", "bytes"}]
    top_flop_ops: list = field(default_factory=list)  # [{"op", "calls", "flops"}]
    top_collectives: list = field(default_factory=list)  # [{"op", "calls", "wire_bytes"}]


_SHAPE_INFERENCE, _ALLTOALL_FALLBACK, _RECOMPUTE = 1, 2, 4


def _context(in_backward: bool) -> int:
    """Where the op runs, from the Python frames above it: inside DTensor's
    inference of an op's global output shape (not part of any rank's work),
    inside ``shard_dim_alltoall``'s CPU fallback, inside a remat recompute."""
    got = 0
    f = sys._getframe(2)
    while f is not None:
        name = f.f_code.co_name
        if name.startswith("_propagate_tensor_meta"):
            return _SHAPE_INFERENCE
        if name == "shard_dim_alltoall":
            got |= _ALLTOALL_FALLBACK
        elif (in_backward and name == "recompute_fn"
              and f.f_code.co_filename.endswith("checkpoint.py")):
            got |= _RECOMPUTE
        f = f.f_back
    return got


def _phase(ctx: int, in_backward: bool) -> str:
    return "recompute" if ctx & _RECOMPUTE else "backward" if in_backward else "forward"


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


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for y in x:
            yield from _tensors(y)


def _nbytes(x) -> int:
    return sum(t.numel() * t.element_size() for t in _tensors(x))


def _descr(name: str, x) -> str:
    t = next(_tensors(x), None)
    return name if t is None else f"{name} {str(t.dtype).removeprefix('torch.')}{list(t.shape)}"


def _tally(table: dict, key: str, n: float) -> None:
    row = table[key]
    row[0] += 1
    row[1] += n


def _keep(*_) -> None:
    """A finalizer that does nothing: it holds its arguments alive."""


def _top(table: dict, key: str, least: float = 0.0) -> list:
    rows = [{"op": op, "calls": calls, key: b} for op, (calls, b) in table.items() if b > least]
    return sorted(rows, key=lambda r: -r[key])[:TOP_N]


class LocalCounter(TorchDispatchMode):
    """Counts FLOPs, HBM bytes, live bytes and collectives of the local ops
    under DTensor."""

    def __init__(self, counts: RooflineCounts):
        super().__init__()
        self.counts = counts
        self.groups: dict = {}  # group name -> (size, on one board)
        self.hbm: dict = defaultdict(lambda: [0, 0.0])  # descr -> [calls, bytes]
        self.flop: dict = defaultdict(lambda: [0, 0.0])  # descr -> [calls, flops]
        self.wire: dict = defaultdict(lambda: [0, 0.0])  # descr -> [calls, wire bytes]
        self.live: dict = {}  # storage -> (its finalizer, the op and shape that made it, bytes)
        self.live_bytes = 0
        self.peak_read = 0  # live bytes when top_live_ops was last read
        self.fallback = None  # the storage standing for an all-to-all's output

    # ------------------------------------------------------------ live bytes --
    def _made(self, storage, n: int, descr: str) -> None:
        """A new storage of ``n`` bytes, live until its last tensor dies."""
        key = storage._cdata
        if key in self.live:
            return
        self.live[key] = (weakref.finalize(storage, self._died, key, n), descr, n)
        self.live_bytes += n
        self.counts.temp_bytes = max(self.counts.temp_bytes, self.live_bytes)
        if (self.live_bytes >= TOP_MIN_BYTES
                and self.live_bytes > (1 + PEAK_STEP) * self.peak_read):
            self.peak_read = self.live_bytes
            table = defaultdict(lambda: [0, 0.0])
            for _, d, b in self.live.values():
                _tally(table, d, b)
            self.counts.top_live_ops = _top(table, "bytes")

    def _died(self, key, n: int) -> None:
        self.live.pop(key, None)
        self.live_bytes -= n

    def _forget(self, key) -> None:
        """Stop counting a storage that is still alive."""
        entry = self.live.pop(key, None)
        if entry is not None and entry[0].detach() is not None:
            self.live_bytes -= entry[2]

    def close(self) -> None:
        for fin, _, _ in list(self.live.values()):
            fin.detach()
        self.live.clear()

    def _new_storages(self, args, kwargs, out) -> list:
        """(storage, tensors on it) of each output that is none of the
        inputs' storages: what the op allocated."""
        held = {t.untyped_storage()._cdata for t in _tensors((args, tuple(kwargs.values())))}
        got = {}
        for t in _tensors(out):
            st = t.untyped_storage()
            if st._cdata not in held:
                got.setdefault(st._cdata, (st, []))[1].append(t)
        return list(got.values())

    # --------------------------------------------------------------- counting --
    def _group(self, args) -> tuple[int, bool]:
        """(size, whether all its ranks lie on one NVLink board) of the
        collective's process group."""
        import torch.distributed as dist
        from torch.distributed.distributed_c10d import _resolve_process_group

        name = next(a for a in reversed(args) if isinstance(a, str))
        if name not in self.groups:
            pg = _resolve_process_group(name)
            boards = {r // hw.BOARD_CARDS for r in dist.get_process_group_ranks(pg)}
            self.groups[name] = (pg.size(), len(boards) == 1)
        return self.groups[name]

    def _collective(self, kind: str, args, out, fallback: bool) -> None:
        c = self.counts
        n, on_board = self._group(args)
        data = _nbytes(out)
        shown = out
        if fallback:  # shard_dim_alltoall's all-gather: one all-to-all of its input
            kind, data, shown = "all-to-all", _nbytes(args[0]), args[0]
        wire = _WIRE_FACTOR[kind](max(n, 2)) * data
        c.collective_wire_bytes += wire
        if on_board:
            c.collective_wire_bytes_nvlink += wire
        else:
            c.collective_wire_bytes_network += wire
        c.collective_bytes_by_type[kind] += data
        c.collective_ops += 1
        c.op_output_bytes += data  # a collective's output, as JAX counts it
        _tally(self.wire, f"{_descr(kind, shown)} n={n} {'nvlink' if on_board else 'network'}",
               wire)
        for st, _ in self._new_storages(args, {}, out):
            if fallback:
                self.fallback = (st._cdata, data)
            self._made(st, data if fallback else st.nbytes(), _descr(kind, shown))

    def kernel(self, name: str, flops: float, n_bytes: float, out_bytes: int) -> None:
        """A shape-only kernel call (``_sharded.watching``)."""
        row = self.counts.kernels.setdefault(name, {"calls": 0, "flops": 0.0, "bytes": 0.0})
        row["calls"] += 1
        row["flops"] += flops
        row["bytes"] += n_bytes
        in_backward = torch._C._current_graph_task_id() != -1
        self.counts.flops_by_phase[_phase(_context(in_backward), in_backward)] += flops
        self.counts.op_output_bytes += out_bytes
        _tally(self.hbm, name, out_bytes)
        _tally(self.flop, name, flops)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        from torch.utils.flop_counter import flop_registry

        if any(t is DTensor for t in types):
            return NotImplemented  # DTensor runs it; its local ops come back here
        kwargs = kwargs or {}
        packet = func._overloadpacket
        if func.namespace == "aten" and packet not in flop_registry:
            # a composite op reaches the mode whole under inference_mode: its
            # parts come back here, as FlopCounterMode does it
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        out = func(*args, **kwargs)
        in_backward = torch._C._current_graph_task_id() != -1
        ctx = _context(in_backward)
        if ctx & _SHAPE_INFERENCE:
            return out
        c = self.counts
        name = packet.__name__
        if func.namespace == "_c10d_functional" and name == "_wrap_tensor_autograd":
            # an alias of the collective's output on a card: keep that alive
            # as long as this storage, and count nothing
            weakref.finalize(out.untyped_storage(), _keep, args[0]).atexit = False
            return out
        kind = COLLECTIVES.get(name) if func.namespace == "_c10d_functional" else None
        if kind is not None:
            self._collective(kind, args, out, bool(ctx & _ALLTOALL_FALLBACK))
            return out
        if ctx & _ALLTOALL_FALLBACK:
            # the fallback's gather, chunk and copy are host work, not the
            # all-to-all's: its output's bytes move to what the copy made
            if self.fallback is not None:
                for st, _ in self._new_storages(args, kwargs, out):
                    key, n = self.fallback
                    self._forget(key)
                    self.fallback = (st._cdata, n)
                    self._made(st, n, _descr("all-to-all", out))
            return out
        if packet in flop_registry:
            f = float(flop_registry[packet](*args, **kwargs, out_val=out))
            c.dot_flops += f
            c.flops_by_op[name] += f
            c.flops_by_phase[_phase(ctx, in_backward)] += f
            _tally(self.flop, _descr(name, out), f)
        if func._schema.is_mutable:
            for x, n in _written(func, args, kwargs):
                c.writes[storage_key(x)] += n
                c.op_output_bytes += n
                _tally(self.hbm, _descr(name, x), n)
        for st, ts in self._new_storages(args, kwargs, out):
            self._made(st, st.nbytes(), _descr(name, ts[0]))
            if name in _EMPTY:
                continue
            n = sum(t.numel() * t.element_size() for t in ts)
            c.op_output_bytes += n
            _tally(self.hbm, _descr(name, ts[0]), n)
        return out


@contextlib.contextmanager
def analyze():
    """Count the enclosed step: yields a ``RooflineCounts`` filled on exit
    (the step's argument bytes are the caller's: ``local_bytes``)."""
    from torch.distributed.tensor.debug import CommDebugMode

    counts = RooflineCounts()
    counter = LocalCounter(counts)
    try:
        with _sharded.watching(counter.kernel), CommDebugMode() as comm, counter:
            yield counts
    finally:
        counter.close()
    kern = counts.kernels
    counts.kernel_flops = sum(v["flops"] for v in kern.values())
    counts.flops = counts.dot_flops + counts.kernel_flops
    counts.flops_by_op = dict(counts.flops_by_op)
    counts.flops_by_op.update({k: v["flops"] for k, v in kern.items()})
    counts.flops_by_phase = dict(counts.flops_by_phase)
    counts.comm_debug_ops = comm.get_total_counts()
    counts.collective_bytes_by_type = dict(counts.collective_bytes_by_type)
    counts.writes = dict(counts.writes)
    counts.top_hbm_ops = _top(counter.hbm, "bytes", TOP_MIN_BYTES)
    counts.top_flop_ops = _top(counter.flop, "flops")
    counts.top_collectives = _top(counter.wire, "wire_bytes")


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
    most its local size. The counterpart of XLA's ``output_size_in_bytes``."""
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
