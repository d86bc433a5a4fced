"""DNN graph IR for the compilation framework (paper Sec. IV, Fig. 4).

The framework consumes quantized (INT8, power-of-two scales) DNN models. We
use an ONNX-like node/tensor representation built directly in Python (the
container has no onnx package; the IR mirrors the fields the paper's parser
extracts: weights/bias dims, quantization scales, dependency structure,
tensor identifiers).

Operators cover the GEMM-based PU capabilities: Conv (lowered to GEMM via
IM2COL), FC/GEMM, elementwise Add (residual), ReLU, pooling (executed in the
PU vector units), plus structural ops handled at graph level.
"""
from __future__ import annotations

import enum
import hashlib
import math
from dataclasses import dataclass, field
from typing import Optional


class OpType(enum.Enum):
    CONV = "Conv"
    FC = "Gemm"
    ADD = "Add"
    RELU = "Relu"
    MAXPOOL = "MaxPool"
    AVGPOOL = "GlobalAveragePool"
    FUSED_CONV_ADD = "FusedConvAdd"  # Conv + residual Add (+ ReLU) in dataflow
    INPUT = "Input"
    OUTPUT = "Output"
    # -- transformer frontend (GEMM-shaped primitives of the encoder block) --
    PROJ = "Proj"  # weighted projection GEMM: Q/K/V/output, FFN up/gate/down
    FUSED_PROJ_ADD = "FusedProjAdd"  # Proj + residual Add (+ act) in dataflow
    ATTN_SCORE = "AttnScore"  # Q @ K^T per head: activation x activation GEMM
    ATTN_CONTEXT = "AttnContext"  # softmax(S) @ V per head: act x act GEMM
    SOFTMAX = "Softmax"  # vector-unit row softmax over attention scores
    LAYERNORM = "LayerNorm"  # vector-unit normalization (LN / RMSNorm)
    GELU = "Gelu"  # vector-unit activation (folded into PROJ by fusion)
    MUL = "Mul"  # elementwise gate multiply (SwiGLU), vector unit
    CONCAT = "Concat"  # row-wise gather of per-slot tensors, vector unit


# GEMM-shaped ops that carry weights streamed/preloaded into URAM.
WEIGHTED_OPS = frozenset(
    {OpType.CONV, OpType.FC, OpType.PROJ, OpType.FUSED_CONV_ADD, OpType.FUSED_PROJ_ADD}
)
# GEMMs whose second operand is an *activation* streamed through the weight
# port of the systolic array (no resident weights).
ATTN_GEMM_OPS = frozenset({OpType.ATTN_SCORE, OpType.ATTN_CONTEXT})


@dataclass(frozen=True)
class TensorInfo:
    """A tensor edge in the DAG (activation tensor, NCHW).

    ``kv_base_rows >= 0`` marks an *append-only K/V cache region* for
    autoregressive decode: ``shape[0]`` is the maximum row count (prefill
    prefix + decode window), the prefill phase populated the first
    ``kv_base_rows`` rows, and each program round appends exactly one row
    while reads cover the full valid prefix (which therefore *grows* one row
    per round — the AddrLen/CYCLE_LEN semantics)."""

    tid: int
    name: str
    shape: tuple[int, ...]  # (C, H, W) activation or (N,) flat
    dtype_bytes: int = 1  # INT8
    kv_base_rows: int = -1  # >= 0: append-only K/V cache (see above)

    @property
    def nbytes(self) -> int:
        return int(math.prod(self.shape)) * self.dtype_bytes

    @property
    def nbytes_padded(self) -> int:
        return (self.nbytes + 63) // 64 * 64  # 64B AXI-beat alignment

    # -- K/V cache geometry (decode-phase scheduling) ------------------------
    @property
    def is_kv_cache(self) -> bool:
        return self.kv_base_rows >= 0

    @property
    def kv_steps(self) -> int:
        """Decode rounds covered by the region (appended rows)."""
        return self.shape[0] - self.kv_base_rows

    @property
    def kv_row_stride(self) -> int:
        """Beat-aligned bytes of one appended row (one token's K or V)."""
        row = int(math.prod(self.shape[1:])) * self.dtype_bytes
        return (row + 63) // 64 * 64

    @property
    def kv_avg_rows(self) -> float:
        """Mean valid length over the decode window: round r reads
        base + r + 1 rows, so the average is base + (steps + 1) / 2."""
        return self.kv_base_rows + (self.kv_steps + 1) / 2

    @property
    def kv_region_bytes(self) -> int:
        """Full single-region allocation (max rows, row-stride padded)."""
        return self.shape[0] * self.kv_row_stride

    # -- per-round traffic views (used by the analytic model) ----------------
    @property
    def stream_bytes(self) -> int:
        """Per-round bytes when streamed through the SA weight port: the
        average valid prefix for caches, the whole tensor otherwise."""
        if self.is_kv_cache:
            return int(self.kv_avg_rows * self.kv_row_stride)
        return self.nbytes_padded

    @property
    def write_bytes(self) -> int:
        """Per-round bytes stored by the producer: one appended row for
        caches, the whole tensor otherwise."""
        return self.kv_row_stride if self.is_kv_cache else self.nbytes_padded


@dataclass
class Node:
    """One DAG node. After fusion, a node maps to exactly one PU GEMM (or a
    vector-unit op) — 'the nodes are partitioned into computational tiles
    matching the first SA dimension of each mapped PU'."""

    nid: int
    name: str
    op: OpType
    inputs: list[int]  # tensor ids
    outputs: list[int]
    # GEMM view (for CONV/FC/FUSED_*): out = W[KxM]^T @ im2col(x)[KxN]
    m: int = 0  # output channels
    n: int = 0  # spatial positions (H_out * W_out) or batch rows
    k: int = 0  # in_ch * kh * kw
    # conv params
    kernel: tuple[int, int] = (1, 1)
    stride: tuple[int, int] = (1, 1)
    padding: tuple[int, int] = (0, 0)
    relu: bool = False
    residual_input: Optional[int] = None  # tensor id of fused shortcut
    scale_shift: int = 0  # po2 requant shift
    attrs: dict = field(default_factory=dict)

    @property
    def macs(self) -> int:
        if self.op in WEIGHTED_OPS or self.op in ATTN_GEMM_OPS:
            return self.m * self.n * self.k
        return 0

    @property
    def weight_bytes(self) -> int:
        """INT8 weights + INT32 bias footprint in URAM."""
        if self.op in WEIGHTED_OPS:
            return self.m * self.k + 4 * self.m
        return 0

    @property
    def is_compute(self) -> bool:
        return (self.op in WEIGHTED_OPS or self.op in ATTN_GEMM_OPS
                or self.op in (OpType.MAXPOOL, OpType.AVGPOOL, OpType.SOFTMAX,
                               OpType.LAYERNORM, OpType.MUL, OpType.CONCAT))


@dataclass
class Graph:
    """Node DAG + tensor table. Nodes are stored in topological order."""

    name: str
    nodes: list[Node] = field(default_factory=list)
    tensors: dict[int, TensorInfo] = field(default_factory=dict)
    input_tensors: list[int] = field(default_factory=list)
    output_tensors: list[int] = field(default_factory=list)
    # graph-level metadata (e.g. decode phase: {"phase": "decode",
    # "prefill_len": S, "decode_steps": T} — one program round = one token)
    attrs: dict = field(default_factory=dict)
    _next_tid: int = 0
    _next_nid: int = 0

    # -- construction --------------------------------------------------------
    def add_tensor(self, name: str, shape: tuple[int, ...], dtype_bytes: int = 1,
                   kv_base_rows: int = -1) -> TensorInfo:
        t = TensorInfo(self._next_tid, name, tuple(shape), dtype_bytes,
                       kv_base_rows=kv_base_rows)
        self.tensors[t.tid] = t
        self._next_tid += 1
        return t

    def add_node(self, **kw) -> Node:
        node = Node(nid=self._next_nid, **kw)
        self._next_nid += 1
        self.nodes.append(node)
        return node

    # -- queries --------------------------------------------------------------
    @property
    def decode_steps(self) -> Optional[int]:
        """Decode-window length of a decode-phase graph (``None`` for
        prefill/CNN graphs). One program round advances one decode step."""
        steps = self.attrs.get("decode_steps")
        return int(steps) if steps else None

    def fingerprint(self) -> str:
        """Stable content hash over nodes, tensors, IO lists and attrs.

        The memoization key of the config-independent compile analysis
        (:func:`repro_torch.compiler.analyze`): two Graph objects with identical
        content share one fused/profiled/weight-scheduled artifact, so a DSE
        sweep — or several tenants of ``explore_multi`` referencing the same
        model — pays for fusion and profiling exactly once. The full content
        is hashed on every call (~1 ms even for deep graphs, trivial next to
        one compile), so in-place mutations of node fields, tensors or attrs
        are always observed and can never serve a stale cached analysis.
        """
        h = hashlib.sha256()
        h.update(repr((self.name, sorted(self.attrs.items()),
                       self.input_tensors, self.output_tensors)).encode())
        for t in sorted(self.tensors.values(), key=lambda t: t.tid):
            h.update(repr((t.tid, t.name, t.shape, t.dtype_bytes,
                           t.kv_base_rows)).encode())
        for nd in self.nodes:
            h.update(repr((nd.nid, nd.name, nd.op.value, nd.inputs, nd.outputs,
                           nd.m, nd.n, nd.k, nd.kernel, nd.stride, nd.padding,
                           nd.relu, nd.residual_input, nd.scale_shift,
                           sorted(nd.attrs.items()))).encode())
        return h.hexdigest()

    def producer_of(self, tid: int) -> Optional[Node]:
        for nd in self.nodes:
            if tid in nd.outputs:
                return nd
        return None

    def consumers_of(self, tid: int) -> list[Node]:
        out = [nd for nd in self.nodes if tid in nd.inputs]
        out += [nd for nd in self.nodes if nd.residual_input == tid]
        return out

    def node_by_id(self, nid: int) -> Node:
        for nd in self.nodes:
            if nd.nid == nid:
                return nd
        raise KeyError(nid)

    def compute_nodes(self) -> list[Node]:
        return [nd for nd in self.nodes if nd.is_compute]

    def total_macs(self) -> int:
        return sum(nd.macs for nd in self.nodes)

    def total_weight_bytes(self) -> int:
        return sum(nd.weight_bytes for nd in self.nodes)

    def validate_topological(self) -> None:
        """Nodes must be topologically ordered over tensor dependencies."""
        produced: set[int] = set(self.input_tensors)
        for nd in self.nodes:
            needs = list(nd.inputs) + ([nd.residual_input] if nd.residual_input is not None else [])
            for tid in needs:
                if tid not in produced:
                    raise ValueError(
                        f"node {nd.name} consumes tensor {tid} before production"
                    )
            produced.update(nd.outputs)

    def summary(self) -> str:
        gmacs = self.total_macs() / 1e9
        wmb = self.total_weight_bytes() / 1e6
        return (
            f"Graph {self.name}: {len(self.nodes)} nodes, "
            f"{gmacs:.2f} GMACs ({2*gmacs:.2f} GOPs), {wmb:.1f} MB weights"
        )
