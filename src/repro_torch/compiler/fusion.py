"""Hardware-aware node fusion (paper Sec. IV-A, Fig. 4(b1)).

Adapts the DNN graph to the PU dataflow capabilities while preserving
computational correctness:

  * A GEMM (Conv or Proj) followed by an element-wise Add fuses into
    FusedConvAdd / FusedProjAdd — the PU post-processing block supports
    residual shortcut additions in dataflow (the *other* producer feeding the
    Add remains unchanged and its output becomes the fused node's
    ``residual_input``). This covers both CNN shortcuts (Fig. 4(b1)) and the
    transformer residual stream (attention-out + x, FFN-down + h).
  * Activation functions (ReLU, and the vector-unit GELU/SiLU of transformer
    FFNs) integrate into the preceding compute node: the Compute
    instruction's vector-activation enable is set and the standalone node
    disappears.

The pass returns a new topologically-ordered Graph whose compute nodes map
1:1 onto PU GEMM executions.

Fusion is config-independent: it runs once per graph content inside
``repro_torch.compiler.analyze`` (memoized by ``Graph.fingerprint``) and the fused
graph is shared — read-only — by every (a, b) configuration a DSE sweep
evaluates.
"""
from __future__ import annotations

from .graph import Graph, Node, OpType

# GEMMs that can absorb a successor Add into their post-processing block.
_FUSABLE_GEMMS = {
    OpType.CONV: OpType.FUSED_CONV_ADD,
    OpType.PROJ: OpType.FUSED_PROJ_ADD,
}
# Standalone activation nodes foldable into a preceding compute node.
_ACT_OPS = (OpType.RELU, OpType.GELU)


def fuse(g: Graph) -> Graph:
    """Apply activation-integration and GEMM+Add(+act) fusion."""
    nodes = list(g.nodes)
    consumed: set[int] = set()  # node ids folded into a fused node
    # position of a tensor's production in the topological order
    pos_of = {tid: i for i, nd in enumerate(nodes) for tid in nd.outputs}
    for tid in g.input_tensors:
        pos_of.setdefault(tid, -1)

    def sole_consumer(tid: int) -> Node | None:
        cons = [nd for nd in nodes if tid in nd.inputs and nd.nid not in consumed]
        return cons[0] if len(cons) == 1 else None

    out = Graph(name=g.name + ".fused")
    out.tensors = dict(g.tensors)
    out._next_tid = g._next_tid
    out.input_tensors = list(g.input_tensors)
    out.output_tensors = list(g.output_tensors)
    out.attrs = dict(g.attrs)  # decode-phase metadata survives fusion

    # tensor rewiring: fused chains alias their intermediate tensors to the
    # final output tensor of the chain.
    alias: dict[int, int] = {}

    def resolve(tid: int) -> int:
        while tid in alias:
            tid = alias[tid]
        return tid

    for nd in nodes:
        if nd.nid in consumed:
            continue
        if nd.op in (OpType.CONV, OpType.FC, OpType.PROJ):
            op = nd.op
            relu = nd.relu
            residual = nd.residual_input
            attrs = dict(nd.attrs)
            out_tid = nd.outputs[0]

            # activation folding *before* the Add (proj -> act -> ... chains:
            # FFN gate/up activations precede the residual join).
            act_folded = False
            nxt = sole_consumer(out_tid)
            if nxt is not None and nxt.op in _ACT_OPS:
                relu = True
                act_folded = True
                attrs.setdefault("act", nxt.attrs.get("act", "relu"))
                consumed.add(nxt.nid)
                out_tid = nxt.outputs[0]

            # GEMM -> Add fusion (residual shortcut executed in dataflow).
            # Not after a folded activation: the post-processing block applies
            # act *after* the shortcut add, so fusing a GEMM->act->Add chain
            # would reorder them (act(x+r) instead of act(x)+r) — the Add
            # stays a standalone vector op there.
            if op in _FUSABLE_GEMMS and residual is None and not act_folded:
                nxt = sole_consumer(out_tid)
                if nxt is not None and nxt.op is OpType.ADD:
                    other = [t for t in nxt.inputs if t != out_tid]
                    # The fused node must be the *latest* producer feeding the
                    # Add: its residual input must already exist at this
                    # topological position ("the other Conv layer remains
                    # unchanged", Fig. 4(b1)).
                    if len(other) == 1 and pos_of.get(other[0], 1 << 30) < pos_of[nd.outputs[0]]:
                        residual = other[0]
                        consumed.add(nxt.nid)
                        out_tid = nxt.outputs[0]
                        op = _FUSABLE_GEMMS[op]

            # (Fused)GEMM -> activation integration after the Add.
            nxt = sole_consumer(out_tid)
            if nxt is not None and nxt.op in _ACT_OPS:
                relu = True
                attrs.setdefault("act", nxt.attrs.get("act", "relu"))
                consumed.add(nxt.nid)
                out_tid = nxt.outputs[0]

            if out_tid != nd.outputs[0]:
                alias[nd.outputs[0]] = out_tid
            out.add_node(
                name=nd.name if op is nd.op else nd.name + "+add",
                op=op,
                inputs=[resolve(t) for t in nd.inputs],
                # Add/act fusion rewrites the primary output only; any extra
                # outputs (multi-consumer forks) survive untouched.
                outputs=[out_tid, *nd.outputs[1:]],
                m=nd.m, n=nd.n, k=nd.k,
                kernel=nd.kernel, stride=nd.stride, padding=nd.padding,
                relu=relu,
                residual_input=resolve(residual) if residual is not None else None,
                scale_shift=nd.scale_shift,
                attrs=attrs,
            )
        elif nd.op in _ACT_OPS:
            # Standalone activation after a non-fusable producer (e.g. Add
            # that could not fuse): keep as vector op.
            out.add_node(
                name=nd.name, op=nd.op,
                inputs=[resolve(t) for t in nd.inputs],
                outputs=list(nd.outputs),
                m=nd.m, n=nd.n, k=nd.k,
                scale_shift=nd.scale_shift,
                attrs=dict(nd.attrs),
            )
        elif nd.op in (OpType.ADD, OpType.MUL):
            # Unfused Add/Mul (both producers already consumed etc.) — vector
            # op with a second operand through the residual stream.
            out.add_node(
                name=nd.name, op=nd.op,
                inputs=[resolve(t) for t in nd.inputs],
                outputs=list(nd.outputs),
                m=nd.m, n=nd.n, k=nd.k,
                scale_shift=nd.scale_shift,
                attrs=dict(nd.attrs),
            )
        else:  # pools, layernorm, softmax, attention GEMMs, ...
            out.add_node(
                name=nd.name, op=nd.op,
                inputs=[resolve(t) for t in nd.inputs],
                outputs=list(nd.outputs),
                m=nd.m, n=nd.n, k=nd.k,
                kernel=nd.kernel, stride=nd.stride, padding=nd.padding,
                scale_shift=nd.scale_shift,
                attrs=dict(nd.attrs),
            )

    # Fix up graph outputs that were aliased into fused nodes.
    out.output_tensors = [resolve(t) for t in out.output_tensors]
    out.validate_topological()
    return out
