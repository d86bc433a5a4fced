"""DNN graph builders for the compilation framework.

ResNet-50 (the paper's benchmark, input 256x256 per Table III footnote),
small synthetic CNNs for tests, and transformer encoders (ViT for the vision
analogue of ResNet-50, LLM block stacks parameterized from ``repro_torch.configs``).
Graphs are built *unfused* (separate Conv / Add / activation nodes, BN folded
into conv weights as usual for INT8 deployment); ``repro_torch.compiler.fusion``
then applies the hardware-aware fusion of Fig. 4(b) extended with the
proj->activation and GEMM->residual-add rules.

Transformer lowering notes: token tensors are (S, D) INT8 activations;
attention scores are (H, S, S). Q/K/V/output projections and FFN matrices are
PROJ GEMMs (weights through URAM, SMOF-streamed when oversized); the score
and context GEMMs are ATTN_* ops whose second operand is an *activation*
streamed through the SA weight port; layernorm / softmax / gating run in the
PU vector units like ReLU and the pools. Embedding lookup, position adds and
the cls token are host-side (free) and omitted.

Autoregressive decode (``transformer_decoder``): one program round processes
one new token; per-block K/V caches are append-only HBM regions
(``TensorInfo.kv_base_rows``) whose attention streams advance in *length*
every round (AddrLen/CYCLE_LEN) — the serving-phase counterpart of the
prefill graphs above.
"""
from __future__ import annotations

from .graph import Graph, OpType, TensorInfo


def _conv(g: Graph, x: TensorInfo, out_ch: int, k: int, stride: int, pad: int,
          name: str) -> TensorInfo:
    c, h, w = x.shape
    oh = (h + 2 * pad - k) // stride + 1
    ow = (w + 2 * pad - k) // stride + 1
    out = g.add_tensor(f"{name}.out", (out_ch, oh, ow))
    g.add_node(
        name=name,
        op=OpType.CONV,
        inputs=[x.tid],
        outputs=[out.tid],
        m=out_ch,
        n=oh * ow,
        k=c * k * k,
        kernel=(k, k),
        stride=(stride, stride),
        padding=(pad, pad),
        scale_shift=7,
    )
    return out


def _relu(g: Graph, x: TensorInfo, name: str) -> TensorInfo:
    out = g.add_tensor(f"{name}.out", x.shape)
    g.add_node(name=name, op=OpType.RELU, inputs=[x.tid], outputs=[out.tid])
    return out


def _add(g: Graph, a: TensorInfo, b: TensorInfo, name: str) -> TensorInfo:
    out = g.add_tensor(f"{name}.out", a.shape)
    g.add_node(name=name, op=OpType.ADD, inputs=[a.tid, b.tid], outputs=[out.tid])
    return out


def _maxpool(g: Graph, x: TensorInfo, k: int, stride: int, pad: int, name: str) -> TensorInfo:
    c, h, w = x.shape
    oh = (h + 2 * pad - k) // stride + 1
    ow = (w + 2 * pad - k) // stride + 1
    out = g.add_tensor(f"{name}.out", (c, oh, ow))
    g.add_node(
        name=name,
        op=OpType.MAXPOOL,
        inputs=[x.tid],
        outputs=[out.tid],
        m=c,
        n=oh * ow,
        k=k * k,  # vector-unit work per output element
        kernel=(k, k),
        stride=(stride, stride),
        padding=(pad, pad),
    )
    return out


def _gap(g: Graph, x: TensorInfo, name: str) -> TensorInfo:
    c, h, w = x.shape
    out = g.add_tensor(f"{name}.out", (c, 1, 1))
    g.add_node(name=name, op=OpType.AVGPOOL, inputs=[x.tid], outputs=[out.tid],
               m=c, n=1, k=h * w)
    return out


def _fc(g: Graph, x: TensorInfo, out_features: int, name: str) -> TensorInfo:
    in_features = 1
    for d in x.shape:
        in_features *= d
    out = g.add_tensor(f"{name}.out", (out_features,))
    g.add_node(name=name, op=OpType.FC, inputs=[x.tid], outputs=[out.tid],
               m=out_features, n=1, k=in_features, scale_shift=7)
    return out


def _bottleneck(g: Graph, x: TensorInfo, mid: int, out_ch: int, stride: int,
                name: str) -> TensorInfo:
    """ResNet-v1 bottleneck: 1x1 -> 3x3 -> 1x1 + shortcut, ReLU after add."""
    in_ch = x.shape[0]
    # shortcut first: the fused Conv+Add node (at conv3's position) consumes
    # it, so it must precede conv3 in the topological order.
    if stride != 1 or in_ch != out_ch:
        sc = _conv(g, x, out_ch, 1, stride, 0, f"{name}.downsample")
    else:
        sc = x
    a = _relu(g, _conv(g, x, mid, 1, 1, 0, f"{name}.conv1"), f"{name}.relu1")
    b = _relu(g, _conv(g, a, mid, 3, stride, 1, f"{name}.conv2"), f"{name}.relu2")
    c = _conv(g, b, out_ch, 1, 1, 0, f"{name}.conv3")
    s = _add(g, c, sc, f"{name}.add")
    return _relu(g, s, f"{name}.relu3")


def resnet50(input_hw: int = 256) -> Graph:
    """ResNet-50, INT8, NCHW (C,H,W tensors; batch handled per program round).

    At 224x224 this graph has the canonical ~3.9 GMACs (7.7 GOPs); the paper
    evaluates with 256x256 inputs."""
    g = Graph(name=f"resnet50_{input_hw}")
    x = g.add_tensor("input", (3, input_hw, input_hw))
    g.input_tensors = [x.tid]

    t = _relu(g, _conv(g, x, 64, 7, 2, 3, "conv1"), "relu1")
    t = _maxpool(g, t, 3, 2, 1, "maxpool")

    spec = [  # (blocks, mid, out, first_stride)
        (3, 64, 256, 1),
        (4, 128, 512, 2),
        (6, 256, 1024, 2),
        (3, 512, 2048, 2),
    ]
    for stage_idx, (blocks, mid, out_ch, stride0) in enumerate(spec, start=1):
        for b in range(blocks):
            t = _bottleneck(g, t, mid, out_ch, stride0 if b == 0 else 1,
                            f"layer{stage_idx}.{b}")

    t = _gap(g, t, "gap")
    t = _fc(g, t, 1000, "fc")
    g.output_tensors = [t.tid]
    g.validate_topological()
    return g


def tiny_cnn(channels: tuple[int, ...] = (8, 16, 16), hw: int = 16,
             residual: bool = True) -> Graph:
    """Small CNN with one residual connection — compiler/simulator tests."""
    g = Graph(name="tiny_cnn")
    x = g.add_tensor("input", (channels[0], hw, hw))
    g.input_tensors = [x.tid]
    t = _relu(g, _conv(g, x, channels[1], 3, 1, 1, "c0"), "r0")
    skip = t
    t = _relu(g, _conv(g, t, channels[2], 3, 1, 1, "c1"), "r1")
    t = _conv(g, t, channels[1], 3, 1, 1, "c2")
    if residual:
        t = _add(g, t, skip, "add")
    t = _relu(g, t, "r2")
    t = _fc(g, t, 10, "fc")
    g.output_tensors = [t.tid]
    g.validate_topological()
    return g


# ------------------------------------------------------- transformer zoo --
def _proj(g: Graph, x: TensorInfo, out_features: int, name: str) -> TensorInfo:
    """Projection GEMM on token tensor x: (S, D) -> (S, out_features)."""
    s, d = x.shape
    assert out_features <= 4095, f"{name}: Compute.M is 12 bits ({out_features})"
    assert d <= 16383, f"{name}: Compute.K is 14 bits ({d})"
    out = g.add_tensor(f"{name}.out", (s, out_features))
    g.add_node(name=name, op=OpType.PROJ, inputs=[x.tid], outputs=[out.tid],
               m=out_features, n=s, k=d, scale_shift=7)
    return out


def _layernorm(g: Graph, x: TensorInfo, name: str) -> TensorInfo:
    s, d = x.shape
    out = g.add_tensor(f"{name}.out", x.shape)
    g.add_node(name=name, op=OpType.LAYERNORM, inputs=[x.tid], outputs=[out.tid],
               m=1, n=s, k=d)
    return out


def _vec_act(g: Graph, x: TensorInfo, name: str, act: str = "gelu") -> TensorInfo:
    """Vector-unit activation node (gelu/silu); fusion folds it into the
    preceding PROJ the way ReLU folds into Conv."""
    s, d = x.shape
    out = g.add_tensor(f"{name}.out", x.shape)
    g.add_node(name=name, op=OpType.GELU, inputs=[x.tid], outputs=[out.tid],
               m=1, n=s, k=d, attrs={"act": act})
    return out


def _mul(g: Graph, a: TensorInfo, b: TensorInfo, name: str) -> TensorInfo:
    s, d = a.shape
    out = g.add_tensor(f"{name}.out", a.shape)
    g.add_node(name=name, op=OpType.MUL, inputs=[a.tid, b.tid], outputs=[out.tid],
               m=1, n=s, k=d)
    return out


def _token_add(g: Graph, a: TensorInfo, b: TensorInfo, name: str) -> TensorInfo:
    s, d = a.shape
    out = g.add_tensor(f"{name}.out", a.shape)
    g.add_node(name=name, op=OpType.ADD, inputs=[a.tid, b.tid], outputs=[out.tid],
               m=1, n=s, k=d)
    return out


def _attention(g: Graph, x: TensorInfo, heads: int, kv_heads: int, head_dim: int,
               name: str) -> TensorInfo:
    """Multi-head (optionally grouped-query) self-attention on (S, D) tokens.

    Q/K/V and the output projection are PROJ GEMMs. The score GEMM
    (Q @ K^T per head, M=S, N=H*S, K=head_dim) and the context GEMM
    (softmax(S) @ V, M=head_dim, N=H*S, K=S) take their second operand from
    an activation tensor streamed through the SA weight port; softmax runs in
    the vector units. MACs: H*S^2*hd each for score and context."""
    s, d = x.shape
    assert s <= 4095, f"{name}: score-GEMM M (seq) is 12 bits ({s})"
    assert heads * s <= 65535, \
        f"{name}: score/context-GEMM N (heads*seq) is 16 bits ({heads * s})"
    q = _proj(g, x, heads * head_dim, f"{name}.wq")
    k = _proj(g, x, kv_heads * head_dim, f"{name}.wk")
    v = _proj(g, x, kv_heads * head_dim, f"{name}.wv")

    scores = g.add_tensor(f"{name}.scores", (heads, s, s))
    g.add_node(name=f"{name}.score", op=OpType.ATTN_SCORE,
               inputs=[q.tid, k.tid], outputs=[scores.tid],
               m=s, n=heads * s, k=head_dim, scale_shift=7)
    probs = g.add_tensor(f"{name}.probs", (heads, s, s))
    g.add_node(name=f"{name}.softmax", op=OpType.SOFTMAX,
               inputs=[scores.tid], outputs=[probs.tid],
               m=1, n=heads * s, k=s)
    ctx = g.add_tensor(f"{name}.ctx", (s, heads * head_dim))
    g.add_node(name=f"{name}.context", op=OpType.ATTN_CONTEXT,
               inputs=[probs.tid, v.tid], outputs=[ctx.tid],
               m=head_dim, n=heads * s, k=s, scale_shift=7)
    return _proj(g, ctx, d, f"{name}.wo")


def _ffn(g: Graph, h: TensorInfo, d_model: int, d_ff: int, mlp: str,
         name: str) -> TensorInfo:
    """Pre-norm FFN sub-block: LN -> (gated) MLP -> +res, shared by the
    prefill encoder and decode blocks."""
    t = _layernorm(g, h, f"{name}.ln2")
    if mlp in ("swiglu", "geglu"):
        act = "silu" if mlp == "swiglu" else "gelu"
        gate = _vec_act(g, _proj(g, t, d_ff, f"{name}.ffn.gate"),
                        f"{name}.ffn.{act}", act=act)
        up = _proj(g, t, d_ff, f"{name}.ffn.up")
        t = _mul(g, gate, up, f"{name}.ffn.mul")
    else:
        t = _vec_act(g, _proj(g, t, d_ff, f"{name}.ffn.up"), f"{name}.ffn.act")
    down = _proj(g, t, d_model, f"{name}.ffn.down")
    return _token_add(g, down, h, f"{name}.add2")


def _encoder_block(g: Graph, x: TensorInfo, heads: int, kv_heads: int,
                   head_dim: int, d_ff: int, mlp: str, name: str) -> TensorInfo:
    """Pre-norm encoder block: LN -> MHA -> +res -> LN -> FFN -> +res."""
    attn_out = _attention(g, _layernorm(g, x, f"{name}.ln1"), heads, kv_heads,
                          head_dim, f"{name}.attn")
    h = _token_add(g, attn_out, x, f"{name}.add1")
    return _ffn(g, h, x.shape[1], d_ff, mlp, name)


def vit(input_hw: int = 224, *, patch: int = 16, d_model: int = 768,
        depth: int = 12, heads: int = 12, d_ff: int = 3072,
        n_classes: int = 1000) -> Graph:
    """ViT-Base/16 (default): the vision analogue of ResNet-50 on the same
    GEMM-centric ISA. Patch embedding is an IM2COL GEMM over 16x16x3
    patches; then ``depth`` pre-norm encoder blocks, mean-pool, classifier."""
    assert input_hw % patch == 0
    n_tokens = (input_hw // patch) ** 2
    assert n_tokens <= 4095, f"token count {n_tokens} exceeds the 12-bit M field"
    g = Graph(name=f"vit{depth}_{input_hw}")
    img = g.add_tensor("input", (3, input_hw, input_hw))
    g.input_tensors = [img.tid]

    # patch embed: conv k=patch s=patch lowered as an IM2COL projection GEMM
    tok = g.add_tensor("patch_embed.out", (n_tokens, d_model))
    g.add_node(name="patch_embed", op=OpType.PROJ,
               inputs=[img.tid], outputs=[tok.tid],
               m=d_model, n=n_tokens, k=3 * patch * patch,
               kernel=(patch, patch), stride=(patch, patch), scale_shift=7)

    t = tok
    for i in range(depth):
        t = _encoder_block(g, t, heads, heads, d_model // heads, d_ff,
                           "gelu", f"block{i}")
    t = _layernorm(g, t, "ln_f")

    pooled = g.add_tensor("pool.out", (d_model,))
    g.add_node(name="pool", op=OpType.AVGPOOL, inputs=[t.tid],
               outputs=[pooled.tid], m=d_model, n=1, k=n_tokens)
    head = _fc(g, pooled, n_classes, "head")
    g.output_tensors = [head.tid]
    g.validate_topological()
    return g


def transformer_encoder(arch="qwen3-0.6b", *, seq_len: int = 256,
                        depth: int | None = None) -> Graph:
    """Decoder-block stack of a ``repro_torch.configs`` architecture as a prefill
    graph: ``depth`` (default: the config's layer count) blocks over a
    (seq_len, d_model) token tensor. ``arch`` is a config name or an
    ``ArchConfig`` instance (e.g. ``get_config("gemma3-4b").reduced()`` for
    architectures whose full dims exceed the ISA field widths). Embedding
    lookup / lm_head stay on the host; causality does not change GEMM shapes
    at this fidelity."""
    from ..configs import get_config

    cfg = get_config(arch) if isinstance(arch, str) else arch
    n_layers = depth if depth is not None else cfg.num_layers
    assert seq_len <= 4095, "ATTN_SCORE M field is 12 bits"
    g = Graph(name=f"{cfg.name.replace('.', '_')}_enc{n_layers}_s{seq_len}")
    x = g.add_tensor("input", (seq_len, cfg.d_model))
    g.input_tensors = [x.tid]

    t = x
    for i in range(n_layers):
        t = _encoder_block(g, t, cfg.num_heads, cfg.num_kv_heads,
                           cfg.resolved_head_dim, cfg.d_ff, cfg.mlp,
                           f"block{i}")
    t = _layernorm(g, t, "ln_f")
    g.output_tensors = [t.tid]
    g.validate_topological()
    return g


# ------------------------------------------------- autoregressive decode --
def _decode_attention(g: Graph, x: TensorInfo, heads: int, kv_heads: int,
                      head_dim: int, base_rows: int, steps: int,
                      name: str) -> TensorInfo:
    """Single-token self-attention against growing K/V cache regions.

    One program round = one decode step. The new token's K/V rows are
    *appended* to per-block cache regions (``kv_base_rows`` rows hold the
    prefill prefix); the score and context GEMMs stream the cache through
    the SA weight port with a per-round advancing length (AddrLen/CYCLE_LEN).
    GEMM dims are *static* in the ISA, so score/context encode the decode
    window's average cache length — the analytic model and the instruction
    stream agree on per-round compute by construction, while the HBM traffic
    executes the true advancing-length semantics."""
    s, d = x.shape
    assert s == 1, f"{name}: decode processes one token per round"
    kv_dim = kv_heads * head_dim
    l_max = base_rows + steps
    n_avg = max(1, round(base_rows + (steps + 1) / 2))  # mean cache length
    assert l_max <= 16383, f"{name}: context-GEMM K (cache len) is 14 bits"
    assert heads * n_avg <= 65535, f"{name}: score-GEMM N is 16 bits"

    q = _proj(g, x, heads * head_dim, f"{name}.wq")
    kcache = g.add_tensor(f"{name}.kcache", (l_max, kv_dim),
                          kv_base_rows=base_rows)
    g.add_node(name=f"{name}.wk", op=OpType.PROJ, inputs=[x.tid],
               outputs=[kcache.tid], m=kv_dim, n=1, k=d, scale_shift=7)
    vcache = g.add_tensor(f"{name}.vcache", (l_max, kv_dim),
                          kv_base_rows=base_rows)
    g.add_node(name=f"{name}.wv", op=OpType.PROJ, inputs=[x.tid],
               outputs=[vcache.tid], m=kv_dim, n=1, k=d, scale_shift=7)

    scores = g.add_tensor(f"{name}.scores", (heads, l_max))
    g.add_node(name=f"{name}.score", op=OpType.ATTN_SCORE,
               inputs=[q.tid, kcache.tid], outputs=[scores.tid],
               m=1, n=heads * n_avg, k=head_dim, scale_shift=7)
    probs = g.add_tensor(f"{name}.probs", (heads, l_max))
    g.add_node(name=f"{name}.softmax", op=OpType.SOFTMAX,
               inputs=[scores.tid], outputs=[probs.tid],
               m=1, n=heads, k=n_avg)
    ctx = g.add_tensor(f"{name}.ctx", (1, heads * head_dim))
    g.add_node(name=f"{name}.context", op=OpType.ATTN_CONTEXT,
               inputs=[probs.tid, vcache.tid], outputs=[ctx.tid],
               m=head_dim, n=heads, k=n_avg, scale_shift=7)
    return _proj(g, ctx, d, f"{name}.wo")


def _decoder_block(g: Graph, x: TensorInfo, heads: int, kv_heads: int,
                   head_dim: int, d_ff: int, mlp: str, base_rows: int,
                   steps: int, name: str) -> TensorInfo:
    """Pre-norm decode block: LN -> cached MHA -> +res -> LN -> FFN -> +res."""
    attn_out = _decode_attention(g, _layernorm(g, x, f"{name}.ln1"), heads,
                                 kv_heads, head_dim, base_rows, steps,
                                 f"{name}.attn")
    h = _token_add(g, attn_out, x, f"{name}.add1")
    return _ffn(g, h, x.shape[1], d_ff, mlp, name)


def _packed_decode_attention(g: Graph, x: TensorInfo, heads: int, kv_heads: int,
                             head_dim: int, slot_rows: tuple[int, ...],
                             steps: int, name: str) -> TensorInfo:
    """Slot-packed self-attention: S concurrent decode sessions, one token
    each per round, against *independent per-slot* K/V cache regions.

    Generalizes :func:`_decode_attention`'s single LEN counter to one
    AddrLen length stream per slot: each session j carries its own prefix
    depth ``slot_rows[j]``, so its cache tensor gets its own
    ``kv_base_rows`` and therefore its own advancing-length read stream and
    append cursor in the compiled programs. The Q/K/V and output projections
    batch all S tokens through one GEMM (N=S) — the continuous-batching
    win: resident weights are streamed once per round for the whole pack —
    while score/softmax/context stay per-slot (each attends over its own
    prefix). A CONCAT vector op gathers the per-slot context rows back into
    the (S, H*hd) token tensor for the shared output projection.

    Per-slot score/context nodes read the full packed Q region at this
    fidelity (one row is live per slot); LD-side traffic of the tiny Q/ctx
    tensors is charged identically by the analytic model and the simulator,
    so conformance is unaffected."""
    s, d = x.shape
    assert s == len(slot_rows), f"{name}: one token per packed slot"
    kv_dim = kv_heads * head_dim

    q = _proj(g, x, heads * head_dim, f"{name}.wq")

    kcaches, vcaches = [], []
    for j, rows in enumerate(slot_rows):
        l_max = rows + steps
        assert l_max <= 16383, \
            f"{name}: slot {j} cache length is 14 bits ({l_max})"
        kcaches.append(g.add_tensor(f"{name}.kcache{j}", (l_max, kv_dim),
                                    kv_base_rows=rows))
        vcaches.append(g.add_tensor(f"{name}.vcache{j}", (l_max, kv_dim),
                                    kv_base_rows=rows))
    # One projection GEMM computes all S new K (resp. V) rows; the store
    # side appends row j to slot j's region (multi-output broadcast store,
    # one row-sized DataMove per slot with the hold bit chaining them).
    g.add_node(name=f"{name}.wk", op=OpType.PROJ, inputs=[x.tid],
               outputs=[kc.tid for kc in kcaches],
               m=kv_dim, n=s, k=d, scale_shift=7)
    g.add_node(name=f"{name}.wv", op=OpType.PROJ, inputs=[x.tid],
               outputs=[vc.tid for vc in vcaches],
               m=kv_dim, n=s, k=d, scale_shift=7)

    ctxs = []
    for j, rows in enumerate(slot_rows):
        l_max = rows + steps
        n_avg = max(1, round(rows + (steps + 1) / 2))  # slot j mean length
        assert heads * n_avg <= 65535, \
            f"{name}: slot {j} score-GEMM N is 16 bits"
        scores = g.add_tensor(f"{name}.scores{j}", (heads, l_max))
        g.add_node(name=f"{name}.score{j}", op=OpType.ATTN_SCORE,
                   inputs=[q.tid, kcaches[j].tid], outputs=[scores.tid],
                   m=1, n=heads * n_avg, k=head_dim, scale_shift=7)
        probs = g.add_tensor(f"{name}.probs{j}", (heads, l_max))
        g.add_node(name=f"{name}.softmax{j}", op=OpType.SOFTMAX,
                   inputs=[scores.tid], outputs=[probs.tid],
                   m=1, n=heads, k=n_avg)
        ctx = g.add_tensor(f"{name}.ctx{j}", (1, heads * head_dim))
        g.add_node(name=f"{name}.context{j}", op=OpType.ATTN_CONTEXT,
                   inputs=[probs.tid, vcaches[j].tid], outputs=[ctx.tid],
                   m=head_dim, n=heads, k=n_avg, scale_shift=7)
        ctxs.append(ctx)

    if s == 1:
        cat = ctxs[0]
    else:
        cat = g.add_tensor(f"{name}.ctxcat", (s, heads * head_dim))
        g.add_node(name=f"{name}.concat", op=OpType.CONCAT,
                   inputs=[c.tid for c in ctxs], outputs=[cat.tid],
                   m=1, n=s, k=heads * head_dim)
    return _proj(g, cat, d, f"{name}.wo")


def _packed_decoder_block(g: Graph, x: TensorInfo, heads: int, kv_heads: int,
                          head_dim: int, d_ff: int, mlp: str,
                          slot_rows: tuple[int, ...], steps: int,
                          name: str) -> TensorInfo:
    """Pre-norm packed decode block: LN -> slot-packed MHA -> +res -> FFN."""
    attn_out = _packed_decode_attention(g, _layernorm(g, x, f"{name}.ln1"),
                                        heads, kv_heads, head_dim, slot_rows,
                                        steps, f"{name}.attn")
    h = _token_add(g, attn_out, x, f"{name}.add1")
    return _ffn(g, h, x.shape[1], d_ff, mlp, name)


def transformer_decoder(arch="qwen3-0.6b", *, seq_len: int = 256,
                        decode_steps: int = 64,
                        depth: int | None = None,
                        slots: tuple[int, ...] | None = None) -> Graph:
    """The decode half of the prefill->decode serving pair: ``depth`` blocks
    processing *one new token per program round* against per-block K/V cache
    regions pre-filled with ``seq_len`` tokens (the matching prefill graph is
    ``transformer_encoder(arch, seq_len=seq_len, depth=depth)`` — a running
    :class:`repro_torch.deploy.System` hot-swaps between the two with no
    reconfiguration). ``decode_steps`` sizes the append-only cache window:
    round r attends over ``seq_len + r + 1`` tokens, and deployments of this
    graph default to ``decode_steps`` rounds (one full decode pass).

    ``slots`` packs S concurrent decode sessions at *different* cache depths
    into the same graph (continuous batching): ``slots=(l0, l1, ...)`` gives
    session j a private per-block K/V cache pre-filled with ``l_j`` tokens
    (``seq_len`` is ignored), batches the weighted projections across all S
    tokens, and keeps attention per-slot via independent AddrLen length
    streams — see :func:`_packed_decode_attention`."""
    from ..configs import get_config

    cfg = get_config(arch) if isinstance(arch, str) else arch
    n_layers = depth if depth is not None else cfg.num_layers
    assert 1 <= decode_steps <= 128, \
        "decode window exceeds the 7-bit AddrCyc NC field (cache append side)"
    if slots is None:
        assert seq_len + decode_steps <= 16383, \
            "max cache length exceeds the 14-bit context-GEMM K field"
        g = Graph(name=f"{cfg.name.replace('.', '_')}_dec{n_layers}"
                       f"_s{seq_len}x{decode_steps}")
        g.attrs.update(phase="decode", prefill_len=seq_len,
                       decode_steps=decode_steps)
        x = g.add_tensor("input", (1, cfg.d_model))
        g.input_tensors = [x.tid]

        t = x
        for i in range(n_layers):
            t = _decoder_block(g, t, cfg.num_heads, cfg.num_kv_heads,
                               cfg.resolved_head_dim, cfg.d_ff, cfg.mlp,
                               seq_len, decode_steps, f"block{i}")
        t = _layernorm(g, t, "ln_f")
        g.output_tensors = [t.tid]
        g.validate_topological()
        return g

    slot_rows = tuple(int(r) for r in slots)
    assert slot_rows and all(r >= 1 for r in slot_rows), \
        "each packed slot needs a non-empty prefill prefix"
    assert len(slot_rows) <= 64, "packed slot count is bounded at 64"
    g = Graph(name=f"{cfg.name.replace('.', '_')}_dec{n_layers}"
                   f"_p{'+'.join(str(r) for r in slot_rows)}x{decode_steps}")
    g.attrs.update(phase="decode", prefill_len=max(slot_rows),
                   decode_steps=decode_steps, slot_prefix_rows=slot_rows)
    x = g.add_tensor("input", (len(slot_rows), cfg.d_model))
    g.input_tensors = [x.tid]

    t = x
    for i in range(n_layers):
        t = _packed_decoder_block(g, t, cfg.num_heads, cfg.num_kv_heads,
                                  cfg.resolved_head_dim, cfg.d_ff, cfg.mlp,
                                  slot_rows, decode_steps, f"block{i}")
    t = _layernorm(g, t, "ln_f")
    g.output_tensors = [t.tid]
    g.validate_topological()
    return g


def linear_chain(n_convs: int = 6, ch: int = 32, hw: int = 32) -> Graph:
    """Plain conv chain (no residuals) — partitioner unit tests."""
    g = Graph(name=f"chain{n_convs}")
    x = g.add_tensor("input", (ch, hw, hw))
    g.input_tensors = [x.tid]
    t = x
    for i in range(n_convs):
        t = _relu(g, _conv(g, t, ch, 3, 1, 1, f"c{i}"), f"r{i}")
    g.output_tensors = [t.tid]
    g.validate_topological()
    return g
