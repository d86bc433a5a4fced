"""The plain reference against a float64 transcription of the equations in
its docstring, written position by position at tiny sizes."""
import math

import pytest
import torch

from cardbench import weights
from cardbench.model_config import dims
from cardbench.reference import dense
from cardbench.tests.tiny import TINY, TINY_GELU


def transcription(d, p: dict, glob: dict, tokens: list[int]) -> torch.Tensor:
    """Logits (s, V) of one sequence, every sum written out, float64."""
    H, G, hd = d.heads, d.kv_heads, d.head_dim

    def norm(x, scale):
        return x / math.sqrt(float((x * x).mean()) + d.eps) * (1 + scale)

    def rot(v, pos):
        out = v.clone()
        for i in range(hd // 2):
            a = pos / d.rope_theta ** (2 * i / hd)
            x1, x2 = v[i], v[i + hd // 2]
            out[i], out[i + hd // 2] = x1 * math.cos(a) - x2 * math.sin(a), \
                x2 * math.cos(a) + x1 * math.sin(a)
        return out

    xs = [glob["embed"][t].clone() for t in tokens]
    s = len(xs)
    for layer in range(d.layers):
        w = p[layer]
        hs = [norm(x, w["norm1"]) for x in xs]
        q = [[rot(torch.einsum("d,dq->q", h, w["wq"][:, i]), t) for i in range(H)]
             for t, h in enumerate(hs)]
        k = [[rot(torch.einsum("d,dq->q", h, w["wk"][:, g]), t) for g in range(G)]
             for t, h in enumerate(hs)]
        v = [[torch.einsum("d,dq->q", h, w["wv"][:, g]) for g in range(G)] for h in hs]
        new = []
        for i in range(s):
            o = torch.zeros(d.d, dtype=torch.float64)
            for head in range(H):
                g = head // (H // G)
                seen = [j for j in range(i + 1) if d.window is None or i - j < d.window]
                sc = torch.tensor([float(q[i][head] @ k[j][g]) / math.sqrt(hd) for j in seen],
                                  dtype=torch.float64)
                pr = torch.exp(sc - sc.max())
                pr = pr / pr.sum()
                att = sum(pr[n] * v[j][g] for n, j in enumerate(seen))
                o = o + att @ w["wo"][head]
            new.append(xs[i] + o)
        xs = []
        for x in new:
            h = norm(x, w["norm2"])
            if d.mlp == "swiglu":
                gate = h @ w["w_gate"]
                m = gate / (1 + torch.exp(-gate)) * (h @ w["w_in"])
            else:
                u = h @ w["w_in"]
                m = 0.5 * u * (1 + torch.tanh(math.sqrt(2 / math.pi) * (u + 0.044715 * u ** 3)))
            xs.append(x + m @ w["w_out"])
    return torch.stack([norm(x, glob["final_norm"]) @ glob["lm_head"] for x in xs])


@pytest.mark.parametrize("cfg,window", [(TINY, 5), (TINY, None), (TINY_GELU, None),
                                        (TINY_GELU, 3)])
def test_reference_matches_transcription(cfg, window):
    d = dims({**cfg, "sliding_window": window, "num_hidden_layers": 2})
    p = [{k: v.double() for k, v in weights.layer(d, 3, i, "cpu").items()}
         for i in range(d.layers)]
    glob = {k: weights.global_leaf(d, 3, k, "cpu").double()
            for k in ("embed", "final_norm", "lm_head")}
    tokens = torch.randint(0, d.vocab, (2, 9), generator=torch.Generator().manual_seed(1))
    got = dense.logits(d, lambda i: p[i], glob, tokens)["fp32"]
    for b in range(2):
        want = transcription(d, p, glob, tokens[b].tolist())
        torch.testing.assert_close(got[b], want, rtol=1e-10, atol=1e-10)


def test_attention_blocks_agree():
    """Blocks of query rows (with the window's key range cut) give the
    unblocked attention."""
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(2, 37, 4, 8, generator=g, dtype=torch.float64) for _ in range(3))
    k, v = k[:, :, :2], v[:, :, :2]
    for window in (None, 5, 37):
        whole = dense.attention(q, k, v, window, block=64)
        torch.testing.assert_close(dense.attention(q, k, v, window, block=6), whole,
                                   rtol=1e-12, atol=1e-12)


def test_rows_pick_positions():
    d = dims({**TINY, "num_hidden_layers": 2})
    p = [weights.layer(d, 4, i, "cpu") for i in range(d.layers)]
    glob = {k: weights.global_leaf(d, 4, k, "cpu") for k in ("embed", "final_norm", "lm_head")}
    tokens = torch.randint(0, d.vocab, (1, 12), generator=torch.Generator().manual_seed(2))
    full = dense.logits(d, lambda i: p[i], glob, tokens)["fp32"]
    part = dense.logits(d, lambda i: p[i], glob, tokens, rows=torch.arange(5, 12))["fp32"]
    torch.testing.assert_close(part, full[:, 5:12])
