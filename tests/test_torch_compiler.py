"""The port's copy of the compiler (``repro_torch.compiler``) against the JAX
package's: graph fingerprints and fused node lists, the per-config placement
(stage lists and times), the dense ``AnalysisTables`` arrays, the
instruction programs word for word, and the ``STATS`` counters and caches,
which each package keeps for itself. Small graphs only."""
import dataclasses

import numpy as np
import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")  # the machine with the card has no JAX

from repro import compiler as jc  # noqa: E402
from repro.compiler import compile as jcompile  # noqa: E402
from repro.core.pu import make_u50_system as jsystem  # noqa: E402
from repro_torch import compiler as tc  # noqa: E402
from repro_torch.compiler import compile as tcompile  # noqa: E402
from repro_torch.core.pu import make_u50_system as tsystem  # noqa: E402

GRAPHS = {
    "tiny_cnn": lambda z: z.tiny_cnn(channels=(16, 32, 32), hw=16),
    "qwen3_enc": lambda z: z.transformer_encoder("qwen3-0.6b", seq_len=64, depth=1),
    "qwen3_dec": lambda z: z.transformer_decoder("qwen3-0.6b", seq_len=64,
                                                 decode_steps=8, depth=2),
    "qwen3_dec_slots": lambda z: z.transformer_decoder(
        "qwen3-0.6b", seq_len=64, decode_steps=8, depth=1, slots=[32, 48]),
    "linear_chain": lambda z: z.linear_chain(),
}
# graph construction only (fingerprints and fusion): the full-size zoo too
BUILD_ONLY = {
    "resnet50": lambda z: z.resnet50(256),
    "vit": lambda z: z.vit(224),
    "qwen3_enc_full": lambda z: z.transformer_encoder("qwen3-0.6b", seq_len=256),
}
CONFIGS = [(1, 0), (0, 1), (2, 3), (5, 5)]


def _pair(name):
    mk = {**GRAPHS, **BUILD_ONLY}[name]
    return mk(jc.zoo), mk(tc.zoo)


def _node(nd):
    return (nd.nid, nd.name, nd.op.value, nd.inputs, nd.outputs, nd.m, nd.n, nd.k,
            nd.kernel, nd.stride, nd.padding, nd.relu, nd.residual_input,
            nd.scale_shift, sorted(nd.attrs.items()))


def _stages(stages):
    return [(s.index, s.pu_kind, s.nids, s.time) for s in stages]


@pytest.mark.parametrize("name", [*GRAPHS, *BUILD_ONLY])
def test_fingerprint_and_fusion_match_jax(name):
    gj, gt = _pair(name)
    assert gt.fingerprint() == gj.fingerprint()
    fj, ft = jc.fuse(gj), tc.fuse(gt)
    assert [_node(n) for n in ft.nodes] == [_node(n) for n in fj.nodes]
    assert ft.fingerprint() == fj.fingerprint()


@pytest.mark.parametrize("cfg", CONFIGS, ids=lambda c: f"{c[0]}x{c[1]}")
@pytest.mark.parametrize("name", list(GRAPHS))
def test_place_matches_jax(name, cfg):
    gj, gt = _pair(name)
    mj = jc.place(jc.analyze(gj, jsystem()), *cfg)
    mt = tc.place(tc.analyze(gt, tsystem()), *cfg)
    assert _stages(mt.part.stages) == _stages(mj.part.stages)
    assert mt.part.node_order == mj.part.node_order
    assert mt.stage_times == mj.stage_times
    assert mt.pid_map == mj.pid_map
    assert (mt.predicted_fps, mt.predicted_latency, mt.used_tops, mt.pbe()) == (
        mj.predicted_fps, mj.predicted_latency, mj.used_tops, mj.pbe())
    assert dataclasses.astuple(mt.coupling) == dataclasses.astuple(mj.coupling)


@pytest.mark.parametrize("name", list(GRAPHS))
def test_analysis_tables_match_jax(name):
    gj, gt = _pair(name)
    tj = jc.analyze(gj, jsystem()).tables()
    tt = tc.analyze(gt, tsystem()).tables()
    assert (tt.order, tt.kinds, tt.n_edges, tt.n_tensor_slots) == (
        tj.order, tj.kinds, tj.n_edges, tj.n_tensor_slots)
    for kind in tj.kinds:
        kj, kt = tj.by_kind[kind], tt.by_kind[kind]
        assert kt.prefix == kj.prefix
        for f in ("node_exec", "node_stream", "tile_chunks", "tile_node", "tile_prefix"):
            a, b = getattr(kt, f), getattr(kj, f)
            assert a.dtype == b.dtype and np.array_equal(a, b), f
        assert (kt.t_chunk_load, kt.cap_chunks) == (kj.t_chunk_load, kj.cap_chunks)
        assert np.array_equal(tt.edge_t_write[kind], tj.edge_t_write[kind])
        assert np.array_equal(tt.edge_t_read[kind], tj.edge_t_read[kind])
    for f in ("edge_tensor", "edge_prod", "edge_cons"):
        assert np.array_equal(getattr(tt, f), getattr(tj, f)), f
    assert np.array_equal(tt.partition_values(5, 5), tj.partition_values(5, 5))
    stages = {c: _stages(tj.reconstruct(*c)) for c in CONFIGS}
    assert {c: _stages(tt.reconstruct(*c)) for c in CONFIGS} == stages
    segs = sorted({(tj.pos[s[2][0]], tj.pos[s[2][0]] + len(s[2]), s[1])
                   for st in stages.values() for s in st})
    assert tt.segment_overheads(segs) == tj.segment_overheads(segs)


@pytest.mark.parametrize("cfg", [(1, 1), (3, 2)], ids=lambda c: f"{c[0]}x{c[1]}")
@pytest.mark.parametrize("name", ["tiny_cnn", "qwen3_enc"])
def test_programs_match_jax_word_for_word(name, cfg):
    gj, gt = _pair(name)
    pj = jc.compile_model(gj, *cfg).programs
    pt = tc.compile_model(gt, *cfg).programs
    assert [p.pid for p in pt] == [p.pid for p in pj]
    assert [p.encode() for p in pt] == [p.encode() for p in pj]


def test_stats_move_as_jax_and_caches_are_per_package():
    jc.clear_analysis_cache()
    tc.clear_analysis_cache()
    jc.STATS.reset()
    tc.STATS.reset()

    def calls(c, z):
        g = GRAPHS["qwen3_dec"](z)
        an = c.analyze(g)
        for cfg in CONFIGS:
            c.place(an, *cfg)
        c.analyze(GRAPHS["qwen3_dec"](z))  # a hit: same content
        c.compile_model(g, 2, 2, rounds=4).programs
        an.tables()
        return c.STATS.snapshot()

    assert calls(tc, tc.zoo) == calls(jc, jc.zoo)
    assert tc.STATS.codegen_calls == 1 and tc.STATS.analysis_hits == 2

    # clearing the port's caches leaves the JAX package's in place
    tc.clear_analysis_cache()
    assert jcompile._ANALYSIS_CACHE and jcompile._WSCHED_SHAPE_CACHE
    assert not tcompile._ANALYSIS_CACHE and not tcompile._WSCHED_SHAPE_CACHE
    misses = tc.STATS.analysis_misses
    tc.analyze(GRAPHS["qwen3_dec"](tc.zoo))
    assert tc.STATS.analysis_misses == misses + 1
    hits = jc.STATS.analysis_hits
    jc.analyze(GRAPHS["qwen3_dec"](jc.zoo))
    assert jc.STATS.analysis_hits == hits + 1
