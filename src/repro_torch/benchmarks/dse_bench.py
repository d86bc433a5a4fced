"""DSE engine benchmark: wall-clock + phase-call counts, three engines.

Measures the three-step DSE (Sec. V-A) on the workloads the repo's
quickstarts lead with — ``explore(zoo.resnet50(256))``, ``explore(zoo.vit(224))``,
``explore_multi([resnet50, vit])`` and a qwen3 decode ``explore`` — once per
engine:

* ``engine="batched"`` (default) — one vectorized scoring pass over the
  dense ``AnalysisTables`` export per graph (``repro_torch.dse.batched``);
* ``engine="scalar"`` — the per-config ``place()`` fast engine (config-
  independent ``analyze`` shared across all Step-1 configs, lazy codegen,
  pruned Step-2 composition, O(n log n) Pareto);
* ``engine="reference"`` — the pre-caching engine: full recompile including
  eager instruction codegen per config, unpruned composition, O(n²) Pareto.

Every engine run is cold-vs-cold: ``repro_torch.compiler.STATS``, the analysis
LRU *and* the cross-analysis SMOF shape cache are reset before each run
(``clear_analysis_cache`` clears both caches), so no engine inherits
another's warm state. For every case the artifact records:

  * wall-clock seconds for all three engines, ``speedup`` (reference over
    batched) and ``speedup_batched_vs_scalar`` (the vectorization win),
  * the ``repro_torch.compiler.STATS`` phase-call counters per engine,
  * ``gate_batched_equal``: frontiers and DP-A/B/C (or the joint frontier
    and the ``balanced`` point) compare byte-equal across all three engines.

An ``incremental.*`` case additionally measures ``explore_multi(prev=...)``:
after a full co-exploration, one tenant is swapped and the re-exploration
reuses the surviving tenants' Step-1 caches plus the prior frontier as
incumbent seeds; ``incremental_ratio`` is its wall time over the
from-scratch wall time, each the best of three cold runs (frontier
equality is gated, the ratio is advisory wall-clock).

``--profile`` resets and records ``repro_torch.dse.batched.PROFILE`` around each
batched-engine run, emitting per-phase timings (table build / partition DP /
reconstruction / SMOF solve / scoring) into the artifact.

The twin of the JAX package's ``benchmarks/dse_bench.py`` over the port's
DSE and its own ``repro_torch.compiler.STATS`` (host code: no tensor, no
card). The JSON artifact goes to ``--out`` (default
``build/BENCH_dse.json`` under the working directory; the repository's
``BENCH_dse.json`` is the JAX package's). ``--ci`` runs reduced model sizes
and **gates on the call counts and the equivalence bits** — zero codegen
during exploration, exactly one analysis per distinct graph, all engines
equal — while wall-clock numbers stay advisory so runner jitter cannot
flake the build. The equivalence bit compares results byte for byte, and
the batched engine drifts by one ulp from the scalar ones on some hosts
(the JAX package's ``TestFastEngineEquivalence``), where ``--ci`` exits
nonzero on that bit alone::

    PYTHONPATH=src python -m repro_torch.benchmarks.dse_bench --ci [--out PATH]
"""
from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time

from ..compiler import STATS, clear_analysis_cache, zoo
from ..dse import batched, explore, explore_multi

PROFILE_PHASES = False  # set by --profile


def _timed(fn):
    """Cold run: the analysis LRU, the SMOF shape cache and the STATS
    counters are all reset so successive engine runs never share state."""
    clear_analysis_cache()
    STATS.reset()
    batched.reset_profile()
    t0 = time.perf_counter()
    res = fn()
    wall = time.perf_counter() - t0
    profile = dict(batched.PROFILE) if PROFILE_PHASES else None
    return res, wall, STATS.snapshot(), profile


def _single_equal(x, y) -> bool:
    return (
        x.single == y.single
        and x.single_frontier == y.single_frontier
        and x.multi_frontier == y.multi_frontier
        and x.dp_a == y.dp_a
        and x.dp_b == y.dp_b
        and x.dp_c == y.dp_c
    )


def _single_case(name: str, graph_fn, n_graphs: int = 1) -> dict:
    g = graph_fn()
    bat, t_bat, c_bat, prof = _timed(lambda: explore(g))
    scl, t_scl, c_scl, _ = _timed(lambda: explore(g, engine="scalar"))
    ref, t_ref, c_ref, _ = _timed(lambda: explore(g, engine="reference"))
    equal = _single_equal(bat, scl) and _single_equal(bat, ref)
    return _report(name, n_graphs, t_bat, c_bat, t_scl, c_scl, t_ref, c_ref,
                   equal, prof,
                   extra={"n_single": len(bat.single),
                          "n_multi_batched": len(bat.multi),
                          "n_multi_ref": len(ref.multi)})


def _multi_case(name: str, graphs_fn, n_graphs: int) -> dict:
    graphs = graphs_fn()
    bat, t_bat, c_bat, prof = _timed(lambda: explore_multi(graphs))
    scl, t_scl, c_scl, _ = _timed(lambda: explore_multi(graphs, engine="scalar"))
    ref, t_ref, c_ref, _ = _timed(lambda: explore_multi(graphs, engine="reference"))
    equal = (bat.frontier == scl.frontier == ref.frontier
             and bat.balanced == scl.balanced == ref.balanced)
    return _report(name, n_graphs, t_bat, c_bat, t_scl, c_scl, t_ref, c_ref,
                   equal, prof,
                   extra={"n_points_batched": len(bat.points),
                          "n_points_ref": len(ref.points),
                          "n_frontier": len(bat.frontier)})


def _incremental_case(name: str, graphs_fn, swap_fn, n_graphs: int,
                      repeats: int = 3) -> dict:
    """Co-explore, swap one tenant, re-explore with ``prev=`` vs from
    scratch. Frontier equality is the gate; the wall-time ratio of the
    incremental pass over the from-scratch pass is the headline number.
    Both passes take the best of ``repeats`` cold runs so scheduler jitter
    cannot swing the ratio."""
    graphs = graphs_fn()
    base, t_base, c_base, prof = _timed(lambda: explore_multi(graphs))
    swapped = swap_fn()
    # incremental pass: ``prev`` carries the surviving tenants' Step-1
    # caches, so only the *changed* tenant costs an analysis (the cache
    # clear + STATS reset keep every repeat cold and let the
    # analysis-count gate see exactly one fresh analysis).
    t_inc = math.inf
    for _ in range(repeats):
        clear_analysis_cache()
        STATS.reset()
        batched.reset_profile()
        t0 = time.perf_counter()
        inc = explore_multi(swapped, prev=base)
        t_inc = min(t_inc, time.perf_counter() - t0)
        c_inc = STATS.snapshot()
    t_scr = math.inf
    for _ in range(repeats):
        scr, t, c_scr, _ = _timed(lambda: explore_multi(swapped))
        t_scr = min(t_scr, t)
    equal = (inc.frontier == scr.frontier and inc.balanced == scr.balanced)
    rep = _report(name, n_graphs, t_inc, c_inc, t_scr, c_scr, t_scr, c_scr,
                  equal, prof,
                  extra={"wall_base_s": t_base,
                         "incremental_ratio": t_inc / t_scr if t_scr else 0.0,
                         "n_frontier": len(inc.frontier)})
    # the incremental pass re-analyzes only the swapped-in tenant
    rep["gate_one_analysis_per_graph"] = c_inc["analysis_misses"] == 1
    return rep


def _report(name, n_graphs, t_bat, c_bat, t_scl, c_scl, t_ref, c_ref, equal,
            profile, extra) -> dict:
    rep = {
        "name": name,
        "wall_batched_s": t_bat,
        "wall_scalar_s": t_scl,
        "wall_ref_s": t_ref,
        "speedup": t_ref / t_bat if t_bat else float("inf"),
        "speedup_batched_vs_scalar": t_scl / t_bat if t_bat else float("inf"),
        "counts_batched": c_bat,
        "counts_scalar": c_scl,
        "counts_ref": c_ref,
        "equal": equal,
        # the CI gates: the batched engine generated zero instructions and
        # ran one analysis (fuse+profile) per distinct graph; the reference
        # engine shows what was saved.
        "gate_zero_codegen": c_bat["codegen_calls"] == 0
        and c_bat["memory_plan_calls"] == 0,
        "gate_one_analysis_per_graph": c_bat["analysis_misses"] == n_graphs
        and c_bat["fuse_calls"] == n_graphs
        and c_bat["profile_calls"] == n_graphs,
        "gate_batched_equal": equal,
        **extra,
    }
    if profile is not None:
        rep["profile_batched"] = profile
    return rep


def full_cases() -> list[dict]:
    return [
        _single_case("explore.resnet50_256", lambda: zoo.resnet50(256)),
        _single_case("explore.vit_224", lambda: zoo.vit(224)),
        _multi_case("explore_multi.resnet50+vit",
                    lambda: [zoo.resnet50(256), zoo.vit(224)], n_graphs=2),
        _single_case(
            "explore.qwen3_decode_s256_t64",
            lambda: zoo.transformer_decoder("qwen3-0.6b", seq_len=256,
                                            decode_steps=64, depth=4)),
        _incremental_case(
            "incremental.vit+qwen3_enc16+tiny_cnn.swap_tiny",
            lambda: [zoo.vit(224),
                     zoo.transformer_encoder("qwen3-0.6b", seq_len=256,
                                             depth=16),
                     zoo.tiny_cnn(channels=(8, 16, 16), hw=16)],
            lambda: [zoo.vit(224),
                     zoo.transformer_encoder("qwen3-0.6b", seq_len=256,
                                             depth=16),
                     zoo.tiny_cnn(channels=(4, 8, 8), hw=8)],
            n_graphs=3),
    ]


def ci_cases() -> list[dict]:
    """Reduced sizes (same frontends, same gates) so the CI step stays in
    seconds: the call-count and equivalence gates are size-independent."""
    return [
        _single_case("explore.tiny_cnn",
                     lambda: zoo.tiny_cnn(channels=(16, 32, 32), hw=16)),
        _single_case(
            "explore.qwen3_enc1_s64",
            lambda: zoo.transformer_encoder("qwen3-0.6b", seq_len=64, depth=1)),
        _single_case(
            "explore.qwen3_dec_s64_t8",
            lambda: zoo.transformer_decoder("qwen3-0.6b", seq_len=64,
                                            decode_steps=8, depth=4)),
        _multi_case(
            "explore_multi.tiny_cnn+qwen3_enc",
            lambda: [zoo.tiny_cnn(channels=(16, 32, 32), hw=16),
                     zoo.transformer_encoder("qwen3-0.6b", seq_len=64, depth=1)],
            n_graphs=2),
        _incremental_case(
            "incremental.tiny_cnn+qwen3_enc->tiny_cnn+qwen3_dec",
            lambda: [zoo.tiny_cnn(channels=(16, 32, 32), hw=16),
                     zoo.transformer_encoder("qwen3-0.6b", seq_len=64, depth=1)],
            lambda: [zoo.tiny_cnn(channels=(16, 32, 32), hw=16),
                     zoo.transformer_decoder("qwen3-0.6b", seq_len=64,
                                             decode_steps=8, depth=4)],
            n_graphs=2),
    ]


def main() -> int:
    global PROFILE_PHASES
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--ci", action="store_true",
                    help="reduced sizes; exit nonzero on call-count or "
                         "equivalence gate failures (wall-clock advisory)")
    ap.add_argument("--profile", action="store_true",
                    help="record repro_torch.dse.batched per-phase wall times "
                         "(table build / DP / reconstruct / SMOF / score) "
                         "for each batched-engine run")
    ap.add_argument("--out", default=os.path.join("build", "BENCH_dse.json"),
                    help="artifact path")
    args = ap.parse_args()
    PROFILE_PHASES = args.profile

    cases = ci_cases() if args.ci else full_cases()
    ok = all(c["gate_zero_codegen"] and c["gate_one_analysis_per_graph"]
             and c["gate_batched_equal"] for c in cases)
    report = {
        "mode": "ci" if args.ci else "full",
        "cases": cases,
        "min_speedup": min(c["speedup"] for c in cases),
        "min_speedup_batched_vs_scalar": min(
            c["speedup_batched_vs_scalar"] for c in cases
            if not c["name"].startswith("incremental.")),
        "ok": ok,
    }
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=2)
    for c in cases:
        gates = "ok" if (c["gate_zero_codegen"]
                         and c["gate_one_analysis_per_graph"]
                         and c["gate_batched_equal"]) else "FAIL"
        line = (f"{c['name']:44s} batched={c['wall_batched_s']:7.3f}s "
                f"scalar={c['wall_scalar_s']:7.3f}s "
                f"ref={c['wall_ref_s']:7.3f}s "
                f"x_scalar={c['speedup_batched_vs_scalar']:5.1f} "
                f"equal={int(c['equal'])} {gates}")
        if "incremental_ratio" in c:
            line += f" inc_ratio={c['incremental_ratio']:.2f}"
        print(line)
    print(f"min_speedup={report['min_speedup']:.1f}x "
          f"min_batched_vs_scalar="
          f"{report['min_speedup_batched_vs_scalar']:.1f}x -> {args.out}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
