#!/usr/bin/env python3
"""Time the SSD-scan and wkv6 kernels against variants of their own sources,
on one NVIDIA card.

    python3 tools/scan_variants.py [--kernels ssd_scan,wkv6] [--variants committed,...]
                                   [--baseline DIR]

Each variant is a kernel's ``csrc/*.cu`` with textual changes (``VARIANTS``),
built with the port's nvcc flags into ``build/scan_variants/`` and called
through its C entry point, or the committed source under another plan
(``PLANS``: columns a block, threads a column, tile steps; a ring depth
other than the sources' ``STAGES`` is a textual variant). ``loads_only``
replaces the recurrence by a trivial use of each staged tile;
``compute_only`` stages the first tile of each ring slot only and runs the
recurrence on it for every tile. ``--baseline DIR`` adds the sources found
under ``DIR`` (a checkout of another commit with the same C entry points,
e.g. ``git archive <rev> src | tar -x -C DIR``), named ``base:<variant>``.

The committed source (and the baseline's) is checked against the plain
version first; then every variant is timed at each main-path shape, all
variants in turn and then again in reverse order: the SSD scan at the
zamba2-7b prefill (b 4, s 1024, H 112, P 64, N 64), wkv6 at the rwkv6-7b
prefill (b 4, s 1024, H 64, P 64) with CUDA events around launches, and at
its decode step (b 1, s 1, state in place) as device time from a CUDA graph.
The last line is a JSON object with every number.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import chip_smoke as smoke  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.rwkv6 import kernel as wk  # noqa: E402
from repro_torch.kernels.rwkv6.ref import wkv6_reference  # noqa: E402
from repro_torch.kernels.ssd_scan import kernel as sk  # noqa: E402
from repro_torch.kernels.ssd_scan.ref import ssd_reference  # noqa: E402

REL = {"ssd_scan": "src/repro_torch/kernels/ssd_scan/csrc/ssd_scan.cu",
       "wkv6": "src/repro_torch/kernels/rwkv6/csrc/wkv6.cu"}
# (label, shape, timing): the main-path shapes of each kernel
SHAPES = {
    "ssd_scan": [("prefill", (4, 1024, 112, 64, 64), "events")],
    "wkv6": [("prefill", (4, 1024, 64, 64), "events"), ("decode", (1, 1, 64, 64), "graph")],
}

# the head of each source's step function: loads_only returns at once
_SSD_STEP = "const float4* C4, float (&yo)[CPT]) {\n"
_WKV_STEP = "const float (&vj)[CPT], float (&part)[CPT]) {\n"
_LOAD = "  auto load = [&](int tile) {\n"
_PAIRS = "    for (; tt + 2 <= nt; tt += 2, yp += 2 * step) {\n"
_STAGES = "constexpr int STAGES = 2;"
# (columns a block, threads a column, columns a thread) at P = 64 that the
# committed sources do not instantiate, timed as plans of their own
_ALT_SSD = [(32, 2, 1), (32, 4, 2), (32, 4, 4), (32, 8, 4), (64, 2, 2), (64, 4, 4)]
_ALT_WKV = [(32, 2, 2), (32, 4, 4), (32, 8, 4), (32, 4, 2), (64, 2, 2), (64, 8, 4), (32, 2, 1),
            (16, 4, 1), (64, 2, 1), (64, 4, 2), (64, 8, 2)]
_SSD_LINE = "  SSD_CASE(64, 2, 32, 2)  // zamba2-7b (P 64)\n"
_WKV_LINE = "  WKV_CASE(64, 2, 16, 1)  // rwkv6-7b decode: 256 blocks at b 1\n"
# ring depths other than the sources' 2, each a textual variant
_DEPTHS = (3, 4)
# kernel -> name -> [(old text, new text), ...]; a trivial use of a tile
# keeps y's stores, so only the recurrence's arithmetic goes
VARIANTS = {
    "ssd_scan": {
        "committed": [],
        "loads_only": [(_SSD_STEP, _SSD_STEP + (
            "  for (int c = 0; c < CPT; ++c) yo[c] = decay + u[c] + B4[0].x + C4[0].y;\n"
            "  return;\n"))],
        # each ring slot is filled once, by the first STAGES tiles
        "compute_only": [(_LOAD, _LOAD + "    if (tile >= STAGES) return;\n")],
        # four steps an iteration: the compiler unrolls two pairs
        "unroll2": [(_PAIRS, "#pragma unroll 2\n" + _PAIRS)],
        # each step's y sums meet as soon as it ends, as wkv6's do
        "step_scatter": [
            ("ya);\n      ssd_step<NQ, R, CPT>(h, sdec[tt + 1]",
             "ya);\n      scatter_sum<R, CPT, WMASK>(ya, r);\n"
             "      ssd_step<NQ, R, CPT>(h, sdec[tt + 1]"),
            ("""#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        v[c] = ya[c];
        v[CPT + c] = yc[c];
      }
      scatter_sum<R, 2 * CPT, WMASK>(v, r);
      store_sums<R, 2 * CPT, CPT>(yp, step, v, r);
""", """      scatter_sum<R, CPT, WMASK>(yc, r);
      store_sums<R, CPT, CPT>(yp, step, ya, r);
      store_sums<R, CPT, CPT>(yp + step, step, yc, r);
""")],
        # the other plans PLANS names, instantiated beside the committed ones
        "alt": [(_SSD_LINE, _SSD_LINE + "".join(
            f"  SSD_CASE(64, {r}, {pc}, {c})\n" for pc, r, c in _ALT_SSD))],
    },
    "wkv6": {
        "committed": [],
        "loads_only": [(_WKV_STEP, _WKV_STEP + (
            "  for (int c = 0; c < CPT; ++c) part[c] = r4[0].x + k4[0].y + w4[0].z + vj[c];\n"
            "  return;\n"))],
        "compute_only": [(_LOAD, _LOAD + "    if (tile >= STAGES) return;\n")],
        "unroll2": [(_PAIRS, "#pragma unroll 2\n" + _PAIRS)],
        # the pair's y sums meet in one scatter after both steps, as the SSD
        # scan's do
        "one_scatter": [("""      float va[CPT], vc[CPT], pa[CPT], pb[CPT];
""", """      float va[CPT], vc[CPT], pa[CPT], pb[CPT], x[2 * CPT];
"""), ("""      scatter_sum<R, CPT, WMASK>(pa, ri);
      wkv_step<NQ, R, CPT>(S, r4 + b, k4 + b, w4 + b, vc, pb);
      scatter_sum<R, CPT, WMASK>(pb, ri);
      store_sums<R, CPT, CPT, PC>(yp, step, pa, vs + tt * PC, sruk + tt, ri);
      store_sums<R, CPT, CPT, PC>(yp + step, step, pb, vs + (tt + 1) * PC, sruk + tt + 1, ri);
""", """      wkv_step<NQ, R, CPT>(S, r4 + b, k4 + b, w4 + b, vc, pb);
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        x[c] = pa[c];
        x[CPT + c] = pb[c];
      }
      scatter_sum<R, 2 * CPT, WMASK>(x, ri);
      store_sums<R, 2 * CPT, CPT, PC>(yp, step, x, vs + tt * PC, sruk + tt, ri);
""")],
        "alt": [(_WKV_LINE, _WKV_LINE + "".join(
            f"  WKV_CASE(64, {r}, {pc}, {c})\n" for pc, r, c in _ALT_WKV))],
    },
}
for _table in VARIANTS.values():
    _table.update({f"stages{n}": [(_STAGES, f"constexpr int STAGES = {n};")] for n in _DEPTHS})
# kernel -> name -> (source variant, plan overrides): pcX_rY_cZ is X columns
# a block, Y threads a column and Z columns a thread at P = 64; stagesN_chunkC
# a ring of N slots of C steps
PLANS = {
    kernel: {
        **{f"pc{pc}_r{r}_c{c}": ("alt" if (pc, r, c) in alt else "committed",
                                 {"pc": pc, "r": r, "cpt": c})
           for pc, r, c in alt + committed},
        **{f"stages{n}_chunk{c}": ("committed" if n == 2 else f"stages{n}", {"chunk": c})
           for n, c in ((2, 16), (2, 24), (2, 32), (2, 48), (3, 16), (3, 32), (4, 16))},
    }
    for kernel, alt, committed in (("ssd_scan", _ALT_SSD, [(32, 2, 2)]),
                                   ("wkv6", _ALT_WKV, [(64, 4, 4), (16, 2, 1)]))
}


def build(kernel: str, src: Path, names: list[str], prefix: str) -> dict:
    """``prefix + name`` -> (entry point, plan overrides) for each variant
    or plan in ``names`` of the source ``src``."""
    text = src.read_text()
    table, plans = VARIANTS[kernel], PLANS[kernel]
    want = {n: plans.get(n, (n, {})) for n in names}
    out_dir = _build.BUILD_DIR.parent / "scan_variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    paths = {}
    for name in {v for v, _ in want.values()}:
        if name not in table:
            raise KeyError(f"{kernel}: no variant {name!r} (has {sorted(table) + sorted(plans)})")
        body = text
        for old, new in table[name]:
            if body.count(old) != 1:
                raise RuntimeError(f"variant {name!r}: {old!r} is not once in {src}")
            body = body.replace(old, new)
        path = out_dir / f"{kernel}_{prefix.strip(':') or 'head'}_{name}.cu"
        path.write_text(body)
        paths[name] = path
    built = _build.build({f"{kernel}:{prefix}{n}": p for n, p in paths.items()})
    entry = "ssd_scan_fwd" if kernel == "ssd_scan" else "wkv6_fwd"
    p, i = ctypes.c_void_p, ctypes.c_int
    # pointers, then (b, s, H, P[, N], pc, r, cpt, chunk), then the stream
    n_ptrs, n_ints = (7, 9) if kernel == "ssd_scan" else (8, 8)
    fns = {}
    for name in paths:
        fn = getattr(ctypes.CDLL(str(built[f"{kernel}:{prefix}{name}"].path)), entry)
        fn.argtypes = [p] * n_ptrs + [i] * n_ints + [p]
        fn.restype = i
        fns[name] = fn
    return {prefix + n: (fns[v], over) for n, (v, over) in want.items()}


def call(kernel: str, variant, args, state_out=None):
    """One launch of a variant; returns (y, final state)."""
    fn, over = variant
    stream = torch.cuda.current_stream().cuda_stream
    if kernel == "ssd_scan":
        xh, dt, A, B, C = args
        b, s, H, P = xh.shape
        N = B.shape[-1]
        y = torch.empty_like(xh)
        h = torch.empty((b, H, N, P), dtype=torch.float32, device=xh.device)
        ptrs = [a.data_ptr() for a in (xh, dt, A, B, C, y, h)]
        plan = {**sk.plan(P, N, s), **over}
        err = fn(*ptrs, b, s, H, P, N, plan["pc"], plan["r"], plan["cpt"], plan["chunk"], stream)
        out = (y, h)
    else:
        r, k, v, w, u, state = args
        b, s, H, P = r.shape
        y = torch.empty_like(r)
        so = torch.empty_like(state) if state_out is None else state_out
        ptrs = [a.data_ptr() for a in (r, k, v, w, u, state, y, so)]
        plan = {**wk.plan(b, s, H, P), **over}
        err = fn(*ptrs, b, s, H, P, plan["pc"], plan["r"], plan["cpt"], plan["chunk"], stream)
        out = (y, so)
    if err:
        raise RuntimeError(f"{kernel} launch failed: error {err}")
    return out


def inputs(kernel: str, shape, seed: int):
    if kernel == "ssd_scan":
        return smoke.ssd_inputs(*shape, seed=seed)
    state_scale = 0.5 if shape[1] == 1 else 0.0
    return smoke.wkv6_inputs(*shape, seed=seed, state_scale=state_scale, model_decay=True)


def check(kernel: str, variants: dict) -> None:
    """Each committed source and each plan against the plain version at a
    ragged shape (the variants that drop work are not checked)."""
    shape = (2, 100, 4, 64, 64) if kernel == "ssd_scan" else (2, 100, 4, 64)
    args = inputs(kernel, shape, seed=7)
    want = (ssd_reference if kernel == "ssd_scan" else wkv6_reference)(*args)
    for name, var in variants.items():
        if name.split(":")[-1] in ("loads_only", "compute_only"):
            continue
        got = call(kernel, var, args)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, rtol=2e-4, atol=2e-4)
        print(f"check {kernel} {name}: max_abs_err {smoke.max_err(got, want):.3e} at {shape}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernels", default="ssd_scan,wkv6")
    ap.add_argument("--variants", default="committed,loads_only,compute_only",
                    help="comma-separated names of VARIANTS or PLANS, for every kernel that "
                         "has them")
    ap.add_argument("--baseline", type=Path, default=None,
                    help="a checkout of another commit whose sources are timed beside these")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("scan_variants: no CUDA device", file=sys.stderr)
        return 1
    card = smoke.card_line()
    print(f"card: {card}")
    wanted = args.variants.split(",")
    result = {"card": card}
    for kernel in args.kernels.split(","):
        variants = {}
        roots = [(ROOT, "")] + ([(args.baseline, "base:")] if args.baseline else [])
        for root, prefix in roots:
            have = (set(VARIANTS[kernel]) - {"alt"}) | set(PLANS[kernel])
            variants.update(build(kernel, root / REL[kernel], [n for n in wanted if n in have],
                                  prefix))
        check(kernel, variants)
        names = list(variants)
        result[kernel] = {}
        for label, shape, timing in SHAPES[kernel]:
            args_ = inputs(kernel, shape, seed=smoke.SEED + 5)
            times = {n: [] for n in names}
            for order in (names, names[::-1]):
                for n in order:
                    if timing == "graph":  # the decode step: state written in place
                        state = args_[-1]
                        times[n].append(smoke.graph_ms(
                            lambda: call(kernel, variants[n], args_, state_out=state), 20))
                    else:
                        times[n].append(smoke.cuda_ms(
                            lambda: call(kernel, variants[n], args_), 20))
            result[kernel][label] = {"shape": shape, "timed": timing, "ms": times}
            print(f"{kernel} {label} {shape} ({timing}): " + ", ".join(
                f"{n} {t[0]:.4f} / {t[1]:.4f} ms" for n, t in times.items()) + f"  [{card}]")
            del args_
            torch.cuda.empty_cache()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
