#!/usr/bin/env python3
"""Time the column-major INT8 PU GEMM kernel against variants of its own
source, on one NVIDIA card.

    python3 tools/gemm_variants.py [--variants committed,8_stages,...]

Each variant is ``src/repro_torch/kernels/gemm_int8/csrc/gemm_int8.cu`` with
textual changes (``VARIANTS``), built with the port's nvcc flags into
``build/kernels/`` and called through its ``gemm_int8_kmajor_fwd`` with the
wrapper's own plan (``block_n``, ``split_k``), or the committed source with
another choice of ``block_n`` (``PLANS``). Every variant is checked bit
for bit against the plain version at a ragged and a split shape, then timed
as device time from CUDA graphs: at ``chip_smoke.GEMM_TIMED``, and over
ResNet-50's 54 GEMMs at batch 1 and 16 (each node its own operands, w
column-major), all variants in turn and then again in reverse order; then
each of the 22 GEMM shapes alone at each batch (operands L2-warm), one line
a batch. The last line is a JSON object with every number.
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
from repro_torch.kernels.gemm_int8 import kernel as gk  # noqa: E402
from repro_torch.kernels.gemm_int8.ref import gemm_int8_reference  # noqa: E402

_TRIGGER = '  if (PDL) asm volatile("griddepcontrol.launch_dependents;\\n" ::: "memory");\n'
_LAST = "  if (S > 1) cluster.sync();  // no block leaves while another reads its shared memory\n"
# name -> [(old text, new text), ...]
VARIANTS = {
    "committed": [],
    "3_stages": [("constexpr int STAGES = 4;", "constexpr int STAGES = 3;")],
    "6_stages": [("constexpr int STAGES = 4;", "constexpr int STAGES = 6;")],
    "8_stages": [("constexpr int STAGES = 4;", "constexpr int STAGES = 8;")],
    "no_pdl": [("constexpr bool PDL = true;", "constexpr bool PDL = false;")],
    # programmatic dependent launch on every grid, not only one-wave grids
    "pdl_all": [("if (PDL && (long long)g.x * g.y * g.z <= sms)", "if (PDL)")],
    # the next kernel let in when a block is done, not after its main loop
    "late_trigger": [(_TRIGGER, ""), (_LAST, _LAST + _TRIGGER)],
    # 4 warps of 64 x 32 in the 128 x 64 block, not 8 of 32 x 32
    "n64_wm64": [("constexpr int WM_N64 = 32;", "constexpr int WM_N64 = 64;")],
    # 16 warps of 32 x 32 in the 128 x 128 block, not 8 of 64 x 32
    "n128_wm32": [("constexpr int WM_N128 = 64;", "constexpr int WM_N128 = 32;")],
    # ldmatrix without a memory clobber: the compiler may move it
    "ldsm_free": [('"r"(addr)\n               : "memory");', '"r"(addr));')],
    "bk128": [("constexpr int BK = 64;           // K bytes a tile",
               "constexpr int BK = 128;          // K bytes a tile")],
}
# name -> (block_n(M, N, sms), the most K slices) for the committed source
PLANS = {
    # 128 x 128 blocks wherever N > 64
    "bn128": (lambda M, N, sms: 128 if N > 64 else 64, gk.MAX_SPLITS),
    # 128 x 64 blocks everywhere
    "bn64": (lambda M, N, sms: 64, gk.MAX_SPLITS),
    # at most 4 or 2 K slices (clusters of 4 or 2 blocks)
    "splits4": (gk.block_n, 4),
    "splits2": (gk.block_n, 2),
}


def build(names: list[str]) -> dict:
    """name -> (entry point, block_n) for each variant or plan in ``names``."""
    src = gk.SOURCE.read_text()
    out_dir = _build.BUILD_DIR.parent / "gemm_variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    sources = {n for n in names if n in VARIANTS} | ({"committed"} & set(VARIANTS)
                                                      if set(names) & set(PLANS) else set())
    paths = {}
    for i, name in enumerate(sorted(sources)):
        text = src
        for old, new in VARIANTS[name]:
            if text.count(old) != 1:
                raise RuntimeError(f"variant {name!r}: {old!r} is not once in {gk.SOURCE.name}")
            text = text.replace(old, new)
        path = out_dir / f"gemm_variant{i}.cu"
        path.write_text(text)
        paths[name] = path
    built = _build.build(paths)
    entries = {}
    p, i = ctypes.c_void_p, ctypes.c_int
    for name in built:
        fn = ctypes.CDLL(str(built[name].path)).gemm_int8_kmajor_fwd
        fn.argtypes = [p, p, p, p, p, i, i, i, i, i, i, i, p]
        fn.restype = i
        entries[name] = fn
    return {n: (entries[n], gk.block_n, gk.MAX_SPLITS) if n in VARIANTS
            else (entries["committed"], *PLANS[n]) for n in names}


def _split_k(M, N, K, sms, block_n, max_splits):
    """``split_k`` under another ``block_n`` and cap."""
    blocks = gk._cdiv(M, gk.BM) * gk._cdiv(N, block_n(M, N, sms))
    if blocks >= sms:
        return 1
    return max(1, min(sms // blocks, gk._cdiv(K, gk.BK) // 2, max_splits))


def call(variant, a, w, b, res, shift, relu, sms):
    """The wrapper's column-major route through a variant's entry and plan."""
    fn, block_n, max_splits = variant
    (M, K), N = a.shape, w.shape[1]
    out = torch.empty((M, N), dtype=torch.int8, device=a.device)
    err = fn(a.data_ptr(), w.data_ptr(), b.data_ptr(), None if res is None else res.data_ptr(),
             out.data_ptr(), M, N, K, block_n(M, N, sms),
             _split_k(M, N, K, sms, block_n, max_splits),
             shift, int(relu), torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"launch failed: error {err}")
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variants", default=",".join(VARIANTS),
                    help="comma-separated names of VARIANTS to build and time")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("gemm_variants: no CUDA device", file=sys.stderr)
        return 1
    names = args.variants.split(",")
    card = smoke.card_line()
    print(f"card: {card}")
    fns = build(names)
    sms = gk.sm_count(torch.cuda.current_device())
    shift = smoke.RESNET50_SHIFT
    result = {"card": card, "timed": {}, "network": {}}

    for m, n, k, res in ((100, 72, 300, True), (256, 256, 2304, False)):
        a, w, b, r = smoke.gemm_inputs(m, n, k, seed=k, residual=res)
        want = gemm_int8_reference(a, w, b, shift=shift, relu=True, residual=r)
        for name, fn in fns.items():
            if not torch.equal(call(fn, a, smoke.col_major(w), b, r, shift, True, sms), want):
                raise AssertionError(f"variant {name!r} differs from the plain version at "
                                     f"{m}x{n}x{k}")
    print(f"check: every variant bit-equal at 100x72x300 (residual) and 256x256x2304 (S="
          f"{gk.split_k(256, 256, 2304, sms)})")

    name, batch = smoke.GEMM_TIMED
    _, m, n, k, relu, residual, _ = next(r for r in smoke.RESNET50_GEMMS if r[0] == name)
    a, w, b, r = smoke.gemm_inputs(batch * n, m, k, seed=smoke.SEED + 500, residual=residual)
    w = smoke.col_major(w)
    times = {v: [] for v in fns}
    for order in (names, names[::-1]):
        for v in order:
            times[v].append(smoke.graph_ms(lambda: call(fns[v], a, w, b, r, shift, relu, sms), 20))
    result["timed"] = times
    print(f"{name} batch {batch} (M={batch * n} N={m} K={k}): " + ", ".join(
        f"{v} {t[0]:.4f} / {t[1]:.4f} ms" for v, t in times.items()) + f"  [{card}]")
    del a, w, b, r

    for batch in smoke.RESNET50_BATCHES:
        layers = []
        for nm, m, n, k, relu, residual, count in smoke.RESNET50_GEMMS:
            for _ in range(count):
                a, w, b, r = smoke.gemm_inputs(batch * n, m, k,
                                               seed=smoke.SEED + 1000 + len(layers),
                                               residual=residual)
                layers.append((a, smoke.col_major(w), b, r, relu))
        times = {v: [] for v in fns}
        for order in (names, names[::-1]):
            for v in order:
                times[v].append(smoke.graph_ms(
                    lambda: [call(fns[v], a, w, b, r, shift, relu, sms)
                             for a, w, b, r, relu in layers], 1, replays=10))
        result["network"][batch] = times
        print(f"resnet50 @256 batch {batch}, 54 GEMMs as a CUDA graph: " + ", ".join(
            f"{v} {t[0]:.4f} / {t[1]:.4f} ms" for v, t in times.items()) + f"  [{card}]")
        del layers
        torch.cuda.empty_cache()
    result["shapes"] = {}
    for batch in smoke.RESNET50_BATCHES:
        rows = {}
        for i, (nm, m, n, k, relu, residual, _) in enumerate(smoke.RESNET50_GEMMS):
            a, w, b, r = smoke.gemm_inputs(batch * n, m, k, seed=smoke.SEED + 600 + i,
                                           residual=residual)
            w = smoke.col_major(w)
            rows[nm] = {v: smoke.graph_ms(lambda: call(fns[v], a, w, b, r, shift, relu, sms), 10)
                        for v in names}
        result["shapes"][batch] = rows
        print(f"per shape, batch {batch}, ms: {json.dumps(rows)}  [{card}]")
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
