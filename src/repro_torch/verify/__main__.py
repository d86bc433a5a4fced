"""Command-line static verifier: ``python -m repro_torch.verify [model ...]``.

Compiles zoo models (or a curated sweep covering every model class when no
model is named) and runs the full static analyzer over the resulting
deployments, printing one summary line per target and every non-INFO
diagnostic. Exit status 1 if any target has error-severity diagnostics —
suitable as a blocking CI step (``--quick`` shrinks the models so the sweep
stays fast).

Examples::

    python -m repro_torch.verify                    # full zoo sweep
    python -m repro_torch.verify --quick            # CI-sized sweep
    python -m repro_torch.verify resnet50 --config 3 3
    python -m repro_torch.verify decoder --depth 2 --decode-steps 8 -v
    python -m repro_torch.verify multi              # multi-tenant pair
"""
from __future__ import annotations

import argparse
import sys
import time

from ..compiler import zoo
from ..deploy import Strategy, Workload, compile_deployment
from . import verify_deployment
from .report import Severity

MODELS = ("tiny_cnn", "resnet50", "vit", "encoder", "decoder", "packed",
          "multi")


def _target(name: str, args: argparse.Namespace):
    """Build ``(graph, strategy, rounds, label)`` for one verify target."""
    q = args.quick
    depth = args.depth if args.depth is not None else (2 if q else None)
    seq = args.seq_len if args.seq_len is not None else (64 if q else 256)
    if name == "tiny_cnn":
        g = zoo.tiny_cnn()
        cfg, rounds = (2, 1), 12
    elif name == "resnet50":
        hw = args.input_hw if args.input_hw is not None else (64 if q else 256)
        g = zoo.resnet50(input_hw=hw)
        cfg, rounds = (3, 3), 8
    elif name == "vit":
        hw = args.input_hw if args.input_hw is not None else (64 if q else 224)
        g = zoo.vit(input_hw=hw, depth=depth if depth is not None else 12)
        cfg, rounds = (2, 2), 8
    elif name == "encoder":
        g = zoo.transformer_encoder(seq_len=seq, depth=depth)
        cfg, rounds = (2, 2), 8
    elif name == "decoder":
        steps = args.decode_steps if args.decode_steps is not None else 8
        g = zoo.transformer_decoder(seq_len=seq, depth=depth,
                                    decode_steps=steps)
        cfg, rounds = (2, 2), None  # decode window defaults per member
    elif name == "packed":
        # slot-packed decode: three sessions at different cache depths in
        # one member — exercises the per-slot AddrLen streams and the
        # check_kv_streams hazard tier
        steps = args.decode_steps if args.decode_steps is not None else 8
        g = zoo.transformer_decoder(slots=(2 * seq, seq, seq // 2),
                                    depth=depth, decode_steps=steps)
        cfg, rounds = (2, 2), None
    elif name == "multi":
        strat = Strategy.tenants([
            (Workload(zoo.tiny_cnn(), "cnn"), 1, 1),
            (Workload(zoo.transformer_encoder(seq_len=seq, depth=depth or 2),
                      "enc"), 1, 1),
        ])
        return None, strat, 4, "multi[cnn+enc]"
    else:  # pragma: no cover - argparse choices guard this
        raise ValueError(f"unknown model {name!r}")
    if args.config:
        cfg = tuple(args.config)
    if args.rounds is not None:
        rounds = args.rounds
    label = f"{name}({cfg[0]},{cfg[1]})"
    return g, Strategy.single(*cfg), rounds, label


def main(argv: "list[str] | None" = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.verify",
        description="Static program verification over compiled zoo models.")
    ap.add_argument("models", nargs="*", choices=[[], *MODELS],
                    help=f"targets to verify (default: all of {', '.join(MODELS)})")
    ap.add_argument("--config", nargs=2, type=int, metavar=("A", "B"),
                    help="member config: A PU1x + B PU2x")
    ap.add_argument("--rounds", type=int, help="per-round loop count override")
    ap.add_argument("--input-hw", type=int, help="CNN/ViT input resolution")
    ap.add_argument("--seq-len", type=int, help="transformer sequence length")
    ap.add_argument("--depth", type=int, help="transformer/ViT block count")
    ap.add_argument("--decode-steps", type=int, help="decoder window length")
    ap.add_argument("--quick", action="store_true",
                    help="shrink models to CI-friendly sizes")
    ap.add_argument("-v", "--verbose", action="store_true",
                    help="print INFO diagnostics too")
    args = ap.parse_args(argv)

    names = args.models or list(MODELS)
    failures = 0
    for name in names:
        g, strat, rounds, label = _target(name, args)
        t0 = time.perf_counter()
        dep = compile_deployment(g, strat, rounds=rounds, verify=False)
        t1 = time.perf_counter()
        rep = verify_deployment(dep)
        t2 = time.perf_counter()
        n_inst = sum(len(grp.instructions) for m in dep.members
                     for p in m.compiled.programs
                     for grp in (p.ld, p.cp, p.st))
        status = "clean" if rep.ok else f"{len(rep.errors)} error(s)"
        print(f"{label:24s} {status:12s} {n_inst:6d} inst  "
              f"compile {t1 - t0:6.2f}s  verify {t2 - t1:6.2f}s")
        shown = (rep.diagnostics if args.verbose else
                 [d for d in rep.diagnostics
                  if d.severity is not Severity.INFO])
        for d in shown:
            print(f"    {d}")
        if not rep.ok:
            failures += 1
    if failures:
        print(f"FAILED: {failures}/{len(names)} target(s) with errors")
        return 1
    print(f"OK: {len(names)} target(s) verified clean")
    return 0


if __name__ == "__main__":
    sys.exit(main())
