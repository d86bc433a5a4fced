"""Fault-tolerant serving: inject -> detect -> quarantine -> replan -> replay.

A seeded hardware fault (here: a PU that silently stops decoding
mid-round) is injected into the simulated array while the
:class:`repro_torch.serve.Server` is serving two tenants. The watchdog
(:class:`repro_torch.faults.Watchdog`) converts the silent hang into structured
:class:`~repro_torch.faults.FaultReport` diagnostics naming the exact PU,
instruction and starved sync channel; the server then quarantines the
suspect PU, re-places the surviving tenants over the masked array
(``plan_placement(available=...)`` — byte-equal to a from-scratch
exploration of the degraded budget), hot-swaps the degraded deployment
onto the unchanged machine, and replays every interrupted decode session
from its last completed window's K/V append cursor. The run is fully
deterministic: same schedule, same event log.

The twin of the JAX package's ``examples/fault_tolerant_serving.py``, with its
arguments and printed lines. It is host code over the port's serving
control plane, fault package, deploy layer and simulator copy and
touches no tensor, so it takes no ``--device``.

    PYTHONPATH=src python -m repro_torch.examples.fault_tolerant_serving          # full
    PYTHONPATH=src python -m repro_torch.examples.fault_tolerant_serving --small  # CI smoke
"""
import argparse

from repro_torch.faults import FaultSchedule, PUHang
from repro_torch.serve import SLO, Request, Server


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--small", action="store_true",
                    help="tiny depths + short requests (CI smoke mode)")
    args = ap.parse_args()
    depth, window = (1, 4) if args.small else (2, 8)
    scale = 1 if args.small else 2

    srv = Server()
    srv.join("chat", args.arch, depth=depth, max_slots=2, window=window,
             slo=SLO(priority=1))
    srv.join("batch", args.arch, depth=depth, max_slots=1, window=window)
    for prompt, new in ((8, 6 * scale), (4, 10 * scale)):
        srv.submit(Request("chat", prompt_tokens=prompt, max_new_tokens=new))
    srv.submit(Request("batch", prompt_tokens=6, max_new_tokens=8 * scale))

    # One clean window to learn the placement, then hang a PU it uses.
    srv.step()
    target = srv.system.deployment.members[0].pids[-1]
    print(f"window 1 clean; injecting a hang at pu{target} "
          f"(mid-round, cycle 2000)")
    srv.inject(FaultSchedule(faults=(PUHang(pid=target, at_cycle=2000.0),)))

    report = srv.drain()

    print(f"\n{report}\n")
    print("fault diagnostics:")
    for r in srv.faults:
        print(f"  {r}")
    print("\nevent log (fault-tolerance path):")
    for e in srv.events:
        if e.kind in ("inject", "fault", "quarantine", "replay", "shed",
                      "replan"):
            print(f"  {e}")

    completed = sum(r.completed for r in srv.requests)
    survivors = sum(1 for r in srv.requests if not r.evicted)
    print(f"\n{completed}/{len(srv.requests)} requests completed over "
          f"{srv.windows} windows; quarantined PUs: "
          f"{sorted(srv.quarantined) or 'none'}; "
          f"{len(srv.faults)} fault reports")
    if not srv.faults:
        raise SystemExit("fault was not detected")
    if target not in srv.quarantined:
        raise SystemExit(f"pu{target} was not quarantined")
    if completed != survivors:
        raise SystemExit(
            "not all surviving requests completed on the degraded array")


if __name__ == "__main__":
    main()
