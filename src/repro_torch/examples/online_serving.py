"""Online serving: continuous batching, elastic tenancy and SLO-driven
re-placement on one fixed machine.

The :class:`repro_torch.serve.Server` takes the paper's runtime strategy
switching online. Tenants join and leave while the system serves; their
admitted requests become decode sessions *continuously batched* into
slot-packed members — several sessions at different K/V cache depths share
one member, each with its own AddrLen length stream — and every membership
change (or sustained SLO violation) triggers an incremental re-placement
(``explore_multi(prev=...)``) whose result hot-swaps onto the running
:class:`repro_torch.deploy.System` with no reconfiguration. Virtual time comes
from the simulator, so the whole run is deterministic.

The twin of the JAX package's ``examples/online_serving.py``, with its
arguments and printed lines. It is host code over the port's serving
control plane, fault package, deploy layer and simulator copy and
touches no tensor, so it takes no ``--device``.

    PYTHONPATH=src python -m repro_torch.examples.online_serving          # full
    PYTHONPATH=src python -m repro_torch.examples.online_serving --small  # CI smoke
"""
import argparse

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

    # --- two tenants with different service classes -------------------------
    srv.join("chat", args.arch, depth=depth, max_slots=2, window=window,
             slo=SLO(min_tokens_per_s=50.0, priority=1))
    srv.join("batch", args.arch, depth=depth, max_slots=2, window=window)
    for prompt, new in ((64, 6 * scale), (32, 10 * scale), (48, 4 * scale)):
        srv.submit(Request("chat", prompt_tokens=prompt, max_new_tokens=new))
    srv.submit(Request("batch", prompt_tokens=128, max_new_tokens=8 * scale))

    srv.step()  # one serving window: chat packs 2 sessions, batch runs 1
    placed = next(e for e in srv.events if e.kind == "replan")
    print(f"after window 1: t={srv.now * 1e3:.3f} ms, placement {placed.detail}")

    # --- a third tenant joins mid-service -> incremental re-placement -------
    srv.join("burst", args.arch, depth=depth, max_slots=1, window=window)
    srv.submit(Request("burst", prompt_tokens=16, max_new_tokens=4 * scale,
                       arrival_s=srv.now))

    report = srv.drain()

    print(f"\n{report}\n")
    print("event log:")
    for e in srv.events:
        print(f"  {e}")

    completed = sum(r.completed for r in srv.requests)
    replans = sum(e.kind == "replan" for e in srv.events)
    print(f"\n{completed}/{len(srv.requests)} requests completed over "
          f"{srv.windows} windows ({replans} placements, "
          f"{sum(e.kind == 'swap' for e in srv.events)} program swaps, "
          f"0 reconfigurations)")
    if completed != len(srv.requests):
        raise SystemExit("not all requests completed")


if __name__ == "__main__":
    main()
