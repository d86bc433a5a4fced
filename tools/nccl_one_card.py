#!/usr/bin/env python3
"""Whether NCCL takes two ranks on one card: two processes on ``cuda:0``
join an NCCL process group and rank 0 sends rank 1 a tensor. Prints what
each rank saw (the value received, or the error NCCL gave) and the card.

    python3 tools/nccl_one_card.py

The port's executor across processes runs its ranks on one card over gloo
(``repro_torch.runtime.pipeline_ranks``) and takes NCCL only with one card a
rank; this records why. Each rank is bounded by ``TIMEOUT_S``: a rank still
running then is killed and reported as hung.
"""
import os
import subprocess
import sys
import tempfile
import traceback
from datetime import timedelta

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

TIMEOUT_S = 120


def _rank(rank: int, init: str, results) -> None:
    try:
        torch.cuda.set_device(0)
        dist.init_process_group("nccl", init_method=init, rank=rank, world_size=2,
                                timeout=timedelta(seconds=TIMEOUT_S // 2))
        x = torch.full((4,), 7.0, device="cuda:0") if rank == 0 else torch.zeros(4, device="cuda:0")
        if rank == 0:
            dist.send(x, 1)
        else:
            dist.recv(x, 0)
        torch.cuda.synchronize()
        results.put((rank, f"ok, holds {x.tolist()}"))
        dist.destroy_process_group()
    except Exception:  # the point of the probe: report what NCCL raised
        results.put((rank, "raised: " + traceback.format_exc(limit=2).strip()[-1500:]))


def main() -> int:
    if not torch.cuda.is_available():
        print("nccl_one_card: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"card: {card}; torch {torch.__version__}, cuda {torch.version.cuda}, nccl "
          f"{'.'.join(map(str, torch.cuda.nccl.version()))}")
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory() as tmp:
        init = "file://" + os.path.join(tmp, "rendezvous")
        procs = [ctx.Process(target=_rank, args=(r, init, results), daemon=True) for r in (0, 1)]
        for p in procs:
            p.start()
        seen = {}
        for _ in procs:
            try:
                rank, what = results.get(timeout=TIMEOUT_S)
                seen[rank] = what
            except Exception:  # queue.Empty: a rank neither finished nor raised
                break
        for p in procs:
            p.join(10)
            if p.is_alive():
                p.kill()
                p.join(10)
    for rank in (0, 1):
        print(f"rank {rank} (cuda:0): {seen.get(rank, f'hung: no report in {TIMEOUT_S} s')}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
