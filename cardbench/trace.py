"""Reading a ``torch.profiler`` window: device busy time (the union of the
device's operation intervals), time and count by operation, and the idle
gaps by what the host was doing in them. The interval arithmetic is that of
``chip_smoke.py``'s ``kernel_summary``, copied here and frozen.

The window is the span of the profiler's active steps (``ProfilerStep#n``
on the host): the caller synchronises the card before each ``prof.step()``,
so every operation of a step ends inside it. Annotations on the device's
timeline (``nccl:send 2->3``) repeat a kernel's interval and are dropped.
NCCL's kernels are listed but not counted as busy: a receive or a barrier's
all-reduce occupies the card while it waits for a peer.
"""
from __future__ import annotations

import bisect
from collections import defaultdict

TOP = 10  # entries of each breakdown list
WAITING = ("ncclDevKernel", "ncclKernel")  # kernels that spin until a peer is ready


def _merge(spans: list[tuple[float, float]]) -> list[tuple[float, float]]:
    merged: list[list[float]] = []
    for s, e in sorted(spans):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [(s, e) for s, e in merged]


def _top(seconds: dict) -> list:
    """The ``TOP`` largest entries of {name: seconds} as [name, seconds]."""
    return [[n[:120], v] for n, v in sorted(seconds.items(), key=lambda kv: -kv[1])[:TOP]]


def _host_op(starts: list, host: list, t: float) -> str:
    """The innermost host operation running at ``t``: of those that began
    before it, the latest one still running."""
    i = bisect.bisect_right(starts, t) - 1
    for j in range(i, max(-1, i - 400), -1):
        if host[j][1] >= t:
            return host[j][2]
    return "host code between operations"


def summarize(events) -> dict:
    """Busy and window seconds, ``kernels`` {name: [seconds, launches]},
    ``gaps`` {host operation: idle seconds}, and the top ``device_ops`` and
    ``idle_gaps`` as [name, seconds] lists, from the profiler's ``events()``."""
    from torch.autograd import DeviceType

    steps, dev, host = [], [], []
    for e in events:
        span = (e.time_range.start, e.time_range.end)
        if e.device_type == DeviceType.CUDA:
            if not (getattr(e, "is_user_annotation", False) or e.name.startswith(
                    ("nccl:", "ProfilerStep"))):
                dev.append((*span, e.name))
        elif e.name.startswith("ProfilerStep"):
            steps.append(span)
        else:
            host.append((*span, e.name))
    if not steps or not dev:
        raise RuntimeError("the profiler window recorded no step or no device operation")
    lo, hi = min(s for s, _ in steps), max(e for _, e in steps)
    dev = [(max(s, lo), min(e, hi), n) for s, e, n in dev if e > lo and s < hi]
    kernels: dict[str, list] = defaultdict(lambda: [0.0, 0])
    for s, e, n in dev:
        kernels[n][0] += (e - s) * 1e-6
        kernels[n][1] += 1
    merged = _merge([(s, e) for s, e, n in dev if not n.startswith(WAITING)])
    busy_us = sum(e - s for s, e in merged)
    host.sort()
    starts = [h[0] for h in host]
    gaps: dict[str, float] = defaultdict(float)
    edges = [lo] + [x for s, e in merged for x in (s, e)] + [hi]
    for g0, g1 in zip(edges[0::2], edges[1::2]):
        if g1 > g0:
            gaps[_host_op(starts, host, (g0 + g1) / 2)] += (g1 - g0) * 1e-6
    return {"busy_s": busy_us * 1e-6, "window_s": (hi - lo) * 1e-6,
            "kernels": dict(kernels), "gaps": dict(gaps),
            "device_ops": _top({n: v[0] for n, v in kernels.items()}), "idle_gaps": _top(gaps)}


def profiler(n_active: int, done: list):
    """A profiler of CPU and CUDA activity: one warm-up step, then
    ``n_active`` recorded steps, summarised into ``done``."""
    from torch.profiler import ProfilerActivity, profile, schedule

    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                   schedule=schedule(wait=0, warmup=1, active=n_active),
                   on_trace_ready=lambda p: done.append(summarize(p.events())))


def combine(ranks: list[dict]) -> dict:
    """The ranks' windows as one: busy and window seconds averaged over the
    ranks, kernels and breakdown lists summed by name."""
    n = len(ranks)
    kernels: dict[str, list] = defaultdict(lambda: [0.0, 0])
    gaps: dict[str, float] = defaultdict(float)
    for r in ranks:
        for name, (sec, count) in r["kernels"].items():
            kernels[name][0] += sec
            kernels[name][1] += count
        for name, sec in r["gaps"].items():
            gaps[name] += sec
    return {"busy_s": sum(r["busy_s"] for r in ranks) / n,
            "window_s": sum(r["window_s"] for r in ranks) / n,
            "kernels": dict(kernels), "gaps": dict(gaps),
            "device_ops": _top({n: v[0] for n, v in kernels.items()}), "idle_gaps": _top(gaps)}
