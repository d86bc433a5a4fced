"""The device time under the program's spans in a ``torch.profiler`` window,
beside ``trace.py``'s reduction (which drops the spans' device annotations).

While the profiler records, a span (``runtime/spans.py``) is a
``record_function``, and the profiler lays a user annotation of the same
name on the device's timeline over the operations launched inside it. The
time a span's annotations hold is the union of the device's operations
(NCCL's waiting kernels and other annotations not counted) clipped to the
union of those annotations and to the window of the profiler's steps.
"""
from __future__ import annotations

from . import trace


def _overlap(a: list[tuple[float, float]], b: list[tuple[float, float]]) -> float:
    """Length of the intersection of two sorted lists of disjoint intervals."""
    i = j = 0
    total = 0.0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        total += max(0.0, hi - lo)
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def span_seconds(events, names) -> dict[str, float]:
    """Device seconds under each of ``names``'s annotations, from the
    profiler's ``events()``; a name with no annotation is left out."""
    from torch.autograd import DeviceType

    steps, dev, spans = [], [], {n: [] for n in names}
    for e in events:
        iv = (e.time_range.start, e.time_range.end)
        if e.device_type == DeviceType.CUDA:
            if getattr(e, "is_user_annotation", False):
                if e.name in spans:
                    spans[e.name].append(iv)
            elif not e.name.startswith(("nccl:", "ProfilerStep") + trace.WAITING):
                dev.append(iv)
        elif e.name.startswith("ProfilerStep"):
            steps.append(iv)
    if not steps:
        return {}
    lo, hi = min(s for s, _ in steps), max(e for _, e in steps)
    busy = trace._merge([(max(s, lo), min(e, hi)) for s, e in dev if e > lo and s < hi])
    return {n: _overlap(busy, trace._merge(iv)) * 1e-6 for n, iv in spans.items() if iv}


def profiler(n_active: int, done: list, names=()):
    """``trace.profiler``'s window (one warm-up step, then ``n_active``
    recorded ones), summarised into ``done`` with ``spans``: the device
    seconds under each of ``names``."""
    from torch.profiler import ProfilerActivity, profile, schedule

    def ready(p):
        events = p.events()
        done.append({**trace.summarize(events), "spans": span_seconds(events, names)})

    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                   schedule=schedule(wait=0, warmup=1, active=n_active), on_trace_ready=ready)
