"""Named spans at the port's layer boundaries, for a torch profiler.

``span(name)`` is a context manager. While a torch profiler records, it is
``torch.profiler.record_function(name)``: the range lands on the trace's own
clock beside the device's operations, so the card's idle gaps under it can be
put down to it by name. Otherwise it is one shared null context, and the only
cost is one read of the profiler's own enabled flag: no allocation, no
dispatcher call.

Names are fixed strings (``pipeline.WAIT_REQ``, ``serve.step``): the round,
the BID and the rank stay out of them, so a profile sums a span over those.
"""
from __future__ import annotations

import contextlib

import torch
from torch.autograd import profiler as _profiler

_OFF = contextlib.nullcontext()


def span(name: str):
    """``record_function(name)`` while a profiler records, else a shared
    null context."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return torch.profiler.record_function(name)
