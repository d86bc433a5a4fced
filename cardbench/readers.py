"""What the one-card prefill cells' per-layer metrics compute from a run's
record; each reader under ``metrics/`` is one of these. Every function
returns None where the record has nothing to read (an untraced run, or a
program without the span or kernel)."""
from __future__ import annotations

from cardbench import hybrid_roofline, roofline
from cardbench.hybrid import hybrid_dims
from cardbench.model_config import dims


def idle_share(record: dict):
    """The share of the traced calls' window in which the card runs nothing
    (``trace.py``), in %."""
    tr = record.get("trace")
    if not tr:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])


def _mfu(record: dict, flops_a_call):
    if "calls" not in record or "traffic" not in record:
        return None
    tr = record["traffic"]
    flops = record["calls"] * flops_a_call(record["config"], tr["batch"], tr["seq_len"])
    return 100.0 * flops / (record["window_s"] * roofline.PEAK_FLOPS)


def dense_mfu(record: dict):
    """The window's prefill operations (``roofline.prefill_flops``) over the
    window x the peak, in %."""
    return _mfu(record, lambda c, b, s: roofline.prefill_flops(dims(c), b, s))


def hybrid_mfu(record: dict):
    """The window's prefill operations (``hybrid_roofline.prefill_flops``)
    over the window x the peak, in %."""
    return _mfu(record, lambda c, b, s: hybrid_roofline.prefill_flops(hybrid_dims(c), b, s))


def _roofline(record: dict, kernel: str, least_s):
    """Launches x a launch's least time over the device time of the traced
    calls' kernels whose name holds ``kernel``, in %."""
    found = [v for name, v in record.get("trace", {}).get("kernels", {}).items()
             if kernel in name]
    if not found:
        return None
    tr = record["traffic"]
    seconds, launches = sum(v[0] for v in found), sum(v[1] for v in found)
    return 100.0 * launches * least_s(record["config"], tr["batch"], tr["seq_len"]) / seconds


def dense_flash_roofline(record: dict):
    """Flash against ``roofline.flash_least_s``: a launch is one layer over
    the call's batch x seq_len."""
    return _roofline(record, "flash_fwd_kernel",
                     lambda c, b, s: roofline.flash_least_s(dims(c), b, s))


def hybrid_flash_roofline(record: dict):
    """Flash against ``hybrid_roofline.flash_least_s``: a launch is one shared
    call's causal attention over the call's batch x seq_len."""
    return _roofline(record, "flash_fwd_kernel",
                     lambda c, b, s: hybrid_roofline.flash_least_s(hybrid_dims(c), b, s))


def ssd_roofline(record: dict):
    """The SSD scan against ``hybrid_roofline.ssd_least_s``: a launch scans
    one layer over the call's batch x seq_len."""
    return _roofline(record, "ssd_scan_kernel",
                     lambda c, b, s: hybrid_roofline.ssd_least_s(hybrid_dims(c), b, s))


def span_ms(record: dict, span: str):
    """The device's busy ms under the program's ``span`` a traced call
    (``span_trace.py``)."""
    spans = record.get("trace", {}).get("spans", {})
    if span not in spans:
        return None
    return 1e3 * spans[span] / record["trace"]["calls"]


def mamba_ms(record: dict):
    """``span_ms`` of ``hybrid.mamba``: the mamba layers of ``transformer.forward``."""
    return span_ms(record, "hybrid.mamba")


def shared_ms(record: dict):
    """``span_ms`` of ``hybrid.shared``: the shared calls of ``transformer.forward``."""
    return span_ms(record, "hybrid.shared")
