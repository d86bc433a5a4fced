"""bubble_share.pipe4: 1 - the stages' Compute time (the program's own CUDA
events around each stage's Compute instruction, ``stage_ms``) over stages x
the calls' wall (barrier to barrier, host clock), over the window's calls, in %."""


def read(record: dict):
    stage_ms = record.get("stage_ms")
    if not stage_ms or not any(any(call) for call in stage_ms[0]):
        return None  # no card, no CUDA events
    compute_s = sum(ms for rank in stage_ms for call in rank for ms in call) * 1e-3
    return 100.0 * (1.0 - compute_s / (len(stage_ms) * sum(record["call_s"])))
