"""idle_share.decode: the share of an untraced decode step in which the card
runs nothing, in %: 1 - the card's busy time a traced step (``trace.py``)
over the window's mean step time. The profiler slows the host's dispatch of
a step about twofold, so the traced window's own idle share would read the
profiler; the card's busy time a step it does not change."""


def read(record: dict):
    tr = record.get("trace")
    if not tr or not record.get("token_gaps_s"):
        return None
    step_s = record["window_s"] / len(record["token_gaps_s"])
    return 100.0 * (1.0 - tr["busy_s"] / tr["steps"] / step_s)
