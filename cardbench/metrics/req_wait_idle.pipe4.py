"""req_wait_idle.pipe4: the share of a traced call in which a card runs
nothing while its host waits in the executor's ``pipeline.WAIT_REQ`` span,
averaged over the ranks' cards, in %: the idle gaps put down to that span
(``trace.py``; ``combine`` sums them over the ranks and averages the
window). None where the program opens no ``pipeline.`` span."""


def read(record: dict):
    gaps = record.get("trace", {}).get("gaps", {})
    if not any(name.startswith("pipeline.") for name in gaps):
        return None
    return 100.0 * gaps.get("pipeline.WAIT_REQ", 0.0) / (
        record["trace"]["window_s"] * record["chips"])
