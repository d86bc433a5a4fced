"""ack_wait_idle.pipe4: the share of a traced call in which a card runs
nothing while its host waits in the executor's ``pipeline.WAIT_ACK`` span
(in a round, or for the last ACKs at the call's end), averaged over the
ranks' cards, in %: the idle gaps put down to that span (``trace.py``;
``combine`` sums them over the ranks and averages the window). None where
the program opens no ``pipeline.`` span."""


def read(record: dict):
    gaps = record.get("trace", {}).get("gaps", {})
    if not any(name.startswith("pipeline.") for name in gaps):
        return None
    return 100.0 * gaps.get("pipeline.WAIT_ACK", 0.0) / (
        record["trace"]["window_s"] * record["chips"])
