"""idle_share.pipe4: the share of a traced call with no operation running
on a card (NCCL's waiting kernels not counted, ``trace.py``), averaged over
the ranks' cards, in %."""


def read(record: dict):
    tr = record.get("trace")
    if not tr:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
