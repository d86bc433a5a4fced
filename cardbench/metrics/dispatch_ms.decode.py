"""dispatch_ms.decode: the median host time from a serve-step call to its
return, before the step's tokens are read (which waits for the card)."""
import numpy as np


def read(record: dict):
    if "dispatch_s" not in record:
        return None
    return float(np.median(record["dispatch_s"])) * 1e3
