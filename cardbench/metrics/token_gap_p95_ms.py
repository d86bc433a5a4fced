"""token_gap_p95_ms: the 95th percentile (numpy's linear rule) of every gap
between a lane's consecutive tokens in the window, as the host received them."""
import numpy as np


def read(record: dict):
    if "token_gaps_s" not in record:
        return None
    gaps = np.repeat(np.asarray(record["token_gaps_s"]), record["lanes"])
    return float(np.percentile(gaps, 95)) * 1e3
