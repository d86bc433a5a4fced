"""mfu.decode: the decode steps' least time over the window, in %: each
step's least time (``roofline.decode_step_least_s``: the weights, the cache
up to its position, at the data-sheet rates) summed over the window's steps."""
from cardbench import roofline
from cardbench.model_config import dims


def read(record: dict):
    if "step_positions" not in record:
        return None
    d = dims(record["config"])
    least = sum(roofline.decode_step_least_s(d, record["lanes"], p)
                for p in record["step_positions"])
    return 100.0 * least / record["window_s"]
