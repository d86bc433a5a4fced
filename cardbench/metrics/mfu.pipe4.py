"""mfu.pipe4: the model operations of the window's calls over the window x
the cards x the peak (``roofline.prefill_flops``, 495 TFLOP/s), in %."""
from cardbench import roofline
from cardbench.model_config import dims


def read(record: dict):
    if "calls" not in record or "traffic" not in record:
        return None
    d, tr = dims(record["config"]), record["traffic"]
    flops = record["calls"] * tr["microbatches"] * roofline.prefill_flops(
        d, tr["microbatch_size"], tr["seq_len"])
    return 100.0 * flops / (record["window_s"] * record["chips"] * roofline.PEAK_FLOPS)
