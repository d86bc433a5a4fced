"""flash_roofline.pipe4: the flash kernel's least time over its profiled
time, summed over the ranks' traced call, in % (``roofline.flash_least_s``:
every launch of the cell runs one microbatch through one layer)."""
from cardbench import roofline
from cardbench.model_config import dims


def read(record: dict):
    kernels = record.get("trace", {}).get("kernels", {})
    flash = [v for name, v in kernels.items() if "flash_fwd_kernel" in name]
    if not flash:
        return None
    d, tr = dims(record["config"]), record["traffic"]
    seconds, launches = sum(v[0] for v in flash), sum(v[1] for v in flash)
    return 100.0 * launches * roofline.flash_least_s(d, tr["microbatch_size"], tr["seq_len"]) / seconds
