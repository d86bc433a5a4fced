"""flash_roofline.prefill: the attention kernel's least time over its device
time in the traced calls, in % (``roofline.flash_least_s``: every launch
runs one layer over the call's batch x seq_len)."""
from cardbench.readers import dense_flash_roofline as read  # noqa: F401
