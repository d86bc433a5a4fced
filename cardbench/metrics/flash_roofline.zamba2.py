"""flash_roofline.zamba2: the attention kernel's least time over its device
time in the traced calls, in % (``hybrid_roofline.flash_least_s``: every
launch is one shared call's causal attention, 32 heads of 224, over the
call's batch x seq_len)."""
from cardbench.readers import hybrid_flash_roofline as read  # noqa: F401
