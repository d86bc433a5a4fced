"""ssd_roofline.zamba2: the SSD-scan kernel's least time over its device time
in the traced calls, in % (``hybrid_roofline.ssd_least_s``: every launch
scans one layer over the call's batch x seq_len; bound by its bytes)."""
from cardbench.readers import ssd_roofline as read  # noqa: F401
