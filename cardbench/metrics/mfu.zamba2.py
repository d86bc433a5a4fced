"""mfu.zamba2: the window's prefill operations (``hybrid_roofline.prefill_flops``:
the mamba layers' and the shared calls' products, the tied head at every
position, the calls' causal attention and the layers' scans as their
recurrence counts them) over the window x the peak (495 TFLOP/s), in %."""
from cardbench.readers import hybrid_mfu as read  # noqa: F401
