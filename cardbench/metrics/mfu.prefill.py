"""mfu.prefill: the window's prefill operations (``roofline.prefill_flops``:
every product, attention where the mask keeps a pair, logits at every
position) over the window x the peak (495 TFLOP/s), in %."""
from cardbench.readers import dense_mfu as read  # noqa: F401
