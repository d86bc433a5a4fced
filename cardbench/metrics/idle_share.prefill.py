"""idle_share.prefill: the share of the traced calls' window in which the
card runs nothing (``trace.py``), in %."""
from cardbench.readers import idle_share as read  # noqa: F401
