"""mamba_ms.zamba2: the device's busy ms under the program's
``hybrid.mamba`` spans (the mamba layers of ``transformer.forward``) a traced
call (``span_trace.py``). None where the program opens no such span."""
from cardbench.readers import mamba_ms as read  # noqa: F401
