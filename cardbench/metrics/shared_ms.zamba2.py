"""shared_ms.zamba2: the device's busy ms under the program's
``hybrid.shared`` spans (the shared calls of ``transformer.forward``) a traced
call (``span_trace.py``). None where the program opens no such span."""
from cardbench.readers import shared_ms as read  # noqa: F401
