"""fp32 GEMM on the TF32 tensor cores (3xTF32): CUDA kernel (``kernel.py``),
plain version (``ref.py``) and the route between them (``ops.py``)."""
