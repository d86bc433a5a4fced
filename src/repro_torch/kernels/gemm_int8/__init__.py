"""INT8 PU GEMM: CUDA kernel (``kernel.py``), plain version (``ref.py``) and
the dispatch between them (``ops.py``)."""
