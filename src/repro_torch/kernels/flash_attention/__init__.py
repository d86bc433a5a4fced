"""Flash attention: CUDA kernel (``kernel.py``), plain version (``ref.py``)
and the dispatch between them (``ops.py``)."""
