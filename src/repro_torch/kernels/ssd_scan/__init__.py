"""Mamba2 SSD scan: CUDA kernel (``kernel.py``), plain versions (``ref.py``)
and the dispatch between them (``ops.py``)."""
