"""Hand-written Hopper kernels of the port, one package per kernel, each with
``kernel.py`` (the wrapper and its ``launches`` count), ``ref.py`` (the plain
PyTorch version) and ``ops.py`` (dispatch by device).

``SOURCES`` names every CUDA source, so that a caller can build them all at
once (``_build.build(SOURCES)``).
"""
from .flash_attention import kernel as _flash_kernel
from .gemm_int8 import kernel as _gemm_kernel
from .rwkv6 import kernel as _wkv6_kernel
from .ssd_scan import kernel as _ssd_kernel

SOURCES = {"flash_attention": _flash_kernel.SOURCE, "wkv6": _wkv6_kernel.SOURCE,
           "ssd_scan": _ssd_kernel.SOURCE, "gemm_int8": _gemm_kernel.SOURCE}
