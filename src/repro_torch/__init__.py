"""PyTorch/CUDA port of the LM stack of ``repro`` for NVIDIA Hopper (H100),
with the paper's coordination layer, compiler and design-space exploration.

The JAX package ``repro`` stays the reference. This package imports torch and
numpy only; it keeps its own copies of what it needs (``configs``, ``core``,
``compiler``, ``dse``, the strategy types of ``deploy``). Every
entry point takes ``device=None``, which means CUDA (or an error when no card
is present); the tests pass ``device="cpu"``.
"""
from ._device import resolve_device

__all__ = ["resolve_device"]
