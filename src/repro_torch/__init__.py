"""PyTorch/CUDA port of the LM stack of ``repro`` for NVIDIA Hopper (H100),
with the paper's coordination layer, compiler, design-space exploration,
deployment API, static program verifier, fault tolerance and serving
control plane.

The JAX package ``repro`` stays the reference. This package imports torch and
numpy only; it keeps its own copies of what it needs (``configs``, ``core``,
``compiler``, ``dse``, ``deploy``, ``verify``, ``faults``, ``serve``). Every
entry point that touches a tensor takes ``device=None``, which means CUDA
(or an error when no card is present); the tests pass ``device="cpu"``. The
deployment layer, the verifier, the fault package and the serving control
plane are host code over instruction programs and take none.
"""
from ._device import resolve_device

__all__ = ["resolve_device"]
