"""The port's copy of the JAX package's deployment types that the DSE needs:
``Workload`` (one tenant's model), ``Member`` and ``Strategy`` (what to run:
members are (workload, a, b) pipelines). Compiling a strategy into a
deployment and the fixed ``System`` that runs it (``deployment.py``,
``system.py`` and the rest of the JAX package's ``deploy/``, with
``verify/``) are not copied yet."""
from .strategy import Member, Strategy, Workload

__all__ = ["Member", "Strategy", "Workload"]
