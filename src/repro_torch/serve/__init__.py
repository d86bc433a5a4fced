"""The port's copy of the JAX package's ``serve/``, the online serving
control plane (paper Sec. V, taken online): a queue-driven ``Server`` packs
concurrent decode sessions at different cache depths into shared members
(per-slot AddrLen length streams), re-places tenants on join/leave or
sustained SLO violation via incremental ``explore_multi``, quarantines and
replays around detected faults, and hot-swaps the running ``System``
mid-service. Time is the simulator copy's virtual clock; it touches no
tensor (the tensor-level engine is ``repro_torch.runtime.serve``)."""
from ..deploy import SLO, RunReport, TenantReport
from .request import (DecodeSession, Request, ServeEvent, TenantState,
                      WindowSample)
from .server import MAX_WINDOW, DrainStuckError, Server

__all__ = [
    "DecodeSession",
    "DrainStuckError",
    "MAX_WINDOW",
    "Request",
    "RunReport",
    "Server",
    "ServeEvent",
    "SLO",
    "TenantReport",
    "TenantState",
    "WindowSample",
]
