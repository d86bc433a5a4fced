"""The port's copy of the JAX package's ``deploy/``, first-class deployments
(paper Sec. V): ``Workload`` (one tenant's model), ``Strategy`` (what to run:
members are (workload, a, b) pipelines), ``compile_deployment`` (how it
lands on disjoint PU/channel slices, one graph per member, verified by
``repro_torch.verify`` unless ``verify=False``), ``Deployment`` (executable
programs + analytic model), ``System`` (one fixed machine, runtime strategy
switching without reconfiguration, single-tenant <-> multi-tenant swaps
included), ``Session`` (the handle load/switch return: tenants, current
strategy, swap history) and ``RunReport`` (the result schema of ``run()``).
All of it is host code over the instruction programs and the simulator
copy; it touches no tensor. ``System.inject`` / ``clear_faults`` raise
``NotImplementedError`` until the fault package is copied."""
from .deployment import DeployedMember, Deployment, compile_deployment
from .report import SLO, RunReport, TenantReport
from .resources import MemberResources, check_fits, partition_resources
from .session import Session, SwapRecord
from .strategy import Member, Strategy, Workload
from .system import System

__all__ = [
    "DeployedMember",
    "Deployment",
    "Member",
    "MemberResources",
    "RunReport",
    "SLO",
    "Session",
    "Strategy",
    "SwapRecord",
    "System",
    "TenantReport",
    "Workload",
    "check_fits",
    "compile_deployment",
    "partition_resources",
]
