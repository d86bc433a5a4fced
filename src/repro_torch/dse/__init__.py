# The port's copy of the JAX package's DSE (paper Sec. V-A): single-batch
# enumeration, multi-batch hybrid-parallel composition, Pareto analysis —
# plus multi-tenant co-exploration (joint placements of several models on
# one machine). The batched scorer's second backend is float64 torch on the
# card (batched.py); gpu_deploy.py is the H100-pool deployment DSE.
from .batched import BatchedScores, score_details, score_single_batch
from .explorer import (
    DSEResult,
    MultiBatchSchedule,
    MultiDSEResult,
    MultiTenantPoint,
    MultiTenantValidationRecord,
    SingleBatchPoint,
    ValidationRecord,
    enumerate_multi_batch,
    enumerate_single_batch,
    enumerate_single_batch_reference,
    explore,
    explore_multi,
)
from .pareto import constrained, pareto_front, pareto_front_bruteforce
from .replan import Placement, plan_placement

__all__ = [
    "Placement",
    "plan_placement",
    "BatchedScores",
    "DSEResult",
    "score_details",
    "score_single_batch",
    "MultiBatchSchedule",
    "MultiDSEResult",
    "MultiTenantPoint",
    "MultiTenantValidationRecord",
    "SingleBatchPoint",
    "ValidationRecord",
    "enumerate_multi_batch",
    "enumerate_single_batch",
    "enumerate_single_batch_reference",
    "explore",
    "explore_multi",
    "constrained",
    "pareto_front",
    "pareto_front_bruteforce",
]
