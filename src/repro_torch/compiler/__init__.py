# The port's copy of the JAX package's DNN compilation framework, which is
# framework-neutral Python (paper Sec. IV): model processing + fusion,
# profiling, DP partitioning onto heterogeneous PUs, SMOF-style weight
# transfer scheduling, pipeline memory optimization (stage-distance buffers,
# liveness-driven HBM channel assignment) and instruction generation.
from .graph import Graph, Node, OpType, TensorInfo
from .fusion import fuse
from .profiler import NodeProfile, profile_graph, profile_node
from .partition import Partition, Stage, partition
from .weights import WeightSchedule, schedule_weights, CHUNK_BYTES
from .memory import MemoryPlan, TensorPlan, assign_channels, buffer_requirements
from .codegen import generate_programs
from .compile import (
    STATS,
    CompiledModel,
    CompileStats,
    GraphAnalysis,
    analyze,
    clear_analysis_cache,
    compile_model,
    place,
)
from . import zoo

__all__ = [
    "Graph",
    "Node",
    "OpType",
    "TensorInfo",
    "fuse",
    "NodeProfile",
    "profile_graph",
    "profile_node",
    "Partition",
    "Stage",
    "partition",
    "WeightSchedule",
    "schedule_weights",
    "CHUNK_BYTES",
    "MemoryPlan",
    "TensorPlan",
    "assign_channels",
    "buffer_requirements",
    "generate_programs",
    "STATS",
    "CompiledModel",
    "CompileStats",
    "GraphAnalysis",
    "analyze",
    "clear_analysis_cache",
    "compile_model",
    "place",
    "zoo",
]
