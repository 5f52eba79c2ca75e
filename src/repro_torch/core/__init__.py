"""Core Taskgraph framework: TDG, record-and-replay, schedules, executors,
wave-fused lowering, cost-model-driven batcher selection, structural
interning, CUDA-graph replay, the replay mesh (``mesh=`` on ``lower_tdg``,
``ReplayExecutor``, ``@taskgraph`` and the AOT path: fused classes' lanes
split over ``sharding.replay``'s mesh), TDG serialization and exported
(AOT) replay programs (port of ``repro.core``; ``pipeline.py`` is not
ported yet)."""
from .costmodel import (BatcherDecision, BucketTuner, ClassCost, CostModel,
                        adaptive_enabled, default_model, fit_boundaries,
                        plan_key, pow2_boundaries, resolve_batcher)
from .executor import EagerExecutor, ExecStats, ReplayExecutor
from .fuse import (FusionPlan, WaveClass, classify_wave, fused_tdg_as_function,
                   plan as fusion_plan)
from .lower import (AotExecutable, GraphCaptureError, GraphReplay, aot_compile_tdg,
                    clear_intern_cache, fuse_enabled, intern_stats, lower_tdg,
                    tdg_as_function)
from .record import (GraphBuilder, TaskGraphRegion, registry, reset_registry,
                     taskgraph)
from .schedule import (ListSchedule, critical_path, list_schedule,
                       one_f_one_b_order, parallelism, pipeline_tdg,
                       round_robin_assign, topo_order, topo_waves,
                       validate_execution_order, wave_placement, work)
from .serialize import (TaskFnRegistry, TopologyMismatch, executable_from_bytes,
                        executable_serialization_available, executable_to_bytes,
                        load_executable, load_tdg, load_warm, save_executable, save_tdg,
                        tdg_from_dict, tdg_to_dict, topology_fingerprint,
                        warmup_and_save)
from .tdg import (TDG, DependencyTable, DepKind, Edge, EdgeKind, Task,
                  buffers_signature, structure_signature)

__all__ = [
    "TDG", "Task", "Edge", "DepKind", "EdgeKind", "DependencyTable",
    "buffers_signature", "structure_signature",
    "CostModel", "ClassCost", "BatcherDecision", "BucketTuner",
    "adaptive_enabled", "resolve_batcher", "plan_key", "default_model",
    "fit_boundaries", "pow2_boundaries",
    "FusionPlan", "WaveClass", "classify_wave", "fused_tdg_as_function",
    "fusion_plan",
    "topo_order", "topo_waves", "round_robin_assign", "wave_placement",
    "critical_path", "work", "parallelism", "list_schedule", "ListSchedule",
    "pipeline_tdg", "one_f_one_b_order", "validate_execution_order",
    "tdg_as_function", "lower_tdg", "intern_stats", "clear_intern_cache",
    "fuse_enabled", "GraphReplay", "GraphCaptureError", "AotExecutable",
    "aot_compile_tdg",
    "EagerExecutor", "ReplayExecutor", "ExecStats",
    "taskgraph", "TaskGraphRegion", "GraphBuilder", "registry", "reset_registry",
    "TaskFnRegistry", "save_tdg", "load_tdg", "tdg_to_dict", "tdg_from_dict",
    "save_executable", "load_executable",
    "executable_to_bytes", "executable_from_bytes",
    "executable_serialization_available", "warmup_and_save", "load_warm",
    "TopologyMismatch", "topology_fingerprint",
]
