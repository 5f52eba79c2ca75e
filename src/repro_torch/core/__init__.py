from .lower import clear_intern_cache, intern_stats, lower_tdg, tdg_as_function
from .schedule import topo_order, topo_waves, validate_execution_order
from .tdg import (TDG, DependencyTable, Edge, EdgeKind, Task, buffers_signature,
                  structure_signature)

__all__ = ["TDG", "DependencyTable", "Edge", "EdgeKind", "Task",
           "buffers_signature", "clear_intern_cache", "intern_stats",
           "lower_tdg", "structure_signature", "tdg_as_function",
           "topo_order", "topo_waves", "validate_execution_order"]
