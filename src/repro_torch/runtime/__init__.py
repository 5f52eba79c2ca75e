"""Training runtime: fault tolerance, elasticity, straggler detection."""
from .elastic import elastic_restart_plan, gather_checkpoint, reshard_checkpoint
from .fault_tolerance import RunState, StepTimer, StragglerPolicy, run_with_recovery

__all__ = ["RunState", "run_with_recovery", "StepTimer", "StragglerPolicy",
           "reshard_checkpoint", "gather_checkpoint", "elastic_restart_plan"]
