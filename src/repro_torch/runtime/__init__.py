"""Training runtime: fault tolerance and straggler detection (the
reference's ``elastic`` resharding waits for multi-device training)."""
from .fault_tolerance import RunState, StepTimer, StragglerPolicy, run_with_recovery

__all__ = ["RunState", "run_with_recovery", "StepTimer", "StragglerPolicy"]
