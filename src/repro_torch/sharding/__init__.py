"""Distribution (port of ``repro.sharding``): logical-axis partition rules
over pod / data / model meshes, and the replay mesh that spreads a fused
class's lanes, or a coalesced serving batch, over devices."""
from . import partition
from . import replay
from .replay import MESH_ENV, mesh_fingerprint, resolve_mesh
from .partition import (
    DEFAULT_RULES,
    use_mesh,
    active_mesh,
    constrain,
    to_pspec,
    param_pspecs,
    param_shardings,
    batch_pspec,
)

__all__ = ["partition", "replay", "DEFAULT_RULES", "use_mesh",
           "active_mesh", "constrain", "to_pspec", "param_pspecs",
           "param_shardings", "batch_pspec", "MESH_ENV", "mesh_fingerprint",
           "resolve_mesh"]
