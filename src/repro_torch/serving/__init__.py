from .metrics import LatencyReservoir, ServerMetrics, percentile
from .pool import PoolEntry, WarmPool
from .server import RegionServer, Tenant

__all__ = ["LatencyReservoir", "PoolEntry", "RegionServer", "ServerMetrics",
           "Tenant", "WarmPool", "percentile"]
