"""Multi-tenant replay serving (port of ``repro.serving``): the RegionServer
with continuous batching, QoS and served steps under CUDA graphs, its warm
pool, metrics and QoS primitives."""
from .metrics import (TRACE_SCHEMA, ExecutionTraceRing, LatencyReservoir, ServerMetrics,
                      percentile, validate_trace)
from .pool import PoolEntry, WarmPool
from .qos import (SmoothWRR, TokenBucket, tenant_rate_default, tenant_tier_default,
                  tier_weight)
from .server import (DeadlineExceeded, QueueFull, RateLimited, RegionServer, Tenant,
                     continuous_default, queue_bound_default)

__all__ = ["DeadlineExceeded", "ExecutionTraceRing", "LatencyReservoir", "PoolEntry",
           "QueueFull", "RateLimited", "RegionServer", "ServerMetrics", "SmoothWRR",
           "TRACE_SCHEMA", "Tenant", "TokenBucket", "WarmPool", "continuous_default",
           "percentile", "queue_bound_default", "tenant_rate_default",
           "tenant_tier_default", "tier_weight", "validate_trace"]
