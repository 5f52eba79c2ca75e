"""Multi-tenant replay serving (port of ``repro.serving``): the RegionServer
with continuous batching, QoS and served steps under CUDA graphs, its warm
pool (batched callables and exported AOT programs), metrics and QoS
primitives, and the cluster tier: an RPC front on ``RegionServer.submit``
serving from a pool of worker processes, which ships TDG JSON and exported
replay programs to them instead of re-lowering per worker."""
from .cluster import (ClusterError, ClusterFrontend, ClusterRemoteError, PinnedTree,
                      StickyRouter, WorkerDied, WorkerNode, resolve_device,
                      resolve_registry)
from .faults import FaultPlan, InjectedFault
from .metrics import (TRACE_SCHEMA, ExecutionTraceRing, LatencyReservoir, ServerMetrics,
                      percentile, validate_trace)
from .pool import PoolEntry, WarmPool
from .qos import (SmoothWRR, TokenBucket, tenant_rate_default, tenant_tier_default,
                  tier_weight)
from .server import (DeadlineExceeded, QueueFull, RateLimited, RegionServer, Tenant,
                     continuous_default, queue_bound_default)
from .shm import ShmRing
from .spawner import (LocalSpawner, RemoteSpawner, SpawnedWorker, SpawnError,
                      parse_worker_spec)

__all__ = ["ClusterError", "ClusterFrontend", "ClusterRemoteError", "DeadlineExceeded",
           "ExecutionTraceRing", "FaultPlan", "InjectedFault", "LatencyReservoir",
           "LocalSpawner", "PinnedTree", "PoolEntry", "QueueFull", "RateLimited",
           "RegionServer", "RemoteSpawner", "ServerMetrics", "ShmRing", "SmoothWRR",
           "SpawnError", "SpawnedWorker", "StickyRouter", "TRACE_SCHEMA", "Tenant",
           "TokenBucket", "WarmPool", "WorkerDied", "WorkerNode", "continuous_default",
           "parse_worker_spec", "percentile", "queue_bound_default", "resolve_device",
           "resolve_registry", "tenant_rate_default", "tenant_tier_default",
           "tier_weight", "validate_trace"]
