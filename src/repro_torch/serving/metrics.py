"""Serving metrics: queue/batch/latency observability for the RegionServer.

Port of ``repro.serving.metrics`` (it imports no JAX; the port keeps its
own copy). Per request and per batch the server records:

* **queue depth** at admission (and its peak), so head-of-line pressure on
  the admission queue is visible rather than silent;
* **batch occupancy** — how many coalesced requests each batched replay
  actually carried vs. the configured ``max_batch`` ceiling;
* **replay latency** (submit → result) in a bounded reservoir, summarized
  as p50/p99, overall and per QoS tier;
* shedding (queue bound, deadlines, rate limits), pad lanes and bucket
  retunes.

The continuous-batching scheduler also records one
:class:`ExecutionTraceRing` entry **per executed step** — step index,
structure class, occupancy, bucket, join/leave/shed events, per-tier
membership, wall time, and a straggler flag (wall time > 3x the class's
EMA) — dumpable as JSON (:meth:`ExecutionTraceRing.dump`).

The AOT counters count requests served by an exported program
(``aot_served``), warm artifacts that could not be hydrated
(``aot_hydrate_failures``) and those rejected for another device topology
(``aot_topology_rejects``, a hydrate failure too).

Everything here is lock-protected and cheap (O(1) per event, bounded
memory), so metrics can stay on in production serving paths.
"""
from __future__ import annotations

import json
import math
import threading
import time


def percentile(sorted_values: list[float], q: float) -> float:
    """Nearest-rank percentile of an already-sorted list (0 <= q <= 100).

    Classic nearest-rank: the ``ceil(q/100 * n)``-th smallest value.
    Returns 0.0 for an empty list: serving dashboards prefer a zero row
    over an exception when no traffic has arrived yet.
    """
    if not sorted_values:
        return 0.0
    if q <= 0:
        return sorted_values[0]
    if q >= 100:
        return sorted_values[-1]
    rank = math.ceil(q / 100.0 * len(sorted_values)) - 1
    return sorted_values[max(0, min(len(sorted_values) - 1, rank))]


class LatencyReservoir:
    """Bounded sample of per-request latencies (seconds).

    Keeps the most recent ``capacity`` observations (ring buffer): serving
    percentiles should reflect current behaviour, not the cold-start tail
    from an hour ago.
    """

    def __init__(self, capacity: int = 4096):
        self.capacity = max(1, capacity)
        self._buf: list[float] = []
        self._next = 0
        self.count = 0

    def record(self, seconds: float) -> None:
        if len(self._buf) < self.capacity:
            self._buf.append(seconds)
        else:
            self._buf[self._next] = seconds
            self._next = (self._next + 1) % self.capacity
        self.count += 1

    def summary(self) -> dict:
        vals = sorted(self._buf)
        return {
            "count": self.count,
            "p50_s": percentile(vals, 50),
            "p99_s": percentile(vals, 99),
            "max_s": vals[-1] if vals else 0.0,
        }


#: The execution-pattern trace record schema: field name -> accepted types.
#: ``tiers`` maps tier (as a JSON-safe string key) -> member count at that
#: step. A record must carry exactly these fields — the benchmark gate and
#: offline tooling both call :func:`validate_trace` against this table.
TRACE_SCHEMA: dict = {
    "step": int,            # per-class step index (1-based)
    "class_id": int,        # dense id of the structure class
    "t_ms": (int, float),   # ms since the ring was created
    "occupancy": int,       # resident members this step executed
    "bucket": int,          # power-of-two occupancy bucket actually run
    "joins": int,           # members admitted at this step boundary
    "leaves": int,          # members retired/migrated at this boundary
    "sheds": int,           # members deadline-shed at this boundary
    "wall_ms": (int, float),  # step execution wall time
    "straggler": bool,      # wall_ms > 3x this class's EMA (after warmup)
    "coalesced": bool,      # one fused vmap call served the whole step
    "padded": int,          # idle pad lanes run to fill the bucket
    "tiers": dict,          # {str(tier): member count}
}


def validate_trace(records: list) -> None:
    """Raise ``ValueError`` unless every record matches :data:`TRACE_SCHEMA`.

    Exact-key validation (no missing, no extra) so schema drift between
    the scheduler and offline analysis tools fails loudly in CI rather
    than silently producing unparseable dumps.
    """
    want = set(TRACE_SCHEMA)
    for i, rec in enumerate(records):
        if not isinstance(rec, dict):
            raise ValueError(f"trace[{i}]: not a dict: {type(rec).__name__}")
        got = set(rec)
        if got != want:
            raise ValueError(
                f"trace[{i}]: fields {sorted(got)} != schema {sorted(want)}")
        for field, types in TRACE_SCHEMA.items():
            if not isinstance(rec[field], types) or (
                    types is int and isinstance(rec[field], bool)):
                raise ValueError(
                    f"trace[{i}].{field}: {type(rec[field]).__name__} is "
                    f"not {types}")
        for tier, count in rec["tiers"].items():
            if not isinstance(tier, str) or not isinstance(count, int):
                raise ValueError(f"trace[{i}].tiers: want str->int, got "
                                 f"{tier!r}: {count!r}")


class ExecutionTraceRing:
    """Bounded ring of per-step execution-pattern records.

    One entry per executed continuous-batching step (see
    :data:`TRACE_SCHEMA`). The ring computes the ``straggler`` flag itself
    from a per-class exponential moving average of step wall time — a step
    is a straggler when it takes more than ``3x`` the class's EMA, judged
    only after ``warmup`` steps so cold compiles don't flag every class's
    first step. ``capacity``-bounded like the latency reservoir: traces
    must be safe to leave on in production.
    """

    #: Steps per class before the straggler EMA is trusted.
    warmup = 5
    #: Multiplier over the class EMA that flags a straggler.
    threshold = 3.0
    #: EMA smoothing factor.
    alpha = 0.2

    def __init__(self, capacity: int = 4096):
        self.capacity = max(1, capacity)
        self._lock = threading.Lock()
        self._buf: list[dict] = []
        self._next = 0
        self._t0 = time.monotonic()
        self._ema: dict[int, tuple[float, int]] = {}   # cid -> (ema, n)
        self.count = 0
        self.stragglers = 0

    def record(self, rec: dict) -> dict:
        """Append one step record (``straggler``/``t_ms`` filled in here)."""
        rec = dict(rec)
        with self._lock:
            rec.setdefault("t_ms", (time.monotonic() - self._t0) * 1e3)
            cid, wall = rec["class_id"], float(rec["wall_ms"])
            ema, n = self._ema.get(cid, (wall, 0))
            rec["straggler"] = bool(n >= self.warmup
                                    and wall > self.threshold * ema)
            self._ema[cid] = (ema + self.alpha * (wall - ema), n + 1)
            if rec["straggler"]:
                self.stragglers += 1
            if len(self._buf) < self.capacity:
                self._buf.append(rec)
            else:
                self._buf[self._next] = rec
                self._next = (self._next + 1) % self.capacity
            self.count += 1
        return rec

    def snapshot(self) -> list[dict]:
        """The retained records, oldest first."""
        with self._lock:
            return [dict(r) for r in
                    (self._buf[self._next:] + self._buf[:self._next])]

    def summary(self) -> dict:
        with self._lock:
            return {"steps": self.count, "retained": len(self._buf),
                    "stragglers": self.stragglers,
                    "classes": len(self._ema)}

    def dump(self, path: str, meta: dict | None = None) -> dict:
        """Write the trace as JSON for offline execution-pattern analysis."""
        records = self.snapshot()
        validate_trace(records)
        doc = {"schema": sorted(TRACE_SCHEMA), **(meta or {}),
               "summary": self.summary(), "records": records}
        with open(path, "w") as f:
            json.dump(doc, f, indent=1)
        return doc


class ServerMetrics:
    """Thread-safe counters + latency reservoir for one RegionServer."""

    def __init__(self, latency_capacity: int = 4096):
        self._lock = threading.Lock()
        self.admitted = 0
        self.completed = 0
        self.failed = 0
        self.batches = 0
        self.coalesced_requests = 0   # requests served by a fused batch >= 2
        self.batch_fallbacks = 0      # batched replay failed -> serial path
        self.shed = 0                 # rejected at admission: queue bound hit
        self.deadline_sheds = 0       # dropped unexecuted: deadline expired
        self.rate_limited = 0         # refused at admission: token bucket dry
        self.aot_served = 0           # requests served by an exported program
        self.aot_hydrate_failures = 0  # a warm artifact present but unusable
        self.aot_topology_rejects = 0  # an artifact for another device topology
        self.joins = 0                # members admitted into resident batches
        self.leaves = 0               # members retired from resident batches
        self.pad_lanes = 0            # idle lanes run to round batches up
        self.padded_batches = 0       # batches that carried >= 1 pad lane
        self.bucket_retunes = 0       # adaptive bucket-boundary refits
        self.occupancy_sum = 0
        self.occupancy_max = 0
        self.queue_depth_peak = 0
        self.queue_depth_last = 0
        self.latency = LatencyReservoir(latency_capacity)
        self.tier_latency: dict[int, LatencyReservoir] = {}
        self._tier_capacity = latency_capacity
        self.trace = ExecutionTraceRing()

    # -- event hooks (called by the server) --------------------------------
    def on_admit(self, queue_depth: int) -> None:
        with self._lock:
            self.admitted += 1
            self.queue_depth_last = queue_depth
            self.queue_depth_peak = max(self.queue_depth_peak, queue_depth)

    def on_admit_many(self, n: int, queue_depth: int) -> None:
        """One batch-frame admission: ``n`` requests entered the queue at
        once (the cluster wire path admits a whole frame under a single
        lock acquisition — one metrics event to match)."""
        with self._lock:
            self.admitted += n
            self.queue_depth_last = queue_depth
            self.queue_depth_peak = max(self.queue_depth_peak, queue_depth)

    def on_batch(self, occupancy: int, coalesced: bool = True) -> None:
        """Record one dispatched admission group.

        ``occupancy`` is the group size the admission queue assembled;
        ``coalesced`` says whether ONE fused (vmap-batched) replay actually
        served the group — a batch that degraded to serial per-request
        replay reports ``coalesced=False`` so ``coalesced_requests`` never
        overstates real cross-request fusion.
        """
        with self._lock:
            self.batches += 1
            self.occupancy_sum += occupancy
            self.occupancy_max = max(self.occupancy_max, occupancy)
            if coalesced and occupancy >= 2:
                self.coalesced_requests += occupancy

    def on_done(self, latency_seconds: float, failed: bool = False,
                aot: bool = False, tier: int | None = None) -> None:
        with self._lock:
            if failed:
                self.failed += 1
            else:
                self.completed += 1
            if aot:
                self.aot_served += 1
            self.latency.record(latency_seconds)
            if tier is not None and not failed:
                res = self.tier_latency.get(tier)
                if res is None:
                    res = self.tier_latency[tier] = \
                        LatencyReservoir(self._tier_capacity)
                res.record(latency_seconds)

    def on_pad(self, pad_lanes: int) -> None:
        """One batched replay ran ``pad_lanes`` idle lanes to fill its
        occupancy bucket (pad members repeat the last real request and are
        never read back). Bucket granularity trades retraces for exactly
        this waste — the counter is what the adaptive tuner's drift check
        (and operators) watch to see whether the trade is still paying."""
        if pad_lanes <= 0:
            return
        with self._lock:
            self.pad_lanes += pad_lanes
            self.padded_batches += 1

    def on_bucket_retune(self, boundaries: list | None = None) -> None:
        """The bucket tuner refit its occupancy-bucket boundaries (stale
        pooled batched executables were invalidated alongside)."""
        with self._lock:
            self.bucket_retunes += 1

    def on_rate_limited(self, n: int = 1) -> None:
        """``n`` requests refused at admission because the tenant's token
        bucket was dry — per-tenant fairness, distinct from the global
        queue-bound ``shed``. Never admitted, so not in ``admitted``."""
        with self._lock:
            self.rate_limited += n

    def on_step(self, rec: dict) -> None:
        """One continuous-batching step executed: trace it + roll up the
        join/leave counters the trace would otherwise hide in a ring."""
        with self._lock:
            self.joins += rec.get("joins", 0)
            self.leaves += rec.get("leaves", 0)
        self.trace.record(rec)

    def on_aot_hydrate_failure(self) -> None:
        """A warm artifact existed but could not be hydrated: the tenant is
        lowered instead, and this counter keeps the fallback from passing
        for warm in aggregated stats."""
        with self._lock:
            self.aot_hydrate_failures += 1

    def on_aot_topology_reject(self) -> None:
        """A shipped artifact was exported for another device topology:
        counted as a hydrate failure too (the tenant re-lowers), and apart,
        since a spike means artifacts are shipped across platforms or
        versions."""
        with self._lock:
            self.aot_topology_rejects += 1
            self.aot_hydrate_failures += 1

    def on_batch_fallback(self) -> None:
        with self._lock:
            self.batch_fallbacks += 1

    def on_shed(self, n: int = 1) -> None:
        """``n`` requests refused at admission because the queue was at its
        configured bound — the backpressure signal. A shed request was
        never admitted, so it does not count in ``admitted``/``failed``."""
        with self._lock:
            self.shed += n

    def on_deadline_shed(self, n: int = 1) -> None:
        """``n`` admitted requests dropped *before execution* because their
        deadline had already passed — replaying them would burn compute on
        an answer nobody is waiting for. Counted in ``failed`` too (their
        futures resolve with ``DeadlineExceeded``); this counter isolates
        the deadline-driven subset."""
        with self._lock:
            self.deadline_sheds += n

    # -- reporting ---------------------------------------------------------
    def snapshot(self) -> dict:
        with self._lock:
            mean_occ = (self.occupancy_sum / self.batches
                        if self.batches else 0.0)
            return {
                "admitted": self.admitted,
                "completed": self.completed,
                "failed": self.failed,
                "batches": self.batches,
                "coalesced_requests": self.coalesced_requests,
                "batch_fallbacks": self.batch_fallbacks,
                "aot_served": self.aot_served,
                "aot_hydrate_failures": self.aot_hydrate_failures,
                "aot_topology_rejects": self.aot_topology_rejects,
                "shed": self.shed,
                "deadline_sheds": self.deadline_sheds,
                "rate_limited": self.rate_limited,
                "joins": self.joins,
                "leaves": self.leaves,
                "pad_lanes": self.pad_lanes,
                "padded_batches": self.padded_batches,
                "pad_fraction": round(
                    self.pad_lanes / (self.pad_lanes + self.occupancy_sum), 4)
                if self.pad_lanes + self.occupancy_sum else 0.0,
                "bucket_retunes": self.bucket_retunes,
                "batch_occupancy_mean": round(mean_occ, 3),
                "batch_occupancy_max": self.occupancy_max,
                "queue_depth_peak": self.queue_depth_peak,
                "queue_depth_last": self.queue_depth_last,
                "latency": self.latency.summary(),
                "tiers": {str(t): r.summary()
                          for t, r in sorted(self.tier_latency.items())},
                "trace": self.trace.summary(),
            }
