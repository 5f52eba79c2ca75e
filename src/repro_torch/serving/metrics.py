"""Serving metrics for the request-level RegionServer.

Port of the counters of ``repro.serving.metrics`` that the request-level
path records: queue depth at admission (and its peak), batch occupancy,
batch fallbacks, pad lanes, and submit-to-result latency in a bounded
reservoir summarized as p50/p99. The execution-trace ring and per-tier
latency belong to continuous batching and QoS (ROADMAP.md, queue A item 7).
"""
from __future__ import annotations

import math
import threading


def percentile(sorted_values: list[float], q: float) -> float:
    """Nearest-rank percentile of an already-sorted list (0 <= q <= 100).

    The ``ceil(q/100 * n)``-th smallest value; 0.0 for an empty list.
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
    """The most recent ``capacity`` latencies (seconds), as a ring buffer."""

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
        return {"count": self.count, "p50_s": percentile(vals, 50),
                "p99_s": percentile(vals, 99), "max_s": vals[-1] if vals else 0.0}


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
        self.pad_lanes = 0            # idle lanes run to round batches up
        self.occupancy_sum = 0
        self.occupancy_max = 0
        self.queue_depth_peak = 0
        self.latency = LatencyReservoir(latency_capacity)

    def on_admit(self, queue_depth: int) -> None:
        with self._lock:
            self.admitted += 1
            self.queue_depth_peak = max(self.queue_depth_peak, queue_depth)

    def on_batch(self, occupancy: int, coalesced: bool = True) -> None:
        """One dispatched group; ``coalesced`` iff ONE batched replay served it."""
        with self._lock:
            self.batches += 1
            self.occupancy_sum += occupancy
            self.occupancy_max = max(self.occupancy_max, occupancy)
            if coalesced and occupancy >= 2:
                self.coalesced_requests += occupancy

    def on_done(self, latency_seconds: float, failed: bool = False) -> None:
        with self._lock:
            if failed:
                self.failed += 1
            else:
                self.completed += 1
            self.latency.record(latency_seconds)

    def on_pad(self, pad_lanes: int) -> None:
        with self._lock:
            self.pad_lanes += max(0, pad_lanes)

    def on_batch_fallback(self) -> None:
        with self._lock:
            self.batch_fallbacks += 1

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "admitted": self.admitted,
                "completed": self.completed,
                "failed": self.failed,
                "batches": self.batches,
                "coalesced_requests": self.coalesced_requests,
                "batch_fallbacks": self.batch_fallbacks,
                "pad_lanes": self.pad_lanes,
                "batch_occupancy_mean": round(self.occupancy_sum / self.batches, 3)
                if self.batches else 0.0,
                "batch_occupancy_max": self.occupancy_max,
                "queue_depth_peak": self.queue_depth_peak,
                "latency": self.latency.summary(),
            }
