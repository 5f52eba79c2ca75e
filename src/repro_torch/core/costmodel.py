"""Cost-model-driven grain decisions (port of ``repro.core.costmodel``).

Two decision engines, as in the reference:

* :class:`CostModel` — per-wave-class batcher selection. Each fused class's
  payload is probed once for ONE member's arguments, and its flops over its
  bytes (arithmetic intensity) classify the class:

  - **compute-bound** (intensity >= ``ridge``): ``vmap``;
  - **memory-bound** with a cache-resident member (``bytes <=
    map_member_bytes``) but a cache-overflowing batch (``size * bytes >=
    map_total_bytes``): ``map``, lanes one at a time;
  - **below the fused-overhead break-even** (``size * flops <
    unroll_flops``): ``unrolled``.

  The thresholds and :meth:`CostModel.decide` are the reference's. The
  probe differs: the reference reads XLA's cost analysis of a compiled
  probe; the port runs the payload on meta tensors under
  ``torch.utils.flop_counter.FlopCounterMode`` and counts the member's
  input and output tensor bytes. FlopCounterMode counts only the ops it has
  formulas for (matrix products, convolutions, attention), so a count of 0
  means "unknown", not "free", and is normalized to ``None`` (the
  counterpart of XLA's ``-1`` sentinel). A payload that cannot run on meta
  tensors is unmeasured. Unmeasured payloads fall back to ``vmap``.

* :class:`BucketTuner` — occupancy buckets for the serving tier, fitted from
  the observed histogram by an exact pad-minimizing DP (``fit_boundaries``).
  ``RegionServer`` rounds each coalesced batch up to its bucket.

``REPRO_TORCH_ADAPTIVE=0`` is the kill switch for both: ``"auto"``
resolves to ``vmap`` and the tuner pins the pow-2 ladder. :func:`plan_key`
fingerprints the active policy for the intern and replay caches.
"""
from __future__ import annotations

import collections
import dataclasses
import os
import threading
from typing import Any, Callable, Mapping, Sequence

import torch
from torch.utils import _pytree as pytree
from torch.utils.flop_counter import FlopCounterMode

from .tdg import abstract_eval

ADAPTIVE_ENV = "REPRO_TORCH_ADAPTIVE"

#: Arithmetic-intensity ridge (flops/byte) separating compute-bound from
#: memory-bound classes.
DEFAULT_RIDGE = 1.0
#: ``map`` upper bound on one member's bytes: past it a member cannot be
#: cache-resident, so streaming lanes buys nothing.
DEFAULT_MAP_MEMBER_BYTES = 512 * 1024
#: ``map`` lower bound on the stacked class's total bytes: below it the
#: whole batch is cache-resident and one fused vmap wins.
DEFAULT_MAP_TOTAL_BYTES = 128 * 1024
#: Unrolled break-even: classes whose TOTAL flops fall below it are cheaper
#: inlined than stacked and unstacked.
DEFAULT_UNROLL_FLOPS = 256.0


def adaptive_enabled(arg: bool | str = "auto") -> bool:
    """Resolve an ``adaptive`` argument (True | False | "auto"); "auto"
    honours ``REPRO_TORCH_ADAPTIVE`` (0/false/off/no disables)."""
    if arg is True or arg is False:
        return arg
    if arg != "auto":
        raise ValueError(f"adaptive must be True, False or 'auto', got {arg!r}")
    env = os.environ.get(ADAPTIVE_ENV)
    if env is not None:
        return env.strip().lower() not in ("0", "false", "off", "no")
    return True


@dataclasses.dataclass(frozen=True)
class ClassCost:
    """Measured per-member cost of one wave class's payload (None where the
    probe could not count)."""

    flops: float | None
    bytes_accessed: float | None
    source: str = "measured"        # "measured" | "unavailable"

    @property
    def intensity(self) -> float | None:
        """Arithmetic intensity in flops/byte, or None if unmeasured."""
        if self.flops is None or not self.bytes_accessed:
            return None
        return self.flops / self.bytes_accessed


UNMEASURED = ClassCost(flops=None, bytes_accessed=None, source="unavailable")


@dataclasses.dataclass(frozen=True)
class BatcherDecision:
    """One batcher choice plus the numbers that drove it."""

    batcher: str                    # "vmap" | "map" | "unrolled"
    reason: str
    cost: ClassCost
    size: int

    def describe(self) -> dict:
        """JSON-safe record for plan summaries."""
        inten = self.cost.intensity
        return {
            "batcher": self.batcher,
            "size": self.size,
            "flops": self.cost.flops,
            "bytes": self.cost.bytes_accessed,
            "intensity": None if inten is None else round(inten, 4),
            "reason": self.reason,
        }


def _leaf_key(leaf: Any) -> tuple:
    if isinstance(leaf, torch.Tensor):
        return (tuple(leaf.shape), str(leaf.dtype), leaf.device.type)
    if isinstance(leaf, (bool, int, float, str, type(None))):
        return ("value", leaf)
    return ("id", id(leaf))


def _spec_signature(spec: Any) -> tuple:
    leaves, treespec = pytree.tree_flatten(spec)
    return (str(treespec), tuple(_leaf_key(l) for l in leaves))


def _tensor_bytes(tree: Any) -> int:
    return sum(t.numel() * t.element_size() for t in pytree.tree_leaves(tree)
               if isinstance(t, torch.Tensor))


def _ambient_kernel_mode() -> str:
    from ..kernels import registry as _kreg

    return _kreg.kernel_mode()


class CostModel:
    """Measured flops/bytes -> per-class batcher decisions (see module doc).

    Probe results are cached per (payload identity, argument signature,
    kernel mode), LRU-bounded, with a strong reference pinning each payload
    so ``id()`` keys stay sound.
    """

    def __init__(self, ridge: float = DEFAULT_RIDGE,
                 map_member_bytes: int = DEFAULT_MAP_MEMBER_BYTES,
                 map_total_bytes: int = DEFAULT_MAP_TOTAL_BYTES,
                 unroll_flops: float = DEFAULT_UNROLL_FLOPS,
                 cache_size: int = 512):
        self.ridge = float(ridge)
        self.map_member_bytes = int(map_member_bytes)
        self.map_total_bytes = int(map_total_bytes)
        self.unroll_flops = float(unroll_flops)
        self._lock = threading.Lock()
        self._cache_size = max(1, int(cache_size))
        self._cache: collections.OrderedDict[tuple, tuple] = collections.OrderedDict()
        self.probes = 0
        self.probe_failures = 0

    def fingerprint(self) -> str:
        """Threshold fingerprint — part of the adaptive plan's cache key."""
        return (f"r{self.ridge:g}-m{self.map_member_bytes}"
                f"-t{self.map_total_bytes}-u{self.unroll_flops:g}")

    def measure(self, fn: Callable, arg_specs: Sequence[Any]) -> ClassCost:
        """Probe ``fn`` on ONE member's arguments (tensors of any device,
        meta included) and count its flops and bytes."""
        key = (id(fn), tuple(_spec_signature(s) for s in arg_specs),
               _ambient_kernel_mode())
        with self._lock:
            hit = self._cache.get(key)
            if hit is not None:
                self._cache.move_to_end(key)
                return hit[1]
        cost = self._probe(fn, arg_specs)
        with self._lock:
            self._cache[key] = (fn, cost)
            self._cache.move_to_end(key)
            while len(self._cache) > self._cache_size:
                self._cache.popitem(last=False)
        return cost

    def _probe(self, fn: Callable, arg_specs: Sequence[Any]) -> ClassCost:
        self.probes += 1
        try:
            with FlopCounterMode(display=False) as counter:
                out = abstract_eval(fn, *arg_specs)
        except Exception:   # a payload that cannot run on meta tensors
            self.probe_failures += 1
            return UNMEASURED
        flops = counter.get_total_flops() or None
        nbytes = (_tensor_bytes(list(arg_specs)) + _tensor_bytes(out)) or None
        if flops is None and nbytes is None:
            return UNMEASURED
        return ClassCost(flops=flops, bytes_accessed=nbytes)

    def decide(self, cost: ClassCost, size: int) -> BatcherDecision:
        """Pick vmap | map | unrolled for a class of ``size`` members."""
        size = max(1, int(size))
        flops, nbytes, inten = cost.flops, cost.bytes_accessed, cost.intensity
        if flops is None and nbytes is None:
            return BatcherDecision(
                "vmap", "unmeasured payload: static fallback", cost, size)
        if flops is not None and size * flops < self.unroll_flops:
            return BatcherDecision(
                "unrolled",
                f"{size}x{flops:g} flops < break-even {self.unroll_flops:g}",
                cost, size)
        if inten is not None and inten < self.ridge and nbytes is not None:
            if (nbytes <= self.map_member_bytes
                    and size * nbytes >= self.map_total_bytes):
                return BatcherDecision(
                    "map",
                    f"memory-bound ({inten:.3g} flops/B < ridge "
                    f"{self.ridge:g}), member {nbytes:g}B cache-resident, "
                    f"batch {size * nbytes:g}B is not",
                    cost, size)
            return BatcherDecision(
                "vmap",
                f"memory-bound ({inten:.3g} flops/B) but "
                f"{'member too large to stream' if nbytes > self.map_member_bytes else 'whole batch cache-resident'}",
                cost, size)
        shown = "unknown" if inten is None else f"{inten:.3g}"
        return BatcherDecision(
            "vmap", f"compute-bound ({shown} flops/B >= ridge "
            f"{self.ridge:g})", cost, size)

    def decide_for(self, fn: Callable, arg_specs: Sequence[Any],
                   size: int) -> BatcherDecision:
        return self.decide(self.measure(fn, arg_specs), size)


_default_model = CostModel()


def default_model() -> CostModel:
    """The process-wide cost model (what ``batcher="auto"`` consults)."""
    return _default_model


# -------------------------------------------------------- batcher resolution

_BATCHERS = ("vmap", "map", "auto")


def resolve_batcher(batcher: str) -> str:
    """``"auto"`` stays ``"auto"`` when adaptivity is on and collapses to
    ``"vmap"`` under ``REPRO_TORCH_ADAPTIVE=0``; static policies pass."""
    if batcher not in _BATCHERS:
        raise ValueError(f"batcher must be one of {_BATCHERS}, got {batcher!r}")
    if batcher == "auto" and not adaptive_enabled():
        return "vmap"
    return batcher


def plan_key(batcher: str) -> str:
    """Cache-key component naming the batcher *plan*: ``"vmap"``/``"map"``,
    or ``"auto/<thresholds>"`` so a threshold change re-lowers too."""
    resolved = resolve_batcher(batcher)
    if resolved == "auto":
        return f"auto/{default_model().fingerprint()}"
    return resolved


# ------------------------------------------------------------ bucket fitting

def pow2_boundaries(max_batch: int) -> list[int]:
    """The static ladder: 2, 4, 8, ... up to (at least) ``max_batch``."""
    bounds = [2]
    while bounds[-1] < max(2, int(max_batch)):
        bounds.append(bounds[-1] * 2)
    return bounds


def fit_boundaries(histogram: Mapping[int, int], max_buckets: int,
                   floor: int = 2) -> list[int]:
    """Choose <= ``max_buckets`` bucket boundaries minimizing pad lanes.

    Boundaries are drawn from the observed occupancies (>= ``floor``) and
    always include the maximum. Exact DP; deterministic.
    """
    vals = sorted(v for v, c in histogram.items() if v >= floor and c > 0)
    if not vals:
        return []
    cnts = [histogram[v] for v in vals]
    d = len(vals)
    k_max = max(1, min(int(max_buckets), d))

    def seg_cost(i: int, j: int) -> int:
        # members in vals[i..j] all pad up to vals[j]
        return sum(cnts[t] * (vals[j] - vals[t]) for t in range(i, j + 1))

    INF = float("inf")
    dp = [[INF] * d for _ in range(k_max + 1)]
    back: list[list[int]] = [[-1] * d for _ in range(k_max + 1)]
    for j in range(d):
        dp[1][j] = seg_cost(0, j)
    for k in range(2, k_max + 1):
        for j in range(k - 1, d):
            for i in range(k - 2, j):
                cand = dp[k - 1][i] + seg_cost(i + 1, j)
                if cand < dp[k][j]:
                    dp[k][j] = cand
                    back[k][j] = i
    best_k = min(range(1, k_max + 1), key=lambda k: dp[k][d - 1])
    bounds = []
    j, k = d - 1, best_k
    while j >= 0 and k >= 1:
        bounds.append(vals[j])
        j = back[k][j]
        k -= 1
    return sorted(bounds)


class BucketTuner:
    """Occupancy buckets fitted from the live histogram (serving tier).

    Starts on the pow-2 ladder, observes every batched occupancy and, when
    adaptive, refits every ``window`` observations or early when the recent
    pad fraction drifts past ``drift_pad_fraction``. Each new boundary is a
    new batched specialization, so a lifetime ``max_new_buckets`` budget
    bounds tuning; once spent, the boundaries freeze. Thread-safe.
    """

    def __init__(self, max_batch: int, adaptive: bool | str = "auto",
                 window: int = 64, max_buckets: int = 8,
                 max_new_buckets: int = 16,
                 drift_pad_fraction: float = 0.35):
        self.max_batch = max(1, int(max_batch))
        self.adaptive = adaptive_enabled(adaptive)
        self.window = max(1, int(window))
        self.max_buckets = max(1, int(max_buckets))
        self.max_new_buckets = max(0, int(max_new_buckets))
        self.drift_pad_fraction = float(drift_pad_fraction)
        self._lock = threading.Lock()
        self.boundaries: list[int] = pow2_boundaries(self.max_batch)
        self._histogram: collections.Counter = collections.Counter()
        self._recent: collections.deque = collections.deque(maxlen=self.window)
        self.observations = 0
        self.retunes = 0
        self.new_buckets_spent = 0
        self.pad_lanes = 0
        self.lanes = 0

    def bucket_for(self, occupancy: int) -> int:
        """Smallest boundary >= occupancy (pow-2-extended past the ladder)."""
        n = max(1, int(occupancy))
        if n <= 1:
            return 1
        with self._lock:
            for b in self.boundaries:
                if b >= n:
                    return b
            top = self.boundaries[-1] if self.boundaries else 2
        while top < n:
            top *= 2
        return top

    def observe(self, occupancy: int) -> bool:
        """Record one batched occupancy; True iff boundaries just changed."""
        n = int(occupancy)
        if n < 2:
            return False
        pad = self.bucket_for(n) - n
        with self._lock:
            self._histogram[n] += 1
            self._recent.append((n, pad))
            self.observations += 1
            self.pad_lanes += pad
            self.lanes += n + pad
            if not self.adaptive or self.new_buckets_spent >= self.max_new_buckets:
                return False
            due = self.observations % self.window == 0
            if not due and len(self._recent) >= self.window:
                recent_lanes = sum(o + p for o, p in self._recent)
                recent_pad = sum(p for _, p in self._recent)
                due = (recent_lanes > 0
                       and recent_pad / recent_lanes > self.drift_pad_fraction)
            if not due:
                return False
            fitted = fit_boundaries(self._histogram, self.max_buckets)
            if not fitted or fitted == self.boundaries:
                return False
            new = [b for b in fitted if b not in self.boundaries]
            budget_left = self.max_new_buckets - self.new_buckets_spent
            if len(new) > budget_left:
                # Keep the most frequent new boundaries within budget.
                new = sorted(new, key=lambda b: -self._histogram[b])[:budget_left]
                fitted = sorted(set(new) | {max(self._histogram)})
                if not new:
                    return False
            self.new_buckets_spent += len(new)
            self.boundaries = fitted
            self.retunes += 1
            self._recent.clear()
            return True

    def summary(self) -> dict:
        with self._lock:
            return {
                "adaptive": self.adaptive,
                "boundaries": list(self.boundaries),
                "observations": self.observations,
                "retunes": self.retunes,
                "new_buckets_spent": self.new_buckets_spent,
                "retrace_budget": self.max_new_buckets,
                "pad_lanes": self.pad_lanes,
                "pad_fraction": round(self.pad_lanes / self.lanes, 4)
                if self.lanes else 0.0,
                "histogram": {str(k): v for k, v in
                              sorted(self._histogram.items())},
            }
