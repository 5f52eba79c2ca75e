"""Per-tenant QoS primitives: token-bucket rate limits + priority tiers.

Port of ``repro.serving.qos`` (it imports no JAX; the port keeps its own
copy). Free of server state, so they unit-test without threads or clocks:

* :class:`TokenBucket` — the classic leaky-refill limiter. ``rate`` is
  sustained requests/second, ``burst`` the bucket depth (default: one
  second's worth). All time is injectable (``now=``) so accounting under
  burst is testable deterministically.
* :class:`SmoothWRR` — nginx-style smooth weighted round-robin. Used twice
  by the continuous scheduler: to pick which structure class steps next,
  and to pick which *tier* fills the next free slot of a resident batch.
  Weight is :func:`tier_weight` (``2**tier``), so tier 1 gets ~2x the
  admission slots of tier 0 under contention while tier 0 is never starved
  — which composes with queue-bound shedding so low-tier work sheds first.

Tier/rate defaults come from the environment, under the reference's names:
``REPRO_TENANT_TIER`` / ``REPRO_TENANT_RATE`` each accept a single value
applied to every tenant (``"1"``) or a per-tenant spec
(``"free=0,paid=1"``, with an optional ``*=N`` fallback). Explicit
``register_tenant(tier=..., rate=...)`` arguments beat the environment.
"""
from __future__ import annotations

import os
import time
from typing import Hashable, Mapping

TENANT_RATE_ENV = "REPRO_TENANT_RATE"
TENANT_TIER_ENV = "REPRO_TENANT_TIER"


def tier_weight(tier: int) -> int:
    """Scheduling weight of a tier: ``2**tier`` (tier 0 -> 1, tier 1 -> 2).

    Exponential so each tier up doubles its share of contended admission
    slots; never zero, so no tier can be starved outright.
    """
    return 1 << max(0, min(16, int(tier)))


def _parse_spec(raw: str, tenant: str) -> str | None:
    """Resolve ``raw`` (``"2"`` or ``"a=1,b=2,*=0"``) for ``tenant``."""
    raw = raw.strip()
    if not raw:
        return None
    if "=" not in raw:
        return raw
    fallback = None
    for part in raw.split(","):
        name, sep, value = part.strip().partition("=")
        if not sep:
            continue
        if name == tenant:
            return value.strip()
        if name == "*":
            fallback = value.strip()
    return fallback


def tenant_tier_default(tenant: str) -> int:
    """Env-configured tier for ``tenant`` (``REPRO_TENANT_TIER``; 0 = base)."""
    value = _parse_spec(os.environ.get(TENANT_TIER_ENV, ""), tenant)
    try:
        return max(0, int(value)) if value else 0
    except ValueError:
        return 0


def tenant_rate_default(tenant: str) -> float:
    """Env-configured rate for ``tenant`` (req/s; 0 = unlimited)."""
    value = _parse_spec(os.environ.get(TENANT_RATE_ENV, ""), tenant)
    try:
        return max(0.0, float(value)) if value else 0.0
    except ValueError:
        return 0.0


class TokenBucket:
    """Token-bucket rate limiter: ``rate`` tokens/s, depth ``burst``.

    Not thread-safe by itself — the server calls it under its admission
    lock. The clock is injectable everywhere (``now=`` in seconds, any
    monotonic origin) so tests can drive accounting deterministically;
    ``None`` falls back to ``time.monotonic()``.
    """

    def __init__(self, rate: float, burst: float | None = None,
                 now: float | None = None):
        if rate <= 0:
            raise ValueError(f"rate must be > 0, got {rate}")
        self.rate = float(rate)
        self.burst = float(burst) if burst is not None else max(1.0, rate)
        self.tokens = self.burst            # a fresh tenant may burst
        self._t = time.monotonic() if now is None else float(now)

    def _refill(self, now: float | None) -> float:
        now = time.monotonic() if now is None else float(now)
        if now > self._t:
            self.tokens = min(self.burst,
                              self.tokens + (now - self._t) * self.rate)
        self._t = max(self._t, now)
        return now

    def take(self, n: float = 1, now: float | None = None) -> bool:
        """Consume ``n`` tokens if available; False = rate-limit the caller."""
        self._refill(now)
        if self.tokens >= n:
            self.tokens -= n
            return True
        return False

    def available(self, now: float | None = None) -> float:
        """Tokens currently in the bucket (after refill accounting)."""
        self._refill(now)
        return self.tokens


class SmoothWRR:
    """Smooth weighted round-robin over a *dynamic* candidate set.

    The nginx algorithm: each pick adds every candidate's weight to its
    running ``current`` score, selects the max, then subtracts the total
    weight from the winner. For static weights ``{a: 2, b: 1}`` the pick
    sequence is ``a b a  a b a ...`` — proportional *and* interleaved
    (never ``a a b``), which is what keeps low tiers from bursty
    starvation. Candidates may come and go between picks; state for keys
    absent from ``weights`` is dropped so departed classes/tiers cannot
    skew future picks.
    """

    def __init__(self) -> None:
        self._current: dict[Hashable, float] = {}

    def pick(self, weights: Mapping[Hashable, float]) -> Hashable | None:
        if not weights:
            return None
        self._current = {k: self._current.get(k, 0.0) for k in weights}
        total = float(sum(weights.values()))
        best = None
        for key, weight in weights.items():
            self._current[key] += float(weight)
            if best is None or self._current[key] > self._current[best]:
                best = key
        self._current[best] -= total
        return best
