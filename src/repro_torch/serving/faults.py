"""Deterministic fault injection for the cluster tier (the chaos layer).

Port of ``repro.serving.faults`` (it imports no JAX; the port keeps its own
copy): the same points, actions, counters and seeded decisions.

The self-healing machinery in :mod:`repro_torch.serving.cluster` — heartbeat
leases, supervised respawn, deadline shedding, retry/backoff — is only
trustworthy if it can be *exercised*: a recovery path that never runs in CI
is a recovery path that does not work. This module is the injection point:
a seeded, deterministic :class:`FaultPlan` that the wire layer
(:mod:`repro_torch.serving.rpc`), the shared-memory data plane
(:mod:`repro_torch.serving.shm`), the spawners (:mod:`repro_torch.serving.spawner`)
and the frontend's artifact shipping consult at well-defined *points*:

==============  ============================================================
point           where it fires
==============  ============================================================
``send``        :meth:`rpc.RpcConnection.send`, once per frame, after encode
``recv``        :meth:`rpc.RpcConnection.recv`, once per decoded frame
``ring_ack``    :meth:`shm.ShmRing.ack` — a peer ack about to be applied
``spawn``       :meth:`spawner.LocalSpawner.launch` — a worker process start
``artifact``    :meth:`cluster.ClusterFrontend._register_on` — artifact
                bytes about to ship (``corrupt`` flips seeded bytes)
==============  ============================================================

A *rule* is a dict::

    {"role": "worker" | "frontend" | "any",   # which process kind
     "point": "send" | "recv" | "ring_ack" | "spawn" | "artifact",
     "op":    "submit_batch" | "result_batch" | ... | None,  # frame op
     "after": N,      # skip the first N matching events (default 0)
     "count": K,      # fire at most K times, -1 = unlimited (default 1)
     "action": "kill" | "drop" | "delay" | "dup" | "fail" | "corrupt",
     "secs":  0.25}   # for "delay"

Actions: ``kill`` hard-exits the process (``os._exit``, the closest
in-process stand-in for SIGKILL — no atexit, no flushes, sockets break
mid-conversation); ``drop`` suppresses the event (frame not sent / reply
discarded / ack not applied); ``delay`` sleeps ``secs`` first, then lets
the event proceed; ``dup`` performs a send twice; ``fail`` raises
:class:`InjectedFault` (the ``spawn`` point uses it to simulate a start
failure, exercising respawn backoff); ``corrupt`` rewrites seeded byte
positions of an artifact payload.

**Determinism.** Nothing here consults wall-clock randomness: rules fire
on exact per-``(role, point, op)`` event counters, and ``corrupt`` picks
byte positions from a ``random.Random(seed)`` owned by the plan. The same
plan against the same request schedule injects the same faults — which is
what lets the tests assert exact recovery behaviour.

**Zero overhead when disabled.** Every hook site is guarded by the
module-level :data:`ENABLED` flag — one attribute load per frame when no
plan is installed, nothing else.

**Injection.** Ctor-style: build a :class:`FaultPlan` and
:func:`install` it (the frontend process). Env-style: set
``REPRO_FAULT_PLAN`` to the plan's JSON (``{"seed": S, "rules": [...]}``)
before processes start — spawned workers inherit the environment, so one
env var arms a whole fleet; :class:`~repro_torch.serving.cluster.WorkerNode`
and :class:`~repro_torch.serving.cluster.ClusterFrontend` call
:func:`init_from_env` with their role at construction.
"""
from __future__ import annotations

import json
import os
import random
import threading
import time
from typing import Any

FAULT_PLAN_ENV = "REPRO_FAULT_PLAN"

#: The zero-overhead guard. Hook sites check this module attribute before
#: doing ANY other fault work; it is True iff a plan is installed.
ENABLED = False

_POINTS = ("send", "recv", "ring_ack", "spawn", "artifact")
_ACTIONS = ("kill", "drop", "delay", "dup", "fail", "corrupt")
_ROLES = ("worker", "frontend", "any")


class InjectedFault(RuntimeError):
    """An injected failure (the ``fail`` action) — never a real error."""


class FaultPlan:
    """A seeded, deterministic schedule of injected faults.

    Thread-safe: hook sites are called from reader/dispatcher/conn threads
    concurrently; counters and rule budgets live under one lock (the plan
    is only ever consulted when faults are deliberately enabled, so the
    lock is not on any production path).
    """

    def __init__(self, rules: list[dict] | tuple = (), seed: int = 0):
        self.seed = int(seed)
        self.rules = [self._validate(dict(r)) for r in rules]
        self._rng = random.Random(self.seed)
        self._counts: dict[tuple, int] = {}
        self._fired: list[dict] = []
        self._lock = threading.Lock()

    @staticmethod
    def _validate(rule: dict) -> dict:
        point = rule.get("point")
        if point not in _POINTS:
            raise ValueError(f"fault rule point must be one of {_POINTS}, "
                             f"got {point!r}")
        action = rule.get("action")
        if action not in _ACTIONS:
            raise ValueError(f"fault rule action must be one of {_ACTIONS}, "
                             f"got {action!r}")
        role = rule.setdefault("role", "any")
        if role not in _ROLES:
            raise ValueError(f"fault rule role must be one of {_ROLES}, "
                             f"got {role!r}")
        rule.setdefault("op", None)
        rule["after"] = int(rule.get("after", 0))
        rule["count"] = int(rule.get("count", 1))
        rule["secs"] = float(rule.get("secs", 0.0))
        rule["_left"] = rule["count"]
        return rule

    # ------------------------------------------------------------- matching
    def consult(self, role: str, point: str, op: str | None) -> dict | None:
        """The action (if any) for one event; advances counters/budgets.

        Event counters key on ``(point, op)`` — every event at a point
        bumps both its op-specific and its op-agnostic counter, so a rule
        can target "the 3rd submit_batch frame" or "the 10th frame of any
        kind" with the same schema.
        """
        with self._lock:
            self._counts[(point, op)] = self._counts.get((point, op), 0) + 1
            if op is not None:      # op-agnostic counter sees every event
                self._counts[(point, None)] = \
                    self._counts.get((point, None), 0) + 1
            for rule in self.rules:
                if rule["_left"] == 0:
                    continue
                if rule["role"] != "any" and rule["role"] != role:
                    continue
                if rule["point"] != point:
                    continue
                if rule["op"] is not None and rule["op"] != op:
                    continue
                seen = self._counts.get((point, rule["op"]), 0)
                if seen <= rule["after"]:
                    continue
                if rule["_left"] > 0:
                    rule["_left"] -= 1
                self._fired.append({"role": role, "point": point, "op": op,
                                    "action": rule["action"],
                                    "event": seen})
                return rule
            return None

    def corrupt_bytes(self, data: bytes, n_flips: int = 16) -> bytes:
        """Deterministically flip ``n_flips`` seeded byte positions."""
        if not data:
            return data
        buf = bytearray(data)
        with self._lock:
            for _ in range(min(n_flips, len(buf))):
                i = self._rng.randrange(len(buf))
                buf[i] ^= 0xFF
        return bytes(buf)

    # ------------------------------------------------------------ reporting
    def fired(self) -> list[dict]:
        """Every rule firing so far (role/point/op/action/event index)."""
        with self._lock:
            return list(self._fired)

    def exhausted(self) -> bool:
        """True when every bounded rule has spent its budget."""
        with self._lock:
            return all(r["_left"] == 0 for r in self.rules
                       if r["count"] >= 0)

    def to_json(self) -> str:
        """The env-shippable form (counters/budgets not included)."""
        rules = [{k: v for k, v in r.items() if k != "_left"}
                 for r in self.rules]
        return json.dumps({"seed": self.seed, "rules": rules})

    @classmethod
    def from_json(cls, raw: str) -> "FaultPlan":
        try:
            spec = json.loads(raw)
        except ValueError as exc:
            raise ValueError(
                f"{FAULT_PLAN_ENV} is not valid JSON: {exc}") from exc
        if not isinstance(spec, dict) or not isinstance(
                spec.get("rules", []), list):
            raise ValueError(
                f'{FAULT_PLAN_ENV} must be {{"seed": S, "rules": [...]}}')
        return cls(rules=spec.get("rules", ()), seed=spec.get("seed", 0))


# ---------------------------------------------------------------------------
# Process-global installation
# ---------------------------------------------------------------------------

_plan: FaultPlan | None = None
_role: str = "any"


def install(plan: FaultPlan | None, role: str | None = None) -> None:
    """Arm ``plan`` process-globally (``None`` disarms — see :func:`clear`)."""
    global _plan, ENABLED, _role
    if role is not None:
        set_role(role)
    _plan = plan
    ENABLED = plan is not None


def clear() -> None:
    """Disarm fault injection; hook sites go back to the one-bool guard."""
    install(None)


def active() -> FaultPlan | None:
    return _plan


def set_role(role: str) -> None:
    """Declare which kind of process this is (rules filter on it)."""
    global _role
    if role not in _ROLES:
        raise ValueError(f"role must be one of {_ROLES}, got {role!r}")
    _role = role


def init_from_env(role: str) -> None:
    """Arm the plan from ``REPRO_FAULT_PLAN`` if set (worker bootstrap path).

    Called by ``WorkerNode`` / ``ClusterFrontend`` construction so a plan
    exported before the fleet starts arms every process, each knowing its
    role. A process that already has an installed plan keeps it (an
    explicit :func:`install` wins over the inherited env).
    """
    set_role(role)
    if _plan is not None:
        return
    raw = os.environ.get(FAULT_PLAN_ENV)
    if raw and raw.strip():
        install(FaultPlan.from_json(raw))


# ---------------------------------------------------------------------------
# Hook-site helpers (call ONLY under `if faults.ENABLED:`)
# ---------------------------------------------------------------------------

def on_point(point: str, op: str | None = None) -> str | None:
    """Consult the plan at a hook site; applies kill/delay here.

    Returns the remaining action for the caller to apply (``"drop"`` /
    ``"dup"``), raises :class:`InjectedFault` for ``"fail"``, or returns
    ``None`` (no fault, or a delay that has already been slept).
    """
    plan = _plan
    if plan is None:
        return None
    rule = plan.consult(_role, point, op)
    if rule is None:
        return None
    action = rule["action"]
    if action == "kill":
        os._exit(17)                    # crash, not a clean shutdown
    if action == "delay":
        time.sleep(rule["secs"])
        return None
    if action == "fail":
        raise InjectedFault(
            f"injected {point} failure (role={_role}, op={op})")
    return action                       # "drop" | "dup" | "corrupt"


def corrupt_artifact(data: bytes | None) -> bytes | None:
    """The ``artifact`` hook: corrupt shipped bytes when a rule says so."""
    plan = _plan
    if plan is None or data is None:
        return data
    if on_point("artifact") == "corrupt":
        return plan.corrupt_bytes(data)
    return data


def frame_op(obj: Any) -> str | None:
    """Best-effort op tag of a frame object (for rule matching)."""
    if isinstance(obj, dict):
        op = obj.get("op")
        if isinstance(op, str):
            return op
    return None
