"""The port's fault injection (``repro_torch.serving.faults``) against
``repro.serving.faults``, and the self-healing paths it drives.

For the same plan and seed, the port's ``FaultPlan`` fires at the same
events with the same actions as the reference's, and corrupts the same
bytes; the reference's unit cases run on the port; and the injected faults
drive the port's cluster tier on the CPU: a dropped result frame becomes a
typed ``DeadlineExceeded``, a failed respawn is counted and retried, a dead
worker's shared-memory rings are unlinked, and ``close()`` with a window in
flight neither hangs nor drops a future.
"""
import os
import random
import signal
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.serving import faults as jfaults  # noqa: E402
from repro_torch.core import ReplayExecutor  # noqa: E402
from repro_torch.serving import (ClusterFrontend, DeadlineExceeded, FaultPlan,  # noqa: E402
                                 InjectedFault)
from repro_torch.serving import faults  # noqa: E402
from repro_torch.serving.demo import demo_region  # noqa: E402

REGISTRY_SPEC = "repro_torch.serving.demo:DEMO_REGISTRY"
DIM = 6


def _bufs(seed, width=2):
    rng = np.random.default_rng(seed)
    b = {f"x{s}": torch.from_numpy(rng.standard_normal((DIM, DIM)).astype(np.float32))
         for s in range(width)}
    b["w"] = torch.from_numpy(rng.standard_normal((DIM, DIM)).astype(np.float32))
    return b


def _check(out, tdg, bufs):
    want = ReplayExecutor(tdg).run(dict(bufs))
    for k in want:
        np.testing.assert_allclose(out[k].numpy(), want[k].numpy(), rtol=2e-5, atol=2e-5)


@pytest.fixture(autouse=True)
def _no_leaked_plan():
    """Every test starts and ends with fault injection disarmed."""
    faults.clear()
    jfaults.clear()
    yield
    faults.clear()
    jfaults.clear()


_RULES = [
    {"point": "send", "op": "submit_batch", "after": 2, "count": 2, "action": "drop"},
    {"point": "recv", "after": 5, "count": -1, "action": "dup", "role": "worker"},
    {"point": "recv", "op": "result_batch", "after": 1, "count": 1, "action": "delay",
     "secs": 0.0, "role": "frontend"},
    {"point": "ring_ack", "after": 3, "count": 2, "action": "drop"},
    {"point": "spawn", "after": 1, "count": 1, "action": "fail", "role": "frontend"},
    {"point": "artifact", "count": 1, "action": "corrupt"},
]


class TestSameDecisionsAsTheReference:
    @pytest.mark.parametrize("seed", [0, 7, 123])
    def test_same_plan_same_schedule_fires_the_same_events(self, seed):
        plans = [P(_RULES, seed=seed) for P in (FaultPlan, jfaults.FaultPlan)]
        rng = random.Random(seed)
        points = ["send", "recv", "ring_ack", "spawn", "artifact"]
        ops = [None, "submit_batch", "result_batch", "register", "hb"]
        for _ in range(300):
            event = (rng.choice(["worker", "frontend"]), rng.choice(points), rng.choice(ops))
            got = [p.consult(*event) for p in plans]
            assert (got[0] is None) == (got[1] is None)
            if got[0] is not None:
                assert got[0]["action"] == got[1]["action"]
        assert plans[0].fired() == plans[1].fired() and plans[0].fired()
        assert plans[0].exhausted() == plans[1].exhausted()

    @pytest.mark.parametrize("seed", [0, 3, 99])
    def test_corrupt_bytes_flip_the_same_positions(self, seed):
        data = bytes(range(256)) * 16
        assert FaultPlan(seed=seed).corrupt_bytes(data) == \
            jfaults.FaultPlan(seed=seed).corrupt_bytes(data)

    def test_env_json_is_interchangeable(self):
        plan = FaultPlan(_RULES, seed=5)
        jplan = jfaults.FaultPlan(_RULES, seed=5)
        assert plan.to_json() == jplan.to_json()
        assert FaultPlan.from_json(jplan.to_json()).rules == plan.rules
        assert faults.FAULT_PLAN_ENV == jfaults.FAULT_PLAN_ENV == "REPRO_FAULT_PLAN"

    def test_on_point_applies_the_same_actions(self):
        rules = [{"point": "send", "after": 1, "count": 3, "action": "dup"},
                 {"point": "recv", "action": "fail", "count": 2}]
        for mod in (faults, jfaults):
            mod.install(mod.FaultPlan(rules, seed=1), role="worker")
        for point in ["send"] * 5:
            assert faults.on_point(point, "x") == jfaults.on_point(point, "x")
        for mod, exc in ((faults, InjectedFault), (jfaults, jfaults.InjectedFault)):
            with pytest.raises(exc, match="recv"):
                mod.on_point("recv")
        assert [f["event"] for f in faults.active().fired()] == \
            [f["event"] for f in jfaults.active().fired()]


class TestFaultPlan:
    def test_validation_is_loud(self):
        with pytest.raises(ValueError, match="point"):
            FaultPlan([{"point": "teleport", "action": "drop"}])
        with pytest.raises(ValueError, match="action"):
            FaultPlan([{"point": "send", "action": "explode"}])
        with pytest.raises(ValueError, match="role"):
            FaultPlan([{"point": "send", "action": "drop", "role": "gpu"}])

    def test_after_and_count_budgets(self):
        plan = FaultPlan([{"point": "send", "op": "submit_batch",
                           "after": 2, "count": 2, "action": "drop"}])
        hits = [plan.consult("frontend", "send", "submit_batch") is not None
                for _ in range(6)]
        # events 1,2 skipped (after=2), events 3,4 fire (count=2), then spent
        assert hits == [False, False, True, True, False, False]
        assert plan.exhausted()

    def test_op_none_counts_any_frame(self):
        plan = FaultPlan([{"point": "recv", "after": 1, "count": 1,
                           "action": "drop"}])
        assert plan.consult("worker", "recv", "submit_batch") is None
        assert plan.consult("worker", "recv", "result_batch") is not None

    def test_role_filtering(self):
        plan = FaultPlan([{"point": "send", "role": "worker",
                           "action": "drop", "count": -1}])
        assert plan.consult("frontend", "send", None) is None
        assert plan.consult("worker", "send", None) is not None

    def test_determinism_same_plan_same_schedule(self):
        spec = [{"point": "send", "op": "submit_batch", "after": 1,
                 "count": 2, "action": "drop"}]
        fired = []
        for _ in range(2):
            plan = FaultPlan(spec, seed=7)
            for _ in range(5):
                plan.consult("frontend", "send", "submit_batch")
            fired.append([(f["event"], f["action"]) for f in plan.fired()])
        assert fired[0] == fired[1] == [(2, "drop"), (3, "drop")]

    def test_corrupt_bytes_is_seeded(self):
        data = bytes(range(256)) * 4
        a = FaultPlan(seed=3).corrupt_bytes(data)
        b = FaultPlan(seed=3).corrupt_bytes(data)
        c = FaultPlan(seed=4).corrupt_bytes(data)
        assert a == b and a != data and a != c

    def test_json_roundtrip(self):
        plan = FaultPlan([{"point": "spawn", "action": "fail", "count": 3}],
                         seed=11)
        again = FaultPlan.from_json(plan.to_json())
        assert again.seed == 11
        assert again.rules[0]["point"] == "spawn"
        assert again.rules[0]["count"] == 3
        with pytest.raises(ValueError, match="not valid JSON"):
            FaultPlan.from_json("{nope")
        with pytest.raises(ValueError, match="rules"):
            FaultPlan.from_json('{"rules": "not-a-list"}')

    def test_install_flips_the_guard(self):
        assert faults.ENABLED is False
        faults.install(FaultPlan(), role="frontend")
        assert faults.ENABLED is True
        assert faults.active() is not None
        faults.clear()
        assert faults.ENABLED is False
        assert faults.on_point("send") is None     # disarmed: no-op

    def test_explicit_install_wins_over_env(self, monkeypatch):
        mine = FaultPlan(seed=42)
        faults.install(mine, role="frontend")
        monkeypatch.setenv(faults.FAULT_PLAN_ENV,
                           FaultPlan(seed=1).to_json())
        faults.init_from_env("frontend")
        assert faults.active() is mine

    def test_env_arms_when_nothing_installed(self, monkeypatch):
        monkeypatch.setenv(faults.FAULT_PLAN_ENV,
                           FaultPlan(seed=9).to_json())
        faults.init_from_env("worker")
        assert faults.ENABLED and faults.active().seed == 9

    def test_fail_action_raises_injected_fault(self):
        faults.install(FaultPlan([{"point": "spawn", "action": "fail"}]),
                       role="frontend")
        with pytest.raises(InjectedFault, match="spawn"):
            faults.on_point("spawn")


def _wait_for(pred, timeout=90.0, tick=0.05):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(tick)
    return False


class TestInjectedFaults:
    def test_dropped_result_frame_becomes_deadline_exceeded(self):
        # Drop the second result_batch the FRONTEND receives: the worker
        # computed and answered, the reply evaporated. Without the
        # supervisor's deadline sweep this hangs forever; with it the
        # caller gets a typed DeadlineExceeded, the window slot frees, and
        # the next request flows normally. The first request warms the
        # worker, so the 3 s deadline never races a cold first step on a
        # loaded host (the rule must fire, not the deadline alone).
        faults.install(FaultPlan([{"role": "frontend", "point": "recv",
                                   "op": "result_batch", "after": 1, "count": 1,
                                   "action": "drop"}]), role="frontend")
        with ClusterFrontend(workers=1, registry=REGISTRY_SPEC, device="cpu",
                             heartbeat_secs=0.3, lease_misses=3,
                             retry_budget=0, name="test-drop") as fe:
            tdg = demo_region("drop[0]")
            fe.register_tenant("d", tdg)
            bufs = _bufs(20)
            _check(fe.serve("d", bufs, timeout=120), tdg, bufs)
            with pytest.raises(DeadlineExceeded):
                fe.serve("d", bufs, timeout=3.0)
            assert faults.active().exhausted()
            assert fe.deadline_failures >= 1
            # the sweep released the frame slot: the connection still flows
            _check(fe.serve("d", bufs, timeout=120), tdg, bufs)

    def test_spawn_fault_burns_a_respawn_attempt_then_recovers(self):
        # Kill the worker, and make the FIRST respawn attempt fail at
        # launch (a host that momentarily cannot start processes). The
        # supervisor must count the failure, back off, and succeed on the
        # next attempt.
        faults.install(FaultPlan([{"role": "frontend", "point": "spawn",
                                   "after": 1, "count": 1,
                                   "action": "fail"}]), role="frontend")
        with ClusterFrontend(workers=1, registry=REGISTRY_SPEC, device="cpu",
                             heartbeat_secs=0.3, lease_misses=3,
                             respawn_max=5, name="test-spawnfault") as fe:
            tdg = demo_region("sf[0]")
            fe.register_tenant("s", tdg)
            bufs = _bufs(21)
            _check(fe.serve("s", bufs, timeout=120), tdg, bufs)
            fe._handles[0].process.kill()
            assert _wait_for(lambda: fe.respawn_failures >= 1)
            assert _wait_for(lambda: fe.respawns >= 1
                             and fe._handles[0].alive)
            _check(fe.serve("s", bufs, timeout=120), tdg, bufs)
            assert fe.stats()["frontend"]["respawn_failures"] >= 1


class TestDeathCleanupRegressions:
    """Two regressions of the reference: shm-segment leaks on worker death, and
    the close()-vs-dispatcher race."""

    def test_worker_death_unlinks_shm_rings_and_falls_back_to_tcp(self):
        with ClusterFrontend(workers=1, registry=REGISTRY_SPEC, device="cpu",
                             transport="shm", heartbeat_secs=0.3,
                             lease_misses=3, respawn_max=5,
                             name="test-shmleak") as fe:
            h = fe._handles[0]
            assert h.transport == "shm"
            ring_names = [r.name for r in (h.conn._send_ring,
                                           h.conn._recv_ring)]
            for nm in ring_names:
                assert os.path.exists(f"/dev/shm/{nm}")
            tdg = demo_region("leak[0]")
            fe.register_tenant("l", tdg)
            bufs = _bufs(30)
            _check(fe.serve("l", bufs, timeout=120), tdg, bufs)
            fallbacks_before = fe.stats()["frontend"]["shm_fallbacks"]
            h.process.kill()
            assert _wait_for(lambda: not h.alive)
            # the death path (not frontend teardown) unlinked both rings
            assert _wait_for(lambda: not any(
                os.path.exists(f"/dev/shm/{nm}") for nm in ring_names),
                timeout=30)
            assert _wait_for(lambda: fe.respawns >= 1
                             and fe._handles[0].alive)
            # replacement's first connection is deliberately TCP, counted
            assert fe._handles[0].transport == "tcp"
            assert fe.stats()["frontend"]["shm_fallbacks"] > fallbacks_before
            _check(fe.serve("l", bufs, timeout=120), tdg, bufs)

    def test_close_with_inflight_window_never_hangs_or_drops_futures(self):
        # Stall the worker (SIGSTOP) with a window's worth of submissions
        # in flight, then close() the frontend: close must return promptly
        # and every outstanding future must resolve to a typed error —
        # never hang, never silently stay pending.
        fe = ClusterFrontend(workers=1, registry=REGISTRY_SPEC, device="cpu",
                             heartbeat_secs=0, shutdown_grace=5.0,
                             name="test-closerace")
        closed = False
        try:
            tdg = demo_region("cr[0]")
            fe.register_tenant("c", tdg)
            bufs = _bufs(31)
            _check(fe.serve("c", bufs, timeout=120), tdg, bufs)
            os.kill(fe._handles[0].process.pid, signal.SIGSTOP)
            futs = [fe.submit("c", bufs) for _ in range(24)]
            t0 = time.monotonic()
            closer = threading.Thread(target=fe.close, daemon=True)
            closer.start()
            closer.join(timeout=60)
            assert not closer.is_alive(), "close() hung on inflight window"
            closed = True
            assert time.monotonic() - t0 < 60
            for f in futs:
                assert f.done(), "close() dropped a future silently"
                with pytest.raises(Exception):
                    f.result(0)
        finally:
            try:
                os.kill(fe._handles[0].process.pid, signal.SIGCONT)
            except (ProcessLookupError, OSError):
                pass
            if not closed:
                fe.close()
