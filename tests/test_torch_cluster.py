"""The port's cluster tier (``repro_torch.serving.cluster``, ``spawner``,
``worker``) on the CPU, against in-process ground truth and the reference.

Workers are spawned with ``device="cpu"``. Every distributed answer is held
to the port's in-process ``ReplayExecutor`` and to the JAX package's on the
same numpy inputs (the RPC front must never change WHAT is computed, only
WHERE); ``StickyRouter`` makes the reference's assignments for the same call
sequence; the reference's cluster cases run on the port: cross-process
coalescing, error isolation, pinned groups, artifact shipping (a shipped
worker never lowers, ``REPRO_SHIP_ARTIFACTS=0`` re-lowers, a poisoned
artifact is loud), requeue after a worker death, supervised respawn, typed
wire errors, remote bootstrap through ``python -m repro_torch.serving.worker
--device cpu``, the shared-memory data plane; and ``launch.serve --smoke
--cluster 2 --device cpu`` generates the JAX in-process server's greedy
tokens at the reduced qwen2.5-3b. The multi-worker soak is ``slow``, as the
reference's is.
"""
import pickle
import random
import re
import shutil
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import repro.core as J  # noqa: E402
from repro.serving.cluster import StickyRouter as JStickyRouter  # noqa: E402
from repro.serving.demo import DEMO_REGISTRY as J_DEMO  # noqa: E402
from repro_torch.core import (ReplayExecutor, tdg_to_dict, topology_fingerprint,  # noqa: E402
                              warmup_and_save)
from repro_torch.serving import (ClusterError, ClusterFrontend, ClusterRemoteError,  # noqa: E402
                                 RateLimited, RegionServer, StickyRouter, WorkerNode)
from repro_torch.serving.metrics import validate_trace  # noqa: E402
from repro_torch.serving.demo import DEMO_REGISTRY, demo_affine, demo_region  # noqa: E402
from repro_torch.serving.worker import spawn_worker_subprocess  # noqa: E402

REGISTRY_SPEC = "repro_torch.serving.demo:DEMO_REGISTRY"
DIM = 6


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a, np.float32))


def _bufs(seed, width=2, shared_w=None):
    rng = np.random.default_rng(seed)
    b = {f"x{s}": _t(rng.standard_normal((DIM, DIM))) for s in range(width)}
    b["w"] = shared_w if shared_w is not None else _t(rng.standard_normal((DIM, DIM)))
    return b


def _check(out, tdg, bufs):
    """``out`` against the port's in-process replay and the JAX package's
    (the same TDG, re-linked from its JSON) on the same inputs."""
    want = ReplayExecutor(tdg).run(dict(bufs))
    jtdg = J.tdg_from_dict(tdg_to_dict(tdg, DEMO_REGISTRY), J_DEMO)
    jwant = J.ReplayExecutor(jtdg).run({k: np.asarray(v) for k, v in bufs.items()})
    assert set(out) == set(want) == set(jwant)
    for k in want:
        assert isinstance(out[k], torch.Tensor) and out[k].device.type == "cpu"
        np.testing.assert_allclose(out[k].numpy(), want[k].numpy(), rtol=2e-5, atol=2e-5)
        np.testing.assert_allclose(out[k].numpy(), np.asarray(jwant[k]), rtol=2e-5, atol=2e-5)


class TestSameRoutingAsTheReference:
    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_same_call_sequence_same_assignments(self, seed):
        rng = random.Random(seed)
        port, ref = StickyRouter(4), JStickyRouter(4)
        alive = {0, 1, 2, 3}
        for _ in range(200):
            key = f"sig{rng.randrange(9)}"
            if rng.random() < 0.2 and len(alive) > 1:
                dead = rng.choice(sorted(alive))
                args = (key, alive - {dead}, {dead})
                assert port.reroute(*args) == ref.reroute(*args)
            else:
                live = set(rng.sample(sorted(alive), rng.randint(1, len(alive))))
                assert port.route(key, live) == ref.route(key, live)
        assert port.assignment() == ref.assignment()


class TestDeviceIsExplicit:
    @pytest.mark.skipif(torch.cuda.is_available(), reason="needs a machine without a card")
    def test_no_card_raises_unless_cpu(self):
        from repro_torch.launch import serve
        with pytest.raises(RuntimeError, match="device='cpu'"):
            WorkerNode(DEMO_REGISTRY)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            ClusterFrontend(workers=1, registry=REGISTRY_SPEC)
        with pytest.raises(RuntimeError, match="--device cpu"):
            serve.build_decode_registry(smoke=True)
        with pytest.raises(RuntimeError, match="--device cpu"):
            serve.main(["--smoke", "--cluster", "1"])


class TestShipArtifactsKillSwitch:
    def test_ship_artifacts_0_relowers(self, monkeypatch, tmp_path):
        tdg = demo_region("ks[0]")
        bufs = _bufs(61)
        path = str(tmp_path / "ks.json")
        warmup_and_save(tdg, bufs, path, DEMO_REGISTRY)
        monkeypatch.setenv("REPRO_SHIP_ARTIFACTS", "0")
        with ClusterFrontend(device="cpu", workers=1, registry=REGISTRY_SPEC,
                             heartbeat_secs=0, name="test-noship") as fe:
            assert fe.ship_artifacts is False
            rec = fe.register_tenant("ks", warm_path=path)
            assert rec.artifact is not None          # held, never shipped
            _check(fe.serve("ks", bufs), tdg, bufs)
            st = fe.stats()
        assert st["frontend"]["artifacts_shipped"] == 0
        assert st["aggregate"]["hydrated_inband"] == 0
        assert st["workers"][0]["intern"]["misses"] >= 1
        assert st["aggregate"]["aot_served"] == 0


class TestClusterWarmup:
    def test_warmup_exports_on_the_worker_and_ships_to_the_next(self, frontend, shared_w):
        tdg = demo_region("cw[0]")
        frontend.register_tenant("cw", tdg, pinned={"w": shared_w})
        bufs = _bufs(90, shared_w=shared_w)
        send = {k: v for k, v in bufs.items() if k != "w"}
        report = frontend.warmup("cw", send)          # pinned w merged worker-side
        assert report["fused"] and report["trace_seconds"] > 0
        rec = frontend.tenant("cw")
        assert rec.artifact is not None
        blob = pickle.loads(rec.artifact)
        assert blob["topology"] == topology_fingerprint("cpu")
        before = frontend.stats()["aggregate"]["aot_served"]
        _check(frontend.serve("cw", send), tdg, bufs)
        assert frontend.stats()["aggregate"]["aot_served"] == before + 1


class TestStickyRouter:
    def test_sticky_by_key(self):
        r = StickyRouter(4)
        alive = {0, 1, 2, 3}
        w = r.route("sigA", alive)
        for _ in range(5):
            assert r.route("sigA", alive) == w

    def test_distinct_structures_spread_least_loaded(self):
        r = StickyRouter(2)
        alive = {0, 1}
        workers = {r.route(f"sig{i}", alive) for i in range(2)}
        assert workers == {0, 1}

    def test_reroute_excludes_dead(self):
        r = StickyRouter(3)
        alive = {0, 1, 2}
        w = r.route("sig", alive)
        w2 = r.reroute("sig", alive - {w}, exclude={w})
        assert w2 != w
        assert r.route("sig", alive - {w}) == w2   # sticky on the new home

    def test_no_live_workers(self):
        r = StickyRouter(2)
        with pytest.raises(Exception, match="no live workers"):
            r.route("sig", set())


@pytest.fixture(scope="module")
def frontend():
    fe = ClusterFrontend(device="cpu", workers=2, registry=REGISTRY_SPEC, max_wait_ms=5.0,
                         name="test-cluster")
    yield fe
    fe.close()


@pytest.fixture(scope="module")
def shared_w():
    return _t(np.random.default_rng(99).standard_normal((DIM, DIM)))


class TestClusterServing:
    def test_parity_vs_inprocess_ground_truth(self, frontend, shared_w):
        tenants = []
        for i in range(4):
            tdg = demo_region(f"par[{i}]")
            frontend.register_tenant(f"par{i}", tdg, pinned={"w": shared_w})
            tenants.append((tdg, _bufs(20 + i, shared_w=shared_w)))
        futs = [frontend.submit(f"par{i}",
                                {k: v for k, v in b.items() if k != "w"})
                for i, (_, b) in enumerate(tenants)]
        outs = [f.result(120) for f in futs]
        for (tdg, b), out in zip(tenants, outs):
            _check(out, tdg, b)

    def test_sticky_routing_by_structure(self, frontend, shared_w):
        # 3 tenants of one structure + 2 of another: each structure must
        # land whole on exactly one worker (warm state never splits).
        for i in range(3):
            frontend.register_tenant(
                f"stA{i}", demo_region(f"stA[{i}]", waves=3),
                pinned={"w": shared_w})
        for i in range(2):
            frontend.register_tenant(
                f"stB{i}", demo_region(f"stB[{i}]", waves=3,
                                       body=demo_affine),
                pinned={"w": shared_w})
        a_workers = {frontend.tenant(f"stA{i}").worker for i in range(3)}
        b_workers = {frontend.tenant(f"stB{i}").worker for i in range(2)}
        assert len(a_workers) == 1
        assert len(b_workers) == 1
        # different payload symbol => different routing key; least-loaded
        # assignment puts it on the other worker of the pair
        assert a_workers != b_workers

    def test_cross_process_coalescing(self, frontend, shared_w):
        # Same-structure tenants routed to one worker still coalesce there:
        # the fleet's coalesced_requests must rise when we fire concurrently.
        before = frontend.stats()["aggregate"]["coalesced_requests"]
        for i in range(3):
            frontend.register_tenant(
                f"co{i}", demo_region(f"co[{i}]", waves=4),
                pinned={"w": shared_w})
        bufs = [_bufs(40 + i, shared_w=shared_w) for i in range(3)]
        for _ in range(3):      # several rounds: at least one coalesces
            futs = [frontend.submit(
                f"co{i}", {k: v for k, v in bufs[i].items() if k != "w"})
                for i in range(3)]
            [f.result(120) for f in futs]
        after = frontend.stats()["aggregate"]["coalesced_requests"]
        assert after > before

    def test_request_error_is_isolated(self, frontend):
        frontend.register_tenant("err", demo_region("err[0]"))
        with pytest.raises(ClusterRemoteError, match="missing"):
            frontend.serve("err", {"x0": torch.ones((DIM, DIM))})  # no x1/w
        # the worker survived the bad request
        assert len(frontend._alive()) == 2
        good = _bufs(50)
        out = frontend.serve("err", good)
        _check(out, demo_region("err[0]"), good)

    def test_unknown_tenant(self, frontend):
        with pytest.raises(KeyError, match="unknown tenant"):
            frontend.serve("ghost", {})

    def test_duplicate_tenant_rejected(self, frontend):
        frontend.register_tenant("dup", demo_region("dup[0]"))
        with pytest.raises(ValueError, match="already registered"):
            frontend.register_tenant("dup", demo_region("dup[1]"))

    def test_aggregate_sums_worker_metrics(self, frontend):
        st = frontend.stats()
        live = [s for s in st["workers"].values() if s is not None]
        assert st["aggregate"]["admitted"] == sum(
            s["metrics"]["admitted"] for s in live)
        assert st["frontend"]["alive"] == 2
        assert set(st["aggregate"]) >= {
            "admitted", "completed", "failed", "coalesced_requests",
            "aot_served", "aot_hydrate_failures", "pool", "intern"}

    def test_pinned_group_ships_once_per_worker(self, frontend, shared_w):
        # Every pinned registration in this module passes the SAME shared_w
        # object, so there is exactly one pin group, shipped to at most one
        # worker per distinct placement — never once per tenant.
        st = frontend.stats()
        pinned_workers = {r["worker"] for r in st["tenants"].values()}
        assert 1 <= st["frontend"]["pin_groups_shipped"] <= len(pinned_workers)
        for s in st["workers"].values():
            if s is not None:
                assert s["worker"]["pin_groups"] <= 1

    def test_failed_registration_leaves_no_phantom(self, frontend,
                                                   monkeypatch):
        from repro_torch.core import TDG

        def unregistered_payload(x, w):
            return x + w
        bad = TDG("phantom[0]")
        bad.add_task(unregistered_payload, ins=["x0", "w"], outs=["x0"])
        # frontend-side failure (payload has no symbol in DEMO_REGISTRY):
        # fails before any record exists
        with pytest.raises(ValueError, match="not registered"):
            frontend.register_tenant("phantom", bad)
        # worker-side failure (registration RPC errors after the record is
        # inserted): the record must be rolled back, not left as a phantom
        # that blocks the retry
        def boom(widx, record):
            raise ClusterRemoteError("worker rejected registration")
        monkeypatch.setattr(frontend, "_register_on", boom)
        with pytest.raises(ClusterRemoteError, match="rejected"):
            frontend.register_tenant("phantom", demo_region("phantom[0]"))
        monkeypatch.undo()
        frontend.register_tenant("phantom", demo_region("phantom[1]"))
        good = _bufs(55)
        _check(frontend.serve("phantom", good),
               demo_region("phantom[1]"), good)

    def test_health(self, frontend):
        rows = frontend.health()
        assert len(rows) == 2
        assert all(r["alive"] and r["process_alive"] for r in rows)
        assert all(isinstance(r["pid"], int) for r in rows)


class TestArtifactShipping:
    @pytest.fixture(scope="class")
    def cold_frontend(self):
        fe = ClusterFrontend(device="cpu", workers=1, registry=REGISTRY_SPEC,
                             name="test-cold")
        yield fe
        fe.close()

    @pytest.fixture(scope="class")
    def warm_artifact(self, tmp_path_factory):
        tdg = demo_region("warm[0]")
        bufs = _bufs(60)
        path = str(tmp_path_factory.mktemp("warm") / "region.json")
        warmup_and_save(tdg, bufs, path, DEMO_REGISTRY)
        return path, tdg, bufs

    def test_cold_worker_hydrates_without_relowering(self, cold_frontend,
                                                     warm_artifact):
        path, tdg, bufs = warm_artifact
        rec = cold_frontend.register_tenant("warm", warm_path=path)
        assert rec.artifact is not None          # sidecar held for re-shipping
        out = cold_frontend.serve("warm", bufs)
        _check(out, tdg, bufs)
        st = cold_frontend.stats()
        wk = st["workers"][0]
        assert st["aggregate"]["hydrated_inband"] == 1
        assert st["aggregate"]["aot_served"] >= 1
        # THE cold-start claim: the worker served from the shipped binary
        # and never lowered anything itself.
        assert wk["intern"]["misses"] == 0
        assert st["aggregate"]["aot_hydrate_failures"] == 0

    def test_poisoned_artifact_is_loud_but_survivable(self, cold_frontend,
                                                      warm_artifact,
                                                      tmp_path):
        path, tdg, bufs = warm_artifact
        poisoned = str(tmp_path / "poisoned.json")
        with open(path) as f:
            graph = f.read()
        with open(poisoned, "w") as f:
            f.write(graph)
        with open(poisoned + ".aot", "wb") as f:
            f.write(b"not an executable")
        before = cold_frontend.stats()["aggregate"]["aot_hydrate_failures"]
        cold_frontend.register_tenant("poison", warm_path=poisoned)
        out = cold_frontend.serve("poison", bufs)   # lazy fallback still right
        _check(out, tdg, bufs)
        after = cold_frontend.stats()["aggregate"]["aot_hydrate_failures"]
        assert after == before + 1


class TestWorkerDeathRequeue:
    def test_kill_requeues_to_sibling_with_parity(self):
        # heartbeat_secs=0 pins the supervisor OFF: this test asserts the
        # bare death->requeue contract (victim stays dead, tenant moves to
        # the sibling for good); self-healing respawn has its own tests.
        with ClusterFrontend(device="cpu", workers=2, registry=REGISTRY_SPEC,
                             heartbeat_secs=0,
                             name="test-kill") as fe:
            shared = _t(np.random.default_rng(7).standard_normal((DIM, DIM)))
            tdg = demo_region("kill[0]")
            fe.register_tenant("k", tdg, pinned={"w": shared})
            bufs = {f"x{s}": _t(np.random.default_rng(8 + s).standard_normal((DIM, DIM))) for s in range(2)}
            out_before = fe.serve("k", bufs)
            _check(out_before, tdg, {**bufs, "w": shared})
            victim = fe.tenant("k").worker
            fe._handles[victim].process.terminate()
            fe._handles[victim].process.join(timeout=30)
            deadline = time.monotonic() + 30
            while fe._handles[victim].alive and time.monotonic() < deadline:
                time.sleep(0.05)     # reader notices EOF
            out_after = fe.serve("k", bufs)
            for key in out_before:
                np.testing.assert_allclose(np.asarray(out_after[key]),
                                           np.asarray(out_before[key]),
                                           rtol=2e-5, atol=2e-5)
            st = fe.stats()
            assert fe.tenant("k").worker != victim
            assert st["frontend"]["worker_deaths"] >= 1
            assert st["frontend"]["requeues"] >= 1
            assert st["frontend"]["alive"] == 1


class TestContinuousCluster:
    def test_kill_mid_resident_batch_supervised_all_resolve(self):
        # Workers run continuous RegionServers (the default): a burst of
        # concurrent submits forms a resident batch on the victim when it
        # is SIGKILLed. With the supervisor ON, every in-flight step must
        # resolve — requeued to the sibling with ground-truth parity or
        # failed with a typed error, zero hangs — and the respawned slot
        # must keep serving. The surviving fleet's execution-pattern trace
        # must be retrievable over the wire and schema-valid.
        with ClusterFrontend(device="cpu", workers=2, registry=REGISTRY_SPEC,
                             heartbeat_secs=0.3, lease_misses=3,
                             respawn_max=3, name="test-contkill") as fe:
            shared = _t(np.random.default_rng(27).standard_normal((DIM, DIM)))
            tdg = demo_region("ck[0]")
            fe.register_tenant("ck", tdg, pinned={"w": shared}, tier=1)
            bufs = {f"x{s}": _t(np.random.default_rng(28 + s).standard_normal((DIM, DIM))) for s in range(2)}
            ground = ReplayExecutor(tdg).run({**bufs, "w": shared})
            fe.serve("ck", bufs, timeout=300)       # warm the victim
            victim = fe.tenant("ck").worker
            respawns_before = fe.respawns
            futs = [fe.submit("ck", bufs) for _ in range(12)]
            fe._handles[victim].process.kill()      # SIGKILL mid-batch
            ok, typed = 0, 0
            for f in futs:
                try:
                    out = f.result(timeout=120)      # zero hangs
                except (ClusterError, ClusterRemoteError, RuntimeError):
                    typed += 1
                    continue
                for key in ground:
                    np.testing.assert_allclose(
                        np.asarray(out[key]), np.asarray(ground[key]),
                        rtol=2e-5, atol=2e-5)
                ok += 1
            assert ok + typed == 12 and ok >= 1
            st = fe.stats()["frontend"]
            assert st["worker_deaths"] >= 1
            deadline = time.monotonic() + 120
            while fe.respawns == respawns_before \
                    and time.monotonic() < deadline:
                time.sleep(0.1)
            assert fe.respawns > respawns_before    # supervised comeback
            out_after = fe.serve("ck", bufs, timeout=120)
            for key in ground:
                np.testing.assert_allclose(np.asarray(out_after[key]),
                                           np.asarray(ground[key]),
                                           rtol=2e-5, atol=2e-5)
            traces = [t for t in fe.trace().values() if t is not None]
            assert traces                            # fleet trace reachable
            for t in traces:
                validate_trace(t["records"])
            assert any(t["summary"]["steps"] >= 1 for t in traces)

    def test_rate_limited_crosses_the_wire_typed(self):
        # A tenant registered with rate=0.001 req/s has a one-token burst:
        # the first request spends it, the second must come back as the
        # TYPED RateLimited (matched by name through the rpc error
        # registry), not an opaque ClusterRemoteError — and must NOT be
        # retried onto another worker.
        with ClusterFrontend(device="cpu", workers=1, registry=REGISTRY_SPEC,
                             heartbeat_secs=0,
                             name="test-ratewire") as fe:
            tdg = demo_region("rl[0]")
            fe.register_tenant("rl", tdg, tier=0, rate=0.001)
            bufs = _bufs(31)
            out = fe.serve("rl", bufs, timeout=300)  # spends the only token
            _check(out, tdg, bufs)
            with pytest.raises(RateLimited, match="rate limit"):
                fe.serve("rl", bufs, timeout=120)
            st = fe.stats()
            assert st["aggregate"]["rate_limited"] == 1


# ---------------------------------------------------------------------------
# Multi-worker soak (slow)
# ---------------------------------------------------------------------------

@pytest.mark.slow
class TestClusterSoak:
    def test_four_workers_dependent_chains(self):
        with ClusterFrontend(device="cpu", workers=4, registry=REGISTRY_SPEC,
                             max_wait_ms=10.0, name="test-soak") as fe:
            shared = _t(np.random.default_rng(1).standard_normal((DIM, DIM)))
            tenants = []
            for i in range(8):
                tdg = demo_region(f"soak[{i}]", waves=2 + (i % 4))
                fe.register_tenant(f"s{i}", tdg, pinned={"w": shared})
                tenants.append((tdg, _bufs(100 + i, shared_w=shared)))
            # dependent chains: each round feeds the next
            state = [dict(b, w=shared) for _, b in tenants]
            for _ in range(6):
                futs = [fe.submit(f"s{i}", {k: v for k, v in state[i].items()
                                            if k != "w"})
                        for i in range(8)]
                for i, f in enumerate(futs):
                    state[i].update(f.result(300))
                    state[i]["w"] = shared
            # ground truth: replay the same chain in-process
            for i, (tdg, b) in enumerate(tenants):
                ex = ReplayExecutor(tdg)
                ref = dict(b)
                for _ in range(6):
                    ref.update(ex.run(dict(ref)))
                    ref["w"] = shared
                for k in ("x0", "x1"):
                    np.testing.assert_allclose(
                        np.asarray(state[i][k]), np.asarray(ref[k]),
                        rtol=2e-4, atol=2e-4)
            st = fe.stats()
            used = {r["worker"] for r in st["tenants"].values()}
            assert len(used) == 4          # 4 structures spread over 4 workers
            assert st["aggregate"]["failed"] == 0


WORKER_TOKEN = "test-remote-token"


@pytest.fixture(scope="module")
def remote_workers():
    """Two pre-started subprocess workers via the shared bootstrap helper
    (`repro_torch.serving.worker.spawn_worker_subprocess`, so the READY/argv
    contract has one home).
    Spawning happens in threads so the two cold starts overlap."""
    results: list = [None, None]

    def boot(i):
        results[i] = spawn_worker_subprocess(REGISTRY_SPEC, token=WORKER_TOKEN,
                                             extra_args=("--device", "cpu"))

    threads = [threading.Thread(target=boot, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=180)
    if any(r is None for r in results):
        for r in results:
            if r is not None:
                r[0].kill()
        pytest.fail("worker subprocess bootstrap timed out")
    try:
        yield results
    finally:
        for p, _addr in results:
            if p.poll() is None:
                p.kill()
            p.wait(timeout=10)


class TestRemoteBootstrap:
    @pytest.fixture(scope="class")
    def mixed_frontend(self, remote_workers):
        # One pre-started remote worker + one locally spawned: both kinds
        # behind the same router/shipping/requeue machinery.
        (_, addr0), _ = remote_workers
        fe = ClusterFrontend(device="cpu", workers=[addr0, "local"],
                             registry=REGISTRY_SPEC, token=WORKER_TOKEN,
                             max_wait_ms=5.0, name="test-remote-mixed")
        yield fe
        fe.close()

    def test_parity_vs_inprocess_ground_truth(self, mixed_frontend, shared_w):
        # The existing 2-worker parity contract, now with a remote worker
        # in the fleet: WHAT is computed must not change with WHERE.
        tenants = []
        for i in range(4):
            tdg = demo_region(f"rpar[{i}]", waves=2 + (i % 2))
            mixed_frontend.register_tenant(f"rpar{i}", tdg,
                                           pinned={"w": shared_w})
            tenants.append((tdg, _bufs(200 + i, shared_w=shared_w)))
        futs = [mixed_frontend.submit(
            f"rpar{i}", {k: v for k, v in b.items() if k != "w"})
            for i, (_, b) in enumerate(tenants)]
        outs = [f.result(120) for f in futs]
        for (tdg, b), out in zip(tenants, outs):
            _check(out, tdg, b)
        # both kinds of worker actually served something
        used = {mixed_frontend.tenant(f"rpar{i}").worker for i in range(4)}
        assert used == {0, 1}

    def test_health_reports_kinds_and_topology(self, mixed_frontend):
        rows = mixed_frontend.health()
        assert [r["kind"] for r in rows] == ["remote", "local"]
        assert all(r["alive"] for r in rows)
        assert rows[0]["process_alive"] is None      # no handle for remote
        assert rows[1]["process_alive"] is True
        assert rows[0]["topology"] == topology_fingerprint("cpu")

    def test_remote_request_error_is_isolated(self, mixed_frontend):
        mixed_frontend.register_tenant("rerr", demo_region("rerr[0]"))
        with pytest.raises(ClusterRemoteError, match="missing"):
            mixed_frontend.serve("rerr", {"x0": torch.ones((DIM, DIM))})
        good = _bufs(210)
        _check(mixed_frontend.serve("rerr", good),
               demo_region("rerr[0]"), good)

    def test_wire_totals_are_real_bytes(self, mixed_frontend):
        st = mixed_frontend.stats()
        for idx, w in st["wire"].items():
            assert w["messages_sent"] >= 1
            # frames are length-prefixed: bytes must dwarf message counts
            assert w["bytes_sent"] > w["messages_sent"] * 8
            assert w["bytes_received"] > w["messages_received"] * 8
        total = st["frontend"]["wire"]
        assert total["bytes_sent"] == sum(
            w["bytes_sent"] for w in st["wire"].values())


class TestRemoteColdHydration:
    """The acceptance gate: a pre-started remote worker hydrates the
    shipped artifact (0 intern misses, aot_served >= 1) and rejects a
    topology-mismatched artifact loudly instead of crashing."""

    @pytest.fixture(scope="class")
    def cold_remote(self, remote_workers):
        _, (_, addr1) = remote_workers
        fe = ClusterFrontend(device="cpu", workers=[addr1], registry=REGISTRY_SPEC,
                             token=WORKER_TOKEN, name="test-remote-cold")
        yield fe
        fe.close()

    @pytest.fixture(scope="class")
    def warm_artifact(self, tmp_path_factory):
        tdg = demo_region("rwarm[0]", waves=3)
        bufs = _bufs(220)
        path = str(tmp_path_factory.mktemp("rwarm") / "region.json")
        warmup_and_save(tdg, bufs, path, DEMO_REGISTRY)
        return path, tdg, bufs

    def test_cold_remote_worker_hydrates_without_relowering(
            self, cold_remote, warm_artifact):
        path, tdg, bufs = warm_artifact
        rec = cold_remote.register_tenant("rwarm", warm_path=path)
        assert rec.artifact is not None
        out = cold_remote.serve("rwarm", bufs)
        _check(out, tdg, bufs)
        st = cold_remote.stats()
        wk = st["workers"][0]
        assert st["aggregate"]["hydrated_inband"] == 1
        assert st["aggregate"]["aot_served"] >= 1
        assert wk["intern"]["misses"] == 0       # never lowered anything
        assert st["aggregate"]["aot_hydrate_failures"] == 0

    def test_topology_mismatch_rejected_loudly_not_crash(
            self, cold_remote, warm_artifact, tmp_path):
        path, tdg, bufs = warm_artifact
        bad = str(tmp_path / "badtopo.json")
        shutil.copy(path, bad)
        with open(path + ".aot", "rb") as f:
            blob = pickle.loads(f.read())
        blob["topology"] = dict(blob["topology"], platform="tpu",
                                device_kind="TPU v4")
        with open(bad + ".aot", "wb") as f:
            f.write(pickle.dumps(blob))
        before = cold_remote.stats()["aggregate"]
        cold_remote.register_tenant("badtopo", warm_path=bad)
        out = cold_remote.serve("badtopo", bufs)   # re-lower fallback works
        _check(out, tdg, bufs)
        after = cold_remote.stats()["aggregate"]
        assert after["aot_topology_rejects"] == \
            before["aot_topology_rejects"] + 1
        assert after["aot_hydrate_failures"] == \
            before["aot_hydrate_failures"] + 1
        assert len(cold_remote._alive()) == 1      # worker survived

    def test_close_shuts_down_remote_worker(self, cold_remote,
                                            remote_workers):
        # Must run LAST in this class: the frontend owns no process handle,
        # so the best-effort shutdown RPC is the only thing that can stop
        # the subprocess — assert it actually does, with a clean exit.
        proc = remote_workers[1][0]
        cold_remote.close()
        proc.wait(timeout=30)
        assert proc.returncode == 0


class TestSubmitManyAdmission:
    def test_mixed_batch_is_positionally_aligned(self):
        with RegionServer(max_batch=4, name="many", device="cpu") as server:
            tdg = demo_region("many[0]")
            server.register_tenant("m", tdg)
            good_a, good_b = _bufs(300), _bufs(301)
            futs = server.submit_many([
                ("m", good_a),
                ("ghost", good_a),                  # unknown tenant
                ("m", {"x0": good_a["x0"]}),        # missing input slots
                ("m", good_b),
            ])
            assert len(futs) == 4
            _check(futs[0].result(300), tdg, good_a)
            with pytest.raises(KeyError, match="ghost"):
                futs[1].result(300)
            with pytest.raises(KeyError, match="missing"):
                futs[2].result(300)
            _check(futs[3].result(300), tdg, good_b)
            assert server.metrics.snapshot()["admitted"] >= 2


# ---------------------------------------------------------------------------
# Wire path on a live cluster (module-scoped frontend)
# ---------------------------------------------------------------------------

class TestWirePathCluster:
    def test_burst_parity_and_wire_stats(self, frontend, shared_w):
        tdg = demo_region("wire[0]")
        frontend.register_tenant("wire", tdg, pinned={"w": shared_w})
        before = frontend.stats()["frontend"]["wire"]
        bufs_list = [{f"x{s}": _t(np.random.default_rng(700 + 10 * i + s)
            .standard_normal((DIM, DIM))) for s in range(2)}
            for i in range(24)]
        futs = [frontend.submit("wire", b) for b in bufs_list]
        for b, f in zip(bufs_list, futs):
            _check(f.result(300), tdg, {**b, "w": shared_w})
        st = frontend.stats()
        after = st["frontend"]["wire"]
        # every submission went through the batch path, never one frame
        # per request more than the burst size
        assert after["entries_sent"] - before["entries_sent"] >= 24
        assert after["frames_sent"] - before["frames_sent"] <= 24
        assert after["frames_sent"] <= after["entries_sent"]
        assert after["encode_seconds"] > 0.0
        assert after["decode_seconds"] > 0.0
        assert after["timeouts"] == 0
        fr = st["frontend"]
        assert fr["transport"] in ("tcp", "shm", "auto")
        assert fr["window"] >= 1
        for row in st["wire"].values():
            assert row["window"] == fr["window"]
            assert row["entries_per_frame"] >= 1.0 or row["frames_sent"] == 0
            assert row["transport"] in ("tcp", "shm")
            assert row["inflight_frames"] == 0      # drained after the burst


# ---------------------------------------------------------------------------
# Shared-memory transport end to end (own 1-worker frontends)
# ---------------------------------------------------------------------------

class TestShmTransport:
    def test_shm_data_plane_carries_tensors_with_parity(self):
        big = 32                # 32x32 f32 = 4 KiB/blob: over the shm floor
        with ClusterFrontend(device="cpu", workers=1, registry=REGISTRY_SPEC,
                             transport="shm", name="test-shm") as fe:
            row = fe.stats()["wire"][0]
            if row["transport"] != "shm":
                pytest.skip("shm attach refused on this host")
            tdg = demo_region("shm[0]")
            fe.register_tenant("sm", tdg)
            rng = np.random.default_rng(42)
            bufs = {k: _t(rng.standard_normal((big, big))) for k in ("x0", "x1", "w")}
            out = fe.serve("sm", bufs)
            _check(out, tdg, bufs)
            st = fe.stats()
            row = st["wire"][0]
            assert row["shm_bytes_sent"] >= 3 * big * big * 4
            assert row["shm_bytes_received"] > 0    # replies rode shm too
            assert st["frontend"]["shm_fallbacks"] == 0
            assert st["frontend"]["wire"]["shm_bytes_sent"] == \
                row["shm_bytes_sent"]

    def test_tcp_pinned_worker_forces_counted_fallback(self, monkeypatch):
        # The spawned worker inherits the env pin and refuses the rings;
        # the frontend must land on tcp, count it, and keep full parity.
        monkeypatch.setenv("REPRO_RPC_TRANSPORT", "tcp")
        with ClusterFrontend(device="cpu", workers=1, registry=REGISTRY_SPEC,
                             transport="shm", name="test-shm-fb") as fe:
            st = fe.stats()
            assert st["wire"][0]["transport"] == "tcp"
            assert st["frontend"]["shm_fallbacks"] == 1
            tdg = demo_region("shmfb[0]")
            fe.register_tenant("fb", tdg)
            bufs = _bufs(500)
            _check(fe.serve("fb", bufs), tdg, bufs)
            assert fe.stats()["wire"][0]["shm_bytes_sent"] == 0


class TestServeClusterCli:
    def test_cluster_tokens_equal_the_jax_in_process_server(self, monkeypatch, capsys):
        """``launch.serve --smoke --cluster 2 --device cpu`` against the
        reference's ``launch.serve --smoke --server`` on the same weights
        (the JAX init carried across) and the same prompts: the sample
        tokens both print are equal."""
        from repro.launch import serve as jserve
        from repro.models import model as JM
        from repro_torch.launch import serve
        from repro_torch.models import model as M

        argv = ["--smoke", "--tenants", "4", "--gen", "5", "--prompt-len", "8",
                "--batch", "2", "--seed", "3"]
        assert jserve.main(argv + ["--server"]) == 0
        want = re.findall(r"tenant(\d) sample token ids: (\[.*\])", capsys.readouterr().out)

        def init_params(cfg, generator):
            jcfg = J_reduced_qwen()
            jparams = JM.init_params(jcfg, jax.random.PRNGKey(3))
            return M.params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), cfg, "cpu")

        def prompt_batch(cfg, batch, prompt_len, seed, device):
            key = jax.random.PRNGKey(seed)
            toks = jax.random.randint(key, (batch, prompt_len), 2, cfg.vocab_size)
            return {"tokens": torch.from_numpy(np.array(toks, np.int32))}

        monkeypatch.setattr(serve, "init_params", init_params)
        monkeypatch.setattr(serve, "prompt_batch", prompt_batch)
        assert serve.main(argv + ["--cluster", "2", "--device", "cpu"]) == 0
        out = capsys.readouterr().out
        got = re.findall(r"tenant(\d) sample token ids: (\[.*\])", out)
        assert len(want) == 2 and got == want
        assert "coalesced" in out and "deaths 0" in out


def J_reduced_qwen():
    from repro.configs import get_config, reduced
    return reduced(get_config("qwen2.5-3b"))
