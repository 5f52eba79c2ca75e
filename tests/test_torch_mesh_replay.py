"""The port's multi-device replay against ``tests/test_mesh_replay.py``.

The reference asserts that sharding a fused class's stacked lanes over a
mesh changes where each lane computes, never what: sharded replay is bit
for bit the single-device fused form. The port holds the same invariant
inside itself, and its single-device form to the reference's:

* port sharded == port unsharded, bitwise (``torch.equal``), at 2, 4 and 8
  shards with occupancy 1, 3, 5, 7 and 8, through ``lower_tdg``,
  ``ReplayExecutor``, ``@taskgraph`` and ``RegionServer``;
* port unsharded == JAX ``lower_tdg(mesh=None)`` on the same numpy inputs
  at f32 2e-5 (the reference's fusion tolerance).

One difference from the reference: a shard's call is the unsharded call at
the shard's lane count, and torch's CPU kernels for tanh-GELU, SiLU and
sigmoid compute the tail of their vectorized loop with a scalar formula,
so a lane's bits can depend on the size of the call it ran in. Regions of
such payloads are held bitwise to unsharded runs at the per-shard lane
count and to the whole-batch run at 2e-5
(``test_size_dependent_kernels_are_bitwise_per_shard``); every other case
is bitwise against the whole-batch run, as in the reference.

The reference's multi-device tests skip on one CPU device; these run live,
since a CPU mesh of N shards needs no flag (``make_replay_mesh(n,
device="cpu")``: N positions on the host).
"""
import itertools
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from hypothesis import given, settings, strategies as st  # noqa: E402

import repro.core as J  # noqa: E402
from repro.sharding import replay as jreplay  # noqa: E402
from repro_torch.core import (EagerExecutor, ReplayExecutor, TDG, TopologyMismatch,  # noqa: E402
                              clear_intern_cache, executable_from_bytes,
                              executable_to_bytes, fused_tdg_as_function, intern_stats,
                              lower_tdg, taskgraph, topology_fingerprint)
from repro_torch.core.lower import aot_compile_tdg  # noqa: E402
from repro_torch.core.serialize import TaskFnRegistry, load_warm, warmup_and_save  # noqa: E402
from repro_torch.launch.mesh import ReplayMesh, make_replay_mesh, make_small_mesh  # noqa: E402
from repro_torch.serving.server import RegionServer  # noqa: E402
from repro_torch.sharding import partition as _partition  # noqa: E402
from repro_torch.sharding import replay as shreplay  # noqa: E402

TOL = 2e-5


def _mesh(n):
    return make_replay_mesh(n, device="cpu")


# ---------------------------------------------------------------- graph builders

def _mm(x):
    return torch.tanh(x @ x.T) @ x * 0.5 + x


def _gelu_mix(x):
    return torch.nn.functional.gelu(x, approximate="tanh") @ x + x.sum(dim=-1, keepdim=True)


def _shared_proj(x, w):
    return torch.tanh(x @ w) @ w.T + x


def _jmm(x):
    return jnp.tanh(x @ x.T) @ x * 0.5 + x


def _jgelu_mix(x):
    return jax.nn.gelu(x) @ x + x.sum(axis=-1, keepdims=True)


_PAYLOADS = {"torch": (_mm, _gelu_mix), "jax": (_jmm, _jgelu_mix)}


def _grid_tdg(mod, occupancy, n_waves=2, name="mesh_grid", fn=None):
    """``occupancy`` independent chains of ``n_waves`` identical tasks: each
    wave is one fusion class of exactly ``occupancy`` members."""
    fn = fn or (_mm if mod is TDG else _jmm)
    tdg = mod(region=f"{name}_{occupancy}x{n_waves}")
    for c in range(occupancy):
        src = f"x{c}"
        for w in range(n_waves):
            dst = f"h{c}_{w}"
            tdg.add_task(fn, ins=[src], outs=[dst], name=f"t{c}_{w}")
            src = dst
    return tdg


def _inputs(occupancy, dim=4, seed=0):
    rng = np.random.default_rng(seed)
    return {f"x{c}": rng.standard_normal((dim, dim)).astype(np.float32)
            for c in range(occupancy)}


def _t(np_bufs):
    return {k: torch.from_numpy(v.copy()) for k, v in np_bufs.items()}


def _random_wave_tdg(mod, seed, occupancy, n_waves):
    """The reference's seeded wave-structured TDG: each wave one payload for
    all its tasks (one class) and random fan-in from the previous wave."""
    payloads = _PAYLOADS["torch" if mod is TDG else "jax"]
    rng = np.random.default_rng(seed)
    tdg = mod(region=f"mesh_rand_{seed}_{occupancy}x{n_waves}")
    prev = [f"x{c}" for c in range(occupancy)]
    for w in range(n_waves):
        fn = payloads[int(rng.integers(len(payloads)))]
        width = max(1, int(rng.integers(1, occupancy + 1)))
        cur = []
        for c in range(width):
            src = prev[int(rng.integers(len(prev)))]
            dst = f"h{w}_{c}"
            tdg.add_task(fn, ins=[src], outs=[dst], name=f"t{w}_{c}")
            cur.append(dst)
        prev = cur
    return tdg


def _has_gelu_wave(tdg) -> bool:
    return any(t.fn is _gelu_mix for t in tdg.tasks)


def _equal_or_close(tdg, a, b):
    """Bitwise, unless a wave runs ``_gelu_mix`` (torch's CPU tanh-GELU
    depends on the call's size, see the module docstring): then 2e-5."""
    if _has_gelu_wave(tdg):
        _close(a, b)
    else:
        _equal(a, b)


def _close(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        torch.testing.assert_close(a[k], b[k], rtol=TOL, atol=TOL, msg=f"slot {k!r}")


def _equal(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        assert torch.equal(a[k], b[k]), f"slot {k!r}"


def _close_to_jax(got, want):
    assert sorted(got) == sorted(want)
    for k in got:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=TOL, atol=TOL,
                                   err_msg=f"slot {k!r}")


# ---------------------------------------------------------------- resolution

class TestResolveMesh:
    def test_none_stays_none(self):
        assert shreplay.resolve_mesh(None) is None
        assert shreplay.mesh_fingerprint(None) is None

    def test_auto_without_env_or_scope_is_none(self, monkeypatch):
        monkeypatch.delenv(shreplay.MESH_ENV, raising=False)
        assert shreplay.resolve_mesh("auto") is None

    @pytest.mark.parametrize("raw", ["", "0", "off", "false", "no", "none", "OFF", "False"])
    def test_env_off_values(self, monkeypatch, raw):
        monkeypatch.setenv(shreplay.MESH_ENV, raw)
        assert shreplay.resolve_mesh("auto") is None

    def test_env_junk_raises(self, monkeypatch):
        monkeypatch.setenv(shreplay.MESH_ENV, "banana")
        with pytest.raises(ValueError, match=shreplay.MESH_ENV):
            shreplay.resolve_mesh("auto")

    def test_env_one_device_normalizes_to_none(self, monkeypatch):
        monkeypatch.setenv(shreplay.MESH_ENV, "1")
        assert shreplay.resolve_mesh("auto") is None

    def test_non_auto_string_rejected(self):
        with pytest.raises(ValueError):
            shreplay.resolve_mesh("data=8")

    def test_one_device_mesh_normalizes_to_none(self):
        assert shreplay.resolve_mesh(_mesh(1)) is None
        assert shreplay.resolve_mesh(make_small_mesh(1, 4, device="cpu")) is None

    def test_make_replay_mesh_bad_count(self):
        with pytest.raises(ValueError):
            make_replay_mesh(0, device="cpu")

    @pytest.mark.skipif(torch.cuda.is_available(), reason="needs a host without a card")
    def test_no_card_no_cuda_mesh(self):
        """No fallback: a CUDA mesh with fewer cards raises, and never
        becomes a mesh of repeated or host devices."""
        with pytest.raises(RuntimeError, match="distinct CUDA devices"):
            make_replay_mesh(2, device="cuda")
        with pytest.raises(RuntimeError, match="distinct CUDA devices"):
            make_small_mesh(1, 2, device="cuda")

    def test_explicit_device_list_builds_virtual_shards(self):
        mesh = ReplayMesh((2,), ("data",), ["cpu", "cpu"])
        assert mesh.devices == (torch.device("cpu"),) * 2 and mesh.shape == {"data": 2}
        with pytest.raises(ValueError, match="needs 2 devices"):
            ReplayMesh((2,), ("data",), ["cpu"])

    @pytest.mark.parametrize("shape,names", [((2,), ("data",)), ((8,), ("data",)),
                                             ((2, 4), ("data", "model")),
                                             ((2, 2, 2), ("pod", "data", "model"))])
    def test_fingerprint_equals_the_reference(self, shape, names):
        n = int(np.prod(shape))
        mesh = ReplayMesh(shape, names, ["cpu"] * n)
        jmesh = jax.sharding.AbstractMesh(shape, names)
        fp = shreplay.mesh_fingerprint(mesh)
        assert fp == jreplay.mesh_fingerprint(jmesh)
        assert shreplay.batch_axis_size(mesh) == jreplay.batch_axis_size(jmesh)
        assert json.loads(json.dumps(fp)) == fp

    def test_pad_group(self):
        members = [torch.zeros(3), torch.ones(3)]
        assert shreplay.pad_group(members, None) == 0 and len(members) == 2
        a, b, c = torch.zeros(3), torch.ones(3), torch.full((3,), 2.0)
        members = [a, b, c]
        assert shreplay.pad_group(members, _mesh(2)) == 1
        assert len(members) == 4 and members[3] is c

    def test_env_count_resolves(self, monkeypatch):
        monkeypatch.setenv(shreplay.MESH_ENV, "2")
        assert shreplay.mesh_fingerprint(shreplay.resolve_mesh("auto")) == "data=2"
        monkeypatch.setenv(shreplay.MESH_ENV, "all")     # one host device here
        assert shreplay.resolve_mesh("auto") is None

    def test_scope_beats_env_and_explicit_beats_scope(self, monkeypatch):
        monkeypatch.setenv(shreplay.MESH_ENV, "2")
        with _partition.use_mesh(_mesh(4)):
            assert shreplay.mesh_fingerprint(shreplay.resolve_mesh("auto")) == "data=4"
            assert shreplay.mesh_fingerprint(shreplay.resolve_mesh(_mesh(8))) == "data=8"
        assert shreplay.mesh_fingerprint(shreplay.resolve_mesh("auto")) == "data=2"

    def test_batch_axis_size_and_shard_devices(self):
        assert shreplay.batch_axis_size(None) == 1
        assert shreplay.batch_axis_size(_mesh(2)) == 2
        mesh = ReplayMesh((2, 2), ("data", "model"), ["cpu"] * 4)
        assert shreplay.batch_axis_size(mesh) == 2
        assert shreplay.lane_chunks(6, mesh) == [(torch.device("cpu"), 0, 3),
                                                 (torch.device("cpu"), 3, 6)]
        with pytest.raises(ValueError, match="pad first"):
            shreplay.lane_chunks(5, mesh)

    def test_replicate_copies_only_what_is_elsewhere(self):
        """A tensor or module already on the device is returned as it is; a
        module elsewhere gets one replica there, made once."""
        x, mod = torch.ones(3), torch.nn.Linear(2, 2)
        assert shreplay.replicate({"x": x, "m": mod}, torch.device("cpu"))["m"] is mod
        assert shreplay.replicate(x, torch.device("cpu")) is x
        meta = torch.device("meta")
        a = shreplay.replicate({"m": mod}, meta)["m"]
        assert a is not mod and a.weight.device == meta
        assert shreplay.replicate(mod, meta) is a

    def test_shard_leading_splits_views_and_replicates_the_rest(self):
        x, odd = torch.arange(12.0).reshape(4, 3), torch.arange(3.0)
        parts = shreplay.shard_leading({"x": x, "odd": odd, "s": torch.tensor(1.0)}, _mesh(2))
        assert [p["x"].tolist() for p in parts] == [x[:2].tolist(), x[2:].tolist()]
        assert all(p["x"].data_ptr() == x[2 * i:].data_ptr() for i, p in enumerate(parts))
        assert all(p["odd"] is odd for p in parts)
        assert torch.equal(shreplay.gather_leading([p["x"] for p in parts],
                                                   torch.device("cpu")), x)


# ---------------------------------------------------------------- differentials

_JAX_GRID: dict = {}


def _jax_grid(occupancy):
    """JAX's unsharded replay of the grid, once an occupancy."""
    if occupancy not in _JAX_GRID:
        tdg = _grid_tdg(J.TDG, occupancy, name="jgrid")
        _JAX_GRID[occupancy] = J.lower_tdg(tdg, mesh=None)(
            {k: jnp.asarray(v) for k, v in _inputs(occupancy, seed=occupancy).items()})
    return _JAX_GRID[occupancy]


class TestDifferential:
    @pytest.mark.parametrize("n_dev", [2, 4, 8])
    @pytest.mark.parametrize("occupancy", [1, 3, 5, 7, 8])
    def test_grid_parity(self, n_dev, occupancy):
        tdg = _grid_tdg(TDG, occupancy, name=f"grid{n_dev}")
        bufs = _t(_inputs(occupancy, seed=occupancy))
        fn = fused_tdg_as_function(tdg, mesh=_mesh(n_dev))
        sharded = fn(bufs)
        plain = lower_tdg(tdg, mesh=None)(bufs)
        _equal(sharded, plain)
        _equal(lower_tdg(tdg, mesh=_mesh(n_dev))(bufs), plain)
        _close_to_jax(plain, _jax_grid(occupancy))
        pad = (-occupancy) % n_dev if occupancy >= 2 else 0
        assert fn.last_plan.summary()["padded_lanes"] == 2 * pad      # two waves

    def test_shared_constant_arg_not_sharded(self):
        occupancy = 5
        rng = np.random.default_rng(7)
        np_bufs = {**_inputs(occupancy, seed=7),
                   "w": rng.standard_normal((4, 4)).astype(np.float32)}

        def build(mod, fn):
            tdg = mod(region=f"mesh_shared_{occupancy}")
            for c in range(occupancy):
                tdg.add_task(fn, ins=[f"x{c}", "w"], outs=[f"y{c}"], name=f"proj{c}")
            return tdg

        tdg = build(TDG, _shared_proj)
        fn = fused_tdg_as_function(tdg, mesh=_mesh(4))
        out = fn(_t(np_bufs))
        assert fn.last_plan.classes[0].shared == (False, True)
        _equal(out, lower_tdg(tdg, mesh=None)(_t(np_bufs)))
        want = J.lower_tdg(build(J.TDG, lambda x, w: jnp.tanh(x @ w) @ w.T + x),
                           mesh=None)({k: jnp.asarray(v) for k, v in np_bufs.items()})
        _close_to_jax(out, want)

    def test_seeded_random_sweep(self):
        """Random wave-structured TDGs x occupancy x 2 / 4 / 8 shards."""
        for seed in range(6):
            rng = np.random.default_rng(1000 + seed)
            occupancy = int(rng.integers(1, 11))
            n_waves = int(rng.integers(1, 4))
            tdg = _random_wave_tdg(TDG, seed, occupancy, n_waves)
            np_bufs = _inputs(occupancy, seed=seed)
            plain = lower_tdg(tdg, mesh=None)(_t(np_bufs))
            for n_dev in (2, 4, 8):
                _equal_or_close(tdg, lower_tdg(tdg, mesh=_mesh(n_dev))(_t(np_bufs)), plain)
            eager = EagerExecutor(tdg).run(_t(np_bufs))
            for k in plain:
                torch.testing.assert_close(plain[k], eager[k], rtol=TOL, atol=TOL)
            want = J.lower_tdg(_random_wave_tdg(J.TDG, seed, occupancy, n_waves),
                               mesh=None)({k: jnp.asarray(v) for k, v in np_bufs.items()})
            _close_to_jax(plain, want)

    @pytest.mark.parametrize("n_dev,occupancy", [(2, 3), (2, 7), (4, 5), (8, 13)])
    def test_size_dependent_kernels_are_bitwise_per_shard(self, n_dev, occupancy):
        """A grid of ``_gelu_mix`` chains (independent lanes): the sharded
        replay equals, bit for bit, the unsharded replay of each shard's own
        chains (its pad lanes repeat its last member), and the whole-batch
        replay at 2e-5. Shards of 2+ lanes: an unsharded class of one member
        runs the payload unbatched, where a one-lane shard is a vmap lane."""
        np_bufs = _inputs(occupancy, seed=occupancy)
        tdg = _grid_tdg(TDG, occupancy, name=f"gelu{n_dev}", fn=_gelu_mix)
        sharded = lower_tdg(tdg, mesh=_mesh(n_dev), batcher="vmap")(_t(np_bufs))
        _equal_or_close(tdg, sharded, lower_tdg(tdg, mesh=None)(_t(np_bufs)))
        lanes = list(range(occupancy))
        shreplay.pad_group(lanes, _mesh(n_dev))
        m = len(lanes) // n_dev
        for k in range(n_dev):
            chunk = lanes[k * m:(k + 1) * m]
            sub = _grid_tdg(TDG, len(chunk), name=f"gelu_shard{n_dev}", fn=_gelu_mix)
            want = lower_tdg(sub, mesh=None, batcher="vmap")(
                {f"x{i}": torch.from_numpy(np_bufs[f"x{c}"].copy()) for i, c in enumerate(chunk)})
            for i, c in enumerate(chunk):
                if k * m + i < occupancy:           # a real lane, not a pad
                    for w in range(2):
                        assert torch.equal(sharded[f"h{c}_{w}"], want[f"h{i}_{w}"]), (k, c, w)

    def test_unbatchable_class_falls_back_single_device(self):
        def stubborn(x):
            if torch._C._functorch.is_batchedtensor(x):
                raise TypeError("no batching rule for this payload")
            return x * 2.0 + 1.0

        occupancy = 4
        tdg = TDG(region="mesh_fallback")
        for c in range(occupancy):
            tdg.add_task(stubborn, ins=[f"x{c}"], outs=[f"s{c}"], name=f"stub{c}")
        for c in range(occupancy):
            tdg.add_task(_mm, ins=[f"s{c}"], outs=[f"y{c}"], name=f"mm{c}")
        bufs = _t(_inputs(occupancy, seed=42))
        fn = fused_tdg_as_function(tdg, mesh=_mesh(4))
        out = fn(bufs)
        assert {cls.fused for cls in fn.last_plan.classes} == {True, False}
        expected = EagerExecutor(tdg).run(dict(bufs))
        for k in out:
            torch.testing.assert_close(out[k], expected[k], rtol=TOL, atol=TOL)
        _equal(lower_tdg(tdg, mesh=_mesh(4))(bufs), lower_tdg(tdg, mesh=None)(bufs))

    def test_map_batcher_ignores_mesh(self):
        tdg = _grid_tdg(TDG, 4, name="mapb")
        bufs = _t(_inputs(4, seed=9))
        fn = fused_tdg_as_function(tdg, batcher="map", mesh=_mesh(4))
        out = fn(bufs)
        assert fn.last_plan.summary()["padded_lanes"] == 0
        _equal(out, lower_tdg(tdg, batcher="map", mesh=None)(bufs))
        # one lane a call (a 2-D product) against the vmap call (batched)
        _close(out, lower_tdg(tdg, mesh=None)(bufs))

    def test_donated_slot_under_a_mesh(self):
        """Donated inout slots through a sharded replay: each call's outputs
        equal the unsharded replay's, fed back call after call."""
        tdg = TDG(region="mesh_donate")
        for c in range(3):
            tdg.add_task(_mm, inouts=[f"x{c}"], name=f"t{c}")
        slots = tuple(f"x{c}" for c in range(3))
        a = _t(_inputs(3, seed=13))
        b = {k: v.clone() for k, v in a.items()}
        sharded = lower_tdg(tdg, donate_slots=slots, mesh=_mesh(2))
        plain = lower_tdg(tdg, donate_slots=slots, mesh=None)
        for _ in range(3):
            a, b = sharded(a), plain(b)
            _equal(a, b)


@settings(max_examples=12, deadline=None)
@given(seed=st.integers(0, 2**16), occupancy=st.integers(1, 24),
       n_waves=st.integers(1, 3), n_dev=st.sampled_from([1, 2, 4, 8]))
def test_property_sharded_replay_bit_exact(seed, occupancy, n_waves, n_dev):
    tdg = _random_wave_tdg(TDG, seed, occupancy, n_waves)
    bufs = _t(_inputs(occupancy, dim=2, seed=seed))
    mesh = _mesh(n_dev) if n_dev > 1 else None
    _equal_or_close(tdg, lower_tdg(tdg, mesh=mesh)(bufs), lower_tdg(tdg, mesh=None)(bufs))


# ---------------------------------------------------------------- executor / region / interning

_REGION_IDS = itertools.count()


class TestExecutorAndRegion:
    @pytest.mark.parametrize("n_dev", [2, 4, 8])
    def test_replay_executor_mesh_parity_and_keys(self, n_dev):
        tdg = _grid_tdg(TDG, 5, name=f"exec{n_dev}")
        bufs = _t(_inputs(5, seed=3))
        ex_m, ex_p = ReplayExecutor(tdg, mesh=_mesh(n_dev)), ReplayExecutor(tdg, mesh=None)
        assert ex_m.mesh_fp == f"data={n_dev}" and ex_p.mesh_fp is None
        _equal(ex_m.run(dict(bufs)), ex_p.run(dict(bufs)))
        assert {k[2] for k in ex_m._cache} == {f"data={n_dev}"}

    def test_region_mesh_resolves_per_replay(self, monkeypatch):
        """``@taskgraph`` keeps mesh="auto" unresolved: REPRO_MESH is read at
        each replay and keys the replay cache, so flipping it re-lowers."""
        monkeypatch.delenv(shreplay.MESH_ENV, raising=False)

        @taskgraph(name=f"mesh_region_{next(_REGION_IDS)}")
        def region(g, **xs):
            for c in range(3):
                g.task(_mm, ins=[f"x{c}"], outs=[f"h{c}"], name=f"a{c}")
                g.task(_mm, ins=[f"h{c}"], outs=[f"y{c}"], name=f"b{c}")

        bufs = _t(_inputs(3, seed=5))
        region(**bufs)                     # record
        o_plain = region(**bufs)           # replay, single-device
        for n in ("2", "4", "8"):
            monkeypatch.setenv(shreplay.MESH_ENV, n)
            _equal(region(**bufs), o_plain)
        assert {key[2] for key in region._replay_cache} == {None, "data=2", "data=4", "data=8"}

    def test_env_and_explicit_mesh_intern_to_one_entry(self):
        tdg = _grid_tdg(TDG, 3, name="internhit")
        bufs = _t(_inputs(3, seed=11))
        clear_intern_cache()
        out1 = lower_tdg(tdg, mesh=_mesh(2))(bufs)
        with _partition.use_mesh(_mesh(2)):
            out2 = lower_tdg(tdg)(bufs)
        stats = intern_stats()
        assert stats["entries"] == 1 and stats["hits"] >= 1
        _equal(out1, out2)

    def test_mesh_and_no_mesh_never_collide_in_intern_cache(self):
        tdg = _grid_tdg(TDG, 3, name="internmiss")
        bufs = _t(_inputs(3, seed=12))
        clear_intern_cache()
        out_m = lower_tdg(tdg, mesh=_mesh(2))(bufs)
        out_p = lower_tdg(tdg, mesh=None)(bufs)
        out_4 = lower_tdg(tdg, mesh=_mesh(4))(bufs)
        stats = intern_stats()
        assert stats["entries"] == 3 and stats["misses"] == 3
        _equal(out_m, out_p)
        _equal(out_4, out_p)


# ---------------------------------------------------------------- serving under a mesh

def _serve_rounds(server, rounds):
    results = []
    for reqs in rounds:
        futures = server.submit_many(reqs)
        results.append([f.result(timeout=60) for f in futures])
    return results


class TestServingUnderMesh:
    @pytest.mark.parametrize("continuous", [False, True], ids=["request-level", "continuous"])
    @pytest.mark.parametrize("n_dev,occupancy", [(2, 4), (2, 3), (4, 3), (8, 5)])
    def test_batched_dispatch_parity(self, n_dev, occupancy, continuous):
        """One admission batch through a sharded server and a plain server:
        bitwise equal, bucket-rounded occupancy included; and equal to
        serial dispatch (one request a call, a 2-D product where the batch
        runs a batched one) at 2e-5."""
        rng = np.random.default_rng(occupancy)
        reqs = [("t0", {"x": torch.from_numpy(rng.standard_normal((4, 4)).astype(np.float32))})
                for _ in range(occupancy)]
        tdg = TDG(region=f"srv_{n_dev}_{occupancy}")
        tdg.add_task(_mm, ins=["x"], outs=["h"], name="a")
        tdg.add_task(_mm, ins=["h"], outs=["y"], name="b")

        def one(mesh):
            srv = RegionServer(max_batch=8, max_wait_ms=30.0, mesh=mesh, autostart=False,
                               continuous=continuous, device="cpu")
            try:
                srv.register_tenant("t0", tdg)
                futures = srv.submit_many(reqs)
                srv.start()
                return [f.result(timeout=60) for f in futures], srv.stats()
            finally:
                srv.close()

        out_m, stats_m = one(_mesh(n_dev))
        out_p, stats_p = one(None)
        assert stats_m["mesh"] == f"data={n_dev}" and stats_p["mesh"] is None
        m = stats_m["metrics"]
        assert m["coalesced_requests"] == occupancy and m["batch_fallbacks"] == 0
        bucket = 4 if occupancy <= 4 else 8
        assert m["pad_lanes"] == bucket + (-bucket) % n_dev - occupancy
        serial = lower_tdg(tdg, mesh=None)
        for (_, req), a, b in zip(reqs, out_m, out_p):
            _equal(a, b)
            _close(a, serial(req))

    def test_pool_keys_carry_mesh_fingerprint(self):
        srv = RegionServer(max_batch=4, max_wait_ms=20.0, mesh=_mesh(2), device="cpu")
        try:
            tdg = _grid_tdg(TDG, 2, name="poolkeys")
            srv.register_tenant("pk", tdg)
            reqs = [("pk", _t(_inputs(2, seed=21 + i))) for i in range(2)]
            for f in srv.submit_many(reqs):
                f.result(timeout=60)
            srv.warmup("pk", _t(_inputs(2, seed=21)))
            keys = list(srv.pool._entries)
            assert {k[0] for k in keys} >= {"aot", "batched"}
            assert all(key[-1] == "data=2" for key in keys), keys
        finally:
            srv.close()

    def test_pool_eviction_under_mesh_preserves_parity(self):
        def payload_b(x):
            return torch.relu(x @ x.T) - x

        tdg_a = _grid_tdg(TDG, 2, name="evict_a")
        tdg_b = TDG(region="evict_b")
        for c in range(2):
            tdg_b.add_task(payload_b, ins=[f"x{c}"], outs=[f"y{c}"], name=f"b{c}")
        rounds = [[(name, _t(_inputs(2, seed=31 + 10 * i + j))) for j in range(2)]
                  for i, name in enumerate(["a", "b", "a", "b"])]

        def run(mesh):
            srv = RegionServer(max_batch=4, max_wait_ms=20.0, pool_capacity=1, mesh=mesh,
                               device="cpu")
            try:
                srv.register_tenant("a", tdg_a)
                srv.register_tenant("b", tdg_b)
                return _serve_rounds(srv, rounds), srv.pool.stats()
            finally:
                srv.close()

        out_m, pool_m = run(_mesh(2))
        out_p, _ = run(None)
        assert pool_m["evictions"] > 0
        for rm, rp in zip(out_m, out_p):
            for a, b in zip(rm, rp):
                _equal(a, b)


# ---------------------------------------------------------------- topology

class TestTopologyMesh:
    def test_fingerprint_has_mesh_and_is_json_stable(self):
        fp = topology_fingerprint("cpu", mesh=None)
        assert fp["mesh"] is None and json.loads(json.dumps(fp)) == fp
        assert topology_fingerprint("cpu", mesh=_mesh(2))["mesh"] == "data=2"
        assert topology_fingerprint("cpu", mesh="data=4")["mesh"] == "data=4"

    def test_artifact_mesh_mismatch_raises(self):
        tdg = _grid_tdg(TDG, 2, name="topo")
        bufs = _t(_inputs(2, seed=51))
        aot = aot_compile_tdg(tdg, bufs, mesh=_mesh(2))
        assert aot.mesh_fp == "data=2"
        blob = executable_to_bytes(aot)
        with pytest.raises(TopologyMismatch):
            executable_from_bytes(blob, device="cpu", mesh=None)
        with pytest.raises(TopologyMismatch):
            executable_from_bytes(blob, device="cpu", mesh="data=4")
        back = executable_from_bytes(blob, device="cpu", mesh="data=2")
        assert back.mesh_fp == "data=2"
        _equal(back(bufs), lower_tdg(tdg, mesh=None)(bufs))

    def test_server_rejects_foreign_mesh_artifact_but_still_serves(self, tmp_path):
        reg = TaskFnRegistry()
        reg.register("mesh_mm")(_mm)
        tdg = TDG(region="warm_mesh")
        for c in range(2):
            tdg.add_task(_mm, ins=[f"x{c}"], outs=[f"y{c}"], name=f"t{c}")
        bufs = _t(_inputs(2, seed=61))
        path = str(tmp_path / "warm.json")
        warmup_and_save(tdg, bufs, path, reg, mesh=_mesh(2))
        _, aot_ok = load_warm(path, reg, device="cpu", mesh="data=2")
        assert aot_ok is not None and aot_ok.mesh_fp == "data=2"
        srv = RegionServer(max_batch=1, max_wait_ms=1.0, mesh=None, device="cpu")
        try:
            srv.register_tenant("wm", warm_path=path, fn_registry=reg)
            assert srv.metrics.snapshot()["aot_hydrate_failures"] == 1
            _equal(srv.submit("wm", bufs).result(timeout=60), lower_tdg(tdg, mesh=None)(bufs))
        finally:
            srv.close()
        srv = RegionServer(max_batch=1, max_wait_ms=1.0, mesh=_mesh(2), device="cpu")
        try:
            srv.register_tenant("wm", warm_path=path, fn_registry=reg)
            assert srv.metrics.snapshot()["aot_hydrate_failures"] == 0
            _equal(srv.submit("wm", bufs).result(timeout=60), lower_tdg(tdg, mesh=None)(bufs))
            assert srv.stats()["metrics"]["aot_served"] == 1
        finally:
            srv.close()
