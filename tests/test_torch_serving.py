"""The port's RegionServer and serve entry point.

Three tenants of the reduced qwen2.5-3b decode step (JAX parameters
carried across) go through the port's server: through the request-level
dispatcher (``continuous=False``) a coalesced batch must give what each
request gives alone and the shared params module must be broadcast rather
than stacked; under both schedulers (request-level and the continuous
default) the tokens the server generates must equal JAX ``greedy_decode``
on the same parameters and prompts. The continuous scheduler and QoS are
held to the JAX server in ``test_torch_continuous.py`` and
``test_torch_qos.py``.
"""
import threading

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import reduced as jax_reduced  # noqa: E402
from repro.core.costmodel import BucketTuner  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.core import TDG, clear_intern_cache  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.serving import LatencyReservoir, RegionServer, percentile  # noqa: E402
from repro_torch.training import make_serve_step  # noqa: E402

MAX_LEN = 24


@pytest.fixture(scope="module")
def model():
    jcfg = jax_reduced(jax_get_config("qwen2.5-3b"))
    cfg = reduced(get_config("qwen2.5-3b"))
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(1))
    params = M.params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), cfg, "cpu")
    return jcfg, jparams, cfg, params


def _prompt(i):
    return np.random.default_rng(100 + i).integers(2, 256, (2, 10)).astype(np.int32)


def _prefill(cfg, params, i):
    with torch.no_grad():
        logits, caches, pos = M.prefill(params, cfg, {"tokens": torch.from_numpy(_prompt(i))},
                                        MAX_LEN)
    return torch.argmax(logits[:, -1], dim=-1).to(torch.int32), pos, caches


def _decode_tenants(server, decode, n):
    for i in range(n):
        g = TDG(f"decode[{i}]")
        g.add_task(decode, ins=["params", "tokens", "pos", "caches"],
                   outs=["next", "caches"], name="decode")
        server.register_tenant(f"t{i}", g, outputs=("next", "caches"))


def _request(params, tok, pos, caches):
    return {"params": params, "tokens": tok[:, None], "pos": pos, "caches": caches}


def test_coalesced_batch_equals_single_requests(model):
    _, _, cfg, params = model
    clear_intern_cache()
    decode = make_serve_step(cfg)
    server = RegionServer(max_batch=4, max_wait_ms=0, autostart=False, continuous=False)
    _decode_tenants(server, decode, 3)
    assert server.stats()["intern"]["hits"] == 2       # tenants 2, 3 reuse tenant 1
    reqs = [_request(params, *_prefill(cfg, params, i)) for i in range(3)]
    futures = [server.submit(f"t{i}", r) for i, r in enumerate(reqs)]
    server.start()
    outs = [f.result(timeout=120) for f in futures]
    server.close()
    for i, (req, out) in enumerate(zip(reqs, outs)):
        with torch.no_grad():
            alone = server.tenant(f"t{i}").replay_fn()(req)
        torch.testing.assert_close(out["next"], alone["next"], atol=0, rtol=0)
        for a, b in zip(torch.utils._pytree.tree_leaves(out["caches"]),
                        torch.utils._pytree.tree_leaves(alone["caches"])):
            torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5)
    m = server.stats()["metrics"]
    assert (m["batches"], m["batch_occupancy_max"], m["coalesced_requests"]) == (1, 3, 3)
    assert m["batch_fallbacks"] == 0 and m["pad_lanes"] == 1   # 3 runs in bucket 4
    assert m["completed"] == 3 and m["queue_depth_peak"] == 3


def test_shared_params_are_broadcast_not_stacked(model):
    _, _, cfg, params = model
    decode = make_serve_step(cfg)
    server = RegionServer(max_batch=4, max_wait_ms=0, autostart=False, continuous=False)
    _decode_tenants(server, decode, 2)
    futures = [server.submit(f"t{i}", _request(params, *_prefill(cfg, params, i)))
               for i in range(2)]
    server.start()
    for f in futures:
        f.result(timeout=120)
    server.close()
    (key,) = list(server.pool._entries)
    slot_map = server.tenant("t0").slot_map
    assert key[0] == "batched" and key[3] == frozenset({slot_map["params"]})
    assert server.stats()["pool"]["entries"] == 1


@pytest.mark.parametrize("continuous", [False, None], ids=["request-level", "continuous"])
def test_server_tokens_equal_jax_greedy_decode(model, continuous):
    jcfg, jparams, cfg, params = model
    gen, tenants = 6, 3
    decode = make_serve_step(cfg)
    server = RegionServer(max_batch=tenants, max_wait_ms=5.0, continuous=continuous)
    assert server.continuous is (continuous is None)
    _decode_tenants(server, decode, tenants)
    outs, errors = {}, []

    def loop(i):
        try:
            tok, pos, caches = _prefill(cfg, params, i)
            toks = [tok]
            for _ in range(gen - 1):
                out = server.serve(f"t{i}", _request(params, tok, pos, caches), timeout=120)
                tok, caches, pos = out["next"], out["caches"], pos + 1
                toks.append(tok)
            outs[i] = torch.stack(toks, dim=1).numpy()
        except Exception as e:
            errors.append(e)

    threads = [threading.Thread(target=loop, args=(i,)) for i in range(tenants)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    server.close()
    assert not errors and not any(t.is_alive() for t in threads)
    for i in range(tenants):
        want = JM.greedy_decode(jparams, jcfg, {"tokens": jnp.asarray(_prompt(i))}, gen,
                                MAX_LEN)
        np.testing.assert_array_equal(outs[i], np.asarray(want))
    m = server.stats()["metrics"]
    assert m["completed"] == tenants * (gen - 1) and m["batch_fallbacks"] == 0


def test_unbatchable_payload_falls_back_to_serial():
    def step(x):
        return x + float(x.sum())       # host sync: refused under vmap

    server = RegionServer(max_batch=4, max_wait_ms=0, autostart=False, continuous=False)
    for i in range(2):
        g = TDG(f"r{i}")
        g.add_task(step, inouts=["x"])
        server.register_tenant(f"r{i}", g)
    futures = [server.submit(f"r{i}", {"x": torch.full((3,), float(i + 1))}) for i in range(2)]
    server.start()
    outs = [f.result(timeout=60) for f in futures]
    server.close()
    assert [o["x"].tolist() for o in outs] == [[4.0] * 3, [8.0] * 3]
    m = server.stats()["metrics"]
    assert m["batch_fallbacks"] == 1 and m["coalesced_requests"] == 0


def test_different_payloads_never_share_a_batch():
    server = RegionServer(max_batch=4, max_wait_ms=0, autostart=False, continuous=False)
    for name, fn in (("a", lambda x: x + 1), ("b", lambda x: x + 2)):
        g = TDG(name)
        g.add_task(fn, inouts=["x"])
        server.register_tenant(name, g)
    fa = server.submit("a", {"x": torch.zeros(2)})
    fb = server.submit("b", {"x": torch.zeros(2)})
    server.start()
    assert fa.result(timeout=60)["x"].tolist() == [1.0, 1.0]
    assert fb.result(timeout=60)["x"].tolist() == [2.0, 2.0]
    server.close()
    m = server.stats()["metrics"]
    assert m["batches"] == 2 and m["batch_occupancy_max"] == 1


def test_admission_errors():
    assert RegionServer(autostart=False).continuous is True     # the reference's default
    server = RegionServer(continuous=False)
    g = TDG("one")
    g.add_task(lambda x: x, inouts=["x"])
    server.register_tenant("one", g)
    with pytest.raises(ValueError, match="already registered"):
        server.register_tenant("one", g)
    with pytest.raises(KeyError, match="unknown tenant"):
        server.submit("two", {"x": torch.zeros(1)})
    with pytest.raises(KeyError, match="missing input slots"):
        server.submit("one", {})
    server.close()
    with pytest.raises(RuntimeError, match="closed"):
        server.submit("one", {"x": torch.zeros(1)})


def test_bucket_ladder_matches_reference_static_ladder():
    ladder = BucketTuner(8, adaptive=False)
    server = RegionServer(max_batch=8, adaptive=False, autostart=False)
    assert [server._bucket_and_pad(n)[0] for n in range(2, 20)] == \
        [ladder.bucket_for(n) for n in range(2, 20)]


def test_latency_percentiles():
    assert percentile([], 50) == 0.0
    vals = sorted(float(v) for v in range(1, 101))
    assert (percentile(vals, 50), percentile(vals, 99), percentile(vals, 100)) == (50.0, 99.0, 100.0)
    res = LatencyReservoir(capacity=4)
    for v in (5.0, 1.0, 2.0, 3.0, 4.0):
        res.record(v)
    assert res.summary() == {"count": 5, "p50_s": 2.0, "p99_s": 4.0, "max_s": 4.0}


@pytest.mark.parametrize("mode", [["--server", "--tenants", "3"], []])
def test_serve_cli_smoke_on_cpu(mode, capsys):
    assert serve.main(["--smoke", "--device", "cpu", "--gen", "4", "--prompt-len", "8",
                       "--batch", "2", *mode]) == 0
    out = capsys.readouterr().out
    assert "decode:" in out and "kernels: rmsnorm 0 launches" in out
    if mode:
        assert "0 fallbacks" in out


@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "mamba2-370m"])
def test_serve_cli_runs_the_new_families_on_cpu(arch, capsys):
    assert serve.main(["--arch", arch, "--smoke", "--server", "--device", "cpu", "--gen", "3",
                       "--prompt-len", "8", "--batch", "2", "--tenants", "2"]) == 0
    out = capsys.readouterr().out
    assert "0 fallbacks" in out and "grouped_matmul 0, ssd_intra_chunk 0" in out


def test_serve_cli_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device works")
    with pytest.raises(RuntimeError, match="--device cpu"):
        serve.main(["--smoke"])


def test_warm_pool_matches_reference_and_releases_what_leaves():
    from repro.serving.pool import PoolEntry as JEntry
    from repro.serving.pool import WarmPool as JPool
    from repro_torch.serving import PoolEntry, WarmPool

    released = []

    class Replay:
        def __init__(self, name):
            self.name = name

        def release(self):
            released.append(self.name)

    pools = (JPool(capacity=3), WarmPool(capacity=3))
    for pool, entry in zip(pools, (JEntry, PoolEntry)):
        for i in range(4):
            pool.put((i,), entry("batched" if i % 2 else "single", Replay(i)))
        pool.get((1,))
        pool.get((9,))
        pool.get((3,))
        pool.get((3,))
        assert pool.peek((2,)) is not None and pool.peek((0,)) is None
        assert len(pool) == 3
        assert pool.invalidate(lambda k, e: e.kind == "batched") == 2
    jstats, tstats = (p.stats() for p in pools)
    assert tstats == jstats
    assert tstats["hot"] == [{"kind": "single", "hits": 0}]
    assert released == [0, 1, 3]          # evicted, then invalidated (the port's only)
    pools[1].clear()
    assert len(pools[1]) == 0 and released == [0, 1, 3, 2]
    assert pools[1].stats()["misses"] == 0


def test_serve_cli_qos_and_trace_flags_on_cpu(tmp_path, capsys):
    trace = tmp_path / "trace.json"
    assert serve.main(["--smoke", "--device", "cpu", "--server", "--tenants", "3", "--gen",
                       "3", "--prompt-len", "8", "--batch", "2", "--tiers", "0,1",
                       "--trace-out", str(trace)]) == 0
    out = capsys.readouterr().out
    assert "tier 0: n 4" in out and "tier 1: n 2" in out and "trace:" in out
    doc = __import__("json").loads(trace.read_text())
    assert doc["summary"]["steps"] >= 2 and {"0", "1"} <= set().union(
        *(r["tiers"] for r in doc["records"]))
    assert serve.main(["--smoke", "--device", "cpu", "--server", "--request-level",
                       "--tenants", "2", "--gen", "3", "--prompt-len", "8",
                       "--batch", "2"]) == 0
    out = capsys.readouterr().out
    assert "0 fallbacks" in out and "tier 0" not in out


def test_serve_lm_example_on_cpu(capsys):
    from repro_torch.examples import serve_lm
    assert serve_lm.main(["--device", "cpu", "--server", "--tenants", "2", "--gen", "3",
                          "--prompt-len", "8", "--batch", "2"]) == 0
    assert "0 fallbacks" in capsys.readouterr().out


def test_costreport_matches_reference():
    from repro.launch import costreport as jreport
    from repro_torch.launch import costreport as treport
    occupancies = [5] * 40 + [12] * 30 + [3] * 10 + [16] * 5 + [1] * 7
    assert treport.bucket_report(occupancies, 16) == jreport.bucket_report(occupancies, 16)
    rep = treport.bucket_report(occupancies, 16)
    assert rep["fitted_boundaries"] == [3, 5, 12, 16] and rep["pad_lanes_fitted"] == 0
    outcomes = [treport.structure_report(tdg, bufs)["decisions"][0]["batcher"]
                for tdg, bufs in treport._demo_tdgs()]
    assert outcomes == ["vmap", "map", "unrolled"]
    # the same policy, thresholds and decision for a compute-bound class
    tdg, bufs = treport._demo_tdgs()[0]
    jtdg = jax_tdg_like(tdg)
    jbufs = {k: jax.ShapeDtypeStruct(tuple(v.shape), jnp.float32) for k, v in bufs.items()}
    jrep, trep = jreport.structure_report(jtdg, jbufs), treport.structure_report(tdg, bufs)
    assert trep["policy"] == jrep["policy"]
    assert [(d["wave"], d["size"], d["batcher"]) for d in trep["decisions"]] == \
        [(d["wave"], d["size"], d["batcher"]) for d in jrep["decisions"]]
    assert treport.main([]) == 0


def jax_tdg_like(tdg):
    """The reference's TDG of the same tasks, each payload a matmul."""
    from repro.core import TDG as JTDG
    out = JTDG(tdg.region)
    for t in tdg.tasks:
        out.add_task(_jmm, ins=list(t.ins), outs=list(t.outs))
    return out


def _jmm(a, w):
    return a @ w
