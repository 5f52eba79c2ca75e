"""The window's arithmetic on synthetic records: what counts, where, and that
a stall inside the window shows in both end-to-end metrics; the readers of
the ring and of a synthetic device trace."""
import importlib.util
import json
from pathlib import Path

import pytest

from portbench import harness, trace, work
from portbench.arch import dense

PKG = Path(__file__).resolve().parents[1]


def _load(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


RUN = _load(PKG / "run.py", "portbench_run_under_test")


def reader(name):
    return _load(PKG / "metrics" / f"{name}.py", "m_" + name.replace(".", "_")).read


def _served(client, t0, gaps, length=100, outputs=None):
    req = harness.Request(client, 0, length, outputs or len(gaps) + 1, 1)
    times = [t0]
    for g in gaps:
        times.append(times[-1] + g)
    s = harness.Served(req, t_send=t0 - 0.5, t_prefill=t0 - 0.2, times=times)
    s.done = len(times) == req.outputs
    return s


def _window(served, t_open=10.0, t_close=20.0, steps=(), captures=(3, 3)):
    return harness.Window(t_open, t_close, list(served), list(steps), captures,
                          attempted=len(served), failed=0, errors=[])


def _readings(win, trace_=None, sequences=16):
    model = json.loads((PKG / "configs" / "glm4-9b.json").read_text())["model"]
    model["padded_vocab"] = model["vocab_size"]
    return harness.Readings(harness.load_cell("glm4-gen"), model, {"sequences": sequences}, win,
                            trace_, work.PEAKS["NVIDIA H100 80GB HBM3"])


def test_tokens_count_where_they_are_made():
    # 40 ms steps from t=9 to t=21: only the tokens stamped inside [10, 20) count
    s = _served(0, 9.0, [0.04] * 300)
    win = _window([s])
    e2e = RUN.end_to_end(_readings(win), setup_s=30.0)
    inside = sum(1 for t in s.times if 10.0 <= t < 20.0)
    assert e2e["tok_s"] == pytest.approx(16 * inside / 10.0)
    assert e2e["tpot_p95_ms"] == pytest.approx(40.0)
    assert e2e["setup_s"] == 30.0


def test_first_token_has_no_gap_and_prompt_tokens_do_not_count():
    s = _served(0, 12.0, [0.05, 0.05], length=4000)
    e2e = RUN.end_to_end(_readings(_window([s])), setup_s=1.0)
    assert e2e["tok_s"] == pytest.approx(3 * 16 / 10.0)
    assert e2e["tpot_p95_ms"] == pytest.approx(50.0)


def test_a_stall_in_the_window_lowers_tok_s_and_raises_tpot():
    steady = [_served(c, 10.0 + c * 0.01, [0.04] * 240) for c in range(4)]
    stalled_gaps = [0.04 if i % 10 else 0.5 for i in range(240)]
    stalled = [_served(c, 10.0 + c * 0.01, stalled_gaps) for c in range(4)]
    a = RUN.end_to_end(_readings(_window(steady)), 1.0)
    b = RUN.end_to_end(_readings(_window(stalled)), 1.0)
    assert b["tok_s"] < a["tok_s"]
    assert b["tpot_p95_ms"] > a["tpot_p95_ms"]


def test_nearest_rank():
    assert harness.nearest_rank(list(range(1, 101)), 95) == 95
    assert harness.nearest_rank([3.0], 95) == 3.0


def _step(t_end, wall_ms, occupancy, bucket):
    return {"t_end": t_end, "wall_ms": wall_ms, "occupancy": occupancy, "bucket": bucket}


def test_ring_readers():
    steps = [_step(9.9, 40, 1, 1), _step(10.5, 40, 4, 4), _step(11.0, 60, 3, 3),
             _step(20.5, 40, 2, 2)]
    r = _readings(_window([], steps=steps, captures=(7, 9)))
    assert reader("occupancy_mean")(r) == pytest.approx(3.5)
    assert reader("step_ms")(r) == pytest.approx(50.0)
    assert reader("captures_in_window")(r) == 2
    assert r.step_at(10.47)["occupancy"] == 4 and r.step_at(10.6) is None
    empty = _readings(_window([]))
    assert reader("occupancy_mean")(empty) is None and reader("step_ms")(empty) is None


def test_client_and_prefill_readers():
    served = [_served(c, 10.0 + c, [0.04] * 3, length=4096) for c in range(4)]
    r = _readings(_window(served), sequences=2)
    assert reader("ttft_p95_ms.docs")(r) == pytest.approx(500.0)
    # 200 ms for 2 x 4096 prompt tokens
    assert reader("prefill_ms_per_ktok")(r) == pytest.approx(200.0 / 8.192)


def test_mfu_and_mbu_count_the_window():
    s = _served(0, 12.0, [0.04, 0.04], length=100)
    steps = [_step(12.04, 40, 1, 1), _step(12.08, 40, 1, 1)]
    r = _readings(_window([s], steps=steps))
    m = r.model
    flops = dense.prefill_flops(m, 16, 100) + 16 * (dense.decode_flops(m, 101)
                                                    + dense.decode_flops(m, 102))
    assert reader("mfu_pct")(r) == pytest.approx(100 * flops / (989e12 * 10.0))
    nbytes = 2 * dense.step_param_bytes(m, 16) + 16 * (dense.token_cache_bytes(m, 101)
                                                       + dense.token_cache_bytes(m, 102))
    assert reader("mbu_pct")(r) == pytest.approx(100 * nbytes / (3.35e12 * 10.0))


def _events(mark_ts=1000.0):
    """A Chrome trace: the marker at ts 1000 us; an eager flash-attention and
    RMSNorm launch inside a prefill; an RMSNorm launched by a graph replay."""
    return [
        {"name": trace.MARKER, "ph": "X", "ts": mark_ts, "dur": 1, "cat": "user_annotation"},
        {"name": "cudaLaunchKernel", "cat": "cuda_runtime", "ts": 1100, "dur": 5,
         "args": {"correlation": 1}},
        {"name": "cudaGraphLaunch", "cat": "cuda_runtime", "ts": 60000, "dur": 5,
         "args": {"correlation": 2}},
        {"name": "void fa_sm90_kernel<bf16>", "cat": "kernel", "ts": 2000, "dur": 1000,
         "args": {"correlation": 1}},
        {"name": "void rmsnorm_sm90_kernel<bf16>", "cat": "kernel", "ts": 3500, "dur": 20,
         "args": {"correlation": 1}},
        {"name": "void rmsnorm_sm90_kernel<bf16>", "cat": "kernel", "ts": 61000, "dur": 10,
         "args": {"correlation": 2}},
        {"name": "Memcpy DtoD", "cat": "gpu_memcpy", "ts": 61005, "dur": 10,
         "args": {"correlation": 2}},
        {"name": "late", "cat": "kernel", "ts": 900000, "dur": 10, "args": {}},
    ]


def test_trace_parse_busy_and_idle():
    # marker at host t=100.0 s; trace window [100.0, 100.1]
    tr = trace.parse(_events(), mark=100.0, t_start=100.0, t_stop=100.1)
    assert [k.name for k in tr.kernels][-1] == "Memcpy DtoD"   # "late" falls outside
    assert [k.graph for k in tr.kernels] == [False, False, True, True]
    assert tr.kernels[0].start == pytest.approx(100.001)
    assert tr.busy_s() == pytest.approx((1000 + 20 + 15) / 1e6)
    assert tr.window_s == pytest.approx(0.1)
    gaps = tr.idle_gaps()
    assert gaps[0] == pytest.approx((100.0, 100.001))
    assert sum(hi - lo for lo, hi in gaps) == pytest.approx(0.1 - tr.busy_s())


def test_kernel_readers_attribute_launches():
    tr = trace.parse(_events(), mark=100.0, t_start=100.0, t_stop=100.1)
    pre = _served(0, 100.01, [], length=4096)
    pre.t_prefill = 100.0005
    steps = [_step(100.07, 20, 4, 4)]
    r = _readings(_window([pre], t_open=99.0, t_close=101.0, steps=steps), tr, sequences=2)
    peaks = r.peaks
    fa = work.roofline_seconds(*work.flash_attention_work(2, 4096, 32, 2, 128), peaks)
    assert reader("fa_roofline_pct")(r) == pytest.approx(100 * fa / 1e-3)
    rms = (work.roofline_seconds(*work.rmsnorm_work(2 * 4096, 4096), peaks)
           + work.roofline_seconds(*work.rmsnorm_work(4 * 2, 4096), peaks))
    assert reader("rmsnorm_roofline_pct")(r) == pytest.approx(100 * rms / 30e-6)
    assert reader("idle_pct")(r) == pytest.approx(100 * (1 - 1035e-6 / 0.1))
    brk = RUN.breakdown(r)
    assert brk["device_ops"][0][0].startswith("void fa_sm90_kernel")
    assert len(brk["idle_gaps"]) <= 10 and brk["idle_gaps"][0][1] > 0
    assert {g[0] for g in brk["idle_gaps"]} <= {"prefill", "decode_step", "between_steps"}


def test_readers_without_a_trace_read_nothing():
    r = _readings(_window([]))
    for name in ("fa_roofline_pct", "rmsnorm_roofline_pct", "idle_pct"):
        assert reader(name)(r) is None


def test_sample_takes_the_longest_and_spreads_over_requests():
    from portbench import check

    served = [_served(c, 10.0, [0.04] * k) for c, k in enumerate([5, 30, 12, 3])]
    served.append(_served(9, 10.0, [0.04] * 50, outputs=100))     # not finished
    picks = check.sample(served, 7, sequences=4, n=5)
    assert len(picks) == len(set((id(s), r) for s, r in picks)) == 5
    assert [s.req.client for s, _ in picks[:2]] == [1, 1]          # the longest, 31 tokens
    assert {s.req.client for s, _ in picks} == {0, 1, 2, 3}
    assert all(s.done for s, _ in picks)
    assert check.sample(served, 7, 4, 5) == picks
    assert check.sample(served[4:], 7, 4, 5) == []
