"""A whole run on the CPU at a tiny size, past the harness's look for a card:
sound, ``correct`` reads true; with the served step broken underneath, in
each way a serving cell can break, it reads false."""
import importlib.util
from pathlib import Path

import pytest
import torch

from portbench import harness

PKG = Path(__file__).resolve().parents[1]
SEED = 2**31 + 12345


def _run_module():
    spec = importlib.util.spec_from_file_location("portbench_run_faults", PKG / "run.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def tiny_cell(workload="glm4-gen"):
    """The cell's configuration and mix at a CPU size, float32 compute."""
    cell = harness.load_cell(workload)
    model = dict(cell.config["model"], num_layers=2, d_model=64, num_heads=4,
                 num_kv_heads=2, head_dim=16, d_ff=128, vocab_size=512, dtype="float32")
    cell.config = dict(cell.config, model=model)
    cell.traffic = dict(cell.traffic, sequences=2, prompt_len=[8, 16], output_tokens=12,
                        max_len=32, check_sequences=3)
    cell.limits = {"max_logit_gap": 1e-3, "mean_logit_gap": 1e-4, "min_tokens_compared": 20}
    return cell


def _broken(kind):
    from repro_torch.training import make_serve_step

    def make(cfg):
        step = make_serve_step(cfg)

        def serve_step(params, tokens, pos, caches):
            nxt, new = step(params, tokens, pos, caches)
            if kind == "token":
                return (nxt + 1) % cfg.vocab_size, new
            if kind == "state":
                return nxt, caches
            half = tokens.shape[0] // 2
            nxt_h, new_h = step(params, tokens[:half], pos[:half],
                                [{k: {n: t[:half] for n, t in v.items()} for k, v in c.items()}
                                 for c in caches])
            rep = lambda t: torch.cat([t, t], 0)  # noqa: E731
            return rep(nxt_h), [{k: {n: rep(t) for n, t in v.items()} for k, v in c.items()}
                                for c in new_h]
        return serve_step
    return make


@pytest.mark.parametrize("workload", ["glm4-gen", "glm4-docs"])
def test_sound_run_is_correct(workload):
    result, compared = _run_module().run(tiny_cell(workload), SEED, 2.0, False,
                                         torch.device("cpu"))
    assert result["correct"], compared
    assert result["failed"] == 0 and result["attempted"] > 0
    assert list(result)[-1] == "check"
    assert set(result["metrics"]) == {"tok_s", "tpot_p95_ms", "setup_s"}
    assert result["check"]["tokens_compared"]["value"] >= 20


@pytest.mark.parametrize("fault", ["token", "state", "half"])
def test_broken_step_is_not_correct(monkeypatch, fault):
    import repro_torch.training as training

    monkeypatch.setattr(training, "make_serve_step", _broken(fault))
    result, compared = _run_module().run(tiny_cell(), SEED, 2.0, False, torch.device("cpu"))
    assert not result["correct"], compared
    assert result["check"]["max_logit_gap"]["value"] > 1e-3
    assert result["check"]["mean_logit_gap"]["value"] > 1e-4


def _failing(cfg):
    def serve_step(params, tokens, pos, caches):
        raise RuntimeError("planted")
    return serve_step


def test_a_failing_step_fails_set_up(monkeypatch):
    import repro_torch.training as training

    monkeypatch.setattr(training, "make_serve_step", _failing)
    with pytest.raises(RuntimeError, match="planted"):
        _run_module().run(tiny_cell(), SEED, 1.0, False, torch.device("cpu"))


def test_a_failing_client_fails_the_window(monkeypatch):
    import repro_torch.training as training

    monkeypatch.setattr(training, "make_serve_step", _failing)
    monkeypatch.setattr(harness.System, "warm", lambda self: {})
    result, _ = _run_module().run(tiny_cell(), SEED, 1.0, False, torch.device("cpu"))
    assert not result["correct"]
    assert result["failed"] >= 1 and result["check"]["failed_requests"]["value"] >= 1


def test_control_in_the_programs_place_is_not_correct():
    """The reference in float8 (W8A8) in the program's place, read on the
    same prompts and served tokens, is judged not correct by the comparison
    a run makes (``check.compare``), where the sound run is judged correct;
    ``calibrate.py`` judges it so on the card with the cell's limits file."""
    from portbench import check

    cell = tiny_cell()
    system = harness.System(cell, SEED, torch.device("cpu"))
    system.warm()
    win = harness.drive(system, SEED, 2.0)
    picks = check.sample(win.served, SEED, cell.traffic["sequences"],
                         cell.traffic["check_sequences"])
    system.close()
    served, low = check.gaps(check.reference(cell.config), cell.model, system.weights,
                             picks, control="fp8")
    assert served.numel() == low.numel() >= 20
    assert served.max() <= cell.limits["max_logit_gap"] < low.max()
    assert served.mean() <= cell.limits["mean_logit_gap"] < low.mean()
    assert check.compare(served, 0, cell.limits)[0]
    assert not check.compare(low, 0, cell.limits)[0]


@pytest.mark.parametrize("workload", ["glm4-gen", "glm4-docs"])
def test_compare_holds_each_number_to_the_cells_limits_file(workload):
    """Each reading the cell's limits file names decides ``correct`` on its
    own side of its limit, and so do the tokens compared and failed requests."""
    from portbench import check

    limits = harness.load_cell(workload).limits
    n = limits["min_tokens_compared"]
    name = next(k for k in check.READINGS if k in limits)
    ok, compared = check.compare(torch.full((n,), limits[name] * 0.99), 0, limits)
    assert ok and [c[0] for c in compared][-2:] == ["tokens_compared", "failed_requests"]
    assert not check.compare(torch.full((n,), limits[name] * 1.01), 0, limits)[0]
    assert not check.compare(torch.zeros(n - 1), 0, limits)[0]
    assert not check.compare(torch.zeros(n), 1, limits)[0]
    assert not check.compare(torch.zeros(0), 0, limits)[0]


class _StubTracer:
    """Stands in for the profiler: records when it was started and stopped."""
    seconds = 0.5
    started = False

    def __init__(self, system):
        self.system = system

    def start(self):
        self.started = True
        self.t_start = harness.clock()

    def stop(self, t_stop):
        self.t_stop = t_stop


def test_traced_window_holds_the_clients_and_resumes():
    cell = tiny_cell()
    system = harness.System(cell, SEED, torch.device("cpu"))
    system.warm()
    tracer = _StubTracer(system)
    win = harness.drive(system, SEED, 2.0, tracer)
    system.close()
    assert tracer.started and win.failed == 0
    assert win.t_close - 0.6 < tracer.t_start < win.t_close and tracer.t_stop == win.t_close
    after = [t for s in win.served for t in s.times if tracer.t_start < t < win.t_close]
    assert len(after) > 5                                     # the clients came back
