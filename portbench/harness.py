"""One cell of the port's benchmark: set-up, the closed-loop window, records.

A cell is a configuration (``configs/<name>.json``) under a traffic mix
(``traffic/<name>.json``), named by ``BENCHMARK.json``. The configuration
names its architecture (``"arch"``: ``arch/<name>.py``, the parameter layout
and the model-level work counts) and its plain reference (``"reference"``:
``reference/<name>.py``). This module builds what the cell names and drives
it; ``run.py`` is the command line around it, ``check.py`` decides
``correct`` and ``metrics/<name>.py`` read the metrics.

The path the window drives is the program's serving path: a client's
request is prefilled through ``repro_torch.models.model.prefill`` (one
prefill at a time on the card), then decoded one ``RegionServer.submit`` a
token, every step one captured replay of the vmapped decode step over the
resident clients. Tokens are stamped when the call that made them returns.
"""
from __future__ import annotations

import collections
import dataclasses
import importlib.util
import json
import math
import os
import sys
import threading
import time
import types
from pathlib import Path

import numpy as np
import torch

from . import weights as W
from . import work

PKG = Path(__file__).resolve().parent
REPO = PKG.parent
#: Top-level module names a run may never load: JAX and the JAX package.
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "repro"})
#: Prompt lengths a mix sends: an even grid of this many over its range.
LENGTH_GRID = 16
#: Set-up's warm-up: steps a client takes in each occupancy of a round, and
#: the most rounds before it gives up waiting for the graphs to settle.
WARM_STEPS = 3
WARM_MAX_ROUNDS = 60


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name (before the first dot) is forbidden."""
    return sorted({name.split(".")[0] for name in list(sys.modules)} & FORBIDDEN)


def clock() -> float:
    return time.monotonic()


def process_age() -> float | None:
    """Seconds since this process started, from the kernel's own record."""
    try:
        ticks = int(Path("/proc/self/stat").read_text().rsplit(")", 1)[1].split()[19])
        boot = float(Path("/proc/uptime").read_text().split()[0])
    except (OSError, ValueError, IndexError):
        return None
    return boot - ticks / os.sysconf("SC_CLK_TCK")


# ---------------------------------------------------------------------------
# The cell, as the manifest names it
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Cell:
    workload: str
    entry: dict
    bench: dict
    config: dict
    traffic: dict
    limits: dict
    arch: types.ModuleType     # arch/<config["arch"]>.py

    @property
    def model(self) -> dict:
        m = dict(self.config["model"])
        m["padded_vocab"] = -(-m["vocab_size"] // 256) * 256
        return m

    def metrics(self, kind: str) -> list[dict]:
        """The manifest's ``end_to_end`` or ``per_layer`` metrics of this cell."""
        return [m for m in self.bench[kind] if self.workload in m.get("workloads", [self.workload])]


def load_cell(workload: str, root: Path = REPO) -> Cell:
    bench = json.loads((root / "BENCHMARK.json").read_text())
    entry = {w["name"]: w for w in bench["workloads"]}.get(workload)
    if entry is None:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    cfg_file = {c["name"]: c for c in bench["configs"]}[entry["config"]]["file"]
    config = json.loads((root / cfg_file).read_text())
    if "arch" not in config:
        raise SystemExit(f'{cfg_file} has no "arch" key: name the module under '
                         f'portbench/arch/ that lays out its parameters and counts its work')
    return Cell(workload, entry, bench, config,
                json.loads((PKG / "traffic" / f"{entry['traffic']}.json").read_text()),
                json.loads((PKG / "cells" / f"{workload}.json").read_text()),
                load_file(PKG / "arch" / f"{config['arch']}.py"))


def load_file(path: Path):
    """A module of the benchmark found by its file name, which may hold dots."""
    spec = importlib.util.spec_from_file_location("portbench_" + path.stem.replace(".", "_"),
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def port_config(model: dict):
    """The program's ModelConfig holding the configuration file's values."""
    from repro_torch.configs.base import ModelConfig

    fields = {f.name for f in dataclasses.fields(ModelConfig)}
    return ModelConfig(**{k: v for k, v in model.items() if k in fields})


def check_layout(layout: list, program) -> None:
    """Stop unless ``layout`` names every parameter of the program's model
    (a module on any device), at its shape, and nothing else."""
    want = {name: tuple(p.shape) for name, p in program.named_parameters()}
    have = {name: tuple(shape) for name, shape, _ in layout}
    missing, extra = sorted(want.keys() - have.keys()), sorted(have.keys() - want.keys())
    shapes = sorted(f"{n} {have[n]} (program {want[n]})"
                    for n in want.keys() & have.keys() if have[n] != want[n])
    if missing or extra or shapes:
        raise ValueError(f"the arch layout does not match the program's parameters: "
                         f"missing {missing}; extra {extra}; other shapes {shapes}")


# ---------------------------------------------------------------------------
# Traffic: one general generator over the mix's parameters
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Request:
    client: int
    index: int
    length: int
    outputs: int
    token_seed: int


def lengths(traffic: dict) -> list[int]:
    """The mix's prompt lengths: an even grid over its range."""
    lo, hi = traffic["prompt_len"]
    n = LENGTH_GRID
    return [round(lo + (hi - lo) * i / max(1, n - 1)) for i in range(n)]


def plan(traffic: dict, seed: int, per_client: int = 256) -> list[list[Request]]:
    """Each client's requests. Every seed gets the same lengths (an even grid
    over the mix's range, each client walking it in its own seeded order) and
    the same first-request shares (dealt to the clients in a seeded order),
    so seeds change the order of the work and not its amount."""
    rng = np.random.default_rng(seed)
    grid = lengths(traffic)
    n = len(grid)
    shares = list(rng.permutation(traffic["first_shares"]))
    out = []
    for c in range(traffic["clients"]):
        order = rng.permutation(grid)
        reqs = []
        for r in range(per_client):
            outs = traffic["output_tokens"]
            if r == 0:
                outs = max(1, round(shares[c % len(shares)] * outs))
            reqs.append(Request(c, r, int(order[r % n]), outs, int(rng.integers(1 << 62))))
        out.append(reqs)
    return out


def prompt_tokens(req: Request, sequences: int, vocab: int, device) -> torch.Tensor:
    gen = torch.Generator(device=device).manual_seed(req.token_seed)
    return torch.randint(2, vocab, (sequences, req.length), generator=gen,
                         device=device, dtype=torch.int32)


# ---------------------------------------------------------------------------
# The system under test
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Served:
    """One request as a client saw it."""
    req: Request
    t_send: float
    t_prefill: float = 0.0
    times: list = dataclasses.field(default_factory=list)   # one per output token
    done: bool = False
    prompt: torch.Tensor | None = None
    out: torch.Tensor | None = None


class System:
    """The program's model and server for one cell, with a tenant a client."""

    def __init__(self, cell: Cell, seed: int, device: torch.device):
        from repro_torch.core import TDG
        from repro_torch.models import model as M
        from repro_torch.serving import RegionServer
        from repro_torch.training import make_serve_step

        self.cell, self.device, self.M = cell, device, M
        self.model = cell.model
        self.cfg = port_config(self.model)
        self.traffic = cell.traffic
        self.layout = cell.arch.layout(self.model)
        self.weights, self.buffer = W.make(self.layout, seed, device)
        check_layout(self.layout, M.Model(self.cfg, "meta"))
        self.port = M.model_of(self.cfg, self.weights)
        srv = self.traffic["server"]
        t0 = clock()
        self.server = RegionServer(max_batch=srv["max_batch"], max_wait_ms=srv["max_wait_ms"],
                                   name="portbench")
        self.ring_t0 = (t0 + clock()) / 2      # the trace ring's t_ms origin
        step = make_serve_step(self.cfg)       # one payload shared by every tenant
        self.tenants = []
        for c in range(self.traffic["clients"]):
            tdg = TDG(f"decode[{c}]")
            tdg.add_task(step, ins=["params", "tokens", "pos", "caches"],
                         outs=["next", "caches"], name="decode")
            self.server.register_tenant(f"client{c}", tdg, outputs=("next", "caches"))
            self.tenants.append(f"client{c}")
        self.prefill_lock = threading.Lock()
        self.stop = threading.Event()

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def captures(self) -> int:
        return self.server.stats()["graphs"]["captures"]

    # -- one request ---------------------------------------------------------
    def prefill(self, prompt: torch.Tensor):
        from torch.profiler import record_function

        with self.prefill_lock, record_function("prefill"):
            t0 = clock()
            logits, caches, pos = self.M.prefill(self.port, self.cfg, {"tokens": prompt},
                                                 self.traffic["max_len"])
            tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
            self.sync()
            return t0, tok, caches, pos

    def step(self, tenant: str, tok, pos, caches):
        """One blocking decode step of ``tenant`` (set-up's warm-up)."""
        out = self.server.serve(tenant, {"params": self.port, "tokens": tok[:, None],
                                         "pos": pos, "caches": caches}, timeout=300)
        return out["next"], pos + 1, out["caches"]

    # -- set-up: every graph the traffic needs, the tuner settled ------------
    def warm(self) -> dict:
        """Step every occupancy from the most to one in rounds, until a round
        that ran every bucket the clients can fill captures nothing, and the
        bucket tuner can no longer refit (its ladder holds every occupancy a
        batch can have, or it is not adaptive); then prefill every prompt
        length of the mix once."""
        B = self.traffic["sequences"]
        lo = self.traffic["prompt_len"][0]
        states = []
        for c in range(len(self.tenants)):
            req = Request(c, -1, lo, 1, c + 1)
            _, tok, caches, pos = self.prefill(prompt_tokens(req, B, self.model["vocab_size"],
                                                             self.device))
            states.append([tok, pos, caches])
        full = list(range(2, self.server.max_batch + 1))

        errors: list[BaseException] = []

        def drive(c: int) -> None:
            try:
                with torch.no_grad():
                    for _ in range(WARM_STEPS):
                        states[c] = list(self.step(self.tenants[c], *states[c]))
            except BaseException as exc:   # raised again on the calling thread
                errors.append(exc)

        rounds = 0
        for rounds in range(1, WARM_MAX_ROUNDS + 1):
            before = (self.captures(), self.server.stats()["buckets"]["retunes"])
            seen = self.server.metrics.trace.count
            for k in range(len(self.tenants), 0, -1):
                threads = [threading.Thread(target=drive, args=(c,)) for c in range(k)]
                for t in threads:
                    t.start()
                for t in threads:
                    t.join()
                if errors:
                    raise errors[0]
            buckets = self.server.stats()["buckets"]
            settled = not buckets["adaptive"] or buckets["boundaries"] == full
            new = self.server.metrics.trace.count - seen
            ran = {r["bucket"] for r in self.server.metrics.trace.snapshot()[-new:]} \
                if new else set()
            every = {self.server.buckets.bucket_for(k) for k in range(1, len(self.tenants) + 1)}
            if settled and ran >= every and before == (self.captures(), buckets["retunes"]):
                break
        del states
        # Every prompt length the mix sends, once: the library's first call of
        # a shape (cuBLAS's choice of kernel) falls here, not in the window.
        for n in lengths(self.traffic):
            self.prefill(prompt_tokens(Request(0, -1, n, 1, n), B, self.model["vocab_size"],
                                       self.device))
        return {"rounds": rounds, "captures": self.captures(),
                "boundaries": self.server.stats()["buckets"]["boundaries"]}

    def close(self) -> None:
        self.server.close()


# ---------------------------------------------------------------------------
# The window
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Window:
    t_open: float
    t_close: float
    served: list
    steps: list          # the ring's records, with absolute "t_end"
    captures: tuple
    attempted: int
    failed: int
    errors: list

    @property
    def seconds(self) -> float:
        return self.t_close - self.t_open

    def inside(self, t: float) -> bool:
        return self.t_open <= t < self.t_close


def _sleep_until(t: float) -> None:
    left = t - clock()
    if left > 0:
        time.sleep(left)


class Load:
    """The closed-loop clients of one window, on two threads of their own.

    A client's next decode step is submitted from the completion callback of
    its last one (on the server's scheduler thread), so it is queued before
    the server picks the next step and no client thread has to wake for it.
    A client whose request ended waits in line for the one prefill thread:
    one prefill at a time on the card. :meth:`quiesce` holds every client at
    its next boundary, so the profiler starts and stops with no work in
    flight.
    """

    def __init__(self, system: System, requests: list[list[Request]]):
        self.system = system
        self.requests = [iter(r) for r in requests]
        self.served: list[Served] = []
        self.errors: list[BaseException] = []
        self.cond = threading.Condition()
        self.line: collections.deque = collections.deque()   # (client, t_send)
        self.parked: list[int] = []
        self.first: set[int] = set()
        self.active = len(requests)
        self.hold = self.closed = False
        self.state: dict[int, dict] = {}
        self.worker = threading.Thread(target=self._prefills, daemon=True)

    def start(self) -> None:
        self.worker.start()
        for c in range(len(self.requests)):
            self._next(c)

    # -- a client's life ------------------------------------------------------
    def _next(self, c: int) -> None:
        with self.cond:
            if self.system.stop.is_set():
                self.active -= 1
            else:
                self.line.append((c, clock()))
            self.cond.notify_all()

    def _prefills(self) -> None:
        sys_ = self.system
        while True:
            with self.cond:
                self.cond.wait_for(lambda: self.closed or (self.line and not self.hold))
                if self.closed:
                    return
                c, t_send = self.line.popleft()
            if sys_.stop.is_set():
                self._next(c)
                continue
            try:
                with torch.no_grad():
                    req = next(self.requests[c])
                    rec = Served(req, t_send)
                    rec.prompt = prompt_tokens(req, sys_.traffic["sequences"],
                                               sys_.model["vocab_size"], sys_.device)
                    rec.t_prefill, tok, caches, pos = sys_.prefill(rec.prompt)
                    rec.times.append(clock())
                    rec.out = torch.empty((rec.prompt.shape[0], req.outputs),
                                          dtype=torch.int32, device=sys_.device)
                    rec.out[:, 0] = tok
            except BaseException as exc:   # a failed client fails the run, never hangs it
                self._fail(exc)
                self._next(c)
                continue
            self.state[c] = {"rec": rec, "tok": tok, "pos": pos, "caches": caches}
            with self.cond:
                self.first.add(c)
                self.cond.notify_all()
            if req.outputs > 1:
                self._submit(c)
            else:
                self._end(c, done=True)

    def _submit(self, c: int) -> None:
        with self.cond:
            if self.hold:
                self.parked.append(c)
                self.cond.notify_all()
                return
        st = self.state[c]
        try:
            fut = self.system.server.submit(self.system.tenants[c], {
                "params": self.system.port, "tokens": st["tok"][:, None],
                "pos": st["pos"], "caches": st["caches"]})
        except BaseException as exc:   # refused at admission
            self._fail(exc)
            self._end(c, done=False)
            return
        fut.add_done_callback(lambda f, c=c: self._stepped(c, f))

    def _stepped(self, c: int, fut) -> None:
        st = self.state[c]
        try:
            out = fut.result()
            st["rec"].times.append(clock())
            with torch.no_grad():
                st["rec"].out[:, len(st["rec"].times) - 1] = out["next"]
                st["tok"], st["pos"], st["caches"] = out["next"], st["pos"] + 1, out["caches"]
        except BaseException as exc:   # the step failed: so does the run
            self._fail(exc)
            self._end(c, done=False)
            return
        if len(st["rec"].times) == st["rec"].req.outputs:
            self._end(c, done=True)
        elif self.system.stop.is_set():
            self._end(c, done=False)
        else:
            self._submit(c)

    def _end(self, c: int, done: bool) -> None:
        rec = self.state.pop(c)["rec"]
        rec.done = done
        with self.cond:
            self.served.append(rec)
        self._next(c)

    def _fail(self, exc: BaseException) -> None:
        with self.cond:
            self.errors.append(exc)
            self.cond.notify_all()
        self.system.stop.set()

    # -- the main thread's side -----------------------------------------------
    def wait_first_tokens(self, timeout: float) -> None:
        with self.cond:
            self.cond.wait_for(lambda: len(self.first) == len(self.requests) or self.errors
                               or self.active == 0, timeout)

    def quiesce(self, timeout: float = 120.0) -> bool:
        """Hold every client at its next boundary; True once none is in flight."""
        with self.cond:
            self.hold = True
            return self.cond.wait_for(
                lambda: len(self.parked) + len(self.line) >= self.active, timeout)

    def resume(self) -> None:
        with self.cond:
            self.hold = False
            parked, self.parked = self.parked, []
            self.cond.notify_all()
        for c in parked:
            self._submit(c)

    def stop(self, timeout: float = 300.0) -> None:
        """Stop every client at its next boundary and wait for the last."""
        self.system.stop.set()
        self.resume()
        with self.cond:
            if not self.cond.wait_for(lambda: self.active == 0, timeout):
                self.errors.append(RuntimeError(f"clients still active after {timeout} s"))
            self.closed = True
            self.cond.notify_all()
        self.worker.join(timeout)


def drive(system: System, seed: int, seconds: float, tracer=None) -> Window:
    """Start the clients out of phase, open the window once each has its
    first token, measure for ``seconds``, stop the clients and wait for them.
    The traced run starts the profiler ``tracer.seconds`` before the close
    with the clients held, and stops it once they have stopped; its trace
    opens at the end of the first step begun after the clients resumed."""
    system.stop.clear()
    load = Load(system, plan(system.traffic, seed))
    load.start()
    load.wait_first_tokens(timeout=600)
    t_open = clock()
    cap_open = system.captures()
    t_close = t_open + seconds
    if tracer is not None:
        _sleep_until(t_close - tracer.seconds)
        if load.quiesce():
            system.sync()
            tracer.start()
        else:
            load.errors.append(RuntimeError("clients not held for the profiler's start"))
        load.resume()
        t_resumed = clock()
    _sleep_until(t_close)
    t_close = clock()
    cap_close = system.captures()
    load.stop()
    if tracer is not None and tracer.started:
        system.sync()
        tracer.stop(t_close)
    steps = []
    for r in system.server.metrics.trace.snapshot():
        r["t_end"] = system.ring_t0 + r["t_ms"] / 1e3
        steps.append(r)
    if tracer is not None and tracer.started:
        # The trace opens at the end of the first step begun after the clients
        # resumed: the profiler's own start-up falls before it.
        tracer.t_start = min((r["t_end"] for r in steps
                              if r["t_end"] - r["wall_ms"] / 1e3 >= t_resumed), default=t_resumed)
    served = load.served
    return Window(t_open, t_close, served, steps, (cap_open, cap_close),
                  attempted=sum(1 for s in served if s.t_send < t_close and
                                (s.t_send >= t_open or (s.times and s.times[-1] >= t_open))),
                  failed=len(load.errors), errors=load.errors)


# ---------------------------------------------------------------------------
# Readings shared by the metrics
# ---------------------------------------------------------------------------

def token_events(win: Window, sequences: int):
    """(time, tokens, context, gap) of each step's output inside the window:
    ``context`` the positions the step's token attended to (prefill: None),
    ``gap`` the seconds since the same sequences' previous token (None for
    a request's first)."""
    for s in win.served:
        for j, t in enumerate(s.times):
            if win.inside(t):
                yield (t, sequences, None if j == 0 else s.req.length + j,
                       None if j == 0 else t - s.times[j - 1], s)


def steps_in_window(win: Window) -> list[dict]:
    return [r for r in win.steps if win.inside(r["t_end"])]


def peaks(device: torch.device) -> dict | None:
    if device.type != "cuda":
        return None
    return work.PEAKS.get(torch.cuda.get_device_name(device))


def prefills_in(win: Window) -> list[tuple[float, float, Served]]:
    """(call, first token, request) of every prefill, in time order."""
    return sorted((s.t_prefill, s.times[0], s) for s in win.served if s.times)


def nearest_rank(values: list[float], q: float) -> float:
    """The ``ceil(q/100 * n)``-th smallest value."""
    vals = sorted(values)
    return vals[max(0, min(len(vals) - 1, math.ceil(len(vals) * q / 100) - 1))]


@dataclasses.dataclass
class Readings:
    """What a metric reader may read: the cell, the window and the trace."""
    cell: Cell
    model: dict
    traffic: dict
    win: Window
    trace: object        # a trace.Trace from the traced run, else None
    peaks: dict | None

    def step_at(self, t: float) -> dict | None:
        """The ring's step whose host interval holds ``t``."""
        for r in self.win.steps:
            if r["t_end"] - r["wall_ms"] / 1e3 <= t <= r["t_end"]:
                return r
        return None

    def prefill_at(self, t: float) -> Served | None:
        for t0, t1, s in prefills_in(self.win):
            if t0 <= t <= t1:
                return s
        return None
