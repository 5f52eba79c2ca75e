"""The device trace of the window's last seconds, read into plain records.

``torch.profiler`` traces CPU and CUDA activity from ``start`` to ``stop``;
its Chrome trace is written under ``TMPDIR``, read once and deleted. Device
timestamps are moved onto the host's ``time.monotonic`` clock through a
marker span recorded at a known instant, so kernels can be matched with the
harness's own intervals (prefills, the ring's steps).
"""
from __future__ import annotations

import dataclasses
import json
import os
import tempfile
import time

#: Chrome-trace categories of device activity.
DEVICE_CATS = frozenset({"kernel", "gpu_memcpy", "gpu_memset"})
MARKER = "portbench_clock"


@dataclasses.dataclass
class Kernel:
    name: str
    start: float          # host monotonic seconds
    end: float
    graph: bool           # launched by a CUDA graph replay


@dataclasses.dataclass
class Trace:
    t_start: float
    t_stop: float
    kernels: list         # every device activity inside [t_start, t_stop]

    @property
    def window_s(self) -> float:
        return self.t_stop - self.t_start

    def busy_intervals(self) -> list[tuple[float, float]]:
        """The union of the device activity, clipped to the window."""
        spans = sorted((max(k.start, self.t_start), min(k.end, self.t_stop))
                       for k in self.kernels)
        merged: list[list[float]] = []
        for lo, hi in spans:
            if hi <= lo:
                continue
            if merged and lo <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], hi)
            else:
                merged.append([lo, hi])
        return [(lo, hi) for lo, hi in merged]

    def busy_s(self) -> float:
        return sum(hi - lo for lo, hi in self.busy_intervals())

    def idle_gaps(self) -> list[tuple[float, float]]:
        edges = [self.t_start]
        for lo, hi in self.busy_intervals():
            edges += [lo, hi]
        edges.append(self.t_stop)
        return [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]


class Tracer:
    """Profiles ``seconds`` of the window; :meth:`read` gives the :class:`Trace`.

    Made before the program's work starts: a first short session then sets
    up the profiler's device tracing while this is the only thread on the card.
    """

    def __init__(self, seconds: float):
        import torch
        from torch.profiler import ProfilerActivity, profile

        self.seconds = seconds
        self._prof = None
        self._mark = None
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
            torch.zeros(1, device="cuda").add_(1)
            torch.cuda.synchronize()

    started = False

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile, record_function

        self._prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self._prof.start()
        with record_function(MARKER):
            self._mark = time.monotonic()
        self.t_start = time.monotonic()
        self.started = True

    def stop(self, t_stop: float) -> None:
        """Stop tracing; the trace's window ends at ``t_stop``."""
        self.t_stop = t_stop
        self._prof.stop()

    def read(self) -> Trace:
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self._prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.unlink(path)
        self._prof = None
        return parse(events, self._mark, self.t_start, self.t_stop)


def parse(events: list, mark: float, t_start: float, t_stop: float) -> Trace:
    """Device activity of a Chrome trace on the host's clock."""
    ts_mark = next(e["ts"] for e in events if e.get("name") == MARKER and "dur" in e)
    graph_corr = {e["args"]["correlation"] for e in events
                  if e.get("cat") == "cuda_runtime" and "Graph" in e.get("name", "")
                  and "correlation" in e.get("args", {})}
    kernels = []
    for e in events:
        if e.get("cat") not in DEVICE_CATS or "dur" not in e:
            continue
        start = mark + (e["ts"] - ts_mark) / 1e6
        end = start + e["dur"] / 1e6
        if end <= t_start or start >= t_stop:
            continue
        kernels.append(Kernel(e["name"], start, end,
                              e.get("args", {}).get("correlation") in graph_corr))
    return Trace(t_start, t_stop, kernels)
