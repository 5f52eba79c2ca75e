"""The program's own spans (``repro_torch.core.spans``) for the readers of
the ``program_span`` metrics that time parts of the serving path.

The program records spans while a ``torch.profiler`` session runs, so a
``--trace 1`` run holds those of its traced seconds; a ``--trace 0`` run,
and a program without the recorder, hold none, and every reader then reads
nothing. Records are ``SPAN_SCHEMA`` dicts: ``name``, ``thread``, ``t0``,
``t1`` (``time.monotonic()``, the harness's clock) and ``args``.
"""
from __future__ import annotations


def records(r) -> list | None:
    """The readings' span records (``r.spans`` where the readings carry
    them, else the program's recorder), or None when there are none."""
    recs = getattr(r, "spans", None)
    if recs is None:
        try:
            from repro_torch.core import spans
        except ImportError:          # a program that records no spans
            return None
        recs = spans.snapshot()
    return recs or None


def ending_in_window(r, recs: list, name: str) -> list:
    """The ``name`` spans that ended inside the window, in start order."""
    return sorted((s for s in recs if s["name"] == name and r.win.inside(s["t1"])),
                  key=lambda s: s["t0"])


def seconds(s: dict) -> float:
    return s["t1"] - s["t0"]
