"""What decides ``correct``: served greedy tokens held to the plain reference.

Once the window has closed and the program's state is freed, a sample drawn
from the seed of the requests the window finished, the longest among them,
is run through the configuration's reference (``reference/<name>.py``,
float32, TF32 off) over each prompt and its served tokens. Every served token
was the program's greedy choice; its gap is how far the reference's logit
for it lies below the reference's best at that position. The numbers
compared are those the cell's limits file (``cells/<workload>.json``) names:
the widest gap, or, where the widest does not separate the program from the
control, the mean gap. The first token comes from the prefill, the rest
from the served decode step, so the sample covers the prefill, the captured
batched step with its cache and the unembed.

The control (``gaps(control="fp8")``) puts the reference in the program's
place at the next precision below the configuration's bfloat16, float8
(W8A8): at each position of the same tokens it reads the gap of the token
the float8 forward puts first.
"""
from __future__ import annotations

import numpy as np
import torch

from . import harness


def reference(config: dict):
    """The configuration's plain reference, ``reference/<name>.py``."""
    return harness.load_file(harness.PKG / "reference" / f"{config['reference']}.py")


def sample(served: list, seed: int, sequences: int, n: int) -> list[tuple]:
    """``n`` (served request, row) pairs drawn from the seed: two rows of the
    longest finished request, then a row of each other finished request,
    then any rows left."""
    done = sorted((s for s in served if s.done),
                  key=lambda s: (-s.req.outputs, s.req.client, s.req.index))
    if not done:
        return []
    rng = np.random.default_rng([seed, 0xC4EC])
    picked = [(0, int(r)) for r in rng.choice(sequences, min(2, sequences, n), replace=False)]
    others = [(i, r) for i in range(1, len(done)) for r in range(sequences)]
    rng.shuffle(others)
    seen = {0}
    for i, r in others:
        if len(picked) < n and i not in seen:
            picked.append((i, r))
            seen.add(i)
    for pair in others + [(0, r) for r in range(sequences)]:
        if len(picked) < n and pair not in picked:
            picked.append(pair)
    return [(done[i], r) for i, r in picked]


def prune(served: list, picks: list) -> None:
    """Free the tokens of every served request the sample did not pick."""
    kept = {id(s) for s, _ in picks}
    for s in served:
        if id(s) not in kept:
            s.prompt = s.out = None


def _rows(s, row: int):
    prompt = s.prompt[row].long()
    served = s.out[row].long()
    tokens = torch.cat([prompt, served[:-1]])
    rows = torch.arange(prompt.numel() - 1, tokens.numel(), device=tokens.device)
    return tokens, rows, served


def gaps(ref, model: dict, weights: dict, picks: list,
         control: str | None = None) -> tuple[torch.Tensor, torch.Tensor | None]:
    """The gap of every served token of the picked rows; with ``control``,
    also the gap of the token that forward, in that precision, puts first."""
    served_gaps, control_gaps = [], []
    for s, row in picks:
        tokens, rows, served = _rows(s, row)
        exact = ref.logits_at(model, weights, tokens, rows)
        best = exact.max(-1).values
        served_gaps.append(best - exact.gather(-1, served[:, None])[:, 0])
        if control is not None:
            first = ref.logits_at(model, weights, tokens, rows, quant=control).argmax(-1)
            control_gaps.append(best - exact.gather(-1, first[:, None])[:, 0])
    cat = (lambda xs: torch.cat(xs) if xs else torch.zeros(0))  # noqa: E731
    return cat(served_gaps), (cat(control_gaps) if control is not None else None)


#: The numbers a cell's limits file may hold, each read from the gaps.
READINGS = {"max_logit_gap": lambda g: float(g.max()),
            "mean_logit_gap": lambda g: float(g.mean())}


def compare(gaps: torch.Tensor, failed: int, limits: dict) -> tuple[bool, list[tuple]]:
    """``correct``, and each number compared as (name, value, limit, op): the
    readings the cell's limits file names, the tokens compared and the
    requests that failed."""
    compared = [(name, read(gaps) if gaps.numel() else float("inf"), limits[name], "<=")
                for name, read in READINGS.items() if name in limits]
    compared += [("tokens_compared", gaps.numel(), limits["min_tokens_compared"], ">="),
                 ("failed_requests", failed, 0, "<=")]
    return all(v <= L if op == "<=" else v >= L for _, v, L, op in compared), compared
