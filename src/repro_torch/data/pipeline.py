"""Deterministic, shardable data pipeline (a copy of ``repro.data.pipeline``,
which is numpy only; the port imports nothing of the reference).

Design constraints from the 1000+-node target:
  * **Deterministic addressing** — batch ``i`` of host ``h`` is a pure
    function of (seed, step, host), so restart-after-failure resumes at the
    exact batch without coordination or a data server (the same principle as
    the TDG: resolve scheduling once, replay forever).
  * **Per-host sharding** — each host materializes only its slice
    (``host_batch = global_batch / num_hosts``).
  * **Packing** — documents of random length are packed into fixed
    (batch, seq_len) token grids with EOS separators and a loss mask.

Synthetic corpora stand in for real tokenized data (this container is
offline); the interface (``__getitem__(step) -> batch dict``) is what a real
tokenized-shard reader would implement.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, Sequence

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    num_hosts: int = 1
    host_id: int = 0
    eos_id: int = 1
    pad_id: int = 0
    mean_doc_len: int = 256

    @property
    def host_batch(self) -> int:
        assert self.global_batch % self.num_hosts == 0
        return self.global_batch // self.num_hosts


class SyntheticLM:
    """Markov-ish synthetic token stream: deterministic per (seed, step, host).

    Tokens follow ``t[i+1] = (a * t[i] + b + noise) % vocab`` per document —
    enough structure that a real model's loss visibly falls, which the
    end-to-end example uses as its convergence check.
    """

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg

    def _doc(self, rng: np.random.Generator, length: int) -> np.ndarray:
        v = self.cfg.vocab_size
        a = int(rng.integers(2, 8))
        b = int(rng.integers(1, v - 1))
        t0 = int(rng.integers(2, v))
        toks = np.empty(length, np.int64)
        toks[0] = t0
        for i in range(1, length):
            noise = int(rng.integers(0, 3))
            toks[i] = (a * toks[i - 1] + b + noise) % (v - 2) + 2
        return toks

    def batch(self, step: int) -> dict:
        c = self.cfg
        rng = np.random.default_rng(
            np.random.SeedSequence([c.seed, step, c.host_id]))
        docs = []
        total = 0
        need = c.host_batch * c.seq_len
        while total < need:
            ln = max(8, int(rng.exponential(c.mean_doc_len)))
            docs.append(self._doc(rng, ln))
            total += ln + 1
        tokens, mask = pack_documents(docs, c.host_batch, c.seq_len,
                                      eos_id=c.eos_id, pad_id=c.pad_id)
        return {"tokens": tokens.astype(np.int32),
                "loss_mask": mask.astype(np.float32)}

    def __getitem__(self, step: int) -> dict:
        return self.batch(step)


class MixtureDataset:
    """Weighted mixture over component datasets, deterministic per step."""

    def __init__(self, components: Sequence, weights: Sequence[float],
                 seed: int = 0):
        assert len(components) == len(weights) and components
        w = np.asarray(weights, np.float64)
        self.p = w / w.sum()
        self.components = list(components)
        self.seed = seed

    def batch(self, step: int) -> dict:
        rng = np.random.default_rng(np.random.SeedSequence([self.seed, step]))
        idx = int(rng.choice(len(self.components), p=self.p))
        return self.components[idx].batch(step)

    __getitem__ = batch


def pack_documents(docs: Sequence[np.ndarray], batch: int, seq_len: int,
                   eos_id: int = 1, pad_id: int = 0):
    """Greedy sequential packing into (batch, seq_len) with EOS separators.
    Returns (tokens, loss_mask); pad positions get mask 0."""
    flat = []
    for d in docs:
        flat.extend(int(x) for x in d)
        flat.append(eos_id)
    need = batch * seq_len
    if len(flat) < need:
        flat.extend([pad_id] * (need - len(flat)))
    arr = np.asarray(flat[:need], np.int64).reshape(batch, seq_len)
    mask = (arr != pad_id).astype(np.float32)
    return arr, mask


def make_loader(cfg: DataConfig, start_step: int = 0) -> Iterator[dict]:
    """Infinite iterator of host-local batches starting at ``start_step``
    (checkpoint-restart passes the restored step — no state to save)."""
    ds = SyntheticLM(cfg)
    step = start_step
    while True:
        yield ds.batch(step)
        step += 1
