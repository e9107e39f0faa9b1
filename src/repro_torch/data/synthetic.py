"""Deterministic synthetic LM data (a copy of the JAX package's
``repro/data/synthetic.py``, numpy only).

Sequences follow per-sequence affine recurrences ``t_{i+1} = (a*t_i + c)
mod V`` with a sprinkle of noise — fully learnable structure so the
training examples show real loss curves, and *step-addressable* (batch k
is a pure function of (seed, k)) so restart-after-failure resumes the
exact data order (runtime.trainer.run_with_restarts)."""
from __future__ import annotations

import numpy as np


def lm_batch_at(step: int, *, vocab: int, batch: int, seq: int,
                seed: int = 0, noise: float = 0.05):
    rng = np.random.default_rng(seed * 1_000_003 + step)
    a = rng.integers(1, 8, size=(batch, 1))
    c = rng.integers(0, vocab, size=(batch, 1))
    t0 = rng.integers(0, vocab, size=(batch, 1))
    idx = np.arange(seq + 1)
    toks = t0
    seqs = [t0]
    for _ in range(seq):
        toks = (toks * a + c) % vocab
        seqs.append(toks)
    toks = np.concatenate(seqs, axis=1)              # (B, S+1)
    flip = rng.random(toks.shape) < noise
    toks = np.where(flip, rng.integers(0, vocab, toks.shape), toks)
    return {"tokens": toks[:, :-1].astype(np.int32),
            "labels": toks[:, 1:].astype(np.int32)}


def lm_batches(start_step: int, **kw):
    step = start_step
    while True:
        yield lm_batch_at(step, **kw)
        step += 1
