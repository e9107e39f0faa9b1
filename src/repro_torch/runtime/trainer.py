"""Fault-tolerant training runtime (PyTorch port of
``repro/runtime/trainer.py``).

* **checkpoint/restart** — async checkpoints every N steps; the loop is
  wrapped in :func:`run_with_restarts`, which restores the latest
  checkpoint after a (simulated or real) failure and continues: the end
  state is bit-identical to an uninterrupted run (tested);
* **failure injection** — :class:`FailureInjector` raises at a chosen
  step to exercise the restart path in tests and drills;
* **straggler detection** — :class:`StepTimeMonitor` keeps an EWMA of
  step wall time and flags outliers.

A state is any tree the checkpoint store takes (dicts, tuples and lists
of tensors).  A step's time ends with a ``torch.cuda.synchronize()`` of
its metrics' device when that is a CUDA device, so ``dt`` is the step's
device time and not its launches'.

Over a mesh of ranks every rank runs the same loop with the same
``Trainer`` settings and a ``layout`` (``models.sharding.StateLayout``):
a :class:`FailureInjector` raises on every rank at the same step, the
checkpoints hold whole leaves written by one rank (the others wait for
it at a barrier before the next checkpoint, a restart or the end) and
every rank restores its slices of the latest one.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Iterator, Optional

import torch

from ..checkpoint import AsyncCheckpointer, latest_step, restore, save


class FailureInjector:
    """Raises RuntimeError once when the step counter hits `fail_at`
    (a function of the step alone, so ranks given the same `fail_at`
    raise at the same step)."""

    def __init__(self, fail_at: int | None = None):
        self.fail_at = fail_at
        self.fired = False

    def check(self, step: int):
        if self.fail_at is not None and not self.fired \
                and step == self.fail_at:
            self.fired = True
            raise RuntimeError(f"injected failure at step {step}")


class StepTimeMonitor:
    """EWMA step-time tracker with straggler flagging."""

    def __init__(self, alpha: float = 0.1, threshold: float = 2.0):
        self.alpha = alpha
        self.threshold = threshold
        self.mean: float | None = None
        self.stragglers: list[tuple[int, float]] = []

    def record(self, step: int, dt: float) -> bool:
        if self.mean is None:
            self.mean = dt
            return False
        is_straggler = dt > self.threshold * self.mean
        if is_straggler:
            self.stragglers.append((step, dt))
        self.mean = (1 - self.alpha) * self.mean + self.alpha * dt
        return is_straggler


def _sync(metrics: dict) -> None:
    for v in metrics.values():
        if isinstance(v, torch.Tensor) and v.device.type == "cuda":
            torch.cuda.synchronize(v.device)
            return


@dataclasses.dataclass
class Trainer:
    """Checkpointed training loop over a step function.

    ``step_fn(state, batch) -> (state, metrics)``; ``state`` is any tree
    (params, optimizer state, residuals), ``metrics`` a dict of scalars;
    ``layout`` describes a state held in slices over ranks (None: whole
    in this process).
    """

    step_fn: Callable
    ckpt_dir: str
    ckpt_every: int = 50
    keep_last: int = 3
    failure: Optional[FailureInjector] = None
    monitor: StepTimeMonitor = dataclasses.field(
        default_factory=StepTimeMonitor)
    layout: Any = None

    def restore_or_init(self, init_state):
        if latest_step(self.ckpt_dir) is not None:
            step, state = restore(self.ckpt_dir, init_state,
                                  layout=self.layout)
            return step, state
        return 0, init_state

    def run(self, state, batches: Iterator, n_steps: int,
            start_step: int = 0, log_every: int = 10,
            log_fn=print) -> tuple[Any, list[dict]]:
        ckpt = AsyncCheckpointer(self.ckpt_dir, keep_last=self.keep_last,
                                 layout=self.layout)
        history = []
        step = start_step
        try:
            for batch in batches:
                if step >= n_steps:
                    break
                t0 = time.time()
                if self.failure is not None:
                    self.failure.check(step)
                state, metrics = self.step_fn(state, batch)
                _sync(metrics)
                dt = time.time() - t0
                straggler = self.monitor.record(step, dt)
                step += 1
                if step % self.ckpt_every == 0 or step == n_steps:
                    ckpt.save(step, state)
                rec = {k: float(v) for k, v in metrics.items()}
                rec["step"] = step
                rec["dt"] = dt
                rec["straggler"] = straggler
                history.append(rec)
                if log_every and step % log_every == 0:
                    log_fn(f"step {step}: " + " ".join(
                        f"{k}={v:.4f}" for k, v in rec.items()
                        if isinstance(v, float)))
        finally:
            # a failure too waits for the write in flight: the restart
            # must see it, and must not write the same step beside it
            ckpt.wait()
        return state, history


def run_with_restarts(make_batches: Callable[[int], Iterator],
                      trainer: Trainer, init_state, n_steps: int,
                      max_restarts: int = 3, log_every: int = 10,
                      log_fn=print):
    """Drive ``Trainer.run`` with automatic restore-on-failure.

    ``make_batches(start_step)`` must return an iterator positioned at
    ``start_step`` (the synthetic pipelines here are seeded by step).
    A step-0 snapshot is written before training, so a failure before
    the first periodic checkpoint restarts from the initial state as it
    was, whatever the steps did to ``init_state``'s tensors since."""
    if latest_step(trainer.ckpt_dir) is None:
        save(trainer.ckpt_dir, 0, init_state,
             keep_last=trainer.keep_last, layout=trainer.layout)
    attempts = 0
    while True:
        start, state = trainer.restore_or_init(init_state)
        try:
            return trainer.run(state, make_batches(start), n_steps,
                               start_step=start, log_every=log_every,
                               log_fn=log_fn)
        except RuntimeError as e:
            attempts += 1
            log_fn(f"[fault] {e} -> restart {attempts}/{max_restarts}")
            if attempts > max_restarts:
                raise
