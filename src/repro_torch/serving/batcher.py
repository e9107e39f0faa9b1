"""Fixed-shape slot micro-batching for continuous-batching decode.

A copy of the JAX package's ``serving/batcher.py`` (framework-free).

The decode step is one program over a *fixed* batch of
``n_slots`` sequences — arrivals of any cadence are mapped onto the
static batch shape, never onto a new trace.  :class:`SlotBatch` owns the
host-side per-slot state (which request occupies which slot, each slot's
cache length and current token) and hands the engine the dense
``(B, 1)`` token and ``(B,)`` cache-length arrays every step.

Continuous batching: when a sequence finishes, its slot is *released and
refilled immediately* from the admission queue (``free()`` ->
``occupy()``) while the other slots keep decoding — the batch never
drains to a barrier.  Idle slots still ride through the decode step
(fixed shape); their outputs are ignored and their cache is overwritten
wholesale at the next refill.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np


@dataclasses.dataclass
class _SlotState:
    request: Any                 # opaque engine request object
    gen_target: int              # tokens to generate before completion
    gen_count: int               # tokens generated so far (incl. prefill's)


class SlotBatch:
    """Host-side slot table: fixed ``n_slots`` rows of decode state."""

    def __init__(self, n_slots: int):
        if n_slots <= 0:
            raise ValueError(f"n_slots must be positive, got {n_slots}")
        self.n_slots = int(n_slots)
        self._slots: list[Optional[_SlotState]] = [None] * n_slots
        self.cache_lens = np.zeros(n_slots, np.int32)
        self.tokens = np.zeros((n_slots, 1), np.int32)

    # -------------------------------------------------------------- queries
    def free(self) -> list[int]:
        return [i for i, s in enumerate(self._slots) if s is None]

    def active(self) -> list[int]:
        return [i for i, s in enumerate(self._slots) if s is not None]

    @property
    def occupancy(self) -> int:
        return self.n_slots - len(self.free())

    def request_at(self, slot: int):
        s = self._slots[slot]
        return None if s is None else s.request

    # ------------------------------------------------------------ lifecycle
    def occupy(self, slot: int, request, *, first_token: int,
               prompt_len: int, gen_target: int) -> None:
        """Fill a freed slot with a freshly prefilled sequence: the prompt
        occupies cache positions ``[0, prompt_len)`` and ``first_token``
        (prefill's argmax) is the next token to decode at position
        ``prompt_len``."""
        if self._slots[slot] is not None:
            raise ValueError(f"slot {slot} is occupied")
        self._slots[slot] = _SlotState(request=request,
                                       gen_target=int(gen_target),
                                       gen_count=1)
        self.cache_lens[slot] = int(prompt_len)
        self.tokens[slot, 0] = int(first_token)

    def release(self, slot: int):
        """Free a slot; returns the request that occupied it."""
        s = self._slots[slot]
        if s is None:
            raise ValueError(f"slot {slot} is already free")
        self._slots[slot] = None
        return s.request

    def advance(self, next_tokens: np.ndarray,
                on_token=None) -> list[int]:
        """Fold one decode step's ``(B, 1)`` next-token array into the slot
        state: every *active* slot consumed its current token (written at
        ``cache_lens[slot]``) and produced the next one.  Returns the slots
        whose sequences just reached their generation target (caller
        releases and refills them — the continuous-batching step).

        ``on_token(slot, request, token)`` observes each active slot's
        newly decoded token."""
        finished = []
        for slot in self.active():
            s = self._slots[slot]
            tok = int(next_tokens[slot, 0])
            self.cache_lens[slot] += 1
            self.tokens[slot, 0] = tok
            s.gen_count += 1
            if on_token is not None:
                on_token(slot, s.request, tok)
            if s.gen_count >= s.gen_target:
                finished.append(slot)
        return finished
