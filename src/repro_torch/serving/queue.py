"""Bounded admission queue with counted rejections (backpressure stage).

A copy of the JAX package's ``serving/queue.py`` (framework-free).

The serving engine's front door follows the same contract as the table
kernels' static-shape slabs: a *bounded* buffer whose overflow is
**counted, never silent**.  ``offer`` on a full queue refuses the request
and increments the ``rejected`` counter — the caller learns immediately
(backpressure) and the soak benches can assert the accounting identity
``submitted == completed + rejected + feature_misses`` end to end.
"""
from __future__ import annotations

import collections
from typing import Optional

from .metrics import ServingMetrics


class AdmissionQueue:
    """FIFO queue with a hard capacity and counted rejections."""

    def __init__(self, capacity: int,
                 metrics: Optional[ServingMetrics] = None):
        if capacity <= 0:
            raise ValueError(f"queue capacity must be positive, got "
                             f"{capacity}")
        self.capacity = int(capacity)
        self.metrics = metrics if metrics is not None else ServingMetrics()
        self._items: collections.deque = collections.deque()

    def __len__(self) -> int:
        return len(self._items)

    @property
    def depth(self) -> int:
        return len(self._items)

    def offer(self, item) -> bool:
        """Admit ``item`` if there is room.  Returns False (and counts the
        rejection) when the queue is at capacity — never drops silently."""
        self.metrics.inc("submitted")
        if len(self._items) >= self.capacity:
            self.metrics.inc("rejected")
            self.metrics.gauge("queue_depth", len(self._items))
            return False
        self._items.append(item)
        self.metrics.gauge("queue_depth", len(self._items))
        return True

    def pop(self):
        """Dequeue the oldest item (None when empty)."""
        if not self._items:
            return None
        item = self._items.popleft()
        self.metrics.gauge("queue_depth", len(self._items))
        return item
