"""Serving metrics: counters, gauges, and latency percentiles.

A copy of the JAX package's ``serving/metrics.py`` (framework-free).

The engine's observability contract: every
stage of the serving pipeline reports into one :class:`ServingMetrics`
registry so the millions-of-users story is *measurable* —

* **counters** (monotonic): ``submitted``, ``rejected`` (admission-queue
  overflow — the counted-rejection contract: a request is never silently
  dropped), ``admitted``, ``completed``, ``feature_misses`` (admitted but
  no feature row — terminal, counted), ``prefills``, ``decode_steps``,
  ``tokens_generated``, ``feature_rows`` (feature-table rows joined onto
  requests), ``feature_dropped`` (rows lost in the feature-fetch
  shuffle/join slabs — must stay 0 when sized right);
* **gauges** (last + max): ``queue_depth``, ``slot_occupancy``;
* **series** (observations in seconds): ``latency`` (submit -> done),
  ``ttft`` (submit -> first token), ``queue_wait`` (submit -> admit) —
  summarized as count/mean/p50/p99/max.

Percentiles use the nearest-rank method over everything observed (the
soak benches run minutes, not days — no reservoir needed).
"""
from __future__ import annotations

import collections

import numpy as np


class ServingMetrics:
    """In-process metrics registry for one engine instance."""

    def __init__(self):
        self.counters: dict[str, int] = collections.defaultdict(int)
        self.gauges: dict[str, dict[str, float]] = {}
        self.series: dict[str, list[float]] = collections.defaultdict(list)

    # ------------------------------------------------------------- recording
    def inc(self, name: str, n: int = 1) -> None:
        self.counters[name] += int(n)

    def gauge(self, name: str, value: float) -> None:
        g = self.gauges.setdefault(name, {"last": 0.0, "max": 0.0})
        g["last"] = float(value)
        g["max"] = max(g["max"], float(value))

    def observe(self, name: str, value: float) -> None:
        self.series[name].append(float(value))

    # --------------------------------------------------------------- reading
    def count(self, name: str) -> int:
        return self.counters.get(name, 0)

    def percentile(self, name: str, p: float) -> float:
        xs = self.series.get(name)
        if not xs:
            return float("nan")
        return float(np.percentile(np.asarray(xs), p,
                                   method="closest_observation"))

    def summary(self, name: str) -> dict[str, float]:
        xs = self.series.get(name, [])
        if not xs:
            return {"count": 0}
        a = np.asarray(xs)
        return {"count": int(a.size), "mean": float(a.mean()),
                "p50": self.percentile(name, 50),
                "p99": self.percentile(name, 99), "max": float(a.max())}

    def snapshot(self) -> dict:
        """The full metrics schema as one JSON-friendly dict."""
        return {
            "counters": dict(self.counters),
            "gauges": {k: dict(v) for k, v in self.gauges.items()},
            "latency": {k: self.summary(k) for k in self.series},
        }
