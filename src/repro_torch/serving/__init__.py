"""Continuous-batching serving engine fused with distributed feature
joins (see ``engine.py`` for the stage-by-stage story)."""
from .batcher import SlotBatch
from .engine import FeatureStore, Request, ServingEngine
from .metrics import ServingMetrics
from .queue import AdmissionQueue

__all__ = ["AdmissionQueue", "FeatureStore", "Request", "ServingEngine",
           "ServingMetrics", "SlotBatch"]
