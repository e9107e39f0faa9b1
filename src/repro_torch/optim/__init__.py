"""Optimizer and gradient compression of the port (``repro.optim``)."""
from . import adamw  # noqa: F401
from . import compression  # noqa: F401
from .adamw import AdamWConfig  # noqa: F401
