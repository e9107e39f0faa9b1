"""Roofline of a port step on the NVIDIA H100 (the counterpart of the JAX
package's ``roofline/``): ``cost.py`` counts a step op by op,
``collectives.py`` holds the ring model, ``analysis.py`` the H100
constants and the three terms."""
from .analysis import (HBM_BW, NDR_BW, NVLINK_BW, PEAK_FLOPS,  # noqa: F401
                       Roofline)
from .collectives import CollectiveStats  # noqa: F401
