"""Training runtime of the port (``repro.runtime``)."""
