"""Checkpoint store of the port (``repro.checkpoint``)."""
from .store import (  # noqa: F401
    AsyncCheckpointer, all_steps, clear, latest_step, restore, save,
    tree_leaves, tree_map,
)
