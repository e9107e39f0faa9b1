"""Out-of-core morsels (PyTorch port of ``repro/core/morsel.py``).

This slice ports :class:`ChunkedTable` only, the host-side source the
serving feature store streams its tables from.  The chunked operators
(``chunked_dist_join``, ``chunked_dist_groupby``, ``chunked_dist_sort``,
``merge_sorted_runs``) come with the morsel slice.
"""
from __future__ import annotations

import math
from typing import Mapping

import numpy as np

from . import dist_ops as D
from .context import HptmtContext

__all__ = ["ChunkedTable"]


class ChunkedTable:
    """Host-side chunked table: numpy columns streamed as fixed-size
    morsels.

    ``data`` maps column name -> 1-D numpy array (all equal length; a
    ``np.memmap`` works — chunks are slices, nothing is copied until a
    chunk is distributed).  ``chunk_rows`` is the morsel size: every
    chunk has exactly ``chunk_rows`` rows except the last (and a
    zero-row table yields exactly one empty chunk).
    """

    def __init__(self, data: Mapping[str, np.ndarray], chunk_rows: int):
        if chunk_rows <= 0:
            raise ValueError(f"chunk_rows must be positive, got "
                             f"{chunk_rows}")
        self.columns = {k: np.asarray(v) for k, v in data.items()}
        if not self.columns:
            raise ValueError("ChunkedTable needs at least one column")
        lengths = {k: len(v) for k, v in self.columns.items()}
        if len(set(lengths.values())) != 1:
            raise ValueError(f"columns must have equal length: {lengths}")
        self.nrows = next(iter(lengths.values()))
        self.chunk_rows = int(chunk_rows)

    @property
    def names(self) -> tuple[str, ...]:
        return tuple(self.columns.keys())

    @property
    def num_chunks(self) -> int:
        return max(1, math.ceil(self.nrows / self.chunk_rows))

    def chunk(self, i: int) -> dict[str, np.ndarray]:
        lo = i * self.chunk_rows
        hi = min(lo + self.chunk_rows, self.nrows)
        return {k: v[lo:hi] for k, v in self.columns.items()}

    def chunks(self):
        for i in range(self.num_chunks):
            yield self.chunk(i)

    def capacity_per_shard(self, world: int) -> int:
        """The fixed per-shard capacity one morsel needs — the same for
        every chunk (the last, smaller chunk reuses it)."""
        return max(1, math.ceil(self.chunk_rows / world))

    def distribute(self, ctx: HptmtContext,
                   capacity_per_shard: int | None = None):
        """Stream the chunks through ``distribute_table``: yields this
        rank's block of each morsel, all with the same static capacity."""
        cap = capacity_per_shard or self.capacity_per_shard(ctx.world_size)
        for chunk in self.chunks():
            yield D.distribute_table(ctx, chunk, capacity_per_shard=cap)
