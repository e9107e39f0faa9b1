"""Hash partitioning for table shuffles (Cylon's hash-partition step).

Key hashing is the murmur3-style 32-bit chain of
``kernels/fused_bucketing/ref.py`` over the key columns' bits; partition
id = hash % P.  The shuffle ranks the ids with the
``kernels/hash_partition`` kernel.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ..kernels.fused_bucketing.ref import hash_chain, hash_chain_np
from .table import Table, flush_subnormals, flush_subnormals_np


def _col_bits(col: torch.Tensor) -> torch.Tensor:
    """A column's int32 bits; ``-0.0`` and subnormals hash as ``+0.0`` so
    keys the reference compares equal hash equal."""
    if col.dtype.is_floating_point:
        return flush_subnormals(col.to(torch.float32)).view(torch.int32)
    return col.to(torch.int32)


def hash_columns(cols: Sequence[torch.Tensor]) -> torch.Tensor:
    """Combined 32-bit hash (int64 in ``[0, 2**32)``) of parallel key
    columns."""
    return hash_chain([_col_bits(c) for c in cols])


def hash_columns_np(cols: Sequence[np.ndarray]) -> np.ndarray:
    """numpy ``uint32`` copy of :func:`hash_columns`."""
    planes = []
    for c in cols:
        c = np.asarray(c)
        if np.issubdtype(c.dtype, np.floating):
            planes.append(flush_subnormals_np(c.astype(np.float32))
                          .view(np.int32))
        else:
            planes.append(c.astype(np.int32))
    return hash_chain_np(planes)


def partition_ids(table: Table, key_cols: Sequence[str],
                  num_partitions: int) -> torch.Tensor:
    """Partition id per row; padding rows get id 0 (callers mask them)."""
    h = hash_columns([table.columns[k] for k in key_cols])
    pid = (h % num_partitions).to(torch.int32)
    return torch.where(table.valid_mask, pid, 0)

