"""Hash partitioning for table shuffles (Cylon's hash-partition step).

Key hashing is the murmur3-style 32-bit chain of
``kernels/fused_bucketing/ref.py`` over the key columns' bits; partition
id = hash % P.  The shuffle and :func:`plan_partitions` rank the ids
with the ``kernels/hash_partition`` kernel.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ..kernels.fused_bucketing.ref import hash_chain, hash_chain_np
from ..kernels.hash_partition import partition_plan
from .kernel_backend import table_kernel_impl
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


def plan_partitions(table: Table, key_cols: Sequence[str],
                    num_partitions: int, impl: str | None = None):
    """(hist, dest-slot, pid) over *valid* rows only, all int32.

    Padding rows are routed to a one-past-the-end trash partition so they
    never consume real slots.  The ``hash_partition`` kernel ranks the ids
    on a CUDA table, its plain version on a CPU table; ``impl`` (``ref`` or
    ``cuda``), where given, may only confirm what the device implies."""
    pid = partition_ids(table, key_cols, num_partitions)
    if impl is not None and impl != table_kernel_impl(pid.device):
        raise ValueError(f"impl={impl!r} cannot run on a {pid.device.type} "
                         "table: the kernel runs on CUDA tensors and its "
                         "plain version on CPU tensors")
    pid = torch.where(table.valid_mask, pid, num_partitions)
    hist, dest = partition_plan(pid, num_partitions + 1)
    return hist[:num_partitions], dest, pid
