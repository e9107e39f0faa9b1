"""Plain PyTorch version of the radix histogram/rank kernel.

Given partition ids ``pid`` (int32 ``(n,)`` in ``[0, num_partitions)``):

* ``hist``  — ``(num_partitions,)`` int32 row counts per partition;
* ``ranks`` — ``(n,)`` int32 stable rank of each row *within* its
  partition (the i-th row with pid p gets rank i, in row order).

An id outside ``[0, num_partitions)`` is not counted and gets rank 0.

:func:`add_tile_offsets` is the plain version of the cross-tile stage
alone: per-tile histograms and within-tile ranks, as the TPU kernel
leaves them, to the whole-array ranking.
"""
import torch


def radix_histogram_ranks_ref(pid: torch.Tensor, num_partitions: int):
    # (P, n) one-hot: the running count runs along the contiguous axis
    cols = torch.arange(num_partitions, dtype=pid.dtype, device=pid.device)
    onehot = (cols[:, None] == pid[None, :]).to(torch.int32)
    hist = onehot.sum(1, dtype=torch.int32)
    excl = torch.cumsum(onehot, 1, dtype=torch.int32) - onehot
    ranks = (excl * onehot).sum(0, dtype=torch.int32)
    return hist, ranks


def add_tile_offsets(hist_t: torch.Tensor, rank_t: torch.Tensor,
                     ids: torch.Tensor, num_partitions: int, tile: int):
    """Per-tile histograms ``(n_tiles, P)`` and within-tile ranks ``(n,)``
    -> (hist ``(P,)``, ranks ``(n,)``): a row's rank gains the counts of
    its id in earlier tiles.  Rows with an id outside ``[0, P)`` keep
    rank 0."""
    P = num_partitions
    # scan each partition's counts along the contiguous axis: (P, n_tiles)
    per_part = hist_t.t().contiguous()
    offsets = (torch.cumsum(per_part, 1, dtype=torch.int32)
               - per_part).view(-1)
    tile_of = torch.arange(ids.shape[0], device=ids.device) // tile
    inside = (ids >= 0) & (ids < P)
    part = ids.clamp(0, max(P - 1, 0)).to(torch.int64)
    off = offsets[part * hist_t.shape[0] + tile_of]
    ranks = rank_t + torch.where(inside, off, 0)
    return hist_t.sum(0, dtype=torch.int32), ranks
