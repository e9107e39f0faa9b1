"""Plain PyTorch version of the radix histogram/rank kernel.

Given partition ids ``pid`` (int32 ``(n,)`` in ``[0, num_partitions)``):

* ``hist``  — ``(num_partitions,)`` int32 row counts per partition;
* ``ranks`` — ``(n,)`` int32 stable rank of each row *within* its
  partition (the i-th row with pid p gets rank i, in row order).

An id outside ``[0, num_partitions)`` is not counted and gets rank 0.
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
