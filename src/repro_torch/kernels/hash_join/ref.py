"""Plain PyTorch version of the bucketed hash-join probe kernel.

Both join sides arrive bucket-grouped: for each of ``B`` buckets a probe
slab of ``Lc`` slots and a build slab of ``C`` slots, each slot holding
the row's ``K`` int32 key bit-planes plus an occupancy flag.  Per bucket:

* ``counts`` — ``(B, Lc)`` int32 number of build matches per probe slot;
* ``rank``   — ``(B, Lc, C)`` int32 exclusive count of earlier matching
  chain slots, or ``-1`` where the pair does not match.

A pair matches iff both slots are occupied and all key planes are equal.
"""
import torch


def bucket_probe_ref(pbits: torch.Tensor, pocc: torch.Tensor,
                     bbits: torch.Tensor, bocc: torch.Tensor):
    """pbits (B, K, Lc) int32, pocc (B, Lc) int32 0/1, bbits (B, K, C),
    bocc (B, C) -> (counts (B, Lc) int32, rank (B, Lc, C) int32)."""
    match = (pocc[:, :, None] > 0) & (bocc[:, None, :] > 0)
    for k in range(pbits.shape[1]):
        match = match & (pbits[:, k, :, None] == bbits[:, k, None, :])
    m = match.to(torch.int32)
    counts = m.sum(2, dtype=torch.int32)
    excl = torch.cumsum(m, 2, dtype=torch.int32) - m
    rank = torch.where(match, excl, -1)
    return counts, rank
