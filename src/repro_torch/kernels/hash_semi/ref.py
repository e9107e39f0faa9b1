"""Plain PyTorch version of the bucketed hash-semi membership kernel.

Both sides arrive bucket-grouped (``ops.py`` groups them with the shared
``kernels.bucketing`` slabs): for each of ``B`` buckets a probe slab of
``Lc`` slots and a build slab of ``C`` slots, each slot holding the row's
``K`` int32 key bit-planes plus an occupancy flag.  Per bucket:

* ``member`` — ``(B, Lc)`` int32, 1 iff the probe slot is occupied and
  any occupied build slot carries the same key (all planes equal).

Equal keys always share a bucket, so the per-bucket answer is exact.
"""
import torch


def bucket_member_ref(pbits: torch.Tensor, pocc: torch.Tensor,
                      bbits: torch.Tensor, bocc: torch.Tensor):
    """pbits (B, K, Lc) int32, pocc (B, Lc) int32 0/1, bbits (B, K, C),
    bocc (B, C) -> member (B, Lc) int32 0/1."""
    match = (pocc[:, :, None] > 0) & (bocc[:, None, :] > 0)
    for k in range(pbits.shape[1]):
        match = match & (pbits[:, k, :, None] == bbits[:, k, None, :])
    return match.any(2).to(torch.int32)
