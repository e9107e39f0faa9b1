"""Plain PyTorch version of the fused bucketing kernel, and the canonical
bucket hash.

One logical pass over the rows: murmur-mix the key bit-planes into a
bucket id, histogram the ids, and rank each row stably within its bucket.
Invalid rows take the trash bucket ``num_buckets``.

The hash is a chain of 32-bit unsigned operations.  PyTorch's ``uint32``
lacks shifts, addition and remainder, so the chain runs in int64 holding
values in ``[0, 2**32)``, masked after every step; products are split in
16-bit halves so that no intermediate leaves int64.  :func:`bucket_ids_np`
is the same chain in numpy ``uint32`` for the host-side planners.
"""
import numpy as np
import torch

_GOLDEN = 0x9E3779B9
_M32 = 0xFFFFFFFF


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """Low 32 bits of ``x * c`` for ``x`` in ``[0, 2**32)`` (int64)."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """murmur3 fmix32 over values in ``[0, 2**32)`` held in int64."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def hash_chain(planes) -> torch.Tensor:
    """Combined 32-bit hash (int64 in ``[0, 2**32)``) of parallel int32
    bit-planes."""
    h = torch.full(planes[0].shape, _GOLDEN, dtype=torch.int64,
                   device=planes[0].device)
    for p in planes:
        u = p.to(torch.int64) & _M32
        h = _mix32(h ^ ((u + _GOLDEN + (h << 6) + (h >> 2)) & _M32))
    return h


def bucket_ids(bits: tuple, num_buckets: int) -> torch.Tensor:
    """Combined bucket id over int32 key bit-planes (equal keys -> equal
    bucket)."""
    return (hash_chain(bits) % num_buckets).to(torch.int32)


def _mix32_np(x: np.ndarray) -> np.ndarray:
    x = x ^ (x >> np.uint32(16))
    x = x * np.uint32(0x85EBCA6B)
    x = x ^ (x >> np.uint32(13))
    x = x * np.uint32(0xC2B2AE35)
    return x ^ (x >> np.uint32(16))


def hash_chain_np(planes) -> np.ndarray:
    """numpy ``uint32`` copy of :func:`hash_chain` over 32-bit planes."""
    g = np.uint32(_GOLDEN)
    h = np.full(np.shape(planes[0]), g, np.uint32)
    for p in planes:
        u = np.ascontiguousarray(p).view(np.uint32)
        h = _mix32_np(h ^ (u + g + (h << np.uint32(6)) + (h >> np.uint32(2))))
    return h


def bucket_ids_np(bits, num_buckets: int) -> np.ndarray:
    """numpy copy of :func:`bucket_ids` over int32 bit-planes."""
    return (hash_chain_np(bits) % np.uint32(num_buckets)).astype(np.int32)


def fused_bucket_ranks_ref(bits: tuple, valid: torch.Tensor,
                           num_buckets: int):
    """(bid (n,), hist (P+1,), ranks (n,)) for P = num_buckets.

    ``bid`` is ``num_buckets`` (trash) for invalid rows; ``hist`` covers
    the P real buckets plus the trash bucket; ``ranks`` are stable (row
    order) within each bucket including trash."""
    bid = torch.where(valid, bucket_ids(bits, num_buckets), num_buckets)
    cols = torch.arange(num_buckets + 1, dtype=bid.dtype, device=bid.device)
    onehot = (cols[:, None] == bid[None, :]).to(torch.int32)   # (P+1, n)
    hist = onehot.sum(1, dtype=torch.int32)
    excl = torch.cumsum(onehot, 1, dtype=torch.int32) - onehot
    ranks = (excl * onehot).sum(0, dtype=torch.int32)
    return bid, hist, ranks
