"""Shared bucketed-slab machinery for the hash table kernels.

Rows are scattered into per-bucket *slabs* (static ``num_buckets x
slab_cap`` layouts) keyed by a murmur-mixed hash of the key bit-planes,
with stable within-bucket order equal to original row order.  The
grouping is single-pass: ``kernels/fused_bucketing`` computes bucket ids,
histogram and ranks in one sweep, and all columns — key bit-planes,
occupancy, row ids, payloads — land in their slabs through **one** stacked
scatter (every column viewed as an int32 plane first).

Semantics contract:

* equal keys always land in the same bucket (the hash sees only the key
  bit-planes, with ``-0.0`` and subnormal floats normalized to ``+0.0``);
* slot order within a bucket is original row order (stable ranks);
* a bucket holds at most ``slab_cap`` rows — overflowing rows are dropped
  and counted.  Every row that does not get a slot is written to one
  trash slot past the end, so duplicate scatter indices (whose write order
  PyTorch leaves open) only ever meet there.

:class:`BucketPlan` caches one side's bit-planes and its bucket ids per
bucket count, shared by the host-side sizing pass and the kernel plan.
"""
import math

import numpy as np
import torch

from ..core.table import flush_subnormals, flush_subnormals_np
from .fused_bucketing import fused_bucket_ranks
from .fused_bucketing.ref import bucket_ids, bucket_ids_np  # noqa: F401
from .hash_partition import radix_histogram_ranks
from .radix_sort import grouped_ranks

# the single-pass ranking serves at most this many buckets; more go to the
# multi-pass radix rank (kernels/radix_sort)
MAX_RADIX_BUCKETS = 512

# up to this table capacity, default slab sizing uses full-capacity slabs:
# every key distribution (including all-equal keys) fits with zero
# overflow
EXACT_SLAB_CAP = 512


def key_bits(col: torch.Tensor) -> torch.Tensor:
    """Key column -> int32 bit-plane with the reference's equality: floats
    by their bits once ``-0.0`` and subnormals are ``+0.0``."""
    if col.dtype.is_floating_point:
        return flush_subnormals(col.to(torch.float32)).view(torch.int32)
    return col.to(torch.int32)


def key_bits_np(col: np.ndarray) -> np.ndarray:
    """numpy copy of :func:`key_bits`."""
    if np.issubdtype(col.dtype, np.floating):
        return flush_subnormals_np(col.astype(np.float32)).view(np.int32)
    return col.astype(np.int32)


def pack_i32(col: torch.Tensor) -> torch.Tensor:
    """Engine column -> int32 plane, value-preserving (floats are viewed
    as their bits, so :func:`unpack_i32` restores NaNs and ``-0.0``
    exactly)."""
    if col.dtype == torch.int32:
        return col
    if col.dtype == torch.float32:
        return col.view(torch.int32)
    if col.dtype == torch.bool:
        return col.to(torch.int32)
    raise TypeError(f"unsupported engine column dtype {col.dtype} "
                    "(engine contract: int32 / float32 / bool)")


def unpack_i32(plane: torch.Tensor, dtype) -> torch.Tensor:
    """Inverse of :func:`pack_i32` for a plane of the given column dtype."""
    if dtype == torch.int32:
        return plane
    if dtype == torch.float32:
        return plane.view(torch.float32)
    if dtype == torch.bool:
        return plane.to(torch.bool)
    raise TypeError(f"unsupported engine column dtype {dtype} "
                    "(engine contract: int32 / float32 / bool)")


def bucket_ranks(bid: torch.Tensor, num_buckets: int):
    """(hist (P,), stable within-bucket ranks (n,)) for P = num_buckets:
    the single-pass ``hash_partition`` ranking for up to
    ``MAX_RADIX_BUCKETS`` buckets, the multi-pass radix rank
    (``radix_sort.grouped_ranks``) above."""
    if num_buckets <= MAX_RADIX_BUCKETS:
        return radix_histogram_ranks(bid, num_buckets)
    return grouped_ranks(bid, num_buckets)


def group_to_slabs(bits: tuple, valid: torch.Tensor, num_buckets: int,
                   slab_cap: int, payload: tuple = (),
                   bid: torch.Tensor | None = None):
    """Scatter rows into (num_buckets * slab_cap) bucket-grouped slots.

    Returns ``(slab_bits (K, B*cap), occ (B*cap,), row (B*cap,),
    payload_slabs, dropped)``.  Slot order within a bucket is original row
    order.  With ``bid=None`` the bucket ids come out of the fused kernel;
    a caller holding precomputed ids (``BucketPlan.bucket_ids_for``) passes
    them and only the histogram/rank pass runs.  Above
    ``MAX_RADIX_BUCKETS`` buckets the ids are hashed here and ranked by
    the multi-pass radix rank."""
    cap = valid.shape[0]
    if bid is not None:
        bid = torch.where(valid, bid, num_buckets)
        hist, ranks = bucket_ranks(bid, num_buckets + 1)
    elif num_buckets <= MAX_RADIX_BUCKETS:
        bid, hist, ranks = fused_bucket_ranks(bits, valid, num_buckets)
    else:
        bid = torch.where(valid, bucket_ids(bits, num_buckets), num_buckets)
        hist, ranks = grouped_ranks(bid, num_buckets + 1)
    ok = valid & (ranks < slab_cap) & (bid < num_buckets)
    nslots = num_buckets * slab_cap
    slot = torch.where(ok, bid.to(torch.int64) * slab_cap + ranks, nslots)

    # one scatter for every column: key planes, occupancy, row ids and
    # payloads stack into (ncols, n) int32 and land in (ncols, nslots)
    # together (slot nslots is the shared trash column)
    num_keys = len(bits)
    planes = (list(bits)
              + [ok.to(torch.int32),
                 torch.arange(cap, dtype=torch.int32, device=valid.device)]
              + [pack_i32(p) for p in payload])
    stacked = torch.stack(planes)
    buf = (torch.zeros((len(planes), nslots + 1), dtype=torch.int32,
                       device=valid.device)
           .index_copy_(1, slot, stacked)[:, :nslots])
    slab_bits = buf[:num_keys]
    occ = buf[num_keys]
    row = buf[num_keys + 1]
    payload_slabs = tuple(unpack_i32(buf[num_keys + 2 + i], p.dtype)
                          for i, p in enumerate(payload))
    dropped = (hist[:num_buckets] - slab_cap).clamp(min=0).sum(
        dtype=torch.int32)
    return slab_bits, occ, row, payload_slabs, dropped


class BucketPlan:
    """One side's hashing state, shared by the sizing pass and the kernel
    plan: the int32 bit-planes, extracted once, and the bucket ids,
    memoized per bucket count."""

    __slots__ = ("bits", "_bid")

    def __init__(self, key_cols):
        self.bits = tuple(key_bits(c) for c in key_cols)
        self._bid = {}

    def bucket_ids_for(self, num_buckets: int) -> torch.Tensor:
        """Full-capacity bucket ids for ``num_buckets``, memoized."""
        if num_buckets not in self._bid:
            self._bid[num_buckets] = bucket_ids(self.bits, num_buckets)
        return self._bid[num_buckets]


def default_bucket_count(capacity: int) -> int:
    """~16-rows-per-bucket power-of-two bucket count, capped at
    ``MAX_RADIX_BUCKETS``."""
    target = max(1, capacity // 16)
    return 1 << min(MAX_RADIX_BUCKETS.bit_length() - 1,
                    max(3, (target - 1).bit_length()))


def plan_bucket_sizes(key_cols=None, num_buckets: int | None = None, *,
                      headroom: float = 1.25, min_capacity: int = 8,
                      plan: BucketPlan | None = None,
                      nvalid: int | None = None):
    """Two-pass (histogram, then size) bucket planner -> ``(num_buckets,
    slab_capacity)`` that fit the given keys: pass 1 buckets the valid
    keys with the kernels' hash, pass 2 sizes the slab to the largest
    bucket load times ``headroom``, rounded up to a multiple of 8.

    Pass a :class:`BucketPlan` (with ``nvalid``) instead of raw columns to
    reuse its bit-planes and memoize the bucket ids for the kernel plan."""
    if plan is not None:
        n = int(nvalid if nvalid is not None
                else (plan.bits[0].shape[0] if plan.bits else 0))
        if num_buckets is None:
            num_buckets = default_bucket_count(n)
        if n == 0:
            return num_buckets, min_capacity
        bid = plan.bucket_ids_for(num_buckets)[:n]
    else:
        cols = [torch.as_tensor(np.asarray(c)) for c in key_cols]
        n = int(cols[0].shape[0]) if cols else 0
        if num_buckets is None:
            num_buckets = default_bucket_count(n)
        if n == 0:
            return num_buckets, min_capacity
        bid = bucket_ids(tuple(key_bits(c) for c in cols), num_buckets)
    load = int(torch.bincount(bid.to(torch.int64),
                              minlength=num_buckets).max())
    cap = int(math.ceil(load * headroom))
    return num_buckets, max(min_capacity, -(-cap // 8) * 8)
