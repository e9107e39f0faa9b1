"""Bucketed hash-join build + probe plan (``hash_join``).

:func:`hash_join_plan` buckets both sides by the key hash (build side =
the chain table, probe side = the left rows), runs the bucketed probe and
returns what the caller needs to place matched pairs in a static-capacity
output: per-left-row match counts plus, per (probe slot, chain slot)
pair, the original row ids and the within-row match rank.

The probe replaces the TPU kernel ``bucket_probe_buckets`` of
``src/repro/kernels/hash_join/kernel.py``.  The CUDA kernel
(``csrc/hash_join.cu``, on the bucket compare of
``csrc/bucket_match.cuh``) streams each bucket's build keys through shared
memory in chunks and walks every probe slot's chain 32 slots per warp step
with a ballot, writing the dense ``(B, Lc, C)`` rank tensor once,
coalesced; any number of key planes and any slab width run.  That write
bounds it: 4 B per pair.

Static-shape contract: a bucket holds at most ``bucket_capacity`` build
rows and ``probe_capacity`` probe rows; overflowing rows are dropped and
counted (``build_dropped`` / ``probe_dropped``).
"""
import ctypes
from typing import NamedTuple

import torch

from ...core.kernel_backend import table_kernel_impl
from .. import build
from ..bucketing import EXACT_SLAB_CAP, group_to_slabs
from .ref import bucket_probe_ref

REPLACES = "src/repro/kernels/hash_join/kernel.py:46"
SOURCE = "src/repro_torch/kernels/csrc/hash_join.cu"

# kernel launches in this process; chip_smoke.py resets and reads it
launches = 0


def _bucket_probe_cuda(pbits, pocc, bbits, bocc):
    global launches
    for name, t in (("pbits", pbits), ("pocc", pocc), ("bbits", bbits),
                    ("bocc", bocc)):
        build.check_input(name, t)
    B, K, Lc = pbits.shape
    C = bbits.shape[2]
    if pocc.shape != (B, Lc) or bbits.shape != (B, K, C) \
            or bocc.shape != (B, C):
        raise ValueError("inconsistent probe/build slab shapes: "
                         f"{tuple(pbits.shape)} {tuple(pocc.shape)} "
                         f"{tuple(bbits.shape)} {tuple(bocc.shape)}")
    dev = pbits.device
    counts = torch.zeros((B, Lc), dtype=torch.int32, device=dev)
    rank = torch.empty((B, Lc, C), dtype=torch.int32, device=dev)
    if B == 0 or Lc == 0 or C == 0:
        return counts, rank
    if K == 0:
        raise ValueError("the probe kernel needs at least one key plane")
    lib = build.library("hash_join")
    fn = lib.hash_join_probe
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 \
        + [ctypes.c_void_p] * 3
    fn.restype = ctypes.c_int
    status = fn(pbits.data_ptr(), pocc.data_ptr(), bbits.data_ptr(),
                bocc.data_ptr(), B, K, Lc, C, counts.data_ptr(),
                rank.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    build.check(lib, status, "hash_join")
    launches += 1
    return counts, rank


def bucket_probe(pbits, pocc, bbits, bocc):
    """(counts (B, Lc), rank (B, Lc, C)) — see ``ref.py``.  The CUDA kernel
    runs for CUDA tensors, the plain version for CPU tensors."""
    if table_kernel_impl(pbits.device) == "ref":
        return bucket_probe_ref(pbits, pocc, bbits, bocc)
    return _bucket_probe_cuda(pbits, pocc, bbits, bocc)


def _group(bits: tuple, valid: torch.Tensor, num_buckets: int,
           slab_cap: int, bid=None):
    """Bucket-grouped slabs (see kernels.bucketing.group_to_slabs)."""
    slab_bits, occ, row, _, dropped = group_to_slabs(
        bits, valid, num_buckets, slab_cap, bid=bid)
    return slab_bits, occ, row, dropped


class HashJoinPlan(NamedTuple):
    """Probe results mapped back to original row ids.

    ``match_counts`` is indexed by original left row (0 for padding rows
    and for probe-dropped rows); the pair-space arrays are indexed by
    (bucket, probe slot, chain slot) and carry original row ids."""

    match_counts: torch.Tensor   # (Lcap,) int32
    probed: torch.Tensor         # (Lcap,) bool: left row made it into a slab
    probe_row: torch.Tensor      # (B, Lc) int32 original left row per slot
    rank: torch.Tensor           # (B, Lc, C) int32 match rank, -1 = no match
    build_row: torch.Tensor      # (B, C) int32 original right row per slot
    build_dropped: torch.Tensor  # () int32 right rows lost to chain overflow
    probe_dropped: torch.Tensor  # () int32 left rows lost to probe overflow


def hash_join_plan(left_bits: tuple, left_valid: torch.Tensor,
                   right_bits: tuple, right_valid: torch.Tensor, *,
                   num_buckets: int, bucket_capacity: int,
                   probe_capacity: int,
                   left_bid: torch.Tensor | None = None,
                   right_bid: torch.Tensor | None = None) -> HashJoinPlan:
    """Bucketed build (right) + probe (left) over parallel key bit-planes.

    ``left_bid`` / ``right_bid`` carry precomputed bucket ids (the eager
    sizing pass's hash, via ``BucketPlan``) so the plan does not re-hash."""
    B, C, Lc = num_buckets, bucket_capacity, probe_capacity
    lbits, rbits = tuple(left_bits), tuple(right_bits)
    lcap = left_valid.shape[0]

    bslab, bocc, brow, build_dropped = _group(rbits, right_valid, B, C,
                                              bid=right_bid)
    pslab, pocc, prow, probe_dropped = _group(lbits, left_valid, B, Lc,
                                              bid=left_bid)
    num_keys = len(lbits)
    pb = pslab.reshape(num_keys, B, Lc).transpose(0, 1).contiguous()
    bb = bslab.reshape(num_keys, B, C).transpose(0, 1).contiguous()
    counts_g, rank_g = bucket_probe(pb, pocc.reshape(B, Lc), bb,
                                    bocc.reshape(B, C))

    # counts + probed back to original left-row order in ONE stacked
    # scatter (trash slot lcap for empty slots)
    idx = torch.where(pocc > 0, prow.to(torch.int64), lcap)
    packed = (torch.zeros((2, lcap + 1), dtype=torch.int32,
                          device=left_valid.device)
              .index_copy_(1, idx, torch.stack(
                  [counts_g.reshape(-1), (pocc > 0).to(torch.int32)]))
              [:, :lcap])
    return HashJoinPlan(match_counts=packed[0], probed=packed[1] > 0,
                        probe_row=prow.reshape(B, Lc), rank=rank_g,
                        build_row=brow.reshape(B, C),
                        build_dropped=build_dropped,
                        probe_dropped=probe_dropped)


def default_hash_join_sizes(left_capacity: int, right_capacity: int,
                            num_buckets: int | None = None):
    """(num_buckets, bucket_capacity, probe_capacity) heuristics.

    Small tables (both capacities <= ``bucketing.EXACT_SLAB_CAP``) get
    full-capacity slabs, which fit every key distribution.  Larger tables
    get ~16 build rows per bucket on average with 4x headroom per slab."""
    small = max(left_capacity, right_capacity) <= EXACT_SLAB_CAP
    if num_buckets is None:
        if small:
            num_buckets = 8
        else:
            target = max(1, right_capacity // 16)
            num_buckets = 1 << min(16, max(3, (target - 1).bit_length()))
    if small:
        return num_buckets, max(8, right_capacity), max(8, left_capacity)
    chain = max(8, -(-right_capacity // num_buckets) * 4)
    probe = max(8, -(-left_capacity // num_buckets) * 4)
    return num_buckets, chain, probe
