"""Bucketed hash-accumulate groupby plan (``hash_groupby``).

:func:`hash_groupby_plan` is what ``groupby_aggregate(impl="hash")`` (and,
key-only, ``drop_duplicates(impl="hash")``) runs: it groups the rows into
bucket slabs by the key hash (``kernels.bucketing``), then the bucketed
accumulate computes sum, count, min and max for every distinct key in one
pass, with no sort.  Slabs keep original row order, so a group's
representative slot is its key's first occurrence.

The accumulate replaces the TPU kernel ``bucket_accumulate_buckets`` of
``src/repro/kernels/hash_groupby/kernel.py``.  The CUDA kernel
(``csrc/hash_groupby.cu``) gives each bucket one warp, compacts its
occupied slots into shared memory, numbers its groups in the order of
their first slots and folds each group's values over the occupied
slots alone; a slab too wide for shared memory works in a workspace
this wrapper allocates.  On sparse slabs such as the groupby leg's the bytes the
function must move bound it: the occupancy and the occupied slots' keys
and values in, ``4 B C (2 + 3 V)`` bytes of results out.

Static-shape contract: a bucket holds at most ``bucket_capacity`` rows;
overflowing rows are dropped and counted (``dropped``).
"""
import ctypes
import functools
from typing import NamedTuple

import torch

from ...core.kernel_backend import table_kernel_impl
from .. import build
from ..bucketing import EXACT_SLAB_CAP, default_bucket_count, group_to_slabs
from .ref import bucket_accumulate_ref

REPLACES = "src/repro/kernels/hash_groupby/kernel.py:58"
SOURCE = "src/repro_torch/kernels/csrc/hash_groupby.cu"

# kernel launches in this process; chip_smoke.py resets and reads it
launches = 0


@functools.cache
def _entry():
    """(library, ``hash_groupby_workspace_bytes``,
    ``hash_groupby_accumulate``) with argument types set."""
    lib = build.library("hash_groupby")
    size = lib.hash_groupby_workspace_bytes
    size.argtypes = [ctypes.c_int] * 4
    size.restype = ctypes.c_longlong
    fn = lib.hash_groupby_accumulate
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 \
        + [ctypes.c_void_p] * 7
    fn.restype = ctypes.c_int
    return lib, size, fn


def _bucket_accumulate_cuda(kbits, occ, vals):
    global launches
    build.check_input("kbits", kbits)
    build.check_input("occ", occ)
    build.check_input("vals", vals, torch.float32)
    B, K, C = kbits.shape
    V = vals.shape[1]
    if occ.shape != (B, C) or vals.shape != (B, V, C):
        raise ValueError("inconsistent slab shapes: "
                         f"{tuple(kbits.shape)} {tuple(occ.shape)} "
                         f"{tuple(vals.shape)}")
    dev = kbits.device
    if B == 0 or C == 0 or V == 0:                # nothing to launch
        zeros = torch.zeros((B, C), dtype=torch.int32, device=dev)
        return (zeros, zeros.clone(),
                torch.zeros((B, V, C), device=dev),
                torch.full((B, V, C), float("inf"), device=dev),
                torch.full((B, V, C), float("-inf"), device=dev))
    rep = torch.empty((B, C), dtype=torch.int32, device=dev)
    counts = torch.empty((B, C), dtype=torch.int32, device=dev)
    sums, mins, maxs = torch.empty((3, B, V, C), dtype=torch.float32,
                                   device=dev)
    lib, size, fn = _entry()
    # a slab whose per-warp workspace does not fit a block's shared memory
    # works in device memory allocated here
    nbytes = size(B, K, V, C)
    if nbytes < 0:
        raise RuntimeError("hash_groupby: cannot query the device's shared "
                           "memory")
    workspace = torch.empty(nbytes // 4, dtype=torch.int32, device=dev) \
        if nbytes else None
    status = fn(kbits.data_ptr(), occ.data_ptr(), vals.data_ptr(), B, K, V,
                C, workspace.data_ptr() if nbytes else None,
                rep.data_ptr(), counts.data_ptr(), sums.data_ptr(),
                mins.data_ptr(), maxs.data_ptr(),
                torch.cuda.current_stream(dev).cuda_stream)
    build.check(lib, status, "hash_groupby")
    launches += 1
    return rep, counts, sums, mins, maxs


def bucket_accumulate(kbits, occ, vals):
    """(rep, counts, sums, mins, maxs) — see ``ref.py``.  The CUDA kernel
    runs for CUDA tensors, the plain version for CPU tensors."""
    if table_kernel_impl(kbits.device) == "ref":
        return bucket_accumulate_ref(kbits, occ, vals)
    return _bucket_accumulate_cuda(kbits, occ, vals)


class HashGroupbyPlan(NamedTuple):
    """Per-slot accumulate results in bucket-slab space, indexed by
    (bucket, slot); ``row`` maps a slot back to its original row.
    Aggregates are meaningful only where ``rep != 0``."""

    rep: torch.Tensor       # (B, C) int32: slot is a group representative
    row: torch.Tensor       # (B, C) int32 original row per slot
    counts: torch.Tensor    # (B, C) int32 group sizes
    sums: torch.Tensor      # (B, V, C) float32 per-value-column sums
    mins: torch.Tensor      # (B, V, C) float32
    maxs: torch.Tensor      # (B, V, C) float32
    dropped: torch.Tensor   # () int32 rows lost to bucket overflow


def hash_groupby_plan(key_bits_planes: tuple, valid: torch.Tensor,
                      values: tuple = (), *, num_buckets: int,
                      bucket_capacity: int,
                      bid: torch.Tensor | None = None) -> HashGroupbyPlan:
    """Bucketed hash-accumulate over parallel key bit-planes and value
    columns.  ``values`` may be empty (key-only grouping): one zero column
    keeps the kernel's shape.  ``bid`` carries precomputed bucket ids (the
    sizing pass's hash, via ``BucketPlan``)."""
    B, C = num_buckets, bucket_capacity
    bits = tuple(key_bits_planes)
    vals = tuple(v.to(torch.float32) for v in values) \
        or (torch.zeros(valid.shape, dtype=torch.float32,
                        device=valid.device),)
    slab_bits, occ, row, val_slabs, dropped = group_to_slabs(
        bits, valid, B, C, payload=vals, bid=bid)
    num_keys = len(bits)
    kb = slab_bits.reshape(num_keys, B, C).transpose(0, 1).contiguous()
    vs = torch.stack(val_slabs).reshape(len(vals), B, C).transpose(0, 1) \
        .contiguous()
    rep, counts, sums, mins, maxs = bucket_accumulate(
        kb, occ.reshape(B, C), vs)
    return HashGroupbyPlan(rep=rep, row=row.reshape(B, C), counts=counts,
                           sums=sums, mins=mins, maxs=maxs, dropped=dropped)


def default_hash_groupby_sizes(capacity: int,
                               num_buckets: int | None = None):
    """(num_buckets, bucket_capacity) heuristics, as in the reference:
    full-capacity slabs up to ``bucketing.EXACT_SLAB_CAP`` rows (every key
    distribution fits), else ~16 rows per bucket with 4x headroom."""
    if capacity <= EXACT_SLAB_CAP:
        return num_buckets or 8, max(8, capacity)
    if num_buckets is None:
        num_buckets = default_bucket_count(capacity)
    return num_buckets, max(8, -(-capacity // num_buckets) * 4)
